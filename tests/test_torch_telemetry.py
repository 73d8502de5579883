"""The port's telemetry on the CPU against the JAX package's.

``deepspeed_tpu_torch/monitor/{telemetry,monitor}.py``, ``utils/memory.py``
and their wiring through the training engine and the v2 serving engine,
held to their ``deepspeed_tpu`` counterparts:

- units (the cases of the JAX package's ``tests/unit/test_telemetry.py``):
  the same calls into both collectors give equal records (wall stamps
  aside), equal JSONL streams, the same profiler-window transitions, and
  the same ops-plane caches;
- training: the port's and the JAX engine's ``train_step`` records on the
  same tiny Llama have the same keys and agree in ``loss``, ``grad_norm``
  and ``lr`` (rtol 1e-4; the JAX side runs its Pallas kernels in interpret
  mode on a one-device topology); ``flops_per_step`` equals the products
  counted from the shapes; ``hbm`` has its three keys, None on the CPU; the
  ``profile_step`` window writes a Chrome trace; the ``telemetry_smoke`` lane
  (``run_tests.py``);
- serving: the scheduler's and the engine's gauge records under a
  ``FakeClock`` carry the JAX engine's timestamps and steps exactly, and
  with ``trace_jsonl`` on one ``kind: trace`` record lands per request;
  the serve-iteration window writes a trace with the serve phases' ranges."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.monitor import metrics as jmetrics
from deepspeed_tpu.monitor import telemetry as jtelemetry
from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.parallel.mesh import MeshTopology, reset_topology
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.monitor import metrics, telemetry
from deepspeed_tpu_torch.monitor.monitor import MonitorMaster
from deepspeed_tpu_torch.runtime import config
from deepspeed_tpu_torch.utils.memory import HBM_KEYS, device_memory_stats, see_memory_usage
from tests.unit.fault_injection_serving import FakeClock

SIDES = {"jax": (jtelemetry, jconfig), "port": (telemetry, config)}
REQUIRED_FIELDS = ("loss", "grad_norm", "lr", "step_time_ms", "samples_per_sec",
                   "tokens_per_sec", "flops_per_step", "tflops_per_sec", "mfu", "hbm")
VOCAB, SEQ = 96, 32
KW = dict(num_blocks=64, block_size=8, max_blocks_per_seq=8, token_budget=32,
          max_seqs_per_step=8)
_rng = np.random.default_rng(0)
PROMPTS = [_rng.integers(1, 128, int(n)).tolist() for n in _rng.integers(4, 16, 6)]

_CACHE = {}


def _read(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _collector(ns, tmp_path, **cfg_kw):
    tel_mod, cfg_mod = ns
    cfg_kw.setdefault("jsonl_path", str(tmp_path / "telemetry.jsonl"))
    return tel_mod.TelemetryCollector(cfg_mod.TelemetryConfig(**cfg_kw), batch_size=4)


def _stamp_free(record):
    return {k: v for k, v in record.items() if k != "timestamp"}


# ------------------------------------------------------------------- units
def _records(ns, tmp_path):
    tel = _collector(ns, tmp_path, peak_flops_per_chip=1e12, jsonl_flush_every=2)
    tel.n_chips = 2
    tel.set_flops_per_step(4e9)
    out = [tel.record_train_step(step=3, samples=12, loss=1.5, grad_norm=0.25, lr=1e-3,
                                 step_time_s=0.5, tokens=4096),
           tel.record_train_step(step=4, samples=16, loss=1.0, step_time_s=0.25),
           tel.record_gauges({"queue_depth": 3.0, "none": None}, step=2,
                             prefix="Inference/Scheduler", timestamp=12.5),
           tel.record_resilience("serving_shed", step=5, uid=3, code="queue_full"),
           tel.record_trace({"uid": 7, "status": "ok", "spans": []})]
    tel.close()
    stream = [_stamp_free(r) for r in _read(tmp_path / "telemetry.jsonl")]
    return ([_stamp_free(r) for r in out], out[2]["timestamp"], stream, tel.records_written,
            tel.last_gauges, tel.resilience_counts, tel.flops_per_step)


def _disabled_and_null_mfu(ns, tmp_path):
    tel_mod, cfg_mod = ns
    off = tel_mod.TelemetryCollector(cfg_mod.TelemetryConfig(), batch_size=4)
    calls = (off.record_train_step(step=1, samples=4, loss=1.0), off.wants_flops(),
             off.record_gauges({"a": 1.0}, step=1), off.record_resilience("x"))
    on = _collector(ns, tmp_path)
    on.set_flops_per_step(1e9)  # the CPU names no peak: mfu stays null
    rec = on.record_train_step(step=1, samples=4, loss=1.0, step_time_s=0.5)
    on.close()
    return calls, rec["mfu"], rec["hbm"], on.peak_flops_per_chip, on.wants_flops()


def _window_transitions(ns, tmp_path):
    tel = _collector(ns, tmp_path, profile_step_start=2, profile_step_stop=4,
                     profile_serve_iteration_start=1, profile_serve_iteration_stop=3,
                     profile_dir=str(tmp_path / "traces"))
    steps = []
    for step in range(6):
        tel.profile_step_boundary(step)
        steps.append(tel.tracing)
    serves = []
    for _ in range(2):  # one serve window per generate()
        tel.serve_profile_begin()
        for it in range(5):
            tel.profile_serve_boundary(it)
            serves.append(tel.tracing)
        tel.serve_profile_end()
        serves.append(tel.tracing)
    resumed = _collector(ns, tmp_path, profile_step_start=10, profile_step_stop=12,
                         profile_dir=str(tmp_path / "traces"))
    late = []
    for step in (11, 12, 13, 50):
        resumed.profile_step_boundary(step)
        late.append(resumed.tracing)
    tel.close()
    resumed.close()
    return steps, serves, late


@pytest.mark.parametrize("case", [_records, _disabled_and_null_mfu, _window_transitions],
                         ids=lambda f: f.__name__[1:])
def test_collector_matches_jax(case, tmp_path, monkeypatch):
    """The same calls into both collectors give the same records, JSONL
    stream, caches and window transitions (the JAX profiler is stubbed;
    the port's runs for real)."""
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    got = {}
    for side in SIDES:
        os.makedirs(tmp_path / side)
        got[side] = case(SIDES[side], tmp_path / side)
    assert got["port"] == got["jax"]


def test_ops_caches_populate_the_registry_like_jax(tmp_path):
    views = {}
    for side, mod in (("jax", jmetrics), ("port", metrics)):
        tel = _collector(SIDES[side], tmp_path / side)
        tel.record_train_step(step=1, samples=4, loss=2.0, step_time_s=0.5)
        tel.record_gauges({"queue_depth": 3.0}, step=2, prefix="Inference/Scheduler")
        tel.record_resilience("save_retry", step=3)
        tel.close()
        reg = mod.MetricsRegistry()
        mod.populate_from_telemetry(reg, tel)
        views[side] = sorted((n, f.kind, sorted(f.samples.items())) for n, f in
                             reg.families.items() if not n.endswith(("_per_sec", "_ms")))
    assert views["port"] == views["jax"]


def test_config_sections_have_the_jax_fields_and_defaults():
    for name in ("TelemetryConfig", "TensorBoardConfig", "WandbConfig", "CSVConfig"):
        ours, theirs = getattr(config, name)(), getattr(jconfig, name)()
        fields = [f for f in type(theirs).__annotations__ if not f.startswith("_")]
        assert fields == list(type(ours).__annotations__), name
        for field in fields:
            assert getattr(ours, field) == getattr(theirs, field), (name, field)
    for cls in (config.TelemetryConfig, jconfig.TelemetryConfig):
        with pytest.raises(ValueError):
            cls(profile_step_start=5, profile_step_stop=5)
        assert cls(jsonl_path="x.jsonl").enabled
    conf = config.load_config({"train_batch_size": 2, "memory_breakdown": True})
    assert conf.telemetry.memory_breakdown and not conf.wall_clock_breakdown
    assert config.UNPORTED_TRAINING_SECTIONS == ()


def test_memory_stats_and_peak_on_the_cpu():
    assert device_memory_stats() == dict.fromkeys(HBM_KEYS)
    snap = see_memory_usage("unit-test", force=True)
    assert set(HBM_KEYS) <= set(snap) and snap["bytes_in_use"] is None
    assert telemetry.detect_peak_flops_per_chip() is None
    assert [p for needle, p in telemetry.PEAK_FLOPS_BY_DEVICE if needle == "h100"] == [989e12]


def test_monitor_master_writes_csv(tmp_path):
    conf = config.load_config({"train_batch_size": 2, "csv_monitor": {
        "enabled": True, "output_path": str(tmp_path), "job_name": "job"}})
    mon = MonitorMaster(conf)
    assert mon.enabled
    mon.write_events([("Train/loss", 1.5, 1), ("Train/loss", 1.25, 2)])
    with open(tmp_path / "job" / "Train_loss.csv") as fh:
        assert fh.read().splitlines() == ["step,Train/loss", "1,1.5", "2,1.25"]
    assert not MonitorMaster(config.load_config({"train_batch_size": 2})).enabled


# ---------------------------------------------------------------- training
@pytest.fixture
def one_device(monkeypatch):
    monkeypatch.setattr(_pallas, "INTERPRET", True)
    topo = MeshTopology.from_axis_dict({"data": 1}, devices=jax.devices()[:1])
    yield topo
    reset_topology()


def _train_models():
    shape = dict(vocab=VOCAB, hidden=64, layers=2, heads=4, kv_heads=2, seq=SEQ)
    jcfg, cfg = jllama.LlamaConfig.tiny(**shape), llama.LlamaConfig.tiny(**shape)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(5))
    return jcfg, jparams, cfg, llama.params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _train_config(tmp_path, **telemetry_kw):
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "bf16": {"enabled": False}, "steps_per_print": 2,
            "optimizer": {"type": "fused_adam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_max_lr": 1e-3,
                                                         "warmup_num_steps": 5}},
            "wall_clock_breakdown": True,
            "telemetry": {"jsonl_path": str(tmp_path / "telemetry.jsonl"), **telemetry_kw}}


def _batch(seed):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (4, SEQ)).astype(np.int32)
    return llama.causal_lm_batch(ids)


def expected_train_flops(cfg, micro, gas, seq):
    """The products of one train step counted from the shapes, on the CPU,
    where the default attention is the plain dense one (differentiated by
    autograd).  Per micro-batch and layer: each weight product forward,
    twice in the backward (grads of input and weight); the attention's 2
    products forward and 4 backward.  The remat recompute adds, under
    ``nothing_saveable``, every weight product but the last one (``w_down``:
    the recompute stops at the last activation the backward saves) and the
    attention's 2; under ``dots_with_no_batch_dims_saveable`` (the default)
    the weight products are kept and only the attention's 2 (batched, so
    not kept) run again.  The lm_head runs forward and twice backward; the
    embedding is a gather."""
    D, F, L, V = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size
    H, KV = cfg.num_heads, cfg.num_kv_heads
    Dh = D // H
    tokens = micro * seq
    layer = 2 * tokens * (D * H * Dh + 2 * D * KV * Dh + H * Dh * D + 3 * D * F)
    w_down = 2 * tokens * F * D
    attention = 2 * micro * H * seq * seq * Dh
    head = 2 * tokens * D * V
    per_layer = 3 * layer + 6 * attention
    if cfg.remat and cfg.remat_policy in (None, "nothing_saveable"):
        per_layer += layer - w_down + 2 * attention
    elif cfg.remat and cfg.remat_policy == "dots_with_no_batch_dims_saveable":
        per_layer += 2 * attention
    return gas * (L * per_layer + 3 * head)


def test_train_records_match_jax_engine(tmp_path, one_device):
    """The port's and the JAX engine's train_step records: the same keys, and
    loss, grad_norm and lr within rtol 1e-4; flops_per_step counted once;
    hbm null-safe on the CPU."""
    jcfg, jparams, cfg, params = _train_models()
    records = {}
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        conf = _train_config(tmp_path / side, peak_flops_per_chip=1e12)
        if side == "jax":
            engine, *_ = deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg),
                                                  model_parameters=jparams, config=conf,
                                                  topology=one_device)
        else:
            engine, *_ = deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg),
                                                        model_parameters=params, config=conf,
                                                        device="cpu")
        for step in range(3):
            engine.train_batch(_batch(30 + step))
        engine.telemetry.close()
        records[side] = [r for r in _read(tmp_path / side / "telemetry.jsonl")
                         if r["kind"] == "train_step"]
    port, jx = records["port"], records["jax"]
    assert len(port) == len(jx) == 3
    for p, j in zip(port, jx):
        assert set(p) == set(j)
        for key in REQUIRED_FIELDS:
            assert key in p, key
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(p[key], j[key], rtol=1e-4, err_msg=key)
        assert (p["step"], p["samples"]) == (j["step"], j["samples"])
        assert p["hbm"] == j["hbm"] == dict.fromkeys(HBM_KEYS)
        assert p["mfu"] > 0 and p["tokens_per_sec"] == pytest.approx(
            p["samples_per_sec"] * SEQ)
    assert port[0]["flops_per_step"] == expected_train_flops(cfg, 2, 2, SEQ)


def test_flop_count_without_remat_and_once_per_run(tmp_path):
    """Without remat the recompute's products leave the count; the count is
    taken on the first step only."""
    _, _, cfg, params = _train_models()
    cfg = dataclasses.replace(cfg, remat=False)
    engine, *_ = deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg),
                                                model_parameters=params,
                                                config=_train_config(tmp_path), device="cpu")
    engine.train_batch(_batch(1))
    assert not engine.telemetry.wants_flops()
    flops = engine.telemetry.flops_per_step
    assert flops == expected_train_flops(cfg, 2, 2, SEQ)
    assert flops < expected_train_flops(dataclasses.replace(cfg, remat=True), 2, 2, SEQ)
    engine.train_batch(_batch(2))
    assert engine.telemetry.flops_per_step == flops
    engine.telemetry.close()


def test_profile_step_window_writes_a_trace(tmp_path):
    """profile_step_start 1, stop 2: one Chrome trace in profile_dir, with the
    train_step#1 range; the ops endpoint counts the steps."""
    _, _, cfg, params = _train_models()
    tracedir = tmp_path / "traces"
    conf = _train_config(tmp_path, profile_step_start=1, profile_step_stop=2,
                         profile_dir=str(tracedir))
    conf["ops_server"] = {"enabled": True, "refresh_interval_s": 0.0}
    engine, *_ = deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg),
                                                model_parameters=params, config=conf,
                                                device="cpu")
    try:
        for step in range(3):
            engine.train_batch(_batch(step))
        engine.telemetry.close()
        [path] = engine.telemetry.traces_written
        assert os.path.dirname(path) == str(tracedir)
        with open(path) as fh:
            names = {e.get("name") for e in json.load(fh)["traceEvents"]}
        assert "train_step#1" in names and "train_step#0" not in names
        from deepspeed_tpu_torch.monitor.exposition import parse_exposition
        from deepspeed_tpu_torch.monitor.ops_server import scrape
        fams = parse_exposition(scrape(engine.ops.url("/metrics")))
        assert fams["dstpu_train_steps_total"]["samples"][0][2] == 3
        assert "dstpu_train_mfu" not in fams  # no peak on the CPU: mfu null
        health = json.loads(scrape(engine.ops.url("/healthz")))
        assert health["global_steps"] == 3 and health["loss"] is not None
    finally:
        engine.close_ops()


def test_telemetry_smoke_lane(tmp_path):
    """run_tests.py's telemetry_smoke on the port: a 3-step CPU train loop
    of a small MLP with wall_clock_breakdown and telemetry writes 3
    train_step records with the required fields and a trace file."""
    rng = np.random.default_rng(0)
    hidden = 16

    def loss_fn(params, batch, _rng):
        h = torch.relu(batch["x"] @ params["w0"])
        return torch.mean((h @ params["w1"] - batch["y"]) ** 2)

    params = {k: rng.standard_normal((hidden, hidden)).astype("float32") * 0.1
              for k in ("w0", "w1")}
    jsonl = tmp_path / "telemetry.jsonl"
    engine, *_ = deepspeed_tpu_torch.initialize(
        loss_fn=loss_fn, model_parameters=params, device="cpu", config={
            "train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": False},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
            "wall_clock_breakdown": True,
            "telemetry": {"jsonl_path": str(jsonl), "profile_step_start": 1,
                          "profile_step_stop": 2, "profile_dir": str(tmp_path / "traces"),
                          "peak_flops_per_chip": 1e12}})
    for _ in range(3):
        engine.train_batch({k: rng.standard_normal((2, hidden)).astype("float32")
                            for k in ("x", "y")})
    engine.telemetry.close()
    steps = [r for r in _read(jsonl) if r["kind"] == "train_step"]
    assert len(steps) == 3
    for r in steps:
        assert not [k for k in REQUIRED_FIELDS if k not in r]
        assert np.isfinite(r["loss"]) and r["step_time_ms"] > 0 and r["mfu"] > 0
        # no sequence dim: one token per sample
        assert r["tokens_per_sec"] == pytest.approx(r["samples_per_sec"])
    # two products of 2 x 16 x 16 forward, four backward (x's grad is not asked)
    assert steps[0]["flops_per_step"] == 2 * 2 * hidden * hidden * (2 + 3)
    assert os.listdir(tmp_path / "traces")


# ----------------------------------------------------------------- serving
def _serve_params():
    if "serve" not in _CACHE:
        shape = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, seq=256)
        jcfg, cfg = jllama.LlamaConfig.tiny(**shape), llama.LlamaConfig.tiny(**shape)
        jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
        _CACHE["serve"] = (jcfg, jparams, cfg, llama.params_from_jax(
            cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    return _CACHE["serve"]


def _serve_engine(side, config, collector, clock=None):
    jcfg, jparams, cfg, params = _serve_params()
    if side == "jax":
        eng = JaxEngine(jllama, jcfg, jparams, config=dict(config), clock=clock,
                        telemetry=collector, **KW)
        eng._fwd_cache = _CACHE.setdefault("programs", {})
        return eng
    return InferenceEngineV2(llama, cfg, params, config=dict(config), clock=clock,
                             device="cpu", telemetry=collector, **KW)


def test_gauge_timestamps_and_trace_records_match_jax(tmp_path):
    """Under a FakeClock the scheduler's and the engine's gauge records carry
    the JAX engine's timestamps and steps exactly (deterministic: the clock's
    last read, never wall time), the resilience record of the shed matches,
    and with trace_jsonl on one kind: trace record lands per request."""
    config = {"dtype": "float32", "serving_tracing": {"enabled": True}}
    views = {}
    for side in ("jax", "port"):
        tel = SIDES[side][0].TelemetryCollector(
            SIDES[side][1].TelemetryConfig(jsonl_path=str(tmp_path / f"{side}.jsonl")))
        eng = _serve_engine(side, config, tel, FakeClock(start=1000.0, tick=0.25))
        results = eng.generate(PROMPTS + [list(range(1, 100))], max_new_tokens=8, strict=False)
        tel.close()
        recs = _read(tmp_path / f"{side}.jsonl")
        gauges = [(r["prefix"], r["step"], r["timestamp"]) for r in recs if r["kind"] == "gauges"]
        traces = [(r["uid"], r["status"], [s["name"] for s in r["spans"]])
                  for r in recs if r["kind"] == "trace"]
        shed = [_stamp_free(r) for r in recs if r["kind"] == "resilience"]
        views[side] = (gauges, traces, shed, [r.status for r in results])
    assert views["port"] == views["jax"]
    gauges, traces, shed, statuses = views["port"]
    assert {p for p, _, _ in gauges} == {"Inference/Scheduler", "Inference/Serving"}
    assert all(1000.0 <= t < 2000.0 for _, _, t in gauges)
    assert sorted(u for u, _, _ in traces) == list(range(len(PROMPTS) + 1))
    assert shed[0]["event"] == "serving_shed" and statuses[-1] == "shed"


def test_serve_window_writes_a_trace_with_the_phases(tmp_path):
    """profile_serve_iteration_start 1, stop 3: one Chrome trace a
    generate(), with the serve phases' ranges; tokens and ServeCounters
    equal an engine without a collector."""
    tel = telemetry.TelemetryCollector(config.TelemetryConfig(
        jsonl_path=str(tmp_path / "t.jsonl"), profile_serve_iteration_start=1,
        profile_serve_iteration_stop=3, profile_dir=str(tmp_path / "traces")))
    eng = _serve_engine("port", {"dtype": "float32"}, tel)
    plain = _serve_engine("port", {"dtype": "float32"}, None)
    for _ in range(2):
        assert eng.generate(PROMPTS, max_new_tokens=8) == plain.generate(PROMPTS,
                                                                         max_new_tokens=8)
    assert eng.counters.snapshot() == plain.counters.snapshot()
    tel.close()
    assert len(tel.traces_written) == 2 and not tel.tracing
    with open(tel.traces_written[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"admission_pump", "dispatch"} <= names
    prefixes = {r.get("prefix") for r in _read(tmp_path / "t.jsonl")}
    assert {"Inference/Scheduler", "Inference/Serving"} <= prefixes
