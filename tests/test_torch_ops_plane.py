"""The port's ops plane on the CPU against the JAX package's.

``deepspeed_tpu_torch/monitor/{metrics,exposition,ops_server}.py`` and their
wiring through the v2 engine, the serving supervisor and the training
engine, held to their ``deepspeed_tpu`` counterparts:

- units (the cases of the JAX package's ``tests/unit/test_metrics_ops.py``):
  the same registry calls render byte-identical Prometheus text in both
  packages and round-trip through ``parse_exposition`` with identical
  quantiles; ``FleetAggregator`` merges agree, counters stay monotone across
  a generation bump, and the per-rank files one package writes the other
  reads;
- engines: after the same serve under a ``FakeClock`` with the same weights,
  the port engine's registry renders the JAX engine's text except the
  compile, recompile, phase and roofline families (:data:`ENGINE_ONLY`:
  the frameworks build programs differently and the port's roofline cost is
  analytic);
- the ``ops_smoke`` lane (``run_tests.py``): the HTTP server on 127.0.0.1
  answers mid-serve scrapes that strict-parse, ``/healthz`` mirrors
  ``health()``, ``/statez`` carries the flight recorder, and tokens and
  ``ServeCounters`` are identical with the server on and off;
- the supervisor's fleet endpoint stays monotone across an in-process
  restart; the engine publishes rank files under a supervisor's
  ``DSTPU_OPS_DIR`` and ignores it outside one;
- ``health()``, ``state_snapshot()`` and the registry hold no
  ``torch.Tensor`` (nor numpy value), and ``monitor/{perf,metrics,
  exposition,ops_server}.py`` import neither torch nor numpy (AST)."""

import ast
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.monitor import exposition as jexpo
from deepspeed_tpu.monitor import metrics as jmetrics
from deepspeed_tpu.monitor import ops_server as jops
from deepspeed_tpu.monitor import tracing as jtracing
from deepspeed_tpu.runtime.config import OpsServerConfig as JaxOpsConfig
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RequestJournal, ServingSupervisor
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.monitor import exposition, metrics, ops_server, tracing
from deepspeed_tpu_torch.runtime.config import OpsServerConfig
from deepspeed_tpu_torch.runtime.heartbeat import (OPS_DIR_ENV, SERVING_GENERATION_ENV,
                                                   SERVING_JOURNAL_ENV)
from tests.unit.fault_injection_serving import FakeClock

SIDES = {"jax": (jmetrics, jexpo, jops, jtracing), "port": (metrics, exposition, ops_server,
                                                            tracing)}
# the ops_smoke lane's pool and scheduler
KW = dict(num_blocks=64, block_size=8, max_blocks_per_seq=8, token_budget=32,
          max_seqs_per_step=8)
_rng = np.random.default_rng(0)
PROMPTS = [_rng.integers(1, 128, int(n)).tolist() for n in _rng.integers(4, 16, 6)]
TRACED = {"dtype": "float32", "serving_tracing": {"enabled": True}}
# families the two engines fill differently by design: program builds
# (XLA compiles of jit sites vs the port's bucket programs), the phase
# profiler's (its spans cover different host work) and the roofline (XLA's
# cost analysis vs the port's analytic least cost)
ENGINE_ONLY = ("dstpu_fastpath_compiles_total", "dstpu_serving_compiles_total",
               "dstpu_serving_recompiles_total", "dstpu_serving_phase_seconds",
               "dstpu_serving_phase_iterations_total", "dstpu_serving_hbm_bytes_per_token",
               "dstpu_serving_roofline_fraction", "dstpu_serving_model_flops_utilization",
               "dstpu_serving_uncosted_dispatches_total")
HOST_ONLY_MODULES = ("perf", "metrics", "exposition", "ops_server")

_CACHE = {}


# ------------------------------------------------------------------- units
def _registry(ns):
    m, _, _, tr = ns
    reg = m.MetricsRegistry()
    reg.set_counter("dstpu_a_total", 3, help_text="a counter")
    reg.set_counter("dstpu_shed_total", 2, labels={"code": "queue_full"},
                    help_text='sheds "by" code\nsecond line')
    reg.set_gauge("dstpu_b", -1.5, labels={"rank": "0", "path": 'a\\b"c'})
    reg.set_gauge("dstpu_nan", float("nan"))
    reg.set_gauge("dstpu_inf", float("inf"))
    h = tr.StreamingHistogram(6, 1e-5)
    for v in (1e-6, 3e-4, 2e-3, 2e-3, 0.5, 40.0):
        h.add(v)
    reg.set_histogram("dstpu_latency_seconds", h, labels={"phase": "ttft"}, help_text="lat")
    return reg


def _render_and_roundtrip(ns):
    m, expo, _, _ = ns
    reg = _registry(ns)
    text = expo.render(reg)
    fams = expo.parse_exposition(text)
    back = expo.parsed_histogram(fams, "dstpu_latency_seconds", buckets_per_decade=6,
                                 min_value=1e-5, labels={"phase": "ttft"})
    quantiles = [back.quantile(q) for q in (0.5, 0.9, 0.99)]
    with pytest.raises(ValueError):
        reg.set_counter("dstpu_a_total", 1)  # a counter never goes backwards
    return text, quantiles, back.count, back.total, reg.snapshot()


def _fleet_merge(ns):
    m, expo, _, tr = ns
    agg = m.FleetAggregator()
    texts, totals = [], []
    for rank, gen, steps, lat in ((0, 0, 5, 0.01), (1, 0, 7, 0.02), (0, 0, 9, 0.03),
                                  (0, 1, 2, 0.04), (1, 0, 8, 0.05), (0, 0, 100, 0.5)):
        reg = m.MetricsRegistry(generation=gen)
        reg.set_counter("dstpu_steps_total", steps)
        reg.set_gauge("dstpu_live", steps / 2)
        h = tr.StreamingHistogram()
        h.add(lat)
        reg.set_histogram("dstpu_ttft_seconds", h)
        agg.absorb(rank, reg.snapshot())
        merged = agg.registry()
        texts.append(expo.render(merged))
        totals.append(sum(merged.families["dstpu_steps_total"].samples.values()))
    assert totals == sorted(totals), totals  # monotone across rank 0's restart
    return texts, totals, agg.ranks(), agg.absorbed_total


@pytest.mark.parametrize("case", [_render_and_roundtrip, _fleet_merge],
                         ids=lambda f: f.__name__[1:])
def test_registry_units_match_jax(case):
    """The same calls render byte-identical text, parse back to identical
    quantiles and merge to the same fleet view in both packages."""
    got = {side: case(SIDES[side]) for side in SIDES}
    assert repr(got["port"]) == repr(got["jax"])  # repr: nan == nan


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_rank_files_are_interchangeable(writer, reader, tmp_path):
    """A rank file one package writes, the other reads back to the same
    registry; torn and foreign files read as absent in both."""
    w, r = SIDES[writer], SIDES[reader]
    reg = _registry(w)
    assert w[2].write_rank_files(str(tmp_path), 3, reg)
    (tmp_path / "ops.rank4.json").write_text('{"torn": ')
    (tmp_path / "ops.rank5.json").write_text('{"families": 7}')
    snaps = r[2].read_rank_snapshots(str(tmp_path))
    assert list(snaps) == [3]
    back = r[0].MetricsRegistry.from_snapshot(snaps[3])
    assert r[1].render(back) == w[1].render(reg)
    with open(w[2].textfile_path(str(tmp_path), 3)) as fh:
        r[1].parse_exposition(fh.read())


def test_config_section_has_the_jax_fields_and_defaults():
    ours, theirs = OpsServerConfig(), JaxOpsConfig()
    for field in ("enabled", "host", "port", "refresh_interval_s", "textfile_dir", "namespace"):
        assert getattr(ours, field) == getattr(theirs, field), field
    with pytest.raises(ValueError):
        OpsServerConfig(port=70000)


# ----------------------------------------------------------------- engines
def _params():
    if "params" not in _CACHE:
        shape = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, seq=256)
        jcfg, cfg = jllama.LlamaConfig.tiny(**shape), llama.LlamaConfig.tiny(**shape)
        jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
        params = llama.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        _CACHE["params"] = (jcfg, jparams, cfg, params)
    return _CACHE["params"]


def _engine(side, config, clock=None, **kw):
    jcfg, jparams, cfg, params = _params()
    if side == "jax":
        eng = JaxEngine(jllama, jcfg, jparams, config=dict(config), clock=clock, **KW, **kw)
        eng._fwd_cache = _CACHE.setdefault("programs", {})
        return eng
    return InferenceEngineV2(llama, cfg, params, config=dict(config), clock=clock,
                             device="cpu", **KW, **kw)


def test_engine_exposition_matches_jax():
    """The same serve (tracing and the observatory on, a shed request) under
    a FakeClock: the port engine's registry renders the JAX engine's text
    but the families of :data:`ENGINE_ONLY`, each of which both render."""
    texts = {}
    config = {**TRACED, "serving_perf": {"enabled": True}}
    for side in ("jax", "port"):
        eng = _engine(side, config, FakeClock(tick=0.01))
        eng.generate(PROMPTS + [list(range(1, 100))], max_new_tokens=8, strict=False)
        reg = SIDES[side][0].MetricsRegistry()
        SIDES[side][0].populate_from_engine(reg, eng)
        texts[side] = SIDES[side][1].render(reg)
    fams = {side: exposition.parse_exposition(t) for side, t in texts.items()}
    assert set(fams["port"]) == set(fams["jax"])
    for name in ENGINE_ONLY:
        assert name in fams["port"], name
    same = [n for n in fams["port"] if n not in ENGINE_ONLY]
    assert {n: fams["port"][n] for n in same} == {n: fams["jax"][n] for n in same}
    drop = lambda t: "\n".join(line for line in t.splitlines()
                               if not any(name in line for name in ENGINE_ONLY))
    assert drop(texts["port"]) == drop(texts["jax"])
    assert fams["port"]["dstpu_serving_shed_reason_total"]["samples"][0][1] == {
        "code": "prompt_over_cap"}


def _tensors_in(tree, path="$"):
    """Paths of torch tensors and numpy values anywhere in ``tree``."""
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic)):
        return [f"{path}: {type(tree).__name__}"]
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _tensors_in(v, f"{path}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _tensors_in(v, f"{path}[{i}]")]
    return []


def test_snapshots_and_registry_hold_no_tensor(tmp_path):
    """health(), state_snapshot() and the populated registry are host values
    only, through every state-producing path (tracing, the observatory,
    journaling, a shed, a live put() sequence with a deadline)."""
    eng = _engine("port", {**TRACED, "serving_perf": {"enabled": True},
                           "serving_resilience": {"max_queue_depth": 3},
                           "serving_fault_tolerance": {"enabled": True,
                                                       "journal_path": str(tmp_path / "j.wal")}})
    eng.generate(PROMPTS + [list(range(1, 100))], max_new_tokens=8, strict=False)
    eng.put([900], [[1, 2, 3]], ttl_s=60.0)
    eng.step()
    reg = metrics.MetricsRegistry()
    metrics.populate_from_engine(reg, eng)
    for payload in (eng.health(), eng.state_snapshot(), reg.snapshot()):
        assert _tensors_in(payload) == []
        json.dumps(payload)
    for fam in reg.families.values():
        for value in fam.samples.values():
            assert not isinstance(value, (torch.Tensor, np.ndarray, np.generic)), fam.name
    eng.flush(900)


@pytest.mark.parametrize("module", HOST_ONLY_MODULES)
def test_host_only_modules_import_neither_torch_nor_numpy(module):
    """The zero-sync contract as an import rule: a module that cannot import
    torch or numpy cannot read a device value."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "deepspeed_tpu_torch", "monitor", f"{module}.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.add(node.module.split(".")[0])
    assert not imported & {"torch", "numpy", "jax"}, imported


def test_ops_smoke_lane():
    """run_tests.py's ops_smoke on the port: mid-serve scrapes from another
    thread strict-parse, the post-serve families carry the engine's counts,
    /healthz mirrors health(), /statez has the flight recorder, and tokens
    and ServeCounters equal an engine without the server."""
    on = _engine("port", {**TRACED, "ops_server": {"enabled": True, "refresh_interval_s": 0.0}})
    off = _engine("port", TRACED)
    url = on.ops.url
    seen = {"metrics": 0, "errors": []}
    stop = threading.Event()

    def scraper():
        while not stop.is_set():
            try:
                exposition.parse_exposition(ops_server.scrape(url("/metrics")))
                json.loads(ops_server.scrape(url("/healthz")))
                seen["metrics"] += 1
            except Exception as exc:
                seen["errors"].append(repr(exc))
                return

    thread = threading.Thread(target=scraper, daemon=True)
    thread.start()
    try:
        out_on = on.generate(PROMPTS, max_new_tokens=8)
    finally:
        stop.set()
        thread.join(timeout=10.0)
    try:
        assert not seen["errors"] and seen["metrics"] > 0, seen
        fams = exposition.parse_exposition(ops_server.scrape(url("/metrics")))
        counter = lambda name: fams[name]["samples"][0][2]
        assert counter("dstpu_serving_shed_total") == on.admission.shed_total
        assert counter("dstpu_serving_completed_total") == len(PROMPTS)
        assert counter("dstpu_fastpath_host_syncs_total") == on.counters.host_syncs
        for name in ("dstpu_request_ttft_seconds", "dstpu_request_tbt_seconds",
                     "dstpu_request_e2e_seconds"):
            inf = [v for n, lab, v in fams[name]["samples"]
                   if n.endswith("_bucket") and lab.get("le") == "+Inf"]
            assert inf and inf[0] > 0, name
        assert json.loads(ops_server.scrape(url("/healthz"))) == json.loads(
            json.dumps(on.health()))
        assert json.loads(ops_server.scrape(url("/statez")))["flight_recorder"]
        assert out_on == off.generate(PROMPTS, max_new_tokens=8)
        assert on.counters.snapshot() == off.counters.snapshot()
    finally:
        on.close_ops()


def test_ops_server_leaves_tokens_counters_and_clock_reads():
    """With the ops plane on, refreshes are throttled on the engine clock's
    last read: tokens, ServeCounters and the clock reads are those of the
    plane off."""
    runs = {}
    for label, extra in (("on", {"ops_server": {"enabled": True}}), ("off", {})):
        clock = FakeClock(tick=0.01)
        eng = _engine("port", {**TRACED, **extra}, clock)
        runs[label] = (eng.generate(PROMPTS, max_new_tokens=8), eng.counters.snapshot(),
                       clock.calls)
        eng.close_ops()
    assert runs["on"] == runs["off"]


def test_engine_publishes_rank_files_under_supervision(tmp_path, monkeypatch):
    """Under a serving supervisor's env the engine publishes its rank files
    (generation-stamped) without starting a server; without the journal env
    (a serving engine in a training worker) it leaves the ops dir alone."""
    ops_dir = str(tmp_path / "ops")
    monkeypatch.setenv(OPS_DIR_ENV, ops_dir)
    eng = _engine("port", {"dtype": "float32"})
    eng.generate(PROMPTS[:2], max_new_tokens=4)
    assert eng._ops is None and ops_server.read_rank_snapshots(ops_dir) == {}
    monkeypatch.setenv(SERVING_JOURNAL_ENV, str(tmp_path / "j.wal"))
    monkeypatch.setenv(SERVING_GENERATION_ENV, "2")
    eng = _engine("port", {"dtype": "float32"})
    eng.generate(PROMPTS, max_new_tokens=8)
    snaps = jops.read_rank_snapshots(ops_dir)  # the JAX reader, too
    assert snaps[0]["generation"] == 2 and eng.ops is None
    assert snaps[0]["families"]["dstpu_serving_completed_total"]["samples"][0]["value"] == \
        len(PROMPTS)
    with open(os.path.join(ops_dir, "ops.rank0.prom")) as fh:
        exposition.parse_exposition(fh.read())
    eng.journal.close()


def test_supervisor_fleet_endpoint_monotone_across_restart(tmp_path):
    """The supervisor's endpoint merges each generation's final engine
    state: a crash restarts the engine's counters at zero, the fleet
    counters carry generation 0's and never go backwards."""
    path = str(tmp_path / "j.wal")
    builds = []

    class CrashyJournal(RequestJournal):
        writes = 0

        def flush(self):
            wrote = super().flush()
            if wrote:
                type(self).writes += 1
                if type(self).writes >= 2:
                    raise RuntimeError("injected crash at wave 2")
            return wrote

    def factory():
        eng = _engine("port", {"dtype": "float32"})
        if not builds:
            eng.journal = CrashyJournal(path, fsync_every=1)
            eng.journal.open_generation(0)
        builds.append(eng)
        return eng

    sup = ServingSupervisor(factory, journal_path=path, config={"max_restarts": 2},
                            ops_server={"enabled": True})
    totals = []
    refresh = sup._refresh_ops

    def spying_refresh(force=False):
        refresh(force=True)
        fams = exposition.parse_exposition(ops_server.scrape(sup.ops.url("/metrics")))
        fam = fams.get("dstpu_scheduler_steps_total")
        if fam:
            totals.append(sum(v for _, _, v in fam["samples"]))

    sup._refresh_ops = spying_refresh
    try:
        results = sup.serve(PROMPTS, max_new_tokens=8)
        assert sup.restarts_total == 1 and all(r.ok for r in results)
        assert len(totals) >= 2 and totals == sorted(totals), totals
        assert totals[-1] > builds[-1].scheduler.steps  # the carry engaged
        fams = exposition.parse_exposition(ops_server.scrape(sup.ops.url("/metrics")))
        assert fams["dstpu_supervisor_restarts_total"]["samples"][0][2] == 1
        assert fams["dstpu_serving_completed_total"]["samples"][0][1] == {"rank": "0"}
        health = json.loads(ops_server.scrape(sup.ops.url("/healthz")))
        assert health["restarts_total"] == 1 and health["ranks"] == [0]
        events = json.loads(ops_server.scrape(sup.ops.url("/statez")))["events"]
        assert any(e["event"] == "worker_failed" for e in events)
    finally:
        sup.close_ops()
    dark = ServingSupervisor(lambda: _engine("port", {"dtype": "float32"}),
                             journal_path=str(tmp_path / "k.wal"))
    assert dark.ops is None and dark._ops_agg is None
