"""The port's serving perf observatory on the CPU against the JAX package's.

``deepspeed_tpu_torch/monitor/perf.py`` and its wiring through the v2
engine (``serving_perf``), held to ``deepspeed_tpu/monitor/perf.py`` and the
JAX engine:

- units: ``StepPhaseProfiler``, ``CompileLedger`` and ``RooflineModel``
  driven by the same call sequence under a ``FakeClock`` in both packages
  end in equal ``snapshot()`` dicts (the cases of the JAX package's
  ``tests/unit/inference/test_serving_perf.py``);
- the engines, observatory on, serving the ``perf_smoke`` lane's 3 waves
  (``run_tests.py``) under a ``FakeClock`` with the same weights: the
  per-phase sample counts and span totals equal the JAX engine's;
- port-only: tokens and ``ServeCounters`` identical with the observatory on
  and off (fast path and reference loop), spans summing exactly to the
  wall, no warm recompile, no uncosted dispatch, finite roofline gauges,
  the observatory's families strict-parsing off a live ``/metrics``, and
  ``paged_bucket_cost`` equal to ``FlopCounterMode``'s count of the plain
  ``forward_paged``.

The JAX engines share one program cache, so their bucket programs are
compiled once for the module."""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.monitor import perf as jperf
from deepspeed_tpu.runtime.config import ServingPerfConfig as JaxPerfConfig
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.monitor import perf
from deepspeed_tpu_torch.monitor.exposition import parse_exposition
from deepspeed_tpu_torch.monitor.ops_server import scrape
from deepspeed_tpu_torch.runtime.config import ServingPerfConfig
from tests.unit.fault_injection_serving import FakeClock

SIDES = {"jax": (jperf, JaxPerfConfig), "port": (perf, ServingPerfConfig)}
# the perf_smoke lane's pool and scheduler
KW = dict(num_blocks=64, block_size=8, max_blocks_per_seq=8, token_budget=32,
          max_seqs_per_step=8)
_rng = np.random.default_rng(0)
WAVES = [[_rng.integers(1, 128, int(n)).tolist() for n in _rng.integers(4, 16, 5)]
         for _ in range(3)]
PERF = {"dtype": "float32", "serving_perf": {"enabled": True}}
PLAIN = {"dtype": "float32"}

_CACHE = {}


class TracerStub:
    """Records phase_span/event calls; stands in for RequestTracer."""

    def __init__(self):
        self.spans = []
        self.events = []

    def phase_span(self, name, start_s, dur_s, track=0):
        self.spans.append((name, start_s, dur_s, track))

    def event(self, name, **fields):
        self.events.append((name, fields))


# ------------------------------------------------------------------- units
def _profiler_attribution(mod, cfg):
    clock = FakeClock(tick=0.01)
    prof = mod.StepPhaseProfiler(cfg(enabled=True), clock=clock)
    prof.begin_iteration()
    prof.mark("admission_pump")
    prof.mark("dispatch")
    prof.mark("dispatch")
    prof.end_iteration()
    assert sum(prof.totals.values()) == prof.wall_s  # exactly
    return prof.snapshot(), clock.calls


def _profiler_iterations(mod, cfg):
    clock = FakeClock(tick=0.003)
    tracer = TracerStub()
    prof = mod.StepPhaseProfiler(cfg(enabled=True, phase_budget_every=3), clock=clock,
                                 tracer=tracer)
    for i in range(7):
        prof.begin_iteration()
        for phase in mod.PHASES[:1 + (i % 4)]:
            prof.mark(phase)
        prof.end_iteration()
    prof.mark("dispatch")  # outside an iteration: ignored, no clock read
    return prof.snapshot(), tracer.spans, tracer.events, clock.calls


def _profiler_disabled_and_zero_tick(mod, cfg):
    clock = FakeClock(tick=0.01)
    off = mod.StepPhaseProfiler(cfg(enabled=False), clock=clock)
    off.begin_iteration()
    off.mark("dispatch")
    off.end_iteration()
    zero = mod.StepPhaseProfiler(cfg(enabled=True), clock=FakeClock(tick=0.0))
    zero.begin_iteration()
    zero.mark("burst")
    zero.end_iteration()
    return clock.calls, off.snapshot(), zero.snapshot(), sorted(zero.histograms())


def _ledger_classes(mod, cfg):
    class Counters:
        compiles = 0

    counters, tracer = Counters(), TracerStub()
    led = mod.CompileLedger(counters, tracer=tracer)
    classes = [led.record("fwd", (1, 8, 4), prewarmed=True, wall_s=0.25),
               led.record("fwd", (2, 8, 4), wall_s=0.5),
               led.record("burst", (1, 8, 4)),
               led.record("fwd", (1, 8, 4), wall_s=0.125)]
    return classes, led.snapshot(), led.warm_total, counters.compiles, tracer.events


def _roofline(mod, cfg):
    roof = mod.RooflineModel(cfg(hbm_gbps_spec=100.0, peak_flops_per_chip=1e12))
    roof.note_cost((1, 8, 4), flops=2e9, bytes_accessed=1e9)
    roof.note_dispatch((1, 8, 4), tokens=8)
    roof.note_dispatch((9, 9, 9), tokens=2)
    before = roof.snapshot(wall_s=0.5)
    roof.reset()
    roof.note_dispatch((1, 8, 4), tokens=4)
    return before, roof.snapshot(wall_s=2.0), roof.gauges(0.0)


@pytest.mark.parametrize("case", [_profiler_attribution, _profiler_iterations,
                                  _profiler_disabled_and_zero_tick, _ledger_classes, _roofline],
                         ids=lambda f: f.__name__[1:])
def test_instruments_match_jax(case):
    """The same calls into both packages' instruments give equal snapshots."""
    got = {side: case(*SIDES[side]) for side in SIDES}
    assert got["port"] == got["jax"]


def test_config_section_has_the_jax_fields_and_defaults():
    """Same fields and defaults as JAX's but ``hbm_gbps_spec``: the H100
    SXM's 3350 GB/s, not a TPU figure."""
    ours, theirs = ServingPerfConfig(), JaxPerfConfig()
    for field in ("enabled", "phase_budget_every", "histogram_buckets_per_decade",
                  "histogram_min_s", "peak_flops_per_chip", "capture_cost_analysis"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.hbm_gbps_spec == 3350.0 and theirs.hbm_gbps_spec != 3350.0
    assert perf.RooflineModel().hbm_gbps_spec == 3350.0
    with pytest.raises(ValueError):
        ServingPerfConfig(phase_budget_every=0)


# ----------------------------------------------------------------- engines
def _params():
    if "params" not in _CACHE:
        shape = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, seq=256)
        jcfg, cfg = jllama.LlamaConfig.tiny(**shape), llama.LlamaConfig.tiny(**shape)
        jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
        params = llama.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        _CACHE["params"] = (jcfg, jparams, cfg, params)
    return _CACHE["params"]


def _engine(side, config, clock=None):
    jcfg, jparams, cfg, params = _params()
    if side == "jax":
        eng = JaxEngine(jllama, jcfg, jparams, config=dict(config), clock=clock, **KW)
        eng._fwd_cache = _CACHE.setdefault("programs", {})
        return eng
    return InferenceEngineV2(llama, cfg, params, config=dict(config), clock=clock,
                             device="cpu", **KW)


def _three_waves(eng):
    return [eng.generate(w, max_new_tokens=8) for w in WAVES]


def test_phase_sample_counts_and_spans_match_jax_engine():
    """The perf_smoke waves under a FakeClock: the port's loop marks the same
    phases in the same iterations as the JAX engine's, so every phase's
    sample count, and its span total, equals JAX's."""
    runs = {}
    for side in ("jax", "port"):
        eng = _engine(side, PERF, FakeClock(tick=0.001))
        toks = _three_waves(eng)
        prof = eng.phase_profiler
        runs[side] = (toks, eng.counters.loop_iterations, prof.iterations,
                      {p: prof.hists[p].count for p in perf.PHASES},
                      {p: round(prof.totals[p], 9) for p in perf.PHASES})
    assert runs["port"] == runs["jax"]
    assert all(runs["port"][3].values()), runs["port"][3]


@pytest.mark.parametrize("fastpath", [True, False], ids=["fastpath", "reference"])
def test_observatory_leaves_tokens_and_counters(fastpath):
    """Tokens and every ServeCounters field identical with the observatory on
    and off, and with it off no phase is sampled and no clock read added."""
    runs = {}
    for label, config in (("on", PERF), ("off", PLAIN)):
        clock = FakeClock(tick=0.001)
        eng = _engine("port", {**config, "serving_fastpath": {"enabled": fastpath}}, clock)
        runs[label] = (_three_waves(eng), eng.counters.snapshot(), eng)
    assert runs["on"][:2] == runs["off"][:2]
    assert runs["on"][2].phase_profiler.iterations > 0
    assert runs["off"][2].phase_profiler.iterations == 0


def test_perf_smoke_lane():
    """run_tests.py's perf_smoke on the port: every phase family filled, the
    spans summing to the wall, no warm recompile over three waves, full
    roofline cost coverage with finite gauges, and the observatory's
    families strict-parsing off a live /metrics scrape."""
    eng = _engine("port", {**PERF, "serving_tracing": {"enabled": True},
                           "ops_server": {"enabled": True, "refresh_interval_s": 0.0}})
    try:
        _three_waves(eng)
        prof = eng.phase_profiler
        assert not [p for p in perf.PHASES if prof.hists[p].count == 0]
        assert abs(sum(prof.totals.values()) - prof.wall_s) < 1e-6
        led = eng.ledger.snapshot()
        assert led["warm_total"] == 0 and eng.counters.compiles == led["total"]
        roof = eng.health()["perf"]["roofline"]
        assert roof["uncosted_dispatches"] == 0 and roof["costed_buckets"] > 0
        assert roof["hbm_bytes"] > 0 and roof["flops"] > 0
        assert all(np.isfinite(v) for v in roof["gauges"].values())
        fams = parse_exposition(scrape(eng.ops.url("/metrics")))
        phases = {lab.get("phase") for _, lab, _ in fams["dstpu_serving_phase_seconds"]["samples"]}
        assert set(perf.PHASES) <= phases
        assert any(lab.get("site") == "fwd"
                   for _, lab, _ in fams["dstpu_serving_compiles_total"]["samples"])
        assert all(v == 0.0 for _, _, v in fams["dstpu_serving_recompiles_total"]["samples"])
        for name in ("dstpu_serving_roofline_fraction", "dstpu_serving_hbm_bytes_per_token",
                     "dstpu_serving_model_flops_utilization"):
            assert name in fams, name
    finally:
        eng.close_ops()


def test_spans_sum_exactly_and_snapshot_shape():
    """Under a FakeClock the phase spans sum to the wall exactly; health()
    and state_snapshot() carry the JAX engine's ``perf`` shape."""
    eng = _engine("port", PERF, FakeClock(tick=0.001))
    _three_waves(eng)
    prof = eng.phase_profiler
    assert sum(prof.totals.values()) == pytest.approx(prof.wall_s, abs=1e-9)
    snap, jsnap = eng.health()["perf"], _engine("jax", PERF).health()["perf"]
    assert set(snap) == set(jsnap) == {"enabled", "iterations", "wall_s", "phases",
                                       "compile_ledger", "roofline"}
    assert set(snap["roofline"]) == set(jsnap["roofline"])
    assert eng.state_snapshot()["perf"]["compile_ledger"]["warm_total"] == 0


def test_ledger_attributes_prewarm_and_a_forced_rebuild_is_warm():
    """Prewarmed buckets are attributed at intake; a bucket built again after
    it was seen is a warm recompile, lands in the flight recorder and its
    cost is noted again (no uncosted dispatch)."""
    eng = _engine("port", {**PERF, "serving_tracing": {"enabled": True}})
    eng.generate(WAVES[0], max_new_tokens=4)
    led = eng.ledger
    assert led.warm_total == 0 and led.by_site["fwd"].get(perf.CLASS_PREWARMED, 0) > 0
    assert eng.counters.compiles == led.total
    eng.programs._programs.clear()  # forced: every program rebuilds
    eng.generate(WAVES[0], max_new_tokens=4)
    assert led.by_site["fwd"].get(perf.CLASS_WARM, 0) > 0
    assert sum(led.warm_by_site.values()) == led.warm_total
    assert "fwd" in {e["site"] for e in eng.tracer.recorder.tail()
                     if e["event"] == "warm_recompile"}
    assert eng.roofline.uncosted_dispatches == 0


def test_cost_capture_off_leaves_dispatches_uncosted():
    """``capture_cost_analysis: false`` notes no cost: every dispatch is
    counted as a roofline blind spot."""
    eng = _engine("port", {"dtype": "float32",
                           "serving_perf": {"enabled": True, "capture_cost_analysis": False}})
    eng.generate(WAVES[0], max_new_tokens=4)
    roof = eng.roofline
    assert roof.dispatches > 0 and roof.uncosted_dispatches == roof.dispatches
    assert not roof.snapshot()["costed_buckets"]


def _family(name):
    """(module, tiny config, params) of a served family, seeded torch weights."""
    from deepspeed_tpu_torch.models import gptj, mixtral, opt, qwen
    if name == "llama":
        return (llama, *_params()[2:])
    mod, cfg = {"qwen2": (qwen, qwen.QwenConfig.tiny(vocab=128, heads=4, kv_heads=1)),
                "mixtral": (mixtral, mixtral.MixtralConfig.tiny(vocab=128)),
                "opt": (opt, opt.OPTConfig.tiny(vocab=128)),
                "gptj": (gptj, gptj.GPTJConfig.tiny(vocab=128))}[name]
    return mod, cfg, mod.init_params(cfg, torch.Generator().manual_seed(0))


# Llama's cases keep their ids; each other family adds one bucket
@pytest.mark.parametrize("family,n,t,b", [
    pytest.param("llama", 1, 1, 2, id="1-1-2"), pytest.param("llama", 2, 4, 3, id="2-4-3"),
    pytest.param("llama", 4, 16, 8, id="4-16-8"), pytest.param("qwen2", 2, 4, 3, id="qwen2-2-4-3"),
    pytest.param("mixtral", 2, 4, 3, id="mixtral-2-4-3"),
    pytest.param("opt", 4, 16, 8, id="opt-4-16-8"), pytest.param("gptj", 1, 1, 2, id="gptj-1-1-2")])
def test_paged_bucket_cost_flops_equal_the_counted_forward(family, n, t, b):
    """paged_bucket_cost's FLOPs equal FlopCounterMode's count of the plain
    forward_paged over the same bucket (weights, attention over every table
    position, the head over every row; Mixtral's router, all its experts on
    every row and their combine); its bytes count every parameter once, the
    KV read and write, and the token and logit rows."""
    from torch.utils.flop_counter import FlopCounterMode
    mod, cfg, params = _family(family)
    bs = 8
    kv = mod.init_paged_cache(cfg, 64, bs, dtype=torch.float32)
    gen = torch.Generator().manual_seed(n * 100 + t)
    tokens = torch.randint(0, cfg.vocab_size, (n, t), generator=gen, dtype=torch.int32)
    n_tokens = torch.full((n, ), t, dtype=torch.int32)
    start = torch.zeros(n, dtype=torch.int32)
    tables = torch.arange(n * b, dtype=torch.int32).reshape(n, b)
    with FlopCounterMode(display=False) as counter:
        mod.forward_paged(cfg, params, tokens, n_tokens, start, tables, kv, block_size=bs)
    flops, nbytes = mod.paged_bucket_cost(cfg, n, t, b, bs, torch.float32)
    assert flops == counter.get_total_flops()
    D, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    kv_heads = getattr(cfg, "num_kv_heads", cfg.num_heads)
    kv_pos = 2 * L * kv_heads * (D // cfg.num_heads) * 4
    assert kv["k"].shape[2] == kv_heads
    assert nbytes == (mod.num_params(cfg) * 4 + n * b * bs * kv_pos + n * t * kv_pos
                      + n * t * 4 + n * t * V * 4)
    assert mod.paged_bucket_cost(cfg, n, t, b, bs, torch.bfloat16)[1] < nbytes
