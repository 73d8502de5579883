"""The port's request tracing on the CPU against the JAX package's.

``deepspeed_tpu_torch/monitor/tracing.py`` and its wiring through the v2
engine, held to ``deepspeed_tpu/monitor/tracing.py`` and the JAX engine:

- the tracer units take the same calls in both modules and must end in the
  same state (flight-recorder ring, span chain with exact SLO marks, no
  clock read while disabled, idempotent terminal, Chrome export);
- the engines, tracing on, under a ``FakeClock`` with the same weights
  (``params_from_jax``), replay the scenarios of the JAX package's tracing
  suite (``tests/unit/inference/test_serving_tracing.py``) and its
  ``tracing_smoke`` lane: per uid the trace records (span names, starts,
  ends, terminal statuses) are equal, the TTFT/TBT/e2e/queue-wait
  percentiles equal exactly, and so do the flight-recorder events, compile
  events aside (``warm_recompile``: the frameworks build programs
  differently);
- port-only: tokens and ``ServeCounters`` identical with tracing on and
  off, no extra clock read with tracing off (the reads of the tree before
  tracing was wired in, pinned per drive), the queue-wait percentiles in
  ``health()`` with span tracing off, and the keys of ``state_snapshot()``
  and ``health()`` against the JAX engine's.

The JAX engines of one pool size share one program cache, so their bucket
programs are compiled once for the module."""

import json

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import ServingStalledError as JaxStalled
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.monitor import tracing as jtracing
from deepspeed_tpu.runtime.config import ServingTracingConfig as JaxTracingConfig
from deepspeed_tpu_torch.inference.config import UNPORTED_SECTIONS, load_inference_config
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, ServingStalledError
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.monitor import tracing
from deepspeed_tpu_torch.runtime.config import ServingTracingConfig
from tests.unit.fault_injection_serving import FakeClock, FrozenSequenceInjector

TRACED = {"dtype": "float32", "serving_tracing": {"enabled": True}}
PLAIN = {"dtype": "float32"}
# the tracing_smoke lane's pool and scheduler (run_tests.py)
KW = dict(num_blocks=64, block_size=8, max_blocks_per_seq=8, token_budget=32,
          max_seqs_per_step=8)
# the JAX suite's preemption engine: 5 usable blocks
PREEMPT_KW = dict(num_blocks=6, block_size=8, max_blocks_per_seq=8, token_budget=16,
                  max_seqs_per_step=4)
_rng = np.random.default_rng(0)
SMOKE_PROMPTS = ([_rng.integers(1, 128, int(n)).tolist() for n in _rng.integers(4, 16, 6)]
                 + [list(range(1, 100))])  # the last is over the cap: shed
COMPILE_EVENTS = ("warm_recompile", )

_CACHE = {}


def _params():
    if "params" not in _CACHE:
        jcfg = jllama.LlamaConfig.tiny(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2,
                                       seq=256)
        cfg = llama.LlamaConfig.tiny(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2,
                                     seq=256)
        jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
        params = llama.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        _CACHE["params"] = (jcfg, jparams, cfg, params)
    return _CACHE["params"]


class Sink:
    """Collects the ``kind: trace`` records a tracer exports (the seam a
    telemetry collector's ``record_trace`` fills)."""

    def __init__(self):
        self.records = []

    def record_trace(self, record):
        self.records.append(record)


def _engine(side, config, clock=None, **kw):
    """An engine of ``side`` ("jax" or "port") over the module's weights,
    its trace records collected by a :class:`Sink`."""
    jcfg, jparams, cfg, params = _params()
    kw = {**KW, **kw}
    if side == "jax":
        eng = JaxEngine(jllama, jcfg, jparams, config=dict(config), clock=clock, **kw)
        # bucket programs are functions of (params, pool, batch): engines
        # with one pool size share them
        eng._fwd_cache = _CACHE.setdefault(("programs", kw["num_blocks"]), {})
    else:
        eng = InferenceEngineV2(llama, cfg, params, config=dict(config), clock=clock,
                                device="cpu", **kw)
    eng.tracer.telemetry = Sink()
    return eng


def _view(eng):
    """What tracing left: the exported records, the live traces, exact
    percentiles and full histogram snapshots, and the flight recorder's
    events without the compile events."""
    tr = eng.tracer
    return {"records": tr.telemetry.records,
            "live": tr.live_uids(),
            "completed": tr.completed_total,
            "percentiles": tr.percentiles(),
            "latency": tr.latency_snapshot(),
            "counts": {name: dict(h.counts) for name, h in tr.histograms().items()},
            "recorder": [e for e in tr.recorder.tail() if e["event"] not in COMPILE_EVENTS]}


def _statuses(results):
    return [(r.uid, r.status, r.finish_reason, r.reason, r.tokens) for r in results]


# --------------------------------------------------------------- scenarios
def smoke(eng):
    """The tracing_smoke lane: 6 mixed-length prompts and one over the cap
    (shed at the door), 8 new tokens, non-strict."""
    return _statuses(eng.generate(SMOKE_PROMPTS, max_new_tokens=8, strict=False))


def preemption(eng):
    """The JAX suite's preemption case: uid 0's decode preempts uid 1
    (requeue span), the victim resumes once uid 0 is flushed."""
    eng.put([0], [[1] * 16])
    out = [sorted(eng.step())]  # uid 0 prefilled: 2 blocks
    eng.put([1], [[2] * 30])
    eng.manager.ensure_blocks(eng.manager.seqs[1], 24)  # the pool is now full
    out.append(sorted(eng.step()))
    assert eng.manager.seqs[1].preemptions >= 1
    trace = eng.tracer.trace(1)
    assert any(e[0] == "preempt" for e in trace.events)
    assert "requeue" in trace.open_span_names()
    eng.flush(0)
    out.append(sorted(eng.step()))  # the victim re-prefills: requeue closes
    requeues = [s for s in trace.spans if s.name == "requeue"]
    assert requeues and requeues[-1].end is not None
    assert any(e[0] == "resumed" for e in trace.events)
    eng.flush(1)
    assert eng.tracer.trace(1) is None
    return out


def deadline(eng):
    """One request whose 0.4 s TTL expires mid-decode."""
    res = _statuses(eng.generate([[1, 2, 3, 4, 5]], max_new_tokens=64, strict=False,
                                 ttl_s=0.4))
    assert res[0][1] == "deadline_expired"
    assert any(e["event"] == "expire" for e in eng.tracer.recorder.tail())
    return res


def failed_flush(eng):
    """A sequence failed by the manager (finish_reason None) and flushed:
    its trace ends ``failed`` and lands no e2e sample."""
    eng.put([0], [[1, 2, 3]])
    eng.step()
    eng.manager.fail(0, "injected forward error")
    eng.flush(0)
    assert eng.tracer.telemetry.records[-1]["status"] == "failed"
    assert eng.tracer.e2e.count == 0
    return []


def stall(eng):
    """A sequence frozen every step trips the watchdog: the dump carries the
    flight recorder's tail, ending with the stall."""
    FrozenSequenceInjector(eng, 0).install()
    with pytest.raises((ServingStalledError, JaxStalled)) as ei:
        eng.generate([[1] * 40, [2, 3, 4]], max_new_tokens=4)
    tail = [e for e in ei.value.snapshot["flight_recorder"]
            if e["event"] not in COMPILE_EVENTS]
    assert tail[-1]["event"] == "stall" and any(e["event"] == "dispatch" for e in tail)
    return tail


SCENARIOS = {
    "smoke": (smoke, TRACED, 0.01, {}),
    "preemption": (preemption, TRACED, 0.01, PREEMPT_KW),
    "deadline": (deadline, TRACED, 0.05, {}),
    "failed_flush": (failed_flush, TRACED, 0.01, {}),
    "stall": (stall, {**TRACED, "serving_resilience": {"stall_watchdog_steps": 5}}, 0.01, {}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_traces_match_jax_under_fake_clock(name):
    run, config, tick, kw = SCENARIOS[name]
    views = {}
    for side in ("jax", "port"):
        clock = FakeClock(tick=tick)
        eng = _engine(side, config, clock, **kw)
        out = run(eng)
        views[side] = {"out": out, "clock_reads": clock.calls, **_view(eng)}
    jv, pv = views["jax"], views["port"]
    assert pv["records"], "no trace was exported"
    for key in jv:
        assert pv[key] == jv[key], f"{name}: {key} differs from the JAX engine's"
    if name == "smoke":
        statuses = {uid: status for uid, status, *_ in pv["out"]}
        assert {r["uid"]: r["status"] for r in pv["records"]} == statuses
        assert list(statuses.values()).count("shed") == 1
        for r in pv["records"]:
            if r["status"] == "ok":  # a complete chain, every span closed
                names = [s["name"] for s in r["spans"]]
                assert names[0] == "queue_wait" and {"prefill", "decode"} <= set(names)
                assert all(s["end"] is not None for s in r["spans"])
                assert r["e2e_s"] >= r["ttft_s"] >= 0 and r["events"][-1][0] == "ok"
        for metric in ("ttft", "tbt", "e2e", "queue_wait"):
            assert pv["latency"][metric]["count"] > 0


def test_chrome_trace_matches_jax(tmp_path):
    """The Chrome export of one serve: one track per request, the span and
    instant shapes and the ``kv_pool`` counter track, equal to the JAX
    engine's file under a FakeClock."""
    docs = {}
    for side in ("jax", "port"):
        path = str(tmp_path / f"{side}.json")
        config = {"dtype": "float32",
                  "serving_tracing": {"enabled": True, "chrome_trace_path": path}}
        eng = _engine(side, config, FakeClock(tick=0.01))
        eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=3, strict=False)
        with open(path) as fh:
            docs[side] = json.load(fh)
    assert docs["port"] == docs["jax"]
    events = docs["port"]["traceEvents"]
    assert {e["tid"] for e in events if e["ph"] != "C"} == {0, 1}
    assert {e["name"] for e in events if e["ph"] == "X"} >= {"queue_wait", "prefill", "decode"}
    assert any(e["ph"] == "C" and e["name"] == "kv_pool" for e in events)
    assert any(e["ph"] == "i" and e["name"] == "ok" for e in events)


# ------------------------------------------------------------ tracer units
def _unit_ring(mod, clock):
    r = mod.FlightRecorder(capacity=16)
    for i in range(50):
        r.record("dispatch", step=i, t=i * 0.1)
    assert len(r) == 16 and r.events_total == 50
    assert [e["step"] for e in r.tail()] == list(range(34, 50))
    return {"tail": r.tail(), "tail4": r.tail(4)}


def _unit_span_chain(mod, tr):
    tr.on_submit(7, 1.0, prompt_len=4)
    tr.on_admit(7, 1.5, queue_wait_s=0.5)
    tr.on_chunks([(7, 4)])
    tr.on_tokens(7, 1, 2.0)   # first token: ttft 1.0
    tr.on_tokens(7, 4, 3.0)   # a burst of 4: four tbt samples of 0.25
    tr.on_terminal(7, "ok", finish_reason="eos", t=3.5)
    assert tr.ttft.quantile(0.5) == tr.ttft.representative(tr.ttft._index(1.0))
    assert tr.tbt.count == 4
    assert tr.tbt.quantile(0.99) == tr.tbt.representative(tr.tbt._index(0.25))
    assert tr.e2e.quantile(0.5) == tr.e2e.representative(tr.e2e._index(2.5))
    assert tr.live_uids() == [] and tr.completed_total == 1


def _unit_disabled(mod, tr):
    tr.on_submit(1, 0.0)
    tr.on_admit(1)
    tr.on_chunks([(1, 3)])
    tr.on_tokens_map({1: 5})
    tr.on_burst_tokens({1: 3})
    tr.on_preempt(1)
    tr.on_terminal(1, "ok")
    tr.abort_all([1])
    assert tr.clock.calls == 0, "disabled tracing must not read the clock"
    tr.tick(4.25)
    tr.event("dispatch", step=3, seqs=2)
    tr.observe_queue_wait(0.125)  # always on
    tail = tr.recorder.tail()
    assert tail[-1]["t"] == 4.25 and tail[-1]["event"] == "dispatch"
    assert tr.gauge_fields() == {} and tr.queue_wait.count == 1


def _unit_idempotent(mod, tr):
    tr.on_admit(3, 1.0)
    tr.on_tokens(3, 1, 2.0)
    tr.on_terminal(3, "ok", t=2.5)
    tr.on_terminal(3, "failed", t=9.0)  # a late duplicate is ignored
    assert tr.completed_total == 1 and tr.e2e.count == 1


def _unit_lifecycle(mod, tr):
    """Shed, preemption and resume, step- and burst-shaped tokens, abort."""
    tr.tick(0.5)
    tr.on_shed(9, "prompt_over_cap", detail="too long")
    tr.on_submit(1, 1.0, prompt_len=8, priority=1)
    tr.on_submit(2, 1.0, prompt_len=3)
    tr.on_admit(1, queue_wait_s=0.25)
    tr.on_admit(2, 1.25, queue_wait_s=0.25, prompt_len=3)
    tr.on_chunks([(1, 8), (2, 3)], step=1)
    tr.on_preempt(1, freed_blocks=2, rolled_back_to=0, preemptions=1)
    tr.on_tokens_map({2: 11})
    tr.on_chunks([(1, 8)], step=2)
    tr.on_burst_tokens({1: 1, 2: 5})
    tr.on_terminal(2, "ok", finish_reason="max_new_tokens")
    tr.abort_all([1, 2], reason="strict-mode abort")
    tr.reset_histograms()
    tr.observe_queue_wait(0.5)
    assert tr.live_uids() == [] and tr.completed_total == 3


def _unit_chrome(mod, tr, path):
    tr.on_submit(0, 0.0, prompt_len=2)
    tr.on_admit(0, 0.1)
    tr.on_chunks([(0, 2)])
    tr.tick(0.35)
    tr.counter_track("kv_pool", {"free_blocks": 5, "allocated_blocks": 2})
    tr.counter_track("kv_pool", {})  # an empty sample writes nothing
    tr.phase_span("dispatch", 0.2, 0.05, track=1)
    tr.on_tokens(0, 1, 0.4)
    tr.on_terminal(0, "ok", finish_reason="eos", t=0.6)
    assert tr.write_chrome_trace() == path
    with open(path) as fh:
        return json.load(fh)


UNITS = {"flight_recorder_ring": (_unit_ring, {}),
         "span_chain_exact_slo_marks": (_unit_span_chain, {}),
         "disabled_reads_no_clock_keeps_recorder": (_unit_disabled, {"enabled": False}),
         "terminal_is_idempotent": (_unit_idempotent, {}),
         "lifecycle_shed_preempt_burst_abort": (_unit_lifecycle, {}),
         "chrome_export": (_unit_chrome, {})}


@pytest.mark.parametrize("name", list(UNITS))
def test_tracer_units_match_jax(name, tmp_path):
    """The same calls into the JAX module and the port's leave the same
    records, histograms, recorder and clock reads."""
    unit, cfg_kw = UNITS[name]
    states = {}
    for side, mod, cfg_cls in (("jax", jtracing, JaxTracingConfig),
                               ("port", tracing, ServingTracingConfig)):
        clock = FakeClock(start=1.0, tick=0.125)
        if unit is _unit_ring:
            states[side] = unit(mod, clock)
            continue
        kw = {"enabled": True, **cfg_kw}
        path = str(tmp_path / side / "chrome.json")
        if unit is _unit_chrome:
            kw["chrome_trace_path"] = path
        tr = mod.RequestTracer(cfg_cls(**kw), clock=clock, telemetry=Sink())
        got = unit(mod, tr, path) if unit is _unit_chrome else unit(mod, tr)
        states[side] = {"got": got, "clock_reads": clock.calls, "now": tr.last_now,
                        "records": tr.telemetry.records, "live": tr.live_uids(),
                        "snapshot": tr.latency_snapshot(), "gauges": tr.gauge_fields(),
                        "recorder": tr.recorder.tail(), "completed": tr.completed_total}
    assert states["port"] == states["jax"]


def test_tracer_without_a_sink_writes_nothing(tmp_path):
    """``telemetry=None`` (the engine's default): no record goes anywhere,
    and no Chrome file is written without a path."""
    tr = tracing.RequestTracer(ServingTracingConfig(enabled=True), clock=FakeClock(tick=0.1))
    tr.on_admit(0, 0.0)
    tr.on_tokens(0, 1, 0.5)
    tr.on_terminal(0, "ok", t=1.0)
    assert tr.completed_total == 1 and tr.write_chrome_trace() is None
    assert list(tmp_path.iterdir()) == []


def test_config_section_has_the_jax_fields_and_defaults():
    ours = load_inference_config(None).serving_tracing
    theirs = JaxTracingConfig()
    for field in ("enabled", "trace_jsonl", "chrome_trace_path", "flight_recorder_events",
                  "histogram_buckets_per_decade", "histogram_min_s"):
        assert getattr(ours, field) == getattr(theirs, field)
    assert (ours.enabled, ours.flight_recorder_events) == (False, 256)
    assert "serving_tracing" not in UNPORTED_SECTIONS and "serving_perf" not in UNPORTED_SECTIONS
    assert set(UNPORTED_SECTIONS) == set()  # serving_spec_decode is ported too
    assert load_inference_config(TRACED).serving_tracing.enabled
    with pytest.raises(ValueError):
        load_inference_config({"serving_tracing": {"flight_recorder_events": 8}})
    for section in UNPORTED_SECTIONS:
        with pytest.raises(NotImplementedError, match=section):
            load_inference_config({section: {}})


# ------------------------------------------------------------- port only
def _drive_generate(eng):
    return [r.tokens for r in eng.generate(SMOKE_PROMPTS, max_new_tokens=8, strict=False)]


def _drive_put_step(eng):
    """put()/step()/flush() with a request arriving mid-decode and a TTL."""
    eng.put([0, 1], [SMOKE_PROMPTS[0], SMOKE_PROMPTS[1]])
    out = {0: [], 1: [], 2: []}
    for i in range(10):
        if i == 3:
            eng.put([2], [SMOKE_PROMPTS[2]], ttl_s=100.0)
        for uid, tok in eng.step().items():
            out[uid].append(tok)
    for uid in out:
        eng.flush(uid)
    return out


def _drive_decode_burst(eng):
    eng.put([0, 1, 2], SMOKE_PROMPTS[:3])
    out = {}
    while len(out) < 3:
        out.update(eng.step())
    for uid, toks in eng.decode_burst(6).items():
        out[uid] = toks
    for uid in range(3):
        eng.flush(uid)
    return out


DRIVES = {"generate": (_drive_generate, {}),
          "generate_reference": (_drive_generate, {"serving_fastpath": {"enabled": False}}),
          "generate_stepwise": (_drive_generate, {"serving_fastpath": {"fusion_min_steps": 10**6}}),
          "put_step": (_drive_put_step, {}),
          "decode_burst": (_drive_decode_burst, {})}
# clock reads of each drive on the port engine with tracing off, taken on
# the tree before tracing was wired in (a FakeClock counts them)
PARENT_CLOCK_READS = {"generate": 32, "generate_reference": 31, "generate_stepwise": 48,
                      "put_step": 22, "decode_burst": 6}


@pytest.mark.parametrize("name", list(DRIVES))
def test_tracing_leaves_tokens_counters_and_clock_reads(name):
    """Tracing on: tokens and every ServeCounters field byte-identical to
    tracing off.  Tracing off: the clock is read exactly as often as before
    tracing was wired in."""
    drive, extra = DRIVES[name]
    runs = {}
    for label, config in (("on", {**TRACED, **extra}), ("off", {**PLAIN, **extra})):
        clock = FakeClock(tick=0.01)
        eng = _engine("port", config, clock)
        out = drive(eng)
        runs[label] = (out, eng.counters.snapshot(), clock.calls, eng)
    on, off = runs["on"], runs["off"]
    assert on[0] == off[0]
    assert on[1] == off[1]
    assert off[2] == PARENT_CLOCK_READS[name]
    assert on[3].tracer.completed_total > 0 and off[3].tracer.completed_total == 0
    assert off[3].tracer.recorder.events_total > 0  # the recorder is always on


def test_health_reports_queue_wait_percentiles_without_span_tracing():
    """health() has queue-wait p50/p95/p99 with span tracing off: the
    admission pump feeds the histogram for free."""
    eng = _engine("port", {**PLAIN, "serving_resilience": {"max_live_seqs": 1}},
                  FakeClock(tick=0.01))
    eng.generate([[1, 2, 3], [4, 5, 6], [7, 8]], max_new_tokens=3, strict=False)
    h = eng.health()
    assert h["tracing_enabled"] is False
    qw = h["queue_wait"]
    assert qw["count"] == 3 and qw["p50"] is not None and qw["p99"] is not None
    assert qw["max"] > 0.0  # max_live_seqs=1 serializes admission
    assert h["latency"]["ttft"]["count"] == 0 and h["latency"]["queue_wait"] == qw
    assert h["flight_recorder"], "the flight recorder is always on"


# keys of unported items: none since speculative decoding is ported
UNPORTED_KEYS = set()


def test_snapshot_and_health_keys_match_jax():
    """state_snapshot() and health() carry every key of the JAX engine's but
    those of unported items; the port's extra is ``forward_steps``."""
    views = {}
    for side in ("jax", "port"):
        eng = _engine(side, TRACED, FakeClock(tick=0.01))
        eng.put([0], [[1, 2, 3, 4, 5, 6, 7, 8, 9]])
        eng.step()
        views[side] = (eng.state_snapshot(), eng.health())
    (js, jh), (ps, ph) = views["jax"], views["port"]
    assert set(ps) == (set(js) - UNPORTED_KEYS) | {"forward_steps"}
    assert set(ph) == set(jh) - UNPORTED_KEYS
    assert ps["kv"] == js["kv"] and "census_table" in ps["kv"]
    assert ps["prefix_cache"] == js["prefix_cache"]
    assert ps["fault_tolerance"] == js["fault_tolerance"] == ph["fault_tolerance"]
    assert ph["fault_tolerance"] == jh["fault_tolerance"]
    assert ([e for e in ps["flight_recorder"] if e["event"] not in COMPILE_EVENTS]
            == [e for e in js["flight_recorder"] if e["event"] not in COMPILE_EVENTS])
    for key in ("queue_wait", "latency", "tracing_enabled", "qos"):
        assert ph[key] == jh[key]
