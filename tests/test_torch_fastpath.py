"""The port's serving fast path on the CPU against the JAX package's.

Device-resident batch state, the pipelined serve loop, fused decode bursts,
stepped table widths and the intake prewarm of
``deepspeed_tpu_torch/inference/v2`` held to ``deepspeed_tpu/inference/v2``
(``fastpath.py``, ``engine_v2.py``) on tiny fp32 Llama with the same weights
(``params_from_jax``): greedy tokens identical to the JAX fast path and to
the port's own reference loop, the host-link counters
(``ServeCounters``) equal to the JAX engine's in every field but
``compiles``, and the contracts of the JAX package's fast-path suite
(``tests/unit/inference/test_serving_fastpath.py``) and of its
``serving_fastpath_smoke`` lane.  The JAX engines are built once for the
module and reused, so their compiled buckets are paid for once."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import fastpath as jfastpath
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.inference.config import load_inference_config
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.blocked_allocator import (BlockedAllocator,
                                                                KVAllocationError)
from deepspeed_tpu_torch.inference.v2.fastpath import (PENDING_TOKEN, DeferredTokens,
                                                       DeviceBatchState, ServeCounters)
from deepspeed_tpu_torch.models import llama
from tests.unit.fault_injection_serving import FakeClock
from tests.unit.fault_injection_serving import FaultyBlockedAllocator as JaxFaultyAllocator

NO_FUSION = 10**6  # fusion_min_steps too high to ever fire: forces stepwise
KW = dict(num_blocks=64, block_size=8, max_blocks_per_seq=8, token_budget=32,
          max_seqs_per_step=8)
CONFIGS = {"default": {"dtype": "float32"},
           "synchronous": {"dtype": "float32", "serving_fastpath": {"pipeline_depth": 0}},
           "stepwise": {"dtype": "float32", "serving_fastpath": {"fusion_min_steps": NO_FUSION}},
           "reference": {"dtype": "float32", "serving_fastpath": {"enabled": False}}}
# the serving_fastpath_smoke lane's prompts (run_tests.py)
_rng = np.random.default_rng(0)
LANE_PROMPTS = [_rng.integers(1, 128, int(n)).tolist() for n in _rng.integers(4, 16, 6)]
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14, 15, 16, 17], [20, 21]]
COUNTED = [f for f in ServeCounters.FIELDS if f != "compiles"]

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


def _jax_engine(config, **kw):
    """A JAX engine over the module's params.  Its bucket programs come from
    one cache shared by every JAX engine of the module: they are functions
    of (params, KV pool, batch) for one model and block size, so an engine
    dispatching a bucket another already compiled runs the same program."""
    jcfg, jparams, _, _ = _params()
    eng = JaxEngine(jllama, jcfg, jparams, config=dict(config), **{**KW, **kw})
    eng._fwd_cache = _CACHE.setdefault("programs", {})
    return eng


def _jax(name):
    """The module's JAX engine for CONFIGS[name], built once."""
    if name not in _CACHE:
        _CACHE[name] = _jax_engine(CONFIGS[name])
    return _CACHE[name]


def _port(name="default", config=None, **kw):
    _, _, cfg, params = _params()
    return InferenceEngineV2(llama, cfg, params,
                             config=dict(config if config is not None else CONFIGS[name]),
                             device="cpu", **{**KW, **kw})


def _no_pending(results):
    for r in results:
        toks = r.tokens if hasattr(r, "tokens") else r
        assert PENDING_TOKEN not in toks, f"placeholder escaped: {toks}"


class FaultyBlockedAllocator(BlockedAllocator):
    """The port's allocator failing on the schedule of the JAX package's
    ``tests/unit/fault_injection_serving.FaultyBlockedAllocator``: each
    ``allocate`` call fails with probability ``fail_rate`` from a seeded
    ``random.Random``, before the free list changes."""

    def __init__(self, num_blocks: int, *, fail_rate: float = 0.0, seed: int = 0):
        super().__init__(num_blocks)
        self.fail_rate = float(fail_rate)
        self._rng = random.Random(seed)
        self.calls = 0
        self.injected_failures = 0

    def allocate(self, n: int):
        self.calls += 1
        if self.fail_rate and self._rng.random() < self.fail_rate:
            self.injected_failures += 1
            raise KVAllocationError(f"injected allocation failure (call #{self.calls}, "
                                    f"p={self.fail_rate})")
        return super().allocate(n)


# ------------------------------------------------------------------- config
def test_config_section_has_the_jax_fields_and_defaults():
    from deepspeed_tpu.inference.config import load_inference_config as jax_load
    ours = load_inference_config(None).serving_fastpath
    theirs = jax_load(None).serving_fastpath
    for field in ("enabled", "pipeline_depth", "fusion_min_steps", "prewarm_buckets"):
        assert getattr(ours, field) == getattr(theirs, field)
    assert (ours.enabled, ours.pipeline_depth, ours.fusion_min_steps,
            ours.prewarm_buckets) == (True, 1, 2, 4)
    with pytest.raises(ValueError):
        load_inference_config({"serving_fastpath": {"pipeline_depth": 2}})
    with pytest.raises(ValueError):
        load_inference_config({"serving_fastpath": {"fusion_min_steps": 1}})


# ---------------------------------------------- token and counter identity
@pytest.mark.parametrize("name", list(CONFIGS))
def test_serve_matches_jax_engine_tokens_and_counters(name):
    """The lane scenario under each loop: default (pipelined, fused),
    synchronous (pipeline_depth 0), stepwise (fusion above every window) and
    the reference loop.  Tokens equal the JAX engine's and the reference
    loop's; every ServeCounters field but ``compiles`` equals the JAX
    engine's on the same config."""
    jeng = _jax(name)
    eng = _port(name)
    # the forward buckets each side dispatches (its prewarm aside)
    jax_buckets, buckets = set(), set()
    jax_fwd, fwd_program = jeng._compiled_fwd, eng._fwd_program
    jeng._compiled_fwd = lambda n, t, b: jax_fwd(n, t, b) if not jax_buckets.add((n, t, b)) \
        else None
    eng._fwd_program = lambda key, prewarmed=False: fwd_program(key, prewarmed=prewarmed) \
        if prewarmed or not buckets.add(key) else None
    before = jeng.counters.snapshot()
    try:
        want = jeng.generate(LANE_PROMPTS, max_new_tokens=8)
    finally:
        del jeng._compiled_fwd
    jdelta = jeng.counters.delta_since(before)
    got = eng.generate(LANE_PROMPTS, max_new_tokens=8)
    assert got == want
    if name != "reference":  # the port's reference step calls no bucket program
        assert buckets == jax_buckets
    _no_pending(got)
    assert got == _port("reference").generate(LANE_PROMPTS, max_new_tokens=8)
    ours = eng.counters.snapshot()
    assert {f: ours[f] for f in COUNTED} == {f: jdelta[f] for f in COUNTED}
    assert eng.manager.allocator.free_blocks == KW["num_blocks"] - 1 and not eng.manager.seqs
    if name == "synchronous":
        assert ours["flushes"] == 0  # nothing ever left in flight
    if name == "stepwise":
        assert ours["burst_tokens"] == 0
    if name == "reference":
        assert ours["host_syncs"] == ours["loop_iterations"]  # one fetch a step or burst


def test_serving_fastpath_smoke_lane_counters():
    """The JAX lane's single-chip scenario: the counters it records
    (TESTS_LANES.json: host_syncs 4, loop_iterations 5, flushes 1,
    burst_tokens 36, step_tokens 12), <= 1 sync per iteration, fusion
    dominant, and an identical warm rerun that builds nothing."""
    eng = _port()
    out = eng.generate(LANE_PROMPTS, max_new_tokens=8)
    c1 = eng.counters.snapshot()
    assert {f: c1[f] for f in ("host_syncs", "loop_iterations", "flushes", "burst_tokens",
                               "step_tokens")} == {"host_syncs": 4, "loop_iterations": 5,
                                                   "flushes": 1, "burst_tokens": 36,
                                                   "step_tokens": 12}
    assert c1["host_syncs"] <= c1["loop_iterations"] + c1["flushes"]
    assert c1["burst_tokens"] > c1["step_tokens"]
    assert c1["host_syncs"] < c1["burst_tokens"] + c1["step_tokens"]
    assert eng.generate(LANE_PROMPTS, max_new_tokens=8) == out
    warm = eng.counters.delta_since(c1)
    assert warm["compiles"] == 0 and eng.ledger.warm_total == 0, warm
    assert {f: warm[f] for f in COUNTED} == {f: c1[f] for f in COUNTED}


def test_fastpath_matches_jax_and_reference_strict_and_nonstrict():
    want = _jax("default").generate(PROMPTS, max_new_tokens=9)
    assert _port().generate(PROMPTS, max_new_tokens=9) == want
    assert _port("reference").generate(PROMPTS, max_new_tokens=9) == want
    fast_ns = _port().generate(PROMPTS, max_new_tokens=9, strict=False)
    assert [r.tokens for r in fast_ns] == want
    assert all(r.status == "ok" for r in fast_ns)
    _no_pending(fast_ns)


def test_pipelined_stepwise_matches_reference_incl_eos():
    """Fusion off: every decode step goes through the deferred pipeline
    (dispatch N, absorb N-1), including the eos overshoot truncation."""
    ref = _port("reference").generate(PROMPTS, max_new_tokens=7)
    eng = _port("stepwise")
    assert eng.generate(PROMPTS, max_new_tokens=7) == ref
    assert eng.counters.burst_tokens == 0 and eng.counters.flushes == 0
    eos = ref[0][len(PROMPTS[0]) + 3]
    a, b = _port("stepwise"), _port("reference")
    got = a.generate(PROMPTS, max_new_tokens=7, eos_token_id=eos)
    assert got == b.generate(PROMPTS, max_new_tokens=7, eos_token_id=eos)
    assert got == _jax("stepwise").generate(PROMPTS, max_new_tokens=7, eos_token_id=eos)
    assert got[0][-1] == eos and len(got[0]) == len(PROMPTS[0]) + 4
    _no_pending(got)
    assert not a.manager.seqs and a.manager.allocator.free_blocks == b.manager.allocator.free_blocks


def test_fastpath_matches_jax_and_reference_under_allocator_faults():
    """Injected allocator faults (the same seeded schedule on both sides)
    only delay scheduling: statuses and tokens equal the faulted reference
    loop's, the faulted JAX fast path's and the healthy run's, and the pool
    is reclaimed."""
    def run(eng, allocator):
        eng.manager.allocator = allocator
        free0 = allocator.free_blocks
        res = eng.generate(PROMPTS, max_new_tokens=6, strict=False)
        assert allocator.injected_failures > 0
        assert allocator.free_blocks == free0
        return [(r.status, r.tokens) for r in res]

    fast = run(_port(), FaultyBlockedAllocator(64, fail_rate=0.3, seed=7))
    ref = run(_port("reference"), FaultyBlockedAllocator(64, fail_rate=0.3, seed=7))
    jeng = _jax("default")
    healthy_allocator = jeng.manager.allocator
    try:
        jax_fast = run(jeng, JaxFaultyAllocator(64, fail_rate=0.3, seed=7))
    finally:
        jeng.manager.allocator = healthy_allocator
    assert fast == ref == jax_fast
    assert [t for _, t in fast] == _port().generate(PROMPTS, max_new_tokens=6)


def test_fastpath_matches_jax_and_reference_under_expiring_deadlines():
    """With deadlines live the pipeline disengages, so eviction timing (the
    partial token lists) and the clock reads equal the reference loop's and
    the JAX fast path's on the same fake clock."""
    def run(make):
        clock = FakeClock(tick=0.05)
        res = make(clock).generate([[1, 2, 3, 4, 5], [7, 8, 9]], max_new_tokens=64,
                                   strict=False, ttl_s=0.4)
        return [(r.uid, r.status, r.tokens) for r in res], clock.calls

    fast = run(lambda clock: _port(clock=clock))
    ref = run(lambda clock: _port("reference", clock=clock))
    jax_fast = run(lambda clock: _jax_engine(CONFIGS["default"], clock=clock))
    assert fast == ref == jax_fast  # tokens, statuses and clock consumption
    assert any(status == "deadline_expired" for _, status, _ in fast[0])
    for _, _, toks in fast[0]:
        assert PENDING_TOKEN not in toks


# ------------------------------------------------------- host-sync invariants
def test_steady_state_decode_at_most_one_sync_per_iteration():
    eng = _port("stepwise")
    eng.generate(PROMPTS, max_new_tokens=12)
    c = eng.counters
    assert c.loop_iterations > 0
    assert c.host_syncs <= c.loop_iterations + c.flushes, c.snapshot()


def test_fused_decode_is_sub_one_sync_per_token():
    eng = _port()
    out = eng.generate(PROMPTS, max_new_tokens=16)
    c = eng.counters
    tokens = sum(len(t) - len(p) for t, p in zip(out, PROMPTS))
    assert c.burst_tokens > c.step_tokens  # fusion carried the decode
    assert c.host_syncs < tokens / 2, c.snapshot()
    assert c.host_syncs <= c.loop_iterations + c.flushes
    # a burst of k counts k forwards, each a decode step of chunk width 1
    assert eng.chunk_widths[1] >= c.burst_tokens // len(PROMPTS)
    assert eng.scheduler.fused_tokens == c.burst_tokens


def test_bounded_builds_across_three_wave_scenario():
    """The bench's mixed-arrival scenario (3 waves landing mid-decode): the
    cold pass builds a bounded program set; an identical warm pass (same
    table widths thanks to the reset on idle) builds nothing."""
    eng = _port(num_blocks=128, max_blocks_per_seq=16, token_budget=64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 128, 16).tolist() for _ in range(6)]
    arrivals = {0: [0, 1, 2], 5: [3], 9: [4, 5]}
    bench._run_serving_scenario(eng, prompts, arrivals, max_new=8)
    cold = eng.counters.snapshot()
    assert 0 < cold["compiles"] <= 24, cold
    tokens, _, _, stalled, link = bench._run_serving_scenario(eng, prompts, arrivals,
                                                              max_new=8)
    assert not stalled and tokens == 6 * 8
    assert link["compiles"] == 0, link
    assert link["burst_tokens"] > 0
    assert link["host_syncs"] < tokens


# ------------------------------------------------------------ rng determinism
def test_burst_and_stepwise_sample_identical_tokens():
    """Burst and stepwise picks draw from the engine's generator in the same
    order and shapes, so sampled decode is sample-for-sample identical."""
    conf = {"dtype": "float32", "temperature": 1.0, "top_k": 20, "seed": 5}
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9]]

    def primed():
        eng = _port(config=conf, max_seqs_per_step=4, token_budget=16)
        eng.put([0, 1], prompts)
        while len(eng.step(greedy=False)) < 2:
            pass
        return eng

    a = primed()
    stepwise = {0: [], 1: []}
    for _ in range(5):
        for u, t in a.step(greedy=False).items():
            stepwise[u].append(t)
    b = primed()
    burst = b.decode_burst(5, greedy=False)
    assert burst == stepwise
    again = b.decode_burst(5, greedy=False)  # the generator advanced
    assert again is not None and again != burst


# -------------------------------------------------------- bucket hysteresis
def test_table_width_sequence_equals_jax():
    """One scripted series of needs (growth, slack below the patience, the
    shrink, a tall step resetting the patience, the cap) gives the JAX
    engine's widths, on the fast path and in the reference loop; a put()
    into an idle engine resets the sticky width."""
    needs = [1, 5, 9] + [2] * 16 + [11] + [2] * 8 + [10, 3, 200, 7, 64, 1]
    for name in ("default", "reference"):
        eng = _port(name, max_blocks_per_seq=64)
        jeng = _jax_engine(CONFIGS[name], max_blocks_per_seq=64)
        ours = [eng._table_width_for(n) for n in needs]
        assert ours == [jeng._table_width_for(n) for n in needs]
    eng = _port(max_blocks_per_seq=64)
    assert [eng._table_width_for(n) for n in (1, 5, 9)] == [4, 8, 12]
    eng.put([0], [[1, 2, 3]])  # the manager was empty: a fresh serve
    assert eng._table_width == 0 and eng._table_slack == 0
    eng.flush(0)


# --------------------------------------------------------------- unit pieces
def test_device_batch_state_uploads_only_deltas_like_jax():
    """The same update/feed sequence through both DeviceBatchStates: the
    same uploads, upload_ints and dispatches, and the same buffers."""
    key = (4, 2, 4)
    row = lambda i, tok, nt, sp, tab: (i, np.asarray([i, tok, 0, nt, sp] + tab, np.int32))
    rows = [row(0, 5, 1, 3, [1, 2, 9, 9]), row(1, 6, 1, 4, [3, 9, 9, 9])]
    rows2 = [rows[0], row(1, 7, 1, 5, [3, 9, 9, 9])]
    script = [(rows, 2), (rows, 2), (rows2, 2), ([rows2[0]], 1)]
    ours, theirs = ServeCounters(), jfastpath.ServeCounters()
    state, jstate = DeviceBatchState(ours, "cpu"), jfastpath.DeviceBatchState(theirs)
    for i, (r, n_active) in enumerate(script):
        state.update(key, r, n_active=n_active, trash_block=9)
        jstate.update(key, r, n_active=n_active, trash_block=9)
        if i == 1:  # an identical step moves nothing: 2 rows of 3 + t + b ints
            assert ours.uploads == 1 and ours.upload_ints == 2 * 9
    state.feed(key, torch.tensor([40, 41], dtype=torch.int32), [(0, 1)])
    jstate.feed(key, jnp.asarray([40, 41], jnp.int32), [(0, 1)])
    assert [(c.uploads, c.upload_ints, c.dispatches) for c in (ours, theirs)] == [(4, 38, 4)] * 2
    slot, jslot = state.slot(key, 9), jstate.slot(key, 9)
    assert slot.active_rows == jslot.active_rows == 1
    for got, want in zip(slot.buffers(), (jslot.tokens, jslot.n_tokens, jslot.start_pos,
                                          jslot.tables)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the shrink neutralized the stale row: n_tokens 0, tables all trash
    assert int(slot.n_tokens[1]) == 0 and slot.tables[1].tolist() == [9, 9, 9, 9]
    assert int(slot.tokens[0, 0]) == 41  # fed on the device


def test_device_batch_state_writes_in_place():
    """A slot's buffers keep their addresses (they are a captured graph's
    static inputs on the card)."""
    state = DeviceBatchState(ServeCounters(), "cpu")
    slot = state.slot((2, 1, 2), 9)
    ptrs = [t.data_ptr() for t in slot.buffers()]
    state.update((2, 1, 2), [(0, np.asarray([0, 3, 1, 0, 1, 9], np.int32))], n_active=1,
                 trash_block=9)
    state.feed((2, 1, 2), torch.tensor([8], dtype=torch.int32), [(0, 0)])
    assert [t.data_ptr() for t in slot.buffers()] == ptrs
    assert slot.tokens.tolist() == [[8], [0]] and slot.tables.tolist() == [[1, 9], [9, 9]]


def test_deferred_tokens_patch_and_overshoot_drop():
    class Seq:
        def __init__(self, toks):
            self.tokens = toks

    class Mgr:
        def __init__(self):
            self.seqs = {0: Seq([1, 2, PENDING_TOKEN]), 1: Seq([5, PENDING_TOKEN])}

    mgr = Mgr()
    c = ServeCounters()
    d = DeferredTokens(toks_dev=torch.tensor([42, 43], dtype=torch.int32),
                       emits=[(0, 2, 0), (1, 1, 1), (7, 0, 1)],
                       row_of={0: 0, 1: 1, 7: 1}, counters=c)
    d.drop_emit(7)  # retired mid-flight
    assert d.patch(mgr) == {0: 42, 1: 43}
    assert mgr.seqs[0].tokens == [1, 2, 42] and mgr.seqs[1].tokens == [5, 43]
    assert c.host_syncs == 1
    assert d.patch(mgr) == {0: 42, 1: 43}  # idempotent, no second sync
    assert c.host_syncs == 1


def test_prewarm_builds_the_jax_engine_bucket_keys():
    """The intake prewarm builds the buckets the JAX engine's prewarm
    compiles (its ``_fwd_cache`` keys) for the same queued and live
    requests, and records them as prewarmed."""
    jcfg, jparams, _, _ = _params()
    jeng = JaxEngine(jllama, jcfg, jparams, config=dict(CONFIGS["default"]),
                     **{**KW, "max_blocks_per_seq": 16})
    # record the keys the JAX prewarm asks for; compile nothing
    jeng._aot_compile_fwd = lambda n, t, b, prewarmed=True: jeng._fwd_cache.setdefault(
        (n, t, b), None)
    eng = _port(max_blocks_per_seq=16)
    for e in (jeng, eng):
        e.put([0, 1, 2], PROMPTS[:3])
        e.admission.submit(7, list(range(1, 40)))
        e._prewarm(40)
    assert sorted(eng.programs.keys("fwd")) == sorted(jeng._fwd_cache)
    # (n, 1 | 32, prefill width 8 | decode width 12)
    assert eng.ledger.count("prewarmed") == len(jeng._fwd_cache) == 4
    eng._prewarm(40)  # everything is built: nothing more
    assert eng.ledger.total == 4
