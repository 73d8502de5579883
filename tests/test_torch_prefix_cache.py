"""The port's copy-on-write prefix cache against the JAX package's.

Manager-level cases of the JAX package's prefix-cache suite
(``tests/unit/inference/test_prefix_cache.py``) run on both packages' ragged
managers, prefix trees, census and scheduler, which must reach the same
block tables, refcounts and counters; and the port's v2 engine on the CPU
(cache on, its default) is held to the JAX engine (cache on, its default) on
shared-prefix workloads with the fast path on and off: tokens identical,
``health()["prefix_cache"]`` and ``health()["kv"]`` equal, ``ServeCounters``
equal but ``compiles``, and realized savings equal to the observatory's
counterfactual.  Tiny fp32 Llama, weights through ``params_from_jax``."""

import gc
import random
import types
import weakref

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference import v2 as jv2
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.runtime.config import ServingResilienceConfig as JaxResilience
from deepspeed_tpu_torch.inference import v2 as pv2
from deepspeed_tpu_torch.inference.config import load_inference_config
from deepspeed_tpu_torch.inference.v2.blocked_allocator import BlockedAllocator, KVAllocationError
from deepspeed_tpu_torch.inference.v2.fastpath import ServeCounters
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.runtime.config import ServingResilienceConfig
from tests.unit.fault_injection_serving import FakeClock
from tests.unit.fault_injection_serving import FaultyBlockedAllocator as JaxFaultyAllocator

BS = 8  # block size of every manager and engine in this file
HEADER = list(range(100, 124))  # 3 full shared blocks
PORT = types.SimpleNamespace(v2=pv2, resilience=ServingResilienceConfig, name="port")
JAX = types.SimpleNamespace(v2=jv2, resilience=JaxResilience, name="jax")
COUNTED = [f for f in ServeCounters.FIELDS if f != "compiles"]


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


def make_manager(pkg, num_blocks=32, max_blocks=8, census=True, cow_copy=None):
    m = pkg.v2.RaggedStateManager(num_blocks, BS, max_blocks, prefix_cache=pkg.v2.PrefixCache(BS))
    if census:
        m.census = pkg.v2.BlockCensus(BS, num_blocks, m.trash_block)
    m.cow_copy = cow_copy
    return m


def prefill(m, seq, upto=None):
    """Completed prefill as the engine's step does it: grow the table,
    advance ``seen_tokens``, offer the completed prompt blocks to the tree."""
    upto = len(seq.tokens) if upto is None else upto
    m.ensure_blocks(seq, upto)
    seq.seen_tokens = upto
    m.register_prefix_blocks(seq)


def both(case):
    """Run a manager-level case on both packages; what each observed must be
    equal."""
    ours, theirs = case(PORT), case(JAX)
    assert ours == theirs
    return ours


def state(m):
    return ({uid: (list(s.blocks), s.seen_tokens, s.prefix_registered, s.prefix_cached_tokens)
             for uid, s in m.seqs.items()},
            {b: m.allocator.refcount(b) for b in range(m.allocator.num_blocks)},
            m.allocator.free_blocks, m.prefix_cache.snapshot())


# ------------------------------------------------------------- tree mechanics
def test_tree_partial_hit_maps_only_matching_prefix():
    def case(pkg):
        m = make_manager(pkg)
        a = m.add_sequence(0, HEADER + [1, 2, 3, 4])
        prefill(m, a)
        assert len(m.prefix_cache) == 3
        b = m.add_sequence(1, HEADER[:16] + [77] * 8 + [5, 6])  # diverges in block 2
        saved = m.map_prefix(b)
        assert saved == 16 and b.seen_tokens == 16 and b.blocks == a.blocks[:2]
        assert m.prefix_cache.hits_total == 2
        prefill(m, b)
        assert b.blocks[2] not in a.blocks  # the divergent tail is private
        m.census.check_against(m.allocator, m.seqs)
        return state(m)

    both(case)


def test_map_prefix_stops_once_private_progress_exists():
    def case(pkg):
        m = make_manager(pkg)
        prefill(m, m.add_sequence(0, HEADER + [1]))
        b = m.add_sequence(1, HEADER + [2])
        b.seen_tokens = 3  # mid-block private progress (a rolled-back resume)
        m.ensure_blocks(b, 3)
        assert m.map_prefix(b) == 0  # never maps over private KV
        return state(m)

    both(case)


def test_lookup_verifies_token_ids_not_just_hashes():
    def case(pkg):
        m = make_manager(pkg)
        prefill(m, m.add_sequence(0, HEADER + [1]))
        cache = m.prefix_cache
        b = m.add_sequence(1, HEADER + [2])
        # same hash key, different recorded tokens: a manufactured collision
        cache.entries[b.prefix_hashes[0]].tokens = tuple([999] * BS)
        assert m.map_prefix(b) == 0 and cache.collision_rejects_total == 1
        cache.entries[b.prefix_hashes[0]].tokens = tuple(HEADER[:BS])
        cache.entries[b.prefix_hashes[0]].parent = b"bogus"  # ancestry verified too
        assert m.map_prefix(b) == 0 and cache.collision_rejects_total == 2
        return state(m)

    both(case)


def test_register_is_first_writer_wins():
    def case(pkg):
        cache = pkg.v2.PrefixCache(BS)
        first = cache.register(b"h", b"", 4, tuple(range(BS)))
        second = cache.register(b"h", b"", 9, tuple(range(BS)))
        assert first and not second and cache.entries[b"h"].block == 4
        return cache.snapshot()

    assert both(case)["registered_total"] == 1


# -------------------------------------------------------- refcount lifecycle
def test_shared_block_freed_only_by_last_owner():
    def case(pkg):
        m = make_manager(pkg)
        a = m.add_sequence(0, HEADER + [1])
        prefill(m, a)
        b = m.add_sequence(1, HEADER + [2])
        assert m.map_prefix(b) == 24
        shared = list(b.blocks)
        assert all(m.allocator.refcount(blk) == 2 for blk in shared)
        m.retire(0)  # a finishes first: b still maps every shared block
        assert all(m.allocator.refcount(blk) == 1 for blk in shared)
        assert not set(shared) & m.allocator.free_block_set()
        assert len(m.prefix_cache) == 3  # entries outlive the registrant
        m.census.check_against(m.allocator, m.seqs)
        mid = state(m)
        m.retire(1)
        assert m.allocator.free_blocks == 31 and len(m.prefix_cache) == 0
        assert m.prefix_cache.evicted_total == 3
        return mid, state(m), m.census.rollup(m.allocator.free_blocks)

    both(case)


def test_evict_and_fail_decrement_not_free():
    def case(pkg):
        m = make_manager(pkg)
        a = m.add_sequence(0, HEADER + [1])
        prefill(m, a)
        b = m.add_sequence(1, HEADER + [2])
        m.map_prefix(b)
        assert m.evict(b, "deadline_expired") == 0  # TTL expiry mid-life
        assert all(m.allocator.refcount(blk) == 1 for blk in a.blocks[:3])
        m.census.check_against(m.allocator, m.seqs)
        c = m.add_sequence(2, HEADER + [3])
        m.map_prefix(c)
        m.fail(2, "injected")  # the failure path decrements too
        assert all(m.allocator.refcount(blk) == 1 for blk in a.blocks[:3])
        m.census.check_against(m.allocator, m.seqs)
        return state(m), m.failed_requests

    both(case)


def test_preempted_sharer_releases_and_remaps():
    def case(pkg):
        m = make_manager(pkg)
        a = m.add_sequence(0, HEADER + [1])
        prefill(m, a)
        b = m.add_sequence(1, HEADER + list(range(50, 60)))
        m.map_prefix(b)
        prefill(m, b)  # 34 tokens -> 5 blocks (3 shared + 2 private)
        assert len(b.blocks) == 5 and m.releasable_blocks(b, 2) == 2
        # rollback INTO the shared region: only the 2 private blocks return
        assert m.preempt(b, keep_blocks=2) == 2 and b.seen_tokens == 16
        assert b.prefix_registered == 2  # the watermark rolls back with the table
        assert all(m.allocator.refcount(blk) == 2 for blk in b.blocks)
        assert m.allocator.refcount(a.blocks[2]) == 1
        m.census.check_against(m.allocator, m.seqs)
        assert m.map_prefix(b) == BS and b.blocks == a.blocks[:3]  # re-served on resume
        mid = state(m)
        m.retire(0)
        m.retire(1)
        assert m.allocator.free_blocks == 31
        return mid, state(m)

    both(case)


# --------------------------------------------------------------- CoW semantics
def test_cow_on_fully_cached_prompt():
    """A prompt cached to its last token must NOT write the shared block:
    the final block is copied and the one recomputed position lands in the
    private copy."""
    def case(pkg):
        copies = []
        m = make_manager(pkg, cow_copy=lambda src, dst: copies.append((src, dst)))
        full = list(range(200, 232))  # 4 full blocks, the prompt ends on a boundary
        a = m.add_sequence(0, list(full))
        prefill(m, a)
        b = m.add_sequence(1, list(full))
        assert m.map_prefix(b) == 24 + (BS - 1)
        assert b.seen_tokens == 31 and b.pending_tokens == 1
        assert b.blocks[:3] == a.blocks[:3] and b.blocks[3] != a.blocks[3]
        assert copies == [(a.blocks[3], b.blocks[3])]
        assert m.allocator.refcount(b.blocks[3]) == 1
        assert m.prefix_cache.cow_copies_total == 1
        m.census.check_against(m.allocator, m.seqs)
        return state(m), copies

    both(case)


def test_cow_declines_without_copy_seam_or_a_free_block():
    """No copy seam: the final block is recomputed — the shared mapping stops
    one block short.  A pool that cannot spare the copy's block (here an
    injected allocation fault) declines the same way."""
    def case(pkg):
        m = make_manager(pkg, cow_copy=None)
        full = list(range(200, 232))
        prefill(m, m.add_sequence(0, list(full)))
        b = m.add_sequence(1, list(full))
        assert m.map_prefix(b) == 24 and b.seen_tokens == 24 and b.pending_tokens == 8
        assert len(b.blocks) == 3
        m.cow_copy = lambda src, dst: None
        m.allocator.allocate = lambda n: (_ for _ in ()).throw(
            KVAllocationError("injected") if pkg is PORT else
            jv2.KVAllocationError("injected"))
        assert m.map_prefix(b) == 0 and m.prefix_cache.cow_copies_total == 0
        return state(m)

    both(case)


def test_rescue_never_preempts_victims_that_release_nothing():
    """A starved decode must not burn a shared-prefix victim's preemption
    budget (or evict it) when dropping its blocks would only decrement
    refcounts."""
    def case(pkg):
        m = make_manager(pkg, num_blocks=8, max_blocks=8)
        prefill(m, m.add_sequence(0, HEADER + [1, 2, 3, 4, 5, 6, 7, 8]))  # 4 full blocks
        d = m.add_sequence(1, list(range(60, 85)))
        prefill(m, d, upto=24)  # its next decode token needs a 4th block
        assert d.pending_tokens == 1 and m.allocator.free_blocks == 0
        b = m.add_sequence(2, HEADER + [40] * 10)
        assert m.map_prefix(b) == 24 and m.releasable_blocks(b, 0) == 0
        sched = pkg.v2.SplitFuseScheduler(32, 8, resilience=pkg.resilience())
        chunks = sched.schedule(m)
        assert b.preemptions == 0 and not b.done and sched.preempted_total == 0
        assert all(c.uid != 1 for c in chunks)  # the decode genuinely waits
        m.census.check_against(m.allocator, m.seqs)
        return state(m), [(c.uid, c.n_tokens) for c in chunks]

    both(case)


def test_scheduler_defers_same_step_duplicates_and_remaps_late():
    """Three requests with one header admitted together: the first computes
    the header, the others defer for one step (the block they need is being
    computed in this step) and then map it instead of prefilling it."""
    def case(pkg):
        m = make_manager(pkg, num_blocks=40)
        seqs = [m.add_sequence(i, HEADER + [i] * 5) for i in range(3)]
        for s in seqs:
            m.map_prefix(s)
        sched = pkg.v2.SplitFuseScheduler(64, 8, resilience=pkg.resilience())
        steps = []
        for _ in range(3):
            chunks = sched.schedule(m)
            steps.append([(c.uid, c.n_tokens, m.seqs[c.uid].seen_tokens) for c in chunks])
            for c in chunks:
                s = m.seqs[c.uid]
                s.seen_tokens += c.n_tokens
                m.register_prefix_blocks(s)
                if s.seen_tokens >= len(s.tokens):
                    s.tokens.append(7)
        assert m.prefix_cache.deferrals_total == 2 and m.prefix_cache.hits_total == 6
        assert steps[0] == [(0, 29, 0)]
        m.census.check_against(m.allocator, m.seqs)
        return steps, state(m)

    both(case)


# ------------------------------------------------------- census + invariants
def test_invariant_names_block_and_both_uids_on_foreign_kv():
    def case(pkg):
        m = make_manager(pkg)
        a = m.add_sequence(0, HEADER + [1])
        prefill(m, a)
        b = m.add_sequence(1, HEADER + [2])
        m.map_prefix(b)
        m.census.check_against(m.allocator, m.seqs)  # clean while honest
        b.tokens[3] = 999  # b's view of a shared block differs from a's
        with pytest.raises(pkg.v2.CensusInvariantError) as exc:
            m.census.check_against(m.allocator, m.seqs)
        assert exc.value.block == a.blocks[0] and {exc.value.uid, exc.value.uid2} == {0, 1}
        assert "observing another's KV" in str(exc.value)
        return str(exc.value)

    both(case)


def test_invariant_catches_refcount_drift():
    def case(pkg):
        m = make_manager(pkg)
        a = m.add_sequence(0, HEADER + [1])
        prefill(m, a)
        m.allocator.incref(a.blocks[1])  # a mapping the census never heard about
        with pytest.raises(pkg.v2.CensusInvariantError) as exc:
            m.census.check_against(m.allocator, m.seqs)
        assert exc.value.block == a.blocks[1] and "refcount" in str(exc.value)
        return str(exc.value)

    both(case)


# ------------------------------------------------------------------ engines
KW = dict(num_blocks=64, block_size=BS, max_blocks_per_seq=8, token_budget=64,
          max_seqs_per_step=8)
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


def _jax_engine(config=None, **kw):
    """A JAX engine over the module's params; its bucket programs come from
    one cache shared by the module's JAX engines of one pool size (functions
    of params, pool and batch for one model), so each bucket compiles once."""
    jcfg, jparams, _, _ = _params()
    kw = {**KW, **kw}
    eng = jv2.InferenceEngineV2(jllama, jcfg, jparams,
                                config={"dtype": "float32", **(config or {})}, **kw)
    # prewarmed programs are compiled for the pool's shape: one cache a size
    eng._fwd_cache = _CACHE.setdefault(("programs", kw["num_blocks"]), {})
    return eng


def _port(config=None, **kw):
    _, _, cfg, params = _params()
    return pv2.InferenceEngineV2(llama, cfg, params, config={"dtype": "float32", **(config or {})},
                                 device="cpu", **{**KW, **kw})


def _lane_prompts():
    """The prefix-cache smoke lane's workload (``run_tests.py``): six
    prompts behind one 24-token header, four tokens of tail each."""
    rng = np.random.default_rng(0)
    header = rng.integers(1, 128, 24).tolist()
    return [header + rng.integers(1, 128, 4).tolist() for _ in range(6)]


def _counted(eng):
    return {f: v for f, v in eng.counters.snapshot().items() if f != "compiles"}


@pytest.mark.parametrize("fastpath", [True, False])
def test_engine_matches_jax_on_shared_prefix_workload(fastpath):
    prompts = _lane_prompts()
    config = {"serving_fastpath": {"enabled": fastpath}}
    ours, theirs = _port(config), _jax_engine(config)
    out = ours.generate(prompts, max_new_tokens=8)
    assert out == theirs.generate(prompts, max_new_tokens=8)
    h, jh = ours.health(), theirs.health()
    assert h["prefix_cache"] == jh["prefix_cache"]
    assert h["kv"] == jh["kv"]
    assert _counted(ours) == {f: jh["fastpath"][f] for f in COUNTED}
    for key in ("live_seqs", "queue_depth", "free_blocks", "kv_utilization", "scheduler_steps",
                "completed_total", "failed_total", "shed_total", "preempted_total",
                "deadline_expired_total", "stall_streak", "stalls_total"):
        assert h[key] == jh[key], key
    # realized savings equal the observatory's counterfactual
    pc, obs = h["prefix_cache"], h["kv"]["prefix"]
    assert pc["realized_hit_rate"] > 0
    assert pc["tokens_saved_total"] == obs["prefill_tokens_saved_total"] == 5 * 24
    assert pc["hit_blocks_total"] == obs["duplicate_blocks_total"] == 15
    assert pc["entries"] == 0 and h["free_blocks"] == KW["num_blocks"] - 1
    ours.check_kv_invariant()
    assert h["kv"]["invariant_checks_total"] == 1


@pytest.mark.parametrize("fastpath", [True, False])
@pytest.mark.parametrize("strict", [True, False])
def test_outputs_byte_identical_cache_on_vs_off(fastpath, strict):
    rng = np.random.default_rng(3)
    prompts = [HEADER + rng.integers(1, 128, 5).tolist() for _ in range(4)]
    outs = {}
    for enabled in (True, False):
        eng = _port({"serving_prefix_cache": {"enabled": enabled},
                     "serving_fastpath": {"enabled": fastpath}})
        outs[enabled] = eng.generate(prompts, max_new_tokens=6, strict=strict)
        pc = eng.health()["prefix_cache"]
        if enabled:
            assert pc["hits_total"] > 0 and pc["tokens_saved_total"] > 0
            eng.check_kv_invariant()
            assert eng.manager.allocator.free_blocks == 63 and pc["entries"] == 0
        else:
            assert pc == {"enabled": False}
    if strict:
        assert outs[True] == outs[False]
    else:
        assert [r.tokens for r in outs[True]] == [r.tokens for r in outs[False]]
        assert all(r.ok for r in outs[True])


@pytest.mark.parametrize("section", ["serving_prefix_cache", "serving_kv_observability"])
def test_no_sharing_workload_counters_byte_identical(section):
    """With nothing to share, the cache (or the observability) costs the
    serve loop nothing: ``ServeCounters`` byte-identical on and off."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 128, int(n)).tolist() for n in rng.integers(3, 30, 6)]
    snaps = {}
    for enabled in (True, False):
        eng = _port({section: {"enabled": enabled}})
        out = eng.generate(prompts, max_new_tokens=6)
        snaps[enabled] = (eng.counters.snapshot(), out)
        if not enabled and section == "serving_kv_observability":
            assert eng.health()["kv"] == {"enabled": False}
    assert snaps[True] == snaps[False]


def test_shared_prefix_serve_under_allocator_faults_matches_jax():
    """25% injected allocation failures through a shared-prefix serve with
    preemption pressure: the port and the JAX engine, on the same fault
    schedule, give the same statuses and tokens; every request ok, the
    refcount and census invariants clean, the pool drained."""
    rng = np.random.default_rng(11)
    prompts = [HEADER + rng.integers(1, 128, int(n)).tolist() for n in rng.integers(3, 16, 8)]
    kw = dict(num_blocks=40, token_budget=32, max_seqs_per_step=4)
    config = {"serving_resilience": {"max_live_seqs": 4, "stall_watchdog_steps": 50}}
    ours, theirs = _port(config, **kw), _jax_engine(config, **kw)
    ours.manager.allocator = FaultyBlockedAllocator(40, fail_rate=0.25, seed=11)
    theirs.manager.allocator = JaxFaultyAllocator(40, fail_rate=0.25, seed=11)
    res = ours.generate(prompts, max_new_tokens=6, strict=False)
    jres = theirs.generate(prompts, max_new_tokens=6, strict=False)
    assert [(r.status, r.tokens) for r in res] == [(r.status, r.tokens) for r in jres]
    assert all(r.status == "ok" for r in res)
    assert ours.manager.allocator.injected_failures == theirs.manager.allocator.injected_failures > 0
    assert ours.health()["prefix_cache"] == theirs.health()["prefix_cache"]
    assert ours.health()["prefix_cache"]["hits_total"] > 0
    ours.check_kv_invariant()
    assert ours.manager.allocator.free_blocks == 39


def test_second_serve_accrues_identical_savings():
    """uid reuse across generate() calls: the tree drains with the pool, so
    a repeated workload earns the same savings again."""
    prompts = [HEADER + [50 + i] for i in range(3)]
    eng = _port()
    first_out = eng.generate(prompts, max_new_tokens=3)
    first = eng.health()["prefix_cache"]["tokens_saved_total"]
    assert first > 0
    assert eng.generate(prompts, max_new_tokens=3) == first_out
    assert eng.health()["prefix_cache"]["tokens_saved_total"] == 2 * first
    assert eng.health()["kv"]["prefix"]["prefill_tokens_saved_total"] == 2 * first


@pytest.mark.parametrize("fastpath", [True, False])
def test_put_step_cow_and_late_binding_match_jax(fastpath):
    """The step()-level API: a request holding the header mid-decode, then a
    prompt that is exactly the header (mapped to its last token: the CoW
    copy) and two that extend it, put while the first decodes.  Per-step
    outputs, the prefix snapshot and the counters equal the JAX engine's;
    the copied block's KV equals its source's."""
    head = HEADER + list(range(10, 18))  # 4 full blocks
    config = {"serving_fastpath": {"enabled": fastpath}}
    ours, theirs = _port(config), _jax_engine(config)
    log = {}
    for name, eng in (("port", ours), ("jax", theirs)):
        steps = []
        eng.put([0], [head + [3, 4]])
        for _ in range(3):
            steps.append(eng.step())
        eng.put([1, 2, 3], [list(head), head + [5] * 9, head[:16] + [6] * 3])
        seq1 = eng.manager.seqs[1]
        assert seq1.seen_tokens == len(head) - 1 and seq1.pending_tokens == 1
        if name == "port":
            src, dst = eng.manager.seqs[0].blocks[3], seq1.blocks[3]
            for leaf in eng.kv.values():
                assert np.array_equal(leaf[:, dst].numpy(), leaf[:, src].numpy())
        for _ in range(6):
            steps.append(eng.step())
        for uid in range(4):
            eng.flush(uid)
        eng.check_kv_invariant()
        assert eng.manager.allocator.free_blocks == 63
        log[name] = (steps, eng.health()["prefix_cache"], eng.health()["kv"],
                     {f: eng.counters.snapshot()[f] for f in COUNTED})
    assert log["port"] == log["jax"]
    pc = log["port"][1]
    # uid 1: 3 blocks mapped + the copy (31 tokens); uid 2: 4 blocks (32);
    # uid 3: 2 blocks (16)
    assert pc["cow_copies_total"] == 1 and pc["hits_total"] == 3 + 4 + 2
    assert pc["tokens_saved_total"] == 31 + 32 + 16


def test_mid_decode_ttl_expiry_of_a_sharer_matches_jax():
    """A sharer evicted mid-decode (TTL expiry) releases its mappings while
    the survivor decodes on: same statuses and tokens as the JAX engine on
    the same fake clock, invariants clean, pool drained."""
    prompts = [HEADER + [1, 2, 3], HEADER + [4, 5, 6]]
    out = {}
    for name, make in (("port", _port), ("jax", _jax_engine)):
        eng = make(clock=FakeClock(tick=0.05))
        res = eng.generate(prompts, max_new_tokens=24, strict=False, ttl_s=2.0)
        eng.check_kv_invariant()
        assert eng.manager.allocator.free_blocks == 63
        out[name] = ([(r.status, r.tokens) for r in res], eng.health()["prefix_cache"])
    assert out["port"] == out["jax"]
    assert out["port"][1]["hits_total"] > 0


def test_config_sections_have_the_jax_fields_and_defaults():
    from deepspeed_tpu.inference.config import load_inference_config as jax_load
    ours, theirs = load_inference_config(None), jax_load(None)
    for section, fields in (("serving_prefix_cache", ("enabled", "cow", "defer_shared_prefill")),
                            ("serving_kv_observability",
                             ("enabled", "invariant_check", "ewma_alpha", "pressure_steps",
                              "age_buckets_per_decade"))):
        for field in fields:
            assert getattr(getattr(ours, section), field) == \
                getattr(getattr(theirs, section), field), (section, field)
        assert getattr(ours, section).enabled
        off = load_inference_config({section: {"enabled": False}})
        assert not getattr(off, section).enabled
    with pytest.raises(ValueError):
        load_inference_config({"serving_kv_observability": {"ewma_alpha": 0.0}})
    with pytest.raises(ValueError):
        load_inference_config({"serving_kv_observability": {"age_buckets_per_decade": 101}})
    eng = _port({"serving_prefix_cache": {"enabled": False},
                 "serving_kv_observability": {"enabled": False}})
    assert eng.manager.prefix_cache is None and eng.manager.census is None
    assert eng.health()["prefix_cache"] == {"enabled": False}
    assert eng.health()["kv"] == {"enabled": False}


def test_dropped_engine_is_freed_without_the_cycle_collector():
    """The manager's copy seam is bound to the KV pool, not to the engine:
    an engine with the cache on holds no reference cycle, so dropping it
    frees its pool (and, on the card, its graphs) at once."""
    gc.disable()
    try:
        eng = _port()
        eng.generate([HEADER + [1], list(HEADER)], max_new_tokens=3)
        assert eng.health()["prefix_cache"]["cow_copies_total"] == 1
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()
