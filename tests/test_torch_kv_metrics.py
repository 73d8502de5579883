"""The port's KV-pool observability against the JAX package's.

``deepspeed_tpu_torch/inference/v2/kv_metrics.py`` and
``deepspeed_tpu_torch/monitor/tracing.py::StreamingHistogram`` are copies of
the JAX package's host-side modules; here both packages take the same seeded
inputs and must agree exactly: the chained prefix hashes byte for byte, the
histogram quantiles, and the census, observatory and forecaster snapshots
after one scripted run of alloc/share/free/refresh/retire events."""

import types

import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import blocked_allocator as jalloc
from deepspeed_tpu.inference.v2 import kv_metrics as jkv
from deepspeed_tpu.monitor.tracing import StreamingHistogram as JaxHistogram
from deepspeed_tpu_torch.inference.v2 import blocked_allocator as palloc
from deepspeed_tpu_torch.inference.v2 import kv_metrics as pkv
from deepspeed_tpu_torch.monitor.tracing import StreamingHistogram

PACKAGES = {"jax": (jkv, jalloc), "port": (pkv, palloc)}


# ------------------------------------------------------------------- hashes
@pytest.mark.parametrize("tenant", [None, "default", "acme", "tenant-ü"])
def test_tenant_namespace_bytes_equal(tenant):
    assert pkv.tenant_namespace(tenant) == jkv.tenant_namespace(tenant)


@pytest.mark.parametrize("block_size", [1, 8, 16])
@pytest.mark.parametrize("tenant", [None, "acme"])
def test_block_hashes_bytes_equal(block_size, tenant):
    rng = np.random.default_rng(block_size)
    ns = pkv.tenant_namespace(tenant)
    for n in (0, block_size - 1, block_size, 5 * block_size + 3, 64):
        tokens = rng.integers(0, 32000, n).tolist()
        got = pkv.block_hashes(tokens, block_size, ns)
        assert got == jkv.block_hashes(tokens, block_size, ns)
        assert len(got) == n // block_size
        assert all(isinstance(h, bytes) and len(h) == 16 for h in got)
    # chaining: equal hash i iff the first (i + 1) blocks are equal
    a = list(range(4 * block_size))
    b = a[:2 * block_size] + [7] * (2 * block_size)
    ha, hb = pkv.block_hashes(a, block_size, ns), pkv.block_hashes(b, block_size, ns)
    assert ha[:2] == hb[:2] and ha[2] != hb[2]


# ---------------------------------------------------------------- histogram
@pytest.mark.parametrize("bpd,min_value", [(6, 1e-5), (3, 1.0), (20, 1e-3)])
def test_streaming_histogram_quantiles_equal(bpd, min_value):
    rng = np.random.default_rng(bpd)
    values = np.concatenate([[0.0, min_value, min_value * 10],
                             rng.lognormal(0.0, 3.0, 500)]).tolist()
    ours, theirs = StreamingHistogram(bpd, min_value), JaxHistogram(bpd, min_value)
    for v in values:
        ours.add(v)
        theirs.add(v)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0, 1.5):
        assert ours.quantile(q) == theirs.quantile(q)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.counts == theirs.counts
    # merge of two halves equals the whole (the mean up to summation order)
    a, b = StreamingHistogram(bpd, min_value), StreamingHistogram(bpd, min_value)
    for i, v in enumerate(values):
        (a if i % 2 else b).add(v)
    a.merge(b)
    assert a.counts == ours.counts and a.percentiles() == ours.percentiles()
    assert a.total == pytest.approx(ours.total, rel=1e-12) and a.max_seen == ours.max_seen
    with pytest.raises(ValueError, match="shape mismatch"):
        a.merge(StreamingHistogram(bpd + 1, min_value))
    assert StreamingHistogram().snapshot() == JaxHistogram().snapshot()


# ---------------------------------------------------- scripted pool events
BS, NUM_BLOCKS = 4, 24


def _seq(uid, tokens):
    return types.SimpleNamespace(uid=uid, tokens=list(tokens), seen_tokens=0, blocks=[],
                                 prompt_len=len(tokens), done=False)


def _script(kv, alloc_mod):
    """One run of pool events through a package's KVObservability and
    allocator, recording every snapshot the engine exposes."""
    obs = kv.KVObservability(BS, NUM_BLOCKS, NUM_BLOCKS - 1, ewma_alpha=0.3,
                             pressure_steps=40.0, age_buckets_per_decade=4)
    census = obs.census
    alloc = alloc_mod.BlockedAllocator(NUM_BLOCKS)
    rng = np.random.default_rng(0)
    header = rng.integers(0, 100, 3 * BS).tolist()
    seqs = {}
    record = []
    step = [0]

    def grow(seq, upto):
        need = -(-upto // BS) - len(seq.blocks)
        if need > 0:
            got = alloc.allocate(need)
            seq.blocks.extend(got)
            census.on_alloc(seq.uid, got)

    def release(seq, keep):
        dropped = seq.blocks[keep:]
        alloc.free(dropped)
        census.on_free(seq.uid, dropped)
        seq.blocks = seq.blocks[:keep]

    def refresh(k=1):
        step[0] += k
        obs.refresh(seqs, step[0], alloc.free_blocks)
        record.append(("crossing", obs.pressure_crossing()))
        record.append(("snapshot", obs.snapshot(alloc.free_blocks)))
        record.append(("table", census.table()))
        obs.check_invariant(alloc, seqs)

    # a writer prefills the header and a tail; two sharers map the header
    prompts = {0: header + [1, 2, 3], 1: header + [4, 5], 2: header + [6] * 9,
               3: rng.integers(0, 100, 11).tolist()}
    record.append(("observe", obs.prefix.observe({0: prompts[0], 1: prompts[1]})))
    seqs[0] = _seq(0, prompts[0])
    grow(seqs[0], 8)
    seqs[0].seen_tokens = 8
    refresh()
    grow(seqs[0], len(prompts[0]))
    seqs[0].seen_tokens = len(prompts[0])
    refresh()
    for uid in (1, 2):
        seqs[uid] = _seq(uid, prompts[uid])
        for b in seqs[0].blocks[:3]:
            alloc.incref(b)
            census.on_share(uid, b)
            seqs[uid].blocks.append(b)
        seqs[uid].seen_tokens = 3 * BS
    record.append(("observe", obs.prefix.observe(
        {u: (None if obs.prefix.has(u) else prompts[u]) for u in (0, 1)}
        | {2: prompts[2]})))
    refresh()
    # the sharers and an unrelated request prefill and decode
    for uid in (1, 2):
        grow(seqs[uid], len(prompts[uid]) + 1)
        seqs[uid].seen_tokens = len(prompts[uid])
    seqs[3] = _seq(3, prompts[3])
    grow(seqs[3], 11)
    seqs[3].seen_tokens = 7
    refresh(3)
    for _ in range(4):
        for s in seqs.values():
            grow(s, s.seen_tokens + 2)
            s.seen_tokens += 1
        refresh(2)
    # preemption into the shared region: only private blocks return
    release(seqs[2], 2)
    seqs[2].seen_tokens = 2 * BS
    refresh()
    # the writer retires first, the sharers keep the header alive
    release(seqs[0], 0)
    del seqs[0]
    census.on_terminal(0)
    refresh()
    for uid in (1, 2, 3):
        release(seqs[uid], 0)
        del seqs[uid]
        census.on_terminal(uid)
        refresh(5)
    record.append(("observe", obs.prefix.observe({4: header + [9]})))
    record.append(("rollup", census.rollup(alloc.free_blocks)))
    record.append(("forecast", obs.forecaster.snapshot()))
    record.append(("totals", (census.blocks_allocated_total, census.blocks_freed_total,
                              obs.invariant_checks_total, obs.pressure_events_total)))
    return record


def test_scripted_pool_events_snapshots_equal():
    ours = _script(*PACKAGES["port"])
    theirs = _script(*PACKAGES["jax"])
    assert len(ours) == len(theirs)
    for (tag, a), (tag2, b) in zip(ours, theirs):
        assert tag == tag2
        assert a == b, tag
    # the script reaches sharing, a pressure crossing and a drained pool
    snaps = [v for t, v in ours if t == "snapshot"]
    assert max(s["census"]["shared_blocks"] for s in snaps) == 3
    assert any(v is not None for t, v in ours if t == "crossing")
    rollup = dict(ours)["rollup"]
    assert rollup["allocated_blocks"] == 0 and rollup["free_blocks"] == NUM_BLOCKS - 1
    assert rollup["blocks_per_request"]["count"] == 4
    assert snaps[-1]["prefix"]["prefill_tokens_saved_total"] == 6 * BS


def test_capacity_forecaster_equal_on_bursty_steps():
    ours, theirs = pkv.CapacityForecaster(0.25), jkv.CapacityForecaster(0.25)
    rng = np.random.default_rng(4)
    allocs = frees = step = 0
    for _ in range(40):
        allocs += int(rng.integers(0, 9))
        frees += int(rng.integers(0, 7))
        step += int(rng.integers(1, 9))  # a burst of k advances k steps
        free = int(rng.integers(0, 500))
        for f in (ours, theirs):
            f.update(allocs, frees, free, step=step)
        assert ours.snapshot() == theirs.snapshot()
    ours.update(allocs, frees + 10**6, 7)  # draining: no exhaustion forecast
    theirs.update(allocs, frees + 10**6, 7)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.steps_to_exhaustion() is None


@pytest.mark.parametrize("fault", ["owned_and_free", "leak", "refcount_drift", "foreign_kv"])
def test_census_invariant_errors_equal(fault):
    """Each way the census can disagree with the pool raises the same
    ``CensusInvariantError`` (message, block, uids) in both packages."""
    def run(kv, alloc_mod):
        census = kv.BlockCensus(BS, 8, 7)
        alloc = alloc_mod.BlockedAllocator(8)
        a = _seq(0, list(range(9)))
        b = _seq(1, list(range(8)) + [50])
        a.blocks = alloc.allocate(3)
        census.on_alloc(0, a.blocks)
        for blk in a.blocks[:2]:
            alloc.incref(blk)
            census.on_share(1, blk)
            b.blocks.append(blk)
        seqs = {0: a, 1: b}
        census.check_against(alloc, seqs)
        if fault == "owned_and_free":
            alloc.free([a.blocks[2]])
        elif fault == "leak":
            census.on_free(0, [a.blocks[2]])
        elif fault == "refcount_drift":
            alloc.incref(a.blocks[0])
        else:
            b.tokens[5] = 999
        with pytest.raises(kv.CensusInvariantError) as exc:
            census.check_against(alloc, seqs)
        return str(exc.value), exc.value.block, exc.value.uid, exc.value.uid2

    ours, theirs = run(*PACKAGES["port"]), run(*PACKAGES["jax"])
    assert ours == theirs
    if fault == "foreign_kv":
        assert {ours[2], ours[3]} == {0, 1} and "observing another's KV" in ours[0]
