"""Block-level observability over the paged KV pool.

Counterpart of ``deepspeed_tpu/inference/v2/kv_metrics.py``, the same
bookkeeping over the same host state; the prefix hashes are equal to the JAX
package's byte for byte, so both packages key shared blocks alike.  The
blocked allocator knows a free list; this module answers which blocks are
shared, which are cold, how fragmented the pool is, and how many steps of
headroom remain before shed/preempt pressure starts:

- :class:`BlockCensus` — per-block bookkeeping (owner uids, allocated-at
  step, last-touched step, tokens resident) fed by the ragged manager's
  alloc/share/free/retire seams, with pool-level rollups: utilization,
  fragmentation (allocated-but-unfilled token slots), a block-age histogram
  on :class:`~...monitor.tracing.StreamingHistogram`, and a blocks-per-request
  distribution sampled at each sequence's terminal.  The census's owned-block
  set must exactly partition against the allocator's free list at all times —
  :meth:`BlockCensus.check_against` turns the allocator's double-free guard
  into a continuously-checked pool invariant (:class:`CensusInvariantError`
  names the offending uid/block), with the refcount and shared-content
  checks of copy-on-write prefix sharing riding along.
- :class:`PrefixObservatory` — hashes full prompt token-blocks with the
  chained token-block hash the prefix cache keys on (:func:`block_hashes`),
  and reports per serve pass the COUNTERFACTUAL prefix-cache win across
  live + admitted requests: duplicate-block count, prefill tokens sharing
  would have saved, and a would-be hit-rate.  The realized savings of
  ``ragged_manager.PrefixCache`` are held to it.
- :class:`CapacityForecaster` — EWMA of block alloc/free rates per serve
  step yielding a steps-to-exhaustion gauge, so overload becomes
  predictable instead of observed after the fact.

Timing discipline: every input is a python int the host already owns —
census hooks fire at manager bookkeeping points, the refresh walks
``seen_tokens``/block tables, the observatory hashes prompt lists.  Nothing
here touches a device or makes a device sync, so the serve loop's
``ServeCounters`` are byte-identical with observability on and off.  Nothing
here imports torch or numpy.
"""

import dataclasses
import hashlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ...monitor.tracing import StreamingHistogram


class CensusInvariantError(RuntimeError):
    """The census's owned-block set stopped partitioning the allocator's free
    list — either a block is owned by a sequence AND on the free list (the
    aliasing bug class the allocator's double-free guard exists for) or a block
    vanished from both sides (a leak) — or, with copy-on-write prefix sharing,
    a shared block's bookkeeping went inconsistent: census owners
    disagree with the allocator refcount, or two mappers' token ids for the
    block differ (one request would observe another's KV).  Carries the
    offending block id and, when known, the owning uid(s)."""

    def __init__(self, message: str, *, block: Optional[int] = None,
                 uid: Optional[int] = None, uid2: Optional[int] = None):
        super().__init__(message)
        self.block = block
        self.uid = uid
        self.uid2 = uid2


@dataclasses.dataclass
class BlockRecord:
    """One allocated block's census entry (all host ints).  ``owners`` lists
    every sequence mapping the block — one entry for a private block, more
    under copy-on-write prefix sharing; the record lives until the last
    mapping is released (mirroring the allocator refcount)."""
    owners: List[int]         # mapping sequences (first = the allocating writer)
    allocated_step: int       # scheduler step at allocation
    last_touched_step: int    # scheduler step of the last resident-token change
    tokens_resident: int = 0  # KV positions actually written into this block

    @property
    def uid(self) -> int:
        """The allocating (writer) uid — the single-owner view pre-sharing
        callers read."""
        return self.owners[0]

    def as_dict(self) -> Dict[str, Any]:
        return {"uid": self.uid, "owners": list(self.owners),
                "allocated_step": self.allocated_step,
                "last_touched_step": self.last_touched_step,
                "tokens_resident": self.tokens_resident}


class BlockCensus:
    """Per-block bookkeeping over the paged KV pool.

    Hooks (:meth:`on_alloc` / :meth:`on_free`) fire from the ragged manager's
    single reclaim seam, so every path that moves a block — prefill growth,
    burst pre-allocation and rollback, preemption, eviction, failure,
    retirement — keeps the census exact.  :meth:`refresh` runs at wave
    boundaries on the engine's step counter and updates resident-token counts
    and last-touched stamps from ``seen_tokens`` (pure host arithmetic).

    Ages are measured in SCHEDULER STEPS, not wall time: deterministic under
    any clock, so FakeClock tests assert exact quantiles.
    """

    def __init__(self, block_size: int, num_blocks: int, trash_block: int, *,
                 age_buckets_per_decade: int = 6):
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.trash_block = int(trash_block)
        self.step = 0
        self.blocks: Dict[int, BlockRecord] = {}
        # lifetime flow counters (the forecaster's inputs)
        self.blocks_allocated_total = 0
        self.blocks_freed_total = 0
        # peak blocks each live uid has held; sampled into the
        # blocks-per-request distribution at the sequence's retirement — the
        # per-request KV footprint the prefix-cache sizing will read
        self._peak_blocks: Dict[int, int] = {}
        self._held_blocks: Dict[int, int] = {}
        # running resident-token total, maintained incrementally by
        # refresh/on_free so fragmentation_tokens() is O(1) — it is read on
        # every decode step (serving gauges, peak tracking, counter track)
        # and a per-step full-pool walk would tax large pools for nothing
        self._resident_total = 0
        # callbacks run when a sequence's pool life ends (retire): the
        # engine's KVObservability subscribes the prefix observatory's cache
        # invalidation here, so a reused uid is charged as the NEW request
        # it is instead of riding the dead request's cached hashes
        self.terminal_listeners: List[Any] = []
        # seen_tokens at each uid's previous refresh: residency is a pure
        # function of (seen_tokens, block index), so a refresh only needs to
        # touch the blocks inside [prev_seen, seen) — unchanged sequences
        # cost one dict lookup instead of a full block-table walk per wave
        self._last_seen: Dict[int, int] = {}
        self._age_bpd = int(age_buckets_per_decade)
        self.blocks_per_request = StreamingHistogram(self._age_bpd, 1.0)
        # high-water marks, sampled at each refresh: a completed scenario
        # always ends with an empty pool, so POINT-IN-TIME fragmentation at
        # the end carries no signal — the peaks are what sizing reads
        self.peak_fragmentation_tokens = 0
        self.peak_allocated_blocks = 0

    # -------------------------------------------------------------- hooks
    def on_alloc(self, uid: int, blocks: Iterable[int]) -> None:
        uid = int(uid)
        n = 0
        for b in blocks:
            self.blocks[int(b)] = BlockRecord(owners=[uid],
                                              allocated_step=self.step,
                                              last_touched_step=self.step)
            n += 1
        self.blocks_allocated_total += n
        held = self._held_blocks.get(uid, 0) + n
        self._held_blocks[uid] = held
        if held > self._peak_blocks.get(uid, 0):
            self._peak_blocks[uid] = held

    def on_share(self, uid: int, block: int) -> None:
        """A sequence mapped an existing block read-only (copy-on-write
        prefix sharing): the block gains an owner — NOT an
        allocation; the flow counters and the forecaster see only real
        pool movement."""
        uid = int(uid)
        rec = self.blocks.get(int(block))
        if rec is not None:
            rec.owners.append(uid)
        held = self._held_blocks.get(uid, 0) + 1
        self._held_blocks[uid] = held
        if held > self._peak_blocks.get(uid, 0):
            self._peak_blocks[uid] = held

    def on_free(self, uid: int, blocks: Iterable[int]) -> None:
        """Release ``uid``'s mapping of each block; the record (and the
        freed-flow counter) goes only when the LAST owner lets go —
        mirroring the allocator's refcount-zero release."""
        uid = int(uid)
        n = 0
        fully = 0
        for b in blocks:
            b = int(b)
            rec = self.blocks.get(b)
            if rec is None:
                continue
            n += 1
            if uid in rec.owners:
                rec.owners.remove(uid)
            if not rec.owners:
                del self.blocks[b]
                self._resident_total -= rec.tokens_resident
                fully += 1
        self.blocks_freed_total += fully
        if uid in self._held_blocks:
            self._held_blocks[uid] = max(self._held_blocks[uid] - n, 0)

    def on_terminal(self, uid: int) -> None:
        """A sequence's pool life ended (manager ``retire``): sample its PEAK
        held blocks into the blocks-per-request distribution (evictions and
        failures free their blocks before retirement, so sampling current
        holdings there would undercount; zero-peak requests still sample —
        they are the shed-adjacent tail the distribution should show)."""
        uid = int(uid)
        self.blocks_per_request.add(float(self._peak_blocks.pop(uid, 0)))
        self._held_blocks.pop(uid, None)
        self._last_seen.pop(uid, None)
        for listener in self.terminal_listeners:
            listener(uid)

    def refresh(self, seqs: Dict[int, Any], step: int) -> None:
        """Wave-boundary update: advance the census step and refresh resident
        tokens / last-touched stamps from each live sequence's ``seen_tokens``
        (block ``i`` of a sequence holds positions ``[i*bs, (i+1)*bs)``).

        Incremental: residency is a pure function of ``(seen_tokens, block
        index)``, so only the blocks whose index range the seen-pointer
        crossed since the previous refresh are touched — an unchanged
        sequence costs one dict lookup, not a block-table walk."""
        self.step = int(step)
        bs = self.block_size
        for uid, seq in seqs.items():
            seen = seq.seen_tokens
            prev = self._last_seen.get(uid, 0)
            if seen == prev:
                continue  # new blocks (burst pre-alloc) start resident 0
            self._last_seen[uid] = seen
            lo = min(prev, seen) // bs
            hi = min(-(-max(prev, seen) // bs), len(seq.blocks))
            for i in range(lo, hi):
                rec = self.blocks.get(int(seq.blocks[i]))
                if rec is None:
                    continue  # the invariant check reports this, not refresh
                resident = min(max(seen - i * bs, 0), bs)
                if len(rec.owners) > 1:
                    # a shared block is full by construction (only completed
                    # prompt blocks are mappable); one owner's rollback must
                    # not mark KV absent that the other owners still read
                    resident = max(resident, rec.tokens_resident)
                if resident != rec.tokens_resident:
                    self._resident_total += resident - rec.tokens_resident
                    rec.tokens_resident = resident
                    rec.last_touched_step = self.step
        frag = self.fragmentation_tokens()
        if frag > self.peak_fragmentation_tokens:
            self.peak_fragmentation_tokens = frag
        if self.allocated_blocks > self.peak_allocated_blocks:
            self.peak_allocated_blocks = self.allocated_blocks

    # ------------------------------------------------------------ rollups
    @property
    def allocated_blocks(self) -> int:
        return len(self.blocks)

    def shared_blocks(self) -> int:
        """Blocks currently mapped by more than one sequence (copy-on-write
        prefix sharing) — the one home for this definition, which the rollup
        reads.  Iterates a GIL-atomic list copy:
        health() threads call this while the serve thread allocates/frees."""
        return sum(1 for rec in list(self.blocks.values())
                   if len(rec.owners) > 1)

    def tokens_resident(self) -> int:
        return self._resident_total

    def fragmentation_tokens(self) -> int:
        """Allocated-but-unfilled token slots: pool bytes paid for but not yet
        holding KV (prefill in flight, burst pre-allocation, block-granularity
        waste).  O(1):
        the resident total is maintained incrementally, never re-walked."""
        return self.allocated_blocks * self.block_size - self._resident_total

    def age_histogram(self) -> StreamingHistogram:
        """Block ages (census step - allocated step) as a log histogram —
        rebuilt on demand so it always describes the CURRENT pool, not an
        accumulation over dead blocks.  Age 0 lands in the underflow bucket
        (representative 0.0); quantiles are deterministic."""
        hist = StreamingHistogram(self._age_bpd, 1.0)
        # list copy: built on demand from health() threads while the
        # serve thread mutates the census — iterating the live dict crashes
        for rec in list(self.blocks.values()):
            hist.add(float(self.step - rec.allocated_step))
        return hist

    def idle_histogram(self) -> StreamingHistogram:
        """Steps since each block was last touched — the cold-block signal an
        age-aware quantization policy would key on."""
        hist = StreamingHistogram(self._age_bpd, 1.0)
        for rec in list(self.blocks.values()):  # list copy: see age_histogram
            hist.add(float(self.step - rec.last_touched_step))
        return hist

    def rollup(self, free_blocks: int) -> Dict[str, Any]:
        usable = max(self.num_blocks - 1, 1)  # trash never allocated
        return {
            "step": self.step,
            "allocated_blocks": self.allocated_blocks,
            "shared_blocks": self.shared_blocks(),
            "free_blocks": int(free_blocks),
            "usable_blocks": usable,
            "utilization": self.allocated_blocks / usable,
            "tokens_resident": self.tokens_resident(),
            "fragmentation_tokens": self.fragmentation_tokens(),
            "peak_fragmentation_tokens": self.peak_fragmentation_tokens,
            "peak_allocated_blocks": self.peak_allocated_blocks,
            "blocks_allocated_total": self.blocks_allocated_total,
            "blocks_freed_total": self.blocks_freed_total,
            "block_age_steps": self.age_histogram().snapshot(),
            "block_idle_steps": self.idle_histogram().snapshot(),
            "blocks_per_request": self.blocks_per_request.snapshot(),
        }

    def table(self) -> Dict[int, Dict[str, int]]:
        """The full per-block census (diagnostics; bounded by
        the pool size).  Sorts a GIL-atomic list copy — diagnostics threads
        read this while the serve thread allocates/frees."""
        return {b: rec.as_dict()
                for b, rec in sorted(list(self.blocks.items()))}

    # ---------------------------------------------------------- invariant
    def check_against(self, allocator, seqs: Optional[Dict[int, Any]] = None) -> None:
        """The census's owned set and the allocator's free list must exactly
        partition the usable pool; with copy-on-write sharing the refcount
        invariant rides along — every census owner list must agree with the
        allocator refcount, and (when ``seqs`` is provided) every mapper of a
        shared block must hold IDENTICAL token ids for the block's positions,
        or one request would be reading another's KV.  Raises
        :class:`CensusInvariantError` naming the first offending uid/block
        (and both uids for a shared-content violation); returns None when the
        invariant holds."""
        free = allocator.free_block_set()
        owned = set(self.blocks)
        both = owned & free
        if both:
            b = min(both)
            uid = self.blocks[b].uid
            raise CensusInvariantError(
                f"block {b} is owned by uid {uid} (census) AND on the "
                f"allocator free list — the double-free/aliasing bug class; "
                f"{len(both)} block(s) affected", block=b, uid=uid)
        usable = set(range(self.num_blocks)) - {self.trash_block}
        missing = usable - owned - free
        if missing:
            b = min(missing)
            raise CensusInvariantError(
                f"block {b} is neither census-owned nor on the allocator "
                f"free list — {len(missing)} block(s) leaked", block=b)
        extra = (owned | free) - usable
        if extra:
            b = min(extra)
            uid = self.blocks[b].uid if b in self.blocks else None
            raise CensusInvariantError(
                f"block {b} is outside the usable pool (trash block "
                f"{self.trash_block} excluded from [0, {self.num_blocks})) "
                f"yet tracked"
                + (f" by uid {uid}" if uid is not None else " as free"),
                block=b, uid=uid)
        # refcount agreement: owners-per-block must equal the allocator's
        # outstanding mappings (a drifted count frees too early or leaks)
        if hasattr(allocator, "refcount"):
            for b, rec in self.blocks.items():
                refs = allocator.refcount(b)
                if refs != len(rec.owners):
                    raise CensusInvariantError(
                        f"block {b}: census lists {len(rec.owners)} owner(s) "
                        f"{rec.owners} but the allocator refcount is {refs} — "
                        f"a mapping was gained or released without the other "
                        f"side noticing", block=b, uid=rec.owners[0])
        if seqs is not None:
            self._check_shared_content(seqs)

    def _check_shared_content(self, seqs: Dict[int, Any]) -> None:
        """Every mapper of a shared block must hold the SAME token ids for
        the block's position range — the no-request-observes-another's-KV
        invariant the prefix tree's token verification exists to uphold —
        AND belong to the same tenant: the tenant-seeded hash chain makes
        cross-tenant sharing impossible by keying, and this audit proves it
        stayed impossible through CoW maps, rollbacks and reclaims."""
        bs = self.block_size
        for b, rec in self.blocks.items():
            if len(rec.owners) < 2:
                continue
            tenants = {getattr(seqs[uid], "tenant", "default")
                       for uid in rec.owners if uid in seqs}
            if len(tenants) > 1:
                raise CensusInvariantError(
                    f"block {b} is shared ACROSS tenants {sorted(tenants)} — "
                    f"the per-tenant hash namespace was bypassed; one "
                    f"tenant can time another's cache", block=b,
                    uid=rec.owners[0])
            reference: Optional[List[int]] = None
            ref_uid: Optional[int] = None
            for uid in rec.owners:
                seq = seqs.get(uid)
                if seq is None:
                    raise CensusInvariantError(
                        f"block {b} is mapped by uid {uid} which the manager "
                        f"no longer tracks — its mapping was never released",
                        block=b, uid=uid)
                if b not in seq.blocks:
                    raise CensusInvariantError(
                        f"block {b} lists uid {uid} as an owner but is absent "
                        f"from that sequence's block table", block=b, uid=uid)
                i = seq.blocks.index(b)
                slice_ = [int(t) for t in seq.tokens[i * bs:(i + 1) * bs]]
                if reference is None:
                    reference, ref_uid = slice_, uid
                elif slice_ != reference:
                    raise CensusInvariantError(
                        f"shared block {b} maps DIFFERENT content for uid "
                        f"{ref_uid} and uid {uid} — one request is observing "
                        f"another's KV", block=b, uid=ref_uid, uid2=uid)


# ==========================================================================
# Prefix-sharing opportunity analysis
# ==========================================================================

def tenant_namespace(tenant: Optional[str]) -> bytes:
    """Hash-chain seed for a tenant's prefix keying.  The default tenant
    keeps the empty seed (single-tenant hashes are byte-identical with or
    without tenants); any other tenant seeds the chain with its id, so two
    tenants' byte-identical prompts hash to DISJOINT chains and can never
    share a block (the cross-tenant cache-timing side-channel is closed
    structurally, not by a lookup-time filter)."""
    if not tenant or tenant == "default":
        return b""
    return b"tenant:" + tenant.encode("utf-8", "surrogatepass")


def block_hashes(tokens: List[int], block_size: int,
                 namespace: bytes = b"") -> List[bytes]:
    """Chained token-block hashes over the FULL blocks of ``tokens`` — the
    exact keying a copy-on-write prefix tree will use: block ``i``'s hash
    covers its own tokens AND its ancestry (hash chaining), so two sequences
    share hash ``i`` iff their first ``(i+1) * block_size`` tokens are
    identical.  Partial trailing blocks are excluded (they can never be
    shared read-only).  ``namespace`` seeds the chain root (see
    :func:`tenant_namespace`); the default empty seed keeps the
    single-tenant keying."""
    out: List[bytes] = []
    parent = namespace
    for i in range(len(tokens) // block_size):
        chunk = tokens[i * block_size:(i + 1) * block_size]
        h = hashlib.blake2b(digest_size=16)
        h.update(parent)
        h.update(",".join(str(int(t)) for t in chunk).encode())
        parent = h.digest()
        out.append(parent)
    return out


class PrefixObservatory:
    """Counterfactual prefix-cache win, measured per serve pass.

    :meth:`observe` takes the prompt token histories of every live + admitted
    request in a pass and reports what a block-granular prefix cache WOULD
    have saved: for each chained block hash seen ``n`` times, ``n - 1``
    prefills were duplicates.  ``hit_rate`` is duplicate blocks over total
    full prompt blocks — exactly the cache hit-rate a prefix tree keyed on
    these hashes reports, which is what ``PrefixCache``'s realized savings
    are checked against.
    """

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self.passes_total = 0
        self.prompt_blocks_total = 0
        self.duplicate_blocks_total = 0
        self.prefill_tokens_saved_total = 0
        self.last_report: Dict[str, Any] = self._empty_report()
        # per-uid hash cache: a live sequence's prompt is immutable for its
        # whole life (add_sequence refuses duplicate live uids), so its
        # chained block hashes are computed exactly once; :meth:`forget` —
        # wired to the census's retirement listener — invalidates on uid
        # reuse, and entries for uids absent from a pass are pruned as a
        # backstop, so long-lived servers stay bounded by the live set
        self._hash_cache: Dict[int, List[bytes]] = {}

    @staticmethod
    def _empty_report() -> Dict[str, Any]:
        return {"requests": 0, "prompt_blocks": 0, "unique_blocks": 0,
                "duplicate_blocks": 0, "prefill_tokens_saved": 0,
                "hit_rate": 0.0}

    def has(self, uid: int) -> bool:
        """True when ``uid``'s prompt hashes are cached — callers may then
        pass ``None`` as its observe() entry and skip building the token
        list entirely (the per-intake fast path)."""
        return int(uid) in self._hash_cache

    def observe(self, prompts: Dict[int, Optional[List[int]]]) -> Dict[str, Any]:
        """``prompts``: uid -> prompt token history (live requests contribute
        their prompt portion, admitted requests their full prompt), or
        ``None`` for a uid whose hashes are cached (:meth:`has`) — the
        caller then skips materializing the token list.  Returns (and caches
        as ``last_report``) this pass's counterfactual report.

        Two accountings with different lifetimes:

        - ``last_report`` is the INSTANTANEOUS view: duplicates across
          everything live right now (the live gauge).
        - The lifetime ``*_total`` counters charge each request ONCE, at its
          first observation: the blocks of its prompt that already existed in
          the then-live set (or in an earlier request of the same intake) are
          the prefills a cache would actually have skipped — re-observing a
          still-live request on a later pass adds nothing, so the totals are
          a realizable A/B target, not an overcount.
        """
        counts: Dict[bytes, int] = {}
        total_blocks = 0
        cache = self._hash_cache
        new_uids: List[int] = []
        per_uid: Dict[int, List[bytes]] = {}
        for uid, tokens in prompts.items():
            hashes = cache.get(uid)
            if hashes is None:
                if tokens is None:
                    continue  # caller promised a cache hit that isn't there
                hashes = block_hashes(tokens, self.block_size)
                cache[uid] = hashes
                new_uids.append(uid)
            per_uid[uid] = hashes
            for h in hashes:
                counts[h] = counts.get(h, 0) + 1
                total_blocks += 1
        for uid in list(cache):
            if uid not in prompts:
                del cache[uid]
        # lifetime accounting: walk the NEW requests in intake order, counting
        # each one's blocks already present in the prior live set or an
        # earlier new request — exactly the prefills sharing would have saved
        new_set = set(new_uids)
        seen: set = set()
        for uid, hashes in per_uid.items():
            if uid not in new_set:
                seen.update(hashes)
        new_dup = 0
        new_blocks = 0
        for uid in new_uids:
            for h in per_uid[uid]:
                new_blocks += 1
                if h in seen:
                    new_dup += 1
                else:
                    seen.add(h)
        duplicates = total_blocks - len(counts)
        self.passes_total += 1
        self.prompt_blocks_total += new_blocks
        self.duplicate_blocks_total += new_dup
        self.prefill_tokens_saved_total += new_dup * self.block_size
        self.last_report = {
            "requests": len(prompts),
            "prompt_blocks": total_blocks,
            "unique_blocks": len(counts),
            "duplicate_blocks": duplicates,
            "prefill_tokens_saved": duplicates * self.block_size,
            "hit_rate": duplicates / total_blocks if total_blocks else 0.0,
        }
        return self.last_report

    def forget(self, uid: int) -> None:
        """Drop a uid's cached hashes (its request ended): the next prompt
        under this uid is a NEW request and must be charged to the lifetime
        counters even when its tokens are identical."""
        self._hash_cache.pop(int(uid), None)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "passes_total": self.passes_total,
            "prompt_blocks_total": self.prompt_blocks_total,
            "duplicate_blocks_total": self.duplicate_blocks_total,
            "prefill_tokens_saved_total": self.prefill_tokens_saved_total,
            "last_pass": dict(self.last_report),
        }


# ==========================================================================
# Capacity forecasting
# ==========================================================================

class CapacityForecaster:
    """EWMA of block alloc/free rates per SERVE STEP, yielding a
    steps-to-exhaustion gauge.

    Each :meth:`update` consumes the census's lifetime alloc/free totals (the
    deltas since the previous update are this interval's flows) and the
    current free-block count.  ``step`` is the engine's serve-step clock —
    a stepwise dispatch advances it by 1, a fused decode burst of k by k —
    so the deltas are normalized to per-step rates and
    ``steps_to_exhaustion`` means the same thing on a burst-heavy serve as
    on a stepwise one (omitting ``step`` treats each update as one step).
    ``steps_to_exhaustion`` is free blocks over the smoothed NET consumption
    rate — ``None`` while the pool is not trending toward exhaustion, so a monitor
    alarms on "finite and small", the predictable-overload signal this
    forecaster exists for.
    """

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self.alloc_rate = 0.0
        self.free_rate = 0.0
        self.updates = 0
        self._last_allocs = 0
        self._last_frees = 0
        self._last_step: Optional[int] = None
        self.free_blocks = 0

    def update(self, allocs_total: int, frees_total: int,
               free_blocks: int, step: Optional[int] = None) -> None:
        d_alloc = max(int(allocs_total) - self._last_allocs, 0)
        d_free = max(int(frees_total) - self._last_frees, 0)
        d_steps = 1
        if step is not None:
            if self._last_step is not None:
                d_steps = max(int(step) - self._last_step, 1)
            self._last_step = int(step)
        self._last_allocs = int(allocs_total)
        self._last_frees = int(frees_total)
        self.free_blocks = int(free_blocks)
        alloc_sample = d_alloc / d_steps
        free_sample = d_free / d_steps
        if self.updates == 0:
            self.alloc_rate = alloc_sample
            self.free_rate = free_sample
        else:
            a = self.alpha
            self.alloc_rate += a * (alloc_sample - self.alloc_rate)
            self.free_rate += a * (free_sample - self.free_rate)
        self.updates += 1

    @property
    def net_rate(self) -> float:
        """Smoothed net blocks consumed per serve step (negative = draining)."""
        return self.alloc_rate - self.free_rate

    def steps_to_exhaustion(self) -> Optional[float]:
        net = self.net_rate
        if net <= 1e-9:
            return None  # not trending toward exhaustion
        return self.free_blocks / net

    def snapshot(self) -> Dict[str, Any]:
        return {
            "alloc_rate_blocks_per_step": self.alloc_rate,
            "free_rate_blocks_per_step": self.free_rate,
            "net_rate_blocks_per_step": self.net_rate,
            "free_blocks": self.free_blocks,
            "steps_to_exhaustion": self.steps_to_exhaustion(),
            "updates": self.updates,
        }


# ==========================================================================
# The engine-facing facade
# ==========================================================================

class KVObservability:
    """What the engine owns: one census + one observatory + one forecaster,
    plus the pressure-event edge detector a request tracer consumes.

    ``pressure_steps`` is the steps-to-exhaustion threshold below which the
    pool counts as under pressure; :meth:`pressure_crossing` reports only the
    CROSSINGS (entered/cleared), so a long pressure episode is two
    events, not one per iteration."""

    def __init__(self, block_size: int, num_blocks: int, trash_block: int, *,
                 ewma_alpha: float = 0.2, pressure_steps: float = 64.0,
                 age_buckets_per_decade: int = 6):
        self.census = BlockCensus(block_size, num_blocks, trash_block,
                                  age_buckets_per_decade=age_buckets_per_decade)
        self.prefix = PrefixObservatory(block_size)
        # retirement invalidates the prefix hash cache: a reused uid (the
        # generate() API numbers requests 0..n-1 every call) must be charged
        # to the lifetime counterfactual as the new request it is
        self.census.terminal_listeners.append(self.prefix.forget)
        self.forecaster = CapacityForecaster(ewma_alpha)
        self.pressure_steps = float(pressure_steps)
        self.under_pressure = False
        self.pressure_events_total = 0
        self.invariant_checks_total = 0

    def refresh(self, seqs: Dict[int, Any], step: int,
                free_blocks: int) -> None:
        """Wave-boundary refresh: census resident/touch update + forecaster
        rate sample, all from host ints the serve loop already holds.
        ``step`` is the SERVE-STEP clock (a fused burst of k advances it by
        k), so ages and rates mean the same thing on every decode path."""
        self.census.refresh(seqs, step)
        self.forecaster.update(self.census.blocks_allocated_total,
                               self.census.blocks_freed_total, free_blocks,
                               step=step)

    def pressure_crossing(self) -> Optional[Tuple[str, float]]:
        """('entered'|'cleared', steps_to_exhaustion) when the pressure state
        just flipped; None otherwise."""
        ste = self.forecaster.steps_to_exhaustion()
        pressured = ste is not None and ste < self.pressure_steps
        if pressured == self.under_pressure:
            return None
        self.under_pressure = pressured
        if pressured:
            self.pressure_events_total += 1
            return ("entered", float(ste))
        return ("cleared", float("inf") if ste is None else float(ste))

    def check_invariant(self, allocator, seqs: Optional[Dict[int, Any]] = None) -> None:
        self.invariant_checks_total += 1
        self.census.check_against(allocator, seqs)

    def snapshot(self, free_blocks: int) -> Dict[str, Any]:
        """The ``health()["kv"]`` payload (JSON-safe: no inf/nan)."""
        return {
            "enabled": True,
            "census": self.census.rollup(free_blocks),
            "prefix": self.prefix.snapshot(),
            "forecast": self.forecaster.snapshot(),
            "under_pressure": self.under_pressure,
            "pressure_events_total": self.pressure_events_total,
            "invariant_checks_total": self.invariant_checks_total,
        }
