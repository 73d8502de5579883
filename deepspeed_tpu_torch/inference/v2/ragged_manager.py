"""Ragged state manager — sequence tracking + block-table bookkeeping.

Counterpart of ``deepspeed_tpu/inference/v2/ragged_manager.py``: tracks live
sequences, grows their block tables as tokens are scheduled, and frees blocks
at retirement.  All host-side (numpy); the device sees only the padded
block-table array.

Sequences carry admission metadata (arrival order, priority, deadline,
preemption count); :meth:`RaggedStateManager.preempt` rolls a prefilling
victim back to a block boundary so its KV blocks can rescue starved decodes,
and the intake/retire edges validate loudly — :class:`EmptyPromptError` for a
request that could never be scheduled, :class:`UnknownSequenceError` (with the
uid's actual history) instead of a bare ``KeyError`` on a bad retire.

Copy-on-write prefix caching: :class:`PrefixCache` is the prefix tree the
``kv_metrics.PrefixObservatory`` measures the counterfactual for, keyed on
the SAME chained token-block hashes (:func:`kv_metrics.block_hashes`), so
the realized win lands against the metric that predicted it.  An admitted
request whose leading full prompt blocks match live, fully-computed blocks
maps them READ-ONLY (allocator refcount +1 per mapping) and only prefills
its divergent tail into freshly allocated private blocks; a prompt cached to
its last token copies the final block (copy-on-write — the engine provides
the device block copy) so the one recomputed position writes a private
block, never a shared one.  Entries are weak: the tree serves a block only
while some sequence still maps it (the allocator's free() reports
refcount-zero releases and the tree drops those entries), so a drained pool
is a fully-reclaimed pool.  The hash chain is seeded with the owner tenant's
namespace (``kv_metrics.tenant_namespace``): two tenants' byte-identical
prompts never share a block, and the default tenant keeps the single-tenant
keying.
"""

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .blocked_allocator import BlockedAllocator, KVAllocationError
from .kv_metrics import block_hashes, tenant_namespace

# finish reasons that mark an EVICTION (the request did not run to a useful
# completion); retire() excludes them from completed_requests even when the
# caller flushes through the default completed=True path
EVICTED_FINISH_REASONS = frozenset({"deadline_expired", "preempt_requeued_exhausted"})


class EmptyPromptError(ValueError):
    """A request arrived with zero prompt tokens.  Such a sequence has
    ``pending_tokens == 0`` forever: the scheduler never picks it, it never
    retires, and ``generate()`` would spin on it — reject at intake."""

    def __init__(self, uid: int):
        super().__init__(f"uid {uid}: empty prompt — a sequence with no pending "
                         f"tokens can never be scheduled or retired")
        self.uid = uid


class UnknownSequenceError(KeyError):
    """Retire/lookup of a uid the manager does not track, with its history
    (already retired / failed-and-flushed / never added) in the message."""

    def __init__(self, uid: int, detail: str):
        super().__init__(f"uid {uid} is not tracked by RaggedStateManager ({detail})")
        self.uid = uid


@dataclasses.dataclass
class SequenceDescriptor:
    uid: int
    tokens: List[int]  # full known token ids (prompt + generated)
    seen_tokens: int = 0  # tokens already in the KV cache
    blocks: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # --- admission / resilience metadata (inference/v2/admission.py) ---
    prompt_len: int = 0        # prompt tokens at intake; generated = len(tokens) - prompt_len
    arrival: int = 0           # monotonic intake order; preemption evicts the newest
    priority: int = 0          # lower = more urgent (admission-queue order)
    deadline: Optional[float] = None  # absolute clock time; engine evicts past it
    queue_wait_s: float = 0.0  # time spent in the admission queue
    preemptions: int = 0       # times this sequence was preempted-and-requeued
    finish_reason: Optional[str] = None  # eos | max_new_tokens | length_capped | ...
    # --- prefix-cache state ---
    # chained hashes of the FULL blocks of the prompt portion (computed once
    # at intake when the cache is armed; never covers generated tokens)
    prefix_hashes: Optional[List[bytes]] = None
    # prompt blocks already offered to the tree (mapped-from-cache blocks
    # count immediately; self-computed ones as prefill completes them) —
    # preemption rolls this back with the block table
    prefix_registered: int = 0
    # prefill tokens this sequence skipped by mapping shared blocks
    prefix_cached_tokens: int = 0
    # multi-tenant QoS identity: owner tenant + service class, carried from
    # the admission ticket — the prefix-cache keying folds the tenant in
    # (cross-tenant sharing is impossible) and KV-pressure preemption
    # prefers over-quota / lower-class victims
    tenant: str = "default"
    service_class: str = "interactive"

    @property
    def pending_tokens(self) -> int:
        return len(self.tokens) - self.seen_tokens

    @property
    def generated_tokens(self) -> int:
        return len(self.tokens) - self.prompt_len


@dataclasses.dataclass
class PrefixEntry:
    """One shareable, fully-computed prompt block.  ``tokens`` (the block's
    actual token ids) and ``parent`` (the previous block's chained hash) are
    stored so a lookup VERIFIES content, never trusts a hash alone — a
    colliding hash must not map one request onto another's KV."""
    block: int
    tokens: Tuple[int, ...]
    parent: bytes


class PrefixCache:
    """The copy-on-write prefix tree over the paged KV pool.

    Keyed on the chained token-block hashes of :func:`kv_metrics.block_hashes`
    — block ``i``'s hash covers its tokens AND its ancestry, so a flat
    ``hash -> entry`` dict IS the tree (matching a node implies matching the
    whole path to the root).  Entries are weak: a block is served only while
    at least one sequence still maps it; :meth:`invalidate_blocks` (driven by
    the allocator's refcount-zero releases at the manager's one reclaim seam)
    drops dead entries, so a drained pool leaves an empty tree.

    ``defer_shared_prefill``: the scheduler skips a prefill chunk for one
    step when another SCHEDULED sequence is computing the exact block it
    needs — next step the block is computed and maps as a hit, so the
    realized savings match the observatory's same-intake counterfactual.

    All counters are host ints; the one device action (the CoW block copy)
    is a callable the engine installs on the manager.
    """

    def __init__(self, block_size: int, *, cow: bool = True,
                 defer_shared_prefill: bool = True):
        self.block_size = int(block_size)
        self.cow = bool(cow)
        self.defer_shared_prefill = bool(defer_shared_prefill)
        self.entries: Dict[bytes, PrefixEntry] = {}
        self._by_block: Dict[int, bytes] = {}
        # realized-savings counters (the observatory's counterfactual twins)
        self.hits_total = 0              # blocks mapped read-only from the tree
        self.cow_copies_total = 0        # fully-cached prompts served via block copy
        self.misses_total = 0            # full prompt blocks computed by their own request
        self.tokens_saved_total = 0      # prefill tokens skipped (realized)
        self.registered_total = 0        # distinct entries ever inserted
        self.evicted_total = 0           # entries dropped because the block was freed
        self.collision_rejects_total = 0  # hash matched, token ids/ancestry did not
        self.deferrals_total = 0         # prefill chunks deferred one step onto a
        # block another scheduled sequence is computing

    def __len__(self) -> int:
        return len(self.entries)

    def register(self, h: bytes, parent: bytes, block: int,
                 tokens: Tuple[int, ...]) -> bool:
        """Offer a fully-computed prompt block to the tree.  First writer
        wins: an existing entry for ``h`` is kept (two same-step co-prefills
        of the same content both stay valid; only one is served)."""
        if h in self.entries:
            return False
        self.entries[h] = PrefixEntry(block=int(block), tokens=tuple(tokens),
                                      parent=bytes(parent))
        self._by_block[int(block)] = h
        self.registered_total += 1
        return True

    def lookup(self, h: bytes, parent: bytes,
               tokens: Tuple[int, ...]) -> Optional[int]:
        """Block id for ``h`` IF the entry's actual token ids and ancestry
        match (hash-collision safety); None on miss or verification failure."""
        entry = self.entries.get(h)
        if entry is None:
            return None
        if entry.tokens != tuple(tokens) or entry.parent != bytes(parent):
            self.collision_rejects_total += 1
            return None
        return entry.block

    def invalidate_blocks(self, blocks: List[int]) -> None:
        """Drop entries whose block went back to the free list (refcount hit
        zero) — its KV is about to belong to someone else."""
        for b in blocks:
            h = self._by_block.pop(int(b), None)
            if h is not None and self.entries.pop(h, None) is not None:
                self.evicted_total += 1

    @property
    def hit_blocks_total(self) -> int:
        """Blocks the tree served instead of a prefill: read-only shared
        mappings plus CoW copies."""
        return self.hits_total + self.cow_copies_total

    def realized_hit_rate(self) -> float:
        """Shared-or-copied blocks over all full prompt blocks that entered
        the pool — directly comparable to the observatory's counterfactual
        ``hit_rate``."""
        total = self.hit_blocks_total + self.misses_total
        return self.hit_blocks_total / total if total else 0.0

    def snapshot(self) -> Dict[str, object]:
        return {
            "enabled": True,
            "entries": len(self.entries),
            "hit_blocks_total": self.hit_blocks_total,
            "hits_total": self.hits_total,
            "cow_copies_total": self.cow_copies_total,
            "misses_total": self.misses_total,
            "tokens_saved_total": self.tokens_saved_total,
            "registered_total": self.registered_total,
            "evicted_total": self.evicted_total,
            "collision_rejects_total": self.collision_rejects_total,
            "deferrals_total": self.deferrals_total,
            "realized_hit_rate": self.realized_hit_rate(),
        }


class RaggedStateManager:

    def __init__(self, num_blocks: int, block_size: int, max_blocks_per_seq: int,
                 prefix_cache: Optional[PrefixCache] = None):
        self.allocator = BlockedAllocator(num_blocks)
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        # block census (kv_metrics.BlockCensus), attached by the engine when
        # KV observability is on.  Hooks fire at the ONE alloc seam
        # (ensure_blocks), the share seam (map_prefix) and the ONE reclaim
        # seam (_reclaim), so every path that moves a block keeps it exact
        self.census = None
        # copy-on-write prefix tree (None disables sharing); the engine
        # installs ``cow_copy`` (the ONE device action: copy a shared block's
        # KV into a private block) next to it
        self.prefix_cache = prefix_cache
        self.cow_copy: Optional[Callable[[int, int], None]] = None
        self.seqs: Dict[int, SequenceDescriptor] = {}
        self.failures: Dict[int, str] = {}
        # uid history for descriptive retire errors; a bounded recency window
        # (insertion-ordered dict) so a long-lived server doesn't grow it
        # forever — uids older than the window degrade to "never added"
        self.retired_uids: Dict[int, None] = {}
        self._retired_window = 4096
        self.completed_requests = 0
        self.failed_requests = 0
        self._arrivals = 0

    @property
    def trash_block(self) -> int:
        return self.allocator.trash_block

    def add_sequence(self, uid: int, prompt_tokens: List[int], *, priority: int = 0,
                     deadline: Optional[float] = None, queue_wait_s: float = 0.0,
                     prompt_len: Optional[int] = None, tenant: str = "default",
                     service_class: str = "interactive") -> SequenceDescriptor:
        """``prompt_len`` pins where prompt ends and generated output begins
        when it differs from ``len(prompt_tokens)`` — crash recovery
        re-admits ``prompt + already-emitted-prefix`` as the token history
        (the prefill rebuilds their KV in one pass) while the prefix keeps
        counting as GENERATED tokens for budgets and results."""
        if uid in self.seqs:
            raise ValueError(f"uid {uid} already tracked")
        if not prompt_tokens:
            raise EmptyPromptError(uid)
        if prompt_len is None:
            prompt_len = len(prompt_tokens)
        elif not 0 < prompt_len <= len(prompt_tokens):
            raise ValueError(f"uid {uid}: prompt_len={prompt_len} outside "
                             f"(0, {len(prompt_tokens)}]")
        seq = SequenceDescriptor(uid=uid, tokens=list(prompt_tokens),
                                 prompt_len=int(prompt_len), arrival=self._arrivals,
                                 priority=priority, deadline=deadline,
                                 queue_wait_s=queue_wait_s,
                                 tenant=str(tenant) if tenant else "default",
                                 service_class=service_class)
        if self.prefix_cache is not None:
            # the tree's keying, computed once per life over the PROMPT
            # portion only (a recovered request's replayed prefix is
            # generated output, never shareable read-only).  The chain is
            # seeded with the tenant namespace: cross-tenant prompts hash to
            # disjoint chains, so the cache structurally cannot share a
            # block across tenants; the default tenant keeps the empty seed
            seq.prefix_hashes = block_hashes(seq.tokens[:seq.prompt_len], self.block_size,
                                             tenant_namespace(seq.tenant))
        self._arrivals += 1
        self.seqs[uid] = seq
        return seq

    def ensure_blocks(self, seq: SequenceDescriptor, upto_tokens: int) -> None:
        """Grow the block table to cover ``upto_tokens`` cache positions."""
        need = (upto_tokens + self.block_size - 1) // self.block_size
        if need > self.max_blocks_per_seq:
            raise RuntimeError(f"uid {seq.uid}: {upto_tokens} tokens exceeds "
                               f"max_blocks_per_seq={self.max_blocks_per_seq}")
        if need > len(seq.blocks):
            grown = self.allocator.allocate(need - len(seq.blocks))
            seq.blocks.extend(grown)
            if self.census is not None:
                self.census.on_alloc(seq.uid, grown)

    def _reclaim(self, uid: int, blocks: List[int]) -> List[int]:
        """THE reclaim seam: every block leaving a sequence releases its
        mapping here, with the census kept in lock-step.  Shared blocks only
        decrement; the prefix tree drops entries exactly for the blocks whose
        refcount reached zero.  Returns the blocks that actually went back to
        the free list."""
        released = self.allocator.free(blocks)
        if self.census is not None:
            self.census.on_free(uid, blocks)
        if self.prefix_cache is not None and released:
            self.prefix_cache.invalidate_blocks(released)
        return released

    # ------------------------------------------------------- prefix caching
    def map_prefix(self, seq: SequenceDescriptor) -> int:
        """Map as many of ``seq``'s leading full prompt blocks as the tree
        can serve, advancing ``seen_tokens`` past the cached KV.  Returns the
        number of prefill tokens skipped.

        Mapping is read-only (allocator refcount +1; census gains an owner)
        and only proceeds while the sequence sits exactly at a block boundary
        with no private progress — the first divergent or missing block stops
        it, and everything after is prefilled into freshly allocated private
        blocks, so decode always writes a private tail block.

        A prompt cached to its LAST token is the copy-on-write case: mapping
        the final block read-only would leave nothing pending, and
        recomputing its last position would WRITE into the shared block.
        Instead the final block's KV is copied into a private block
        (``cow_copy``), ``seen_tokens`` lands at ``prompt_len - 1``, and the
        one recomputed position rewrites its identical KV into the private
        copy.  Without a copy seam the final block is simply recomputed.

        Called at admit time and again by the scheduler before each prefill
        chunk, so a block computed AFTER this sequence was admitted still
        maps (late binding).  Idempotent and cheap on a miss: one dict probe.
        """
        cache = self.prefix_cache
        if cache is None or seq.done or not seq.prefix_hashes:
            return 0
        bs = self.block_size
        saved = 0
        while True:
            i = len(seq.blocks)
            if seq.seen_tokens != i * bs or i >= len(seq.prefix_hashes):
                break  # private progress past the boundary, or past the prompt
            if seq.prefix_hashes[i] not in cache.entries:
                break  # miss — probe before building the token tuple
            parent = seq.prefix_hashes[i - 1] if i else tenant_namespace(seq.tenant)
            block = cache.lookup(seq.prefix_hashes[i], parent,
                                 tuple(seq.tokens[i * bs:(i + 1) * bs]))
            if block is None:
                break  # collision/verification reject
            if (i + 1) * bs >= seq.prompt_len:
                saved += self._cow_map_final(seq, block)
                break
            self.allocator.incref(block)
            if self.census is not None:
                self.census.on_share(seq.uid, block)
            seq.blocks.append(block)
            seq.prefix_registered = len(seq.blocks)
            seq.seen_tokens += bs
            cache.hits_total += 1
            saved += bs
        if saved:
            cache.tokens_saved_total += saved
            seq.prefix_cached_tokens += saved
        return saved

    def _cow_map_final(self, seq: SequenceDescriptor, src: int) -> int:
        """Copy-on-write for a fully-cached prompt: copy ``src``'s KV into a
        private block, map the copy, and leave exactly one prompt position
        pending (its recompute writes identical KV into the COPY, never the
        shared block).  Declines — the block is recomputed instead — when no
        copy seam is installed or the pool can't spare the block."""
        cache = self.prefix_cache
        if self.cow_copy is None or not cache.cow:
            return 0
        try:
            dst = self.allocator.allocate(1)[0]
        except KVAllocationError:
            return 0  # pool-tight or injected fault: recompute instead
        self.cow_copy(src, dst)
        if self.census is not None:
            self.census.on_alloc(seq.uid, [dst])
        seq.blocks.append(dst)
        seq.prefix_registered = len(seq.blocks)
        seq.seen_tokens = seq.prompt_len - 1
        cache.cow_copies_total += 1
        return self.block_size - 1

    def next_prefix_hash(self, seq: SequenceDescriptor) -> Optional[bytes]:
        """The hash of the next full prompt block ``seq`` needs, or None when
        it has private progress / is past its prompt.  After
        :meth:`map_prefix` this is a TREE MISS — the scheduler defers the
        chunk one step iff another scheduled sequence is computing exactly
        this block."""
        if self.prefix_cache is None or not seq.prefix_hashes:
            return None
        i = len(seq.blocks)
        if seq.seen_tokens != i * self.block_size or i >= len(seq.prefix_hashes):
            return None
        return seq.prefix_hashes[i]

    def register_prefix_blocks(self, seq: SequenceDescriptor) -> int:
        """Offer ``seq``'s newly COMPLETED full prompt blocks to the tree
        (called after every ``seen_tokens`` advance; mapped-from-cache blocks
        were marked registered at mapping, so only self-computed blocks walk
        here).  Returns how many blocks were offered."""
        cache = self.prefix_cache
        if cache is None or not seq.prefix_hashes:
            return 0
        bs = self.block_size
        n_complete = min(min(seq.seen_tokens, seq.prompt_len) // bs,
                         len(seq.prefix_hashes), len(seq.blocks))
        offered = 0
        while seq.prefix_registered < n_complete:
            i = seq.prefix_registered
            cache.register(seq.prefix_hashes[i],
                           seq.prefix_hashes[i - 1] if i else tenant_namespace(seq.tenant),
                           seq.blocks[i], tuple(seq.tokens[i * bs:(i + 1) * bs]))
            cache.misses_total += 1
            seq.prefix_registered = i + 1
            offered += 1
        return offered

    def over_cap(self, upto_tokens: int) -> bool:
        return (upto_tokens + self.block_size - 1) // self.block_size > self.max_blocks_per_seq

    def fail(self, uid: int, reason: str) -> None:
        self.failures[uid] = reason
        self.failed_requests += 1
        seq = self.seqs.get(uid)
        if seq is not None:
            seq.done = True
            self._reclaim(uid, seq.blocks)  # reclaim the KV pool immediately
            seq.blocks = []

    def evict(self, seq: SequenceDescriptor, finish_reason: str) -> int:
        """End a sequence WITHOUT completion: done + finish reason + KV blocks
        reclaimed in place — the one primitive behind deadline expiry and
        preemption-budget exhaustion.  Returns the blocks ACTUALLY released."""
        seq.done = True
        seq.finish_reason = finish_reason
        released = 0
        if seq.blocks:
            released = len(self._reclaim(seq.uid, seq.blocks))
            seq.blocks = []
        return released

    def preempt(self, seq: SequenceDescriptor, keep_blocks: int = 0) -> int:
        """Preempt-and-requeue support: free the sequence's trailing KV blocks
        and roll ``seen_tokens`` back to the kept-block boundary.  The prefix
        KV in the kept blocks stays valid; the dropped positions are simply
        recomputed when the sequence is rescheduled.  Returns the number of
        blocks ACTUALLY released to the pool."""
        released = self.rollback_blocks(seq, keep_blocks)
        seq.seen_tokens = min(seq.seen_tokens, len(seq.blocks) * self.block_size)
        return released

    def rollback_blocks(self, seq: SequenceDescriptor, keep_blocks: int) -> int:
        """Free a sequence's trailing blocks past ``keep_blocks`` WITHOUT
        touching its progress.  Returns the number of blocks actually
        released to the pool."""
        keep_blocks = max(0, min(int(keep_blocks), len(seq.blocks)))
        dropped = seq.blocks[keep_blocks:]
        released = 0
        if dropped:
            released = len(self._reclaim(seq.uid, dropped))
            seq.blocks = seq.blocks[:keep_blocks]
            # dropped prompt blocks are re-offered (or re-mapped) when the
            # sequence resumes: the registration watermark rolls back too
            seq.prefix_registered = min(seq.prefix_registered, keep_blocks)
        return released

    def releasable_blocks(self, seq: SequenceDescriptor, keep_blocks: int) -> int:
        """How many of ``seq``'s trailing blocks past ``keep_blocks`` would
        ACTUALLY return to the pool if dropped (a block mapped by another
        sequence too only loses a refcount)."""
        keep_blocks = max(0, min(int(keep_blocks), len(seq.blocks)))
        return sum(1 for b in seq.blocks[keep_blocks:]
                   if self.allocator.refcount(b) == 1)

    def can_allocate(self, n_blocks: int) -> bool:
        return self.allocator.free_blocks >= n_blocks

    def blocks_needed(self, seq: SequenceDescriptor, upto_tokens: int) -> int:
        need = (upto_tokens + self.block_size - 1) // self.block_size
        return max(0, need - len(seq.blocks))

    def block_table_row(self, seq: SequenceDescriptor,
                        width: Optional[int] = None) -> np.ndarray:
        """Padded block-table row for the device batch; ``width`` bounds it to
        the step's bucketed table width."""
        width = self.max_blocks_per_seq if width is None else width
        row = np.full(width, self.trash_block, np.int32)
        row[:len(seq.blocks)] = seq.blocks
        return row

    def retire(self, uid: int, *, completed: bool = True) -> None:
        """Drop a sequence and reclaim its blocks.  ``completed=False`` marks
        an eviction (deadline/shed/stall) so it doesn't count as a completion.
        Unknown uids raise :class:`UnknownSequenceError` naming what actually
        happened to the uid instead of a bare ``KeyError``."""
        seq = self.seqs.pop(uid, None)
        if seq is None:
            if uid in self.failures:
                detail = f"it failed ({self.failures[uid]!r})"
                if uid in self.retired_uids:
                    detail += " and was already flushed"
            elif uid in self.retired_uids:
                detail = "it was already retired"
            else:
                detail = "it was never added"
            raise UnknownSequenceError(uid, detail)
        self.retired_uids.pop(uid, None)  # re-adding refreshes recency
        self.retired_uids[uid] = None
        while len(self.retired_uids) > self._retired_window:
            self.retired_uids.pop(next(iter(self.retired_uids)))
        self._reclaim(uid, seq.blocks)
        seq.blocks = []
        if self.census is not None:
            self.census.on_terminal(uid)
        # neither a flushed failure nor an evicted request is a completion
        if (completed and uid not in self.failures
                and seq.finish_reason not in EVICTED_FINISH_REASONS):
            self.completed_requests += 1

    def live_uids(self) -> List[int]:
        return [uid for uid, s in list(self.seqs.items()) if not s.done]

    def kv_utilization(self) -> float:
        """Fraction of the usable KV pool currently allocated (trash block
        excluded)."""
        usable = self.allocator.num_blocks - 1
        return (usable - self.allocator.free_blocks) / max(usable, 1)

    def tenant_blocks(self, tenant: str) -> int:
        """Resident KV blocks mapped by ``tenant``'s live sequences — the
        QoS layer's KV-quota denominator.  Shared (prefix) blocks count once
        per mapper: a tenant pays for every mapping it holds, which is
        exactly what its eviction would release pressure on.  List copy
        first (GIL-atomic): health() threads may call this while the serve
        thread admits and retires sequences."""
        return sum(len(s.blocks) for s in list(self.seqs.values())
                   if not s.done and s.tenant == tenant)

    def tenant_block_usage(self) -> Dict[str, int]:
        """{tenant: resident blocks} over live sequences (gauge export)."""
        out: Dict[str, int] = {}
        for s in list(self.seqs.values()):
            if not s.done and s.blocks:
                out[s.tenant] = out.get(s.tenant, 0) + len(s.blocks)
        return out
