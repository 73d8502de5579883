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

The JAX package's copy-on-write ``PrefixCache`` is not ported yet; the
manager keeps its seam (``prefix_cache``, always None here) at the one
reclaim point where the cache plugs in.
"""

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .blocked_allocator import BlockedAllocator

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
    prompt_len: int = 0        # len(tokens) at intake; generated = len(tokens) - prompt_len
    arrival: int = 0           # monotonic intake order; preemption evicts the newest
    priority: int = 0          # lower = more urgent (admission-queue order)
    deadline: Optional[float] = None  # absolute clock time; engine evicts past it
    queue_wait_s: float = 0.0  # time spent in the admission queue
    preemptions: int = 0       # times this sequence was preempted-and-requeued
    finish_reason: Optional[str] = None  # eos | max_new_tokens | length_capped | ...

    @property
    def pending_tokens(self) -> int:
        return len(self.tokens) - self.seen_tokens

    @property
    def generated_tokens(self) -> int:
        return len(self.tokens) - self.prompt_len


class RaggedStateManager:

    def __init__(self, num_blocks: int, block_size: int, max_blocks_per_seq: int):
        self.allocator = BlockedAllocator(num_blocks)
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        # the copy-on-write prefix tree of the JAX package plugs in here (not
        # ported yet: always None)
        self.prefix_cache = None
        self.seqs: Dict[int, SequenceDescriptor] = {}
        self.failures: Dict[int, str] = {}
        # uid history for descriptive retire errors; a bounded recency window
        # (insertion-ordered dict) so a long-lived server doesn't grow it
        # forever — uids older than the window degrade to "never added"
        self.retired_uids: Dict[int, None] = {}
        self._retired_window = 4096
        self.completed_requests = 0
        self._arrivals = 0

    @property
    def trash_block(self) -> int:
        return self.allocator.trash_block

    def add_sequence(self, uid: int, prompt_tokens: List[int], *, priority: int = 0,
                     deadline: Optional[float] = None,
                     queue_wait_s: float = 0.0) -> SequenceDescriptor:
        if uid in self.seqs:
            raise ValueError(f"uid {uid} already tracked")
        if not prompt_tokens:
            raise EmptyPromptError(uid)
        seq = SequenceDescriptor(uid=uid, tokens=list(prompt_tokens),
                                 prompt_len=len(prompt_tokens), arrival=self._arrivals,
                                 priority=priority, deadline=deadline,
                                 queue_wait_s=queue_wait_s)
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
            seq.blocks.extend(self.allocator.allocate(need - len(seq.blocks)))

    def _reclaim(self, uid: int, blocks: List[int]) -> List[int]:
        """THE reclaim seam: every block leaving a sequence releases its
        mapping here.  Returns the blocks that actually went back to the free
        list (shared mappings only decrement)."""
        released = self.allocator.free(blocks)
        if self.prefix_cache is not None and released:
            self.prefix_cache.invalidate_blocks(released)
        return released

    def over_cap(self, upto_tokens: int) -> bool:
        return (upto_tokens + self.block_size - 1) // self.block_size > self.max_blocks_per_seq

    def fail(self, uid: int, reason: str) -> None:
        self.failures[uid] = reason
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
