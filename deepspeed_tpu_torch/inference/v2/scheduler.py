"""Dynamic SplitFuse scheduler.

Counterpart of ``deepspeed_tpu/inference/v2/scheduler.py``: every engine step
runs a fixed token budget; decoding sequences contribute 1 token each, the
remaining budget is filled with prompt CHUNKS (long prompts are split across
steps — "split"), and prompts co-run with decodes in one ragged batch
("fuse").

Resilience: a decode-starvation guard with KV-pressure preemption — a decode
that cannot reserve its one block reclaims capacity from the NEWEST
prefilling sequence, which is rolled back to a block boundary (prefix KV kept)
and requeued; a victim preempted past ``max_preemptions`` is evicted with
finish reason ``preempt_requeued_exhausted``.  A decoding sequence that hits
``max_blocks_per_seq`` completes gracefully (``length_capped``), and
transient :class:`KVAllocationError`s degrade to "chunk skipped this step".
"""

import dataclasses
from typing import List, Optional, Tuple

from ...runtime.config import ServingResilienceConfig
from .blocked_allocator import KVAllocationError
from .ragged_manager import RaggedStateManager, SequenceDescriptor


@dataclasses.dataclass(frozen=True)
class ScheduledChunk:
    uid: int
    n_tokens: int  # tokens of this sequence to run this step


class SplitFuseScheduler:

    def __init__(self, token_budget: int = 512, max_seqs_per_step: int = 64,
                 resilience: Optional[ServingResilienceConfig] = None):
        self.token_budget = token_budget
        self.max_seqs = max_seqs_per_step
        self.resilience = resilience if resilience is not None else ServingResilienceConfig()
        self.steps = 0
        self.preempted_total = 0
        self._requeued: set = set()  # victims preempted THIS step (skip their prefill)
        self._reserve_faulted = False  # last _reserve failed on a transient allocator
        # fault (the pool may have room) rather than genuine exhaustion

    def live_split(self, manager: RaggedStateManager
                   ) -> Tuple[List[SequenceDescriptor], List[SequenceDescriptor]]:
        """Split the live, schedulable set into (decoding, prefilling)."""
        decoding: List[SequenceDescriptor] = []
        prefilling: List[SequenceDescriptor] = []
        for uid in manager.live_uids():
            seq = manager.seqs[uid]
            if seq.pending_tokens <= 0:
                continue
            (prefilling if seq.pending_tokens > 1 else decoding).append(seq)
        return decoding, prefilling

    def schedule(self, manager: RaggedStateManager) -> List[ScheduledChunk]:
        """Pick this step's ragged batch. Decodes first (latency), then prompt
        chunks to fill the budget; respects KV-pool availability."""
        budget = self.token_budget
        chunks: List[ScheduledChunk] = []
        self._requeued = set()
        decoding, prefilling = self.live_split(manager)

        starved: List[SequenceDescriptor] = []
        for seq in decoding:
            if budget <= 0 or len(chunks) >= self.max_seqs:
                break
            if not self._reserve(manager, seq, 1):
                # pool-tight (not capped/failed) decodes are preemption-
                # rescuable; a transient allocator FAULT is not exhaustion —
                # retry next step instead of punishing an innocent prefill
                if not seq.done and not self._reserve_faulted:
                    starved.append(seq)
                continue
            chunks.append(ScheduledChunk(seq.uid, 1))
            budget -= 1

        if starved and self.resilience.preemption:
            budget = self._rescue_starved_decodes(manager, starved, prefilling,
                                                  chunks, budget)

        for seq in prefilling:
            if budget <= 0 or len(chunks) >= self.max_seqs:
                break
            if seq.done or seq.uid in self._requeued:
                continue  # evicted, or preempted-and-requeued this very step
            take = min(seq.pending_tokens, budget)
            while take > 0 and not seq.done and not self._reserve(manager, seq, take):
                if self._reserve_faulted:
                    take = 0  # transient fault: retry next step at full size
                    break
                take //= 2  # shrink the chunk if the KV pool is tight
            if take <= 0 or seq.done:
                continue
            chunks.append(ScheduledChunk(seq.uid, take))
            budget -= take
        self.steps += 1
        return chunks

    # ---------------------------------------------- decode-starvation guard
    def _rescue_starved_decodes(self, manager: RaggedStateManager,
                                starved: List[SequenceDescriptor],
                                prefilling: List[SequenceDescriptor],
                                chunks: List[ScheduledChunk], budget: int) -> int:
        """KV-pressure preemption: a decode that could not reserve its single
        block reclaims capacity from the newest prefilling victim.  Victims
        lose their trailing half of blocks per preemption (rolled back to the
        kept-block boundary, requeued for later steps); a victim already at
        ``max_preemptions`` is instead evicted outright so decodes — which
        hold completed prefill work — never starve behind fresh prompts."""
        scheduled = {c.uid for c in chunks}
        max_preempt = self.resilience.max_preemptions
        for seq in starved:
            if budget <= 0 or len(chunks) >= self.max_seqs:
                break
            rescued = False
            while not rescued:
                if self._reserve(manager, seq, 1):
                    rescued = True
                    break
                if self._reserve_faulted:
                    break  # fault, not pressure: no victim deserves preemption
                # only victims whose droppable tail RELEASES real capacity
                # qualify (a tail of shared mappings only decrements refcounts)
                victims = [p for p in prefilling
                           if p.blocks and not p.done and p.uid not in scheduled
                           and manager.releasable_blocks(p, 0) > 0]
                fresh = [p for p in victims if p.preemptions < max_preempt
                         and manager.releasable_blocks(p, len(p.blocks) // 2) > 0]
                if fresh:
                    victim = max(fresh, key=lambda s: s.arrival)
                    manager.preempt(victim, keep_blocks=len(victim.blocks) // 2)
                    victim.preemptions += 1
                    self.preempted_total += 1
                    self._requeued.add(victim.uid)
                elif victims:
                    # every candidate exhausted its requeue budget: evict the
                    # newest one for good rather than deadlock the decodes
                    victim = max(victims, key=lambda s: s.arrival)
                    manager.evict(victim, "preempt_requeued_exhausted")
                    self.preempted_total += 1
                else:
                    break  # nothing left to reclaim; the stall watchdog owns this
            if rescued:
                chunks.append(ScheduledChunk(seq.uid, 1))
                budget -= 1
        return budget

    def _reserve(self, manager: RaggedStateManager, seq: SequenceDescriptor, n: int) -> bool:
        self._reserve_faulted = False
        upto = seq.seen_tokens + n
        if manager.over_cap(upto):
            if seq.generated_tokens > 0:
                # mid-generation cap: every token generated so far is valid,
                # so complete gracefully instead of hard-failing the request
                seq.done = True
                seq.finish_reason = "length_capped"
            else:
                # the PROMPT itself cannot fit — a genuine rejection
                manager.fail(seq.uid, f"needs {upto} tokens > "
                             f"{manager.max_blocks_per_seq * manager.block_size} cap")
            return False
        need = manager.blocks_needed(seq, upto)
        if need and not manager.can_allocate(need):
            return False
        try:
            manager.ensure_blocks(seq, upto)
        except KVAllocationError:
            self._reserve_faulted = True
            return False  # transient/injected pool failure: retry a later step
        return True
