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

Prefix caching: each prefill candidate first maps the shared prompt blocks
the manager's ``PrefixCache`` can serve (late binding), and a candidate
whose next block is being computed by a sequence scheduled in the same step
waits one step and maps it instead of computing it twice.
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

from ...runtime.config import ServingResilienceConfig
from .blocked_allocator import KVAllocationError
from .ragged_manager import RaggedStateManager, SequenceDescriptor


@dataclasses.dataclass(frozen=True)
class ScheduledChunk:
    uid: int
    n_tokens: int  # tokens of this sequence to run this step


class SplitFuseScheduler:

    def __init__(self, token_budget: int = 512, max_seqs_per_step: int = 64,
                 telemetry=None, resilience: Optional[ServingResilienceConfig] = None,
                 tracer=None, gauge_timestamp=None):
        self.token_budget = token_budget
        self.max_seqs = max_seqs_per_step
        # TelemetryCollector (monitor/telemetry.py); every schedule() emits
        # the scheduler gauges through it when attached
        self.telemetry = telemetry
        # RequestTracer (monitor/tracing.py): preempt/requeue land in the
        # victim's span chain and the always-on flight recorder
        self.tracer = tracer
        # engine-provided deterministic gauge timestamp (None -> wall clock):
        # under an injected clock the engine returns the clock's last read,
        # so gauge records stamp deterministically
        self.gauge_timestamp = gauge_timestamp
        # QosPolicy (inference/v2/qos.py), installed by the engine when
        # serving_qos is armed: steers preemption-victim choice toward
        # over-quota tenants and lower service classes.  None → the
        # newest-prefill heuristic, byte-identical
        self.qos = None
        self.resilience = resilience if resilience is not None else ServingResilienceConfig()
        self.steps = 0
        self.preempted_total = 0
        # fused decode work (engine decode bursts) in step units: the burst
        # length and the tokens it emitted, without advancing ``steps``
        self.fused_steps = 0
        self.fused_tokens = 0
        # the last schedule()'s gauges, kept whether or not a collector is
        # attached (the ops plane reads them)
        self.last_gauges: Dict[str, float] = {}
        self._requeued: set = set()  # victims preempted THIS step (skip their prefill)
        self._reserve_faulted = False  # last _reserve failed on a transient allocator
        # fault (the pool may have room) rather than genuine exhaustion

    def note_fused_work(self, steps: int, tokens: int) -> None:
        """Record one fused decode round's work: ``steps`` is its
        sequential-step equivalent (the burst length k) and ``tokens`` the
        tokens it emitted across the batch."""
        self.fused_steps += int(steps)
        self.fused_tokens += int(tokens)

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
        chunks to fill the budget; respects KV-pool availability.

        Prefix caching: each prefill candidate first maps whatever shared
        prompt blocks the tree can serve (late binding — blocks computed
        since the request was admitted still count), and a candidate whose
        NEXT needed block is being computed by a sequence already scheduled
        THIS step is deferred one step instead of duplicating the prefill —
        next step the block maps as a hit."""
        budget = self.token_budget
        chunks: List[ScheduledChunk] = []
        self._requeued = set()
        decoding, prefilling = self.live_split(manager)
        cache = manager.prefix_cache
        # hashes of prompt blocks that sequences scheduled THIS step will
        # complete — a later candidate needing one of these defers
        pending_hashes: set = set()

        def note_pending(seq: SequenceDescriptor, take: int) -> None:
            if cache is None or not seq.prefix_hashes:
                return
            end = min(seq.seen_tokens + take, seq.prompt_len)
            for i in range(seq.seen_tokens // manager.block_size, end // manager.block_size):
                # only blocks this chunk will actually OFFER to the tree: a
                # CoW copy's final block sits below the registration
                # watermark and is never offered — advertising its hash
                # would defer a peer onto a registration that never comes
                if seq.prefix_registered <= i < len(seq.prefix_hashes):
                    pending_hashes.add(seq.prefix_hashes[i])

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
            note_pending(seq, 1)  # a CoW-mapped prompt's final position
            budget -= 1

        if starved and self.resilience.preemption:
            budget = self._rescue_starved_decodes(manager, starved, prefilling,
                                                  chunks, budget)

        for seq in prefilling:
            if budget <= 0 or len(chunks) >= self.max_seqs:
                break
            if seq.done or seq.uid in self._requeued:
                continue  # evicted, or preempted-and-requeued this very step
            if cache is not None:
                manager.map_prefix(seq)  # late-binding shared-prefix lookup
                if seq.pending_tokens <= 0:
                    continue  # fully served from the tree
                nxt = manager.next_prefix_hash(seq)
                if nxt is not None and cache.defer_shared_prefill and nxt in pending_hashes:
                    # an already-scheduled sequence computes this exact block
                    # this step: wait one step and map it instead
                    cache.deferrals_total += 1
                    continue
            take = min(seq.pending_tokens, budget)
            while take > 0 and not seq.done and not self._reserve(manager, seq, take):
                if self._reserve_faulted:
                    take = 0  # transient fault: retry next step at full size
                    break
                take //= 2  # shrink the chunk if the KV pool is tight
            if take <= 0 or seq.done:
                continue
            chunks.append(ScheduledChunk(seq.uid, take))
            note_pending(seq, take)
            budget -= take
        self._emit_gauges(manager, chunks, len(decoding), len(prefilling))
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
        # victim preference: with a QoS policy armed, over-quota tenants are
        # preempted first, then lower classes, and only then the
        # newest-prefill heuristic breaks ties; without one the rank prefix
        # is constant and max() degenerates to the arrival order
        if self.qos is not None:
            victim_key = lambda s: self.qos.victim_rank(s) + (s.arrival,)
        else:
            victim_key = lambda s: s.arrival
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
                    victim = max(fresh, key=victim_key)
                    freed = manager.preempt(victim, keep_blocks=len(victim.blocks) // 2)
                    victim.preemptions += 1
                    self.preempted_total += 1
                    self._requeued.add(victim.uid)
                    self._record("serving_preempt", uid=victim.uid, freed_blocks=freed,
                                 rolled_back_to=victim.seen_tokens,
                                 preemptions=victim.preemptions)
                    if self.tracer is not None:
                        self.tracer.event("preempt", step=self.steps, uid=victim.uid,
                                          freed_blocks=freed)
                        self.tracer.on_preempt(victim.uid, freed_blocks=freed,
                                               rolled_back_to=victim.seen_tokens,
                                               preemptions=victim.preemptions)
                elif victims:
                    # every candidate exhausted its requeue budget: evict the
                    # newest one for good rather than deadlock the decodes
                    victim = max(victims, key=victim_key)
                    freed = manager.evict(victim, "preempt_requeued_exhausted")
                    self.preempted_total += 1
                    self._record("serving_preempt_exhausted", uid=victim.uid,
                                 freed_blocks=freed, preemptions=victim.preemptions)
                    if self.tracer is not None:
                        self.tracer.event("preempt_exhausted", step=self.steps,
                                          uid=victim.uid, freed_blocks=freed)
                else:
                    break  # nothing left to reclaim; the stall watchdog owns this
            if rescued:
                chunks.append(ScheduledChunk(seq.uid, 1))
                budget -= 1
        return budget

    def _record(self, event: str, **fields) -> None:
        if self.telemetry is not None:
            self.telemetry.record_resilience(event, step=self.steps, **fields)

    def _emit_gauges(self, manager: RaggedStateManager, chunks: List[ScheduledChunk],
                     n_decoding: int, n_prefilling: int) -> None:
        """Scheduler observability: queue depth, batch token occupancy and
        KV-block utilization per step, through the shared telemetry
        collector when one is attached."""
        scheduled_tokens = sum(c.n_tokens for c in chunks)
        self.last_gauges = {
            "queue_depth": float(n_decoding + n_prefilling),
            "decode_seqs": float(n_decoding),
            "prefill_seqs": float(n_prefilling),
            "scheduled_seqs": float(len(chunks)),
            "scheduled_tokens": float(scheduled_tokens),
            "token_occupancy": scheduled_tokens / max(self.token_budget, 1),
            "kv_block_utilization": manager.kv_utilization(),
            "preempted_total": float(self.preempted_total),
        }
        self.steps += 1
        if self.telemetry is not None:
            self.telemetry.record_gauges(
                self.last_gauges, step=self.steps, prefix="Inference/Scheduler",
                timestamp=self.gauge_timestamp() if self.gauge_timestamp else None)

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
