"""Continuous-batching inference engine (FastGen analog).

Counterpart of ``deepspeed_tpu/inference/v2/engine_v2.py`` on its reference
loop (``serving_fastpath.enabled=False``): ``put()`` enqueues requests, each
``step()`` runs ONE ragged forward over a SplitFuse-scheduled token batch
against the paged KV pool, picks the next token of every sequence that
produced one, and fetches those n ints to the host.  ``generate()`` serves a
batch to completion through the admission queue, deadline eviction and the
progress watchdog.

The ragged batch is padded to power-of-two (sequences, chunk) buckets and a
power-of-two block-table width, as the JAX engine's reference loop pads it.
The engine runs on ``device="cuda"`` unless the caller asks for the CPU; it
never falls back from one to the other.
"""

import collections
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import DTYPES as _DTYPES, load_inference_config
from ..engine import _sample
from .admission import (DEADLINE_EXPIRED, FAILED, OK, PREEMPT_REQUEUED_EXHAUSTED, SHED,
                        AdmissionQueue, RequestResult, ServingStalledError)
from .ragged_manager import RaggedStateManager
from .scheduler import SplitFuseScheduler


def round_up_pow2(n: int) -> int:
    """Next power of two >= n: the batch-shape bucketing primitive."""
    b = 1
    while b < n:
        b *= 2
    return b


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("InferenceEngineV2: device 'cuda' requested (the default) but no "
                           "CUDA device is available; pass device='cpu' to run the plain "
                           "PyTorch path on the CPU")
    return device


def _tree_to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device=device, dtype=dtype)


class InferenceEngineV2:

    def __init__(self, model_module, model_config, params, config: Optional[Dict] = None,
                 num_blocks: int = 512, block_size: int = 16,
                 max_blocks_per_seq: int = 64, token_budget: int = 256,
                 max_seqs_per_step: int = 32, clock: Optional[Callable[[], float]] = None,
                 device="cuda"):
        self.config = load_inference_config(config)
        self.device = resolve_device(device)
        self.model = model_module
        self.model_config = model_config
        self.dtype = _DTYPES[self.config.dtype]
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.manager = RaggedStateManager(num_blocks, block_size, max_blocks_per_seq)
        # admission control + load shedding in front of the manager, deadlines
        # on an injectable clock, preemption policy shared with the scheduler
        self.resilience = self.config.serving_resilience
        self._clock = clock if clock is not None else time.monotonic
        self.admission = AdmissionQueue(self.resilience, clock=self._clock)
        self.scheduler = SplitFuseScheduler(token_budget, max_seqs_per_step,
                                            resilience=self.resilience)
        self._deadline_expired_total = 0
        self._stall_streak = 0
        self.stalls_total = 0  # lifetime watchdog trips (streaks are transient)
        self.forward_steps = 0  # ragged forwards run (one per non-empty step)
        self.tokens_run = 0     # real tokens through those forwards
        self.positions_run = 0  # padded (sequences x chunk) positions they computed
        self.chunk_widths = collections.Counter()  # padded chunk width -> forwards run at it
        self.params = _tree_to(params, self.device, self.dtype)
        self.kv = model_module.init_paged_cache(model_config, num_blocks, block_size,
                                                dtype=self.dtype, device=self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(self.config.seed)

    # ------------------------------------------------------------------ intake
    def put(self, uids: Sequence[int], prompts: Sequence[Sequence[int]],
            ttl_s: Optional[float] = None) -> None:
        """Enqueue requests directly into the state manager, bypassing the
        admission queue — the step()-level API for callers running their own
        loop.  ``ttl_s`` stamps a deadline that step() enforces between
        forwards: an expired sequence is evicted (done, ``finish_reason:
        deadline_expired``, blocks reclaimed) before the next batch."""
        ttl = ttl_s if ttl_s is not None else self.resilience.default_ttl_s
        deadline = self._clock() + ttl if ttl is not None else None
        for uid, prompt in zip(uids, prompts):
            self.manager.add_sequence(int(uid), [int(t) for t in prompt], deadline=deadline)

    def flush(self, uid: int) -> None:
        """End a put()-level request's life: retire it and reclaim its blocks."""
        self.manager.retire(uid)

    # ------------------------------------------------------------------- step
    def _table_width_for(self, need: int) -> int:
        """Block-table width for this step's batch: the live maximum rounded
        up to a power of two, capped at max_blocks_per_seq."""
        need = min(need, self.max_blocks_per_seq)
        return min(round_up_pow2(need), self.max_blocks_per_seq)

    @torch.no_grad()
    def step(self, greedy: bool = True) -> Dict[int, int]:
        """Run one SplitFuse step; returns {uid: sampled_token} for sequences
        that produced a next token (finished prefill or decoded)."""
        self._expire_live()
        chunks = self.scheduler.schedule(self.manager)
        if not chunks:
            return {}
        n = round_up_pow2(len(chunks))
        t = round_up_pow2(max(c.n_tokens for c in chunks))
        b = self._table_width_for(max(len(self.manager.seqs[c.uid].blocks) for c in chunks))
        tokens = np.zeros((n, t), np.int32)
        n_tokens = np.zeros((n, ), np.int32)
        start_pos = np.zeros((n, ), np.int32)
        tables = np.full((n, b), self.manager.trash_block, np.int32)
        for i, c in enumerate(chunks):
            seq = self.manager.seqs[c.uid]
            sl = seq.tokens[seq.seen_tokens:seq.seen_tokens + c.n_tokens]
            tokens[i, :len(sl)] = sl
            n_tokens[i] = c.n_tokens
            start_pos[i] = seq.seen_tokens
            tables[i] = self.manager.block_table_row(seq, width=b)
        dev = [torch.from_numpy(a).to(self.device) for a in (tokens, n_tokens, start_pos, tables)]
        logits, self.kv = self.model.forward_paged(self.model_config, self.params, *dev,
                                                   self.kv, block_size=self.block_size)
        self.forward_steps += 1
        self.tokens_run += int(n_tokens.sum())
        self.positions_run += n * t
        self.chunk_widths[t] += 1
        toks = self._pick(logits, dev[1], greedy).cpu().numpy()  # one sync: n ints

        out: Dict[int, int] = {}
        for i, c in enumerate(chunks):
            seq = self.manager.seqs[c.uid]
            seq.seen_tokens += c.n_tokens
            if seq.seen_tokens >= len(seq.tokens):
                tok = int(toks[i])
                seq.tokens.append(tok)
                out[c.uid] = tok
        return out

    def _pick(self, logits, n_tokens, greedy: bool):
        """Token selection on the device: each row's last valid position,
        argmax or temperature/top-k/top-p sampling."""
        last = torch.clamp(n_tokens.long() - 1, min=0)
        row = logits[torch.arange(logits.shape[0], device=logits.device), last]
        if greedy:
            return torch.argmax(row, dim=-1).to(torch.int32)
        cfg = self.config
        return _sample(row, self._generator, temperature=cfg.temperature, top_k=cfg.top_k,
                       top_p=cfg.top_p)

    # ---------------------------------------------------------------- serving
    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None, greedy: bool = True, *,
                 strict: bool = True, priorities: Optional[Sequence[int]] = None,
                 ttl_s: Optional[float] = None
                 ) -> Union[List[List[int]], List[RequestResult]]:
        """Serve a batch to completion through the continuous-batching loop.

        Requests flow through the admission queue (bounded, priority-aware,
        load-shed under pressure), are evicted between steps once past their
        deadline (``ttl_s`` or the config default), and a progress watchdog
        bounds live-but-unschedulable loops.

        ``strict=True`` (default): returns ``List[List[int]]`` of
        prompt+generated tokens and raises on the first shed/failure/stall
        (:class:`ServingStalledError` carries a state snapshot).
        ``strict=False``: every request runs to a terminal status and the call
        returns per-request :class:`RequestResult` objects (status in {ok,
        shed, deadline_expired, preempt_requeued_exhausted, failed}).

        ``greedy=False`` samples with the engine config's temperature/top-k/
        top-p from the engine's seeded generator."""
        uids = list(range(len(prompts)))
        results = self._serve(uids, prompts, max_new_tokens=max_new_tokens,
                              eos_token_id=eos_token_id, greedy=greedy, strict=strict,
                              priorities=priorities, ttl_s=ttl_s)
        if strict:
            return [results[u].tokens for u in uids]
        return [results[u] for u in uids]

    def _serve(self, uids: List[int], prompts: Sequence[Sequence[int]], *,
               max_new_tokens: int, eos_token_id: Optional[int], greedy: bool,
               strict: bool, priorities: Optional[Sequence[int]],
               ttl_s: Optional[float]) -> Dict[int, RequestResult]:
        my = set(uids)
        conflict = sorted(my & set(self.manager.seqs))
        if conflict:
            # fail fast BEFORE any queue/manager mutation: a collision with a
            # put()-registered sequence would otherwise let this call evict
            # foreign work
            raise ValueError(f"generate() uids {conflict} are already tracked (direct "
                             f"put() requests coexist with generate() only with "
                             f"disjoint uids); flush them first")
        for uid in uids:
            # a failure entry left over from a reused uid's previous life must
            # not poison the fresh request
            self.manager.failures.pop(uid, None)
        results: Dict[int, RequestResult] = {}
        produced = {u: 0 for u in uids}
        token_cap = self.manager.max_blocks_per_seq * self.manager.block_size
        try:
            # ---- admission: shed-or-queue BEFORE any KV allocation
            for i, (uid, prompt) in enumerate(zip(uids, prompts)):
                shed = self.admission.submit(
                    uid, [int(tok) for tok in prompt],
                    priority=priorities[i] if priorities is not None else 0,
                    ttl_s=ttl_s, kv_utilization=self.manager.kv_utilization(),
                    token_cap=token_cap)
                if shed is not None:
                    if strict:
                        raise RuntimeError(f"request {uid} shed: {shed}")
                    results[uid] = RequestResult(uid=uid, status=SHED, reason=str(shed),
                                                 retryable=shed.retryable,
                                                 retry_after_s=shed.retry_after_s,
                                                 shed_code=shed.code)
            self._serve_loop(uids, my, results, produced, max_new_tokens=max_new_tokens,
                             eos_token_id=eos_token_id, greedy=greedy, strict=strict)
        except Exception:
            # a strict-mode raise must not leak this call's queued tickets or
            # live sequences into the next call
            self._abandon(my)
            raise
        return results

    def _serve_loop(self, uids: List[int], my: set, results: Dict[int, RequestResult],
                    produced: Dict[int, int], *, max_new_tokens: int,
                    eos_token_id: Optional[int], greedy: bool, strict: bool) -> None:
        stall_streak = 0
        last_sig = None
        while any(u not in results for u in uids):
            self._expire_live()
            self._pump_admissions(my, results, strict)
            self._absorb_step(self.step(greedy=greedy), my, results, produced,
                              max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                              strict=strict)
            # ---- progress watchdog: a live-but-unschedulable engine must trip,
            # not spin.  Identical signatures for the watchdog window = stall.
            sig = self._progress_signature()
            stall_streak = stall_streak + 1 if sig == last_sig else 0
            last_sig = sig
            self._stall_streak = stall_streak
            if stall_streak >= self.resilience.stall_watchdog_steps:
                self._handle_stall(my, results, strict)
                stall_streak, last_sig = 0, None
                self._stall_streak = 0

    def _absorb_step(self, stepped: Dict[int, int], my: set,
                     results: Dict[int, RequestResult], produced: Dict[int, int], *,
                     max_new_tokens: int, eos_token_id: Optional[int],
                     strict: bool) -> None:
        """Fold one step's outcomes into per-request results: sampled-token
        finishes (eos / max_new_tokens), failures, and evictions."""
        for uid, tok in stepped.items():
            if uid not in my or uid in results:
                continue
            produced[uid] += 1
            hit_eos = eos_token_id is not None and tok == eos_token_id
            if produced[uid] >= max_new_tokens or hit_eos:
                self._finish_ok(uid, results, "eos" if hit_eos else "max_new_tokens")

        for uid, reason in list(self.manager.failures.items()):
            if uid in my and uid not in results:
                if strict:
                    raise RuntimeError(f"request {uid} failed: {reason}")
                seq = self.manager.seqs.get(uid)
                results[uid] = RequestResult(
                    uid=uid, status=FAILED, reason=reason,
                    tokens=list(seq.tokens) if seq is not None else [])
                if seq is not None:
                    self.manager.retire(uid, completed=False)
                # consume the entry: uids are reused across generate() calls
                self.manager.failures.pop(uid, None)

        # sequences finished WITHOUT emitting this step: a decode capped at
        # max_blocks_per_seq completes gracefully (length_capped), an expired
        # request was evicted by _expire_live, an exhausted preemption victim
        # ends
        for uid in list(self.manager.seqs):
            if uid not in my or uid in results:
                continue
            seq = self.manager.seqs[uid]
            if not (seq.done and seq.finish_reason):
                continue
            if seq.finish_reason == DEADLINE_EXPIRED:
                if strict:
                    raise RuntimeError(f"request {uid} deadline_expired after "
                                       f"producing {seq.generated_tokens} tokens")
                results[uid] = RequestResult(uid=uid, status=DEADLINE_EXPIRED,
                                             tokens=list(seq.tokens), retryable=True,
                                             reason="deadline expired while running",
                                             queue_wait_s=seq.queue_wait_s,
                                             preemptions=seq.preemptions)
                self.manager.retire(uid, completed=False)
            elif seq.finish_reason == PREEMPT_REQUEUED_EXHAUSTED:
                if strict:
                    raise RuntimeError(
                        f"request {uid} preempted {seq.preemptions}x and evicted "
                        f"(KV pool pressure); enlarge num_blocks or lower concurrency")
                results[uid] = RequestResult(
                    uid=uid, status=PREEMPT_REQUEUED_EXHAUSTED,
                    tokens=list(seq.tokens), retryable=True,
                    reason=f"preempted {seq.preemptions}x under KV pressure",
                    preemptions=seq.preemptions, queue_wait_s=seq.queue_wait_s)
                self.manager.retire(uid, completed=False)
            else:  # length_capped: a graceful completion
                self._finish_ok(uid, results, seq.finish_reason)

    def _abandon(self, my: set) -> None:
        """Strict-mode raise cleanup: reclaim every trace of this call so the
        engine is immediately reusable (blocks freed, queue drained, stale
        failure entries consumed)."""
        for uid in list(self.manager.seqs):
            if uid in my:
                self.manager.retire(uid, completed=False)
        for uid in my:
            self.manager.failures.pop(uid, None)
        self.admission.drain()
        self._stall_streak = 0

    def _finish_ok(self, uid: int, results: Dict[int, RequestResult],
                   finish_reason: str) -> None:
        seq = self.manager.seqs[uid]
        seq.done = True
        seq.finish_reason = finish_reason
        results[uid] = RequestResult(uid=uid, status=OK, tokens=list(seq.tokens),
                                     finish_reason=finish_reason,
                                     queue_wait_s=seq.queue_wait_s,
                                     preemptions=seq.preemptions)
        self.manager.retire(uid)  # reclaim KV blocks immediately, not at batch end

    def _expire_live(self) -> None:
        """Engine-wide deadline enforcement between forwards: any live
        sequence past its deadline is evicted in place (done, ``finish_reason:
        deadline_expired``, KV blocks reclaimed)."""
        now = self._clock()
        for seq in list(self.manager.seqs.values()):
            if seq.done or seq.deadline is None or now < seq.deadline:
                continue
            self.manager.evict(seq, DEADLINE_EXPIRED)
            self._deadline_expired_total += 1

    def _pump_admissions(self, my: set, results: Dict[int, RequestResult],
                         strict: bool) -> None:
        """Move queued tickets into the state manager while the pool has
        headroom; tickets that expired waiting become deadline_expired results
        without ever owning a block.  Tickets stay queued while the live cap
        or pool pressure leaves no headroom."""
        cfg = self.resilience
        while len(self.admission):
            live = self.manager.live_uids()
            if cfg.max_live_seqs and len(live) >= cfg.max_live_seqs:
                return
            if live and self.manager.kv_utilization() >= cfg.shed_kv_utilization:
                return  # pool pressure: hold the queue (something is live, and
                # retiring it reopens the pump)
            ticket, expired = self.admission.pop_ready()
            for t in expired:
                if t.uid in my and t.uid not in results:
                    self._deadline_expired_total += 1
                    if strict:
                        raise RuntimeError(f"request {t.uid} deadline_expired while queued")
                    results[t.uid] = RequestResult(
                        uid=t.uid, status=DEADLINE_EXPIRED, retryable=True,
                        reason="deadline expired in the admission queue")
            if ticket is None:
                break
            wait = max(0.0, self._clock() - ticket.enqueue_t)
            self.manager.add_sequence(ticket.uid, ticket.prompt, priority=ticket.priority,
                                      deadline=ticket.deadline, queue_wait_s=wait)

    def _handle_stall(self, my: set, results: Dict[int, RequestResult],
                      strict: bool) -> None:
        self.stalls_total += 1
        snapshot = self.state_snapshot()
        steps = self.resilience.stall_watchdog_steps
        if strict:
            raise ServingStalledError(
                f"serving made no progress for {steps} consecutive steps with "
                f"{len(snapshot['live_uids'])} live sequences and "
                f"{snapshot['free_blocks']} free KV blocks — see .snapshot for the "
                f"full engine state", snapshot)
        # non-strict: fail the stuck requests (live AND still-queued), reclaim
        # their blocks, and keep serving the rest
        reason = f"stalled: no scheduling progress for {steps} steps"
        for uid in list(self.manager.seqs):
            if uid in my and uid not in results:
                seq = self.manager.seqs[uid]
                results[uid] = RequestResult(uid=uid, status=FAILED, reason=reason,
                                             tokens=list(seq.tokens), retryable=True,
                                             preemptions=seq.preemptions,
                                             queue_wait_s=seq.queue_wait_s)
                self.manager.retire(uid, completed=False)
        for ticket in self.admission.drain():
            if ticket.uid in my and ticket.uid not in results:
                results[ticket.uid] = RequestResult(uid=ticket.uid, status=FAILED,
                                                    reason=reason + " (still queued)",
                                                    retryable=True)

    def _progress_signature(self):
        return (tuple(sorted((uid, s.seen_tokens, len(s.tokens), s.done)
                             for uid, s in self.manager.seqs.items())),
                len(self.admission), self.manager.allocator.free_blocks)

    def state_snapshot(self) -> Dict[str, Any]:
        """Serving state for stall diagnostics: live uids, per-sequence
        progress and block-table occupancy, allocator free count, queue depth."""
        alloc = self.manager.allocator
        return {
            "live_uids": sorted(self.manager.seqs),
            "sequences": {uid: {"seen_tokens": s.seen_tokens,
                                "pending_tokens": s.pending_tokens,
                                "blocks": list(s.blocks),
                                "done": s.done,
                                "preemptions": s.preemptions,
                                "deadline": s.deadline}
                          for uid, s in self.manager.seqs.items()},
            "free_blocks": alloc.free_blocks,
            "num_blocks": alloc.num_blocks,
            "queue_depth": len(self.admission),
            "scheduler_steps": self.scheduler.steps,
            "forward_steps": self.forward_steps,
        }
