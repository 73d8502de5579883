"""Serving admission control — bounded queue, deadlines, load shedding.

Counterpart of ``deepspeed_tpu/inference/v2/admission.py``:

- :class:`AdmissionQueue` — a bounded, priority-aware queue between
  ``generate`` and the scheduler.  ``submit`` applies the load-shedding
  policy (:class:`ShedReason` with a retryable/fatal verdict) and stamps each
  ticket with its deadline; the engine pumps tickets into the
  ``RaggedStateManager`` only while the KV pool has headroom.
- :class:`RequestResult` — the per-request outcome ``generate(strict=False)``
  returns: every request ends in exactly one terminal status.
- :class:`ServingStalledError` — raised by the engine's progress watchdog in
  place of an unbounded loop; carries a state snapshot for postmortems.

Thresholds come from ``ServingResilienceConfig``.  All host-side.
"""

import dataclasses
import heapq
import time
from typing import Any, Dict, List, Optional, Tuple

from ...runtime.config import ServingResilienceConfig

# ----------------------------------------------------------- request statuses
OK = "ok"
SHED = "shed"
DEADLINE_EXPIRED = "deadline_expired"
PREEMPT_REQUEUED_EXHAUSTED = "preempt_requeued_exhausted"
FAILED = "failed"

REQUEST_STATUSES = (OK, SHED, DEADLINE_EXPIRED, PREEMPT_REQUEUED_EXHAUSTED, FAILED)


@dataclasses.dataclass
class RequestResult:
    """Terminal outcome of one served request.

    ``tokens`` is prompt + generated for any request that reached the model
    (possibly partial for evicted ones), empty for requests shed at admission.
    ``retryable`` tells the client whether resubmitting later can succeed
    (queue full / pool pressure / stall) or never will (over-cap prompt).
    """
    uid: int
    status: str
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None  # eos | max_new_tokens | length_capped
    reason: Optional[str] = None         # failure/shed/eviction detail
    retryable: bool = False
    queue_wait_s: float = 0.0
    preemptions: int = 0
    retry_after_s: Optional[float] = None  # the shed's backoff hint
    shed_code: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.status == OK


@dataclasses.dataclass(frozen=True)
class ShedReason:
    """Structured admission rejection, decided before any KV allocation.
    ``retry_after_s`` (retryable sheds only) estimates how long the pressure
    that caused the shed takes to clear; None on fatal sheds."""
    code: str      # empty_prompt | prompt_over_cap | queue_full | kv_pressure
    detail: str
    retryable: bool
    retry_after_s: Optional[float] = None

    def __str__(self):
        kind = "retryable" if self.retryable else "fatal"
        hint = (f"; retry in ~{self.retry_after_s:.2f}s"
                if self.retry_after_s is not None else "")
        return f"[{self.code}/{kind}] {self.detail}{hint}"


class ServingStalledError(RuntimeError):
    """The serving loop was live but unschedulable for the watchdog window.
    ``snapshot`` holds live uids, per-sequence progress and block-table
    occupancy, the allocator free count, and queue depth at trip time."""

    def __init__(self, message: str, snapshot: Dict[str, Any]):
        super().__init__(message)
        self.snapshot = snapshot


@dataclasses.dataclass
class AdmissionTicket:
    uid: int
    prompt: List[int]
    priority: int = 0                  # lower pops first; ties are FIFO
    deadline: Optional[float] = None   # absolute clock() time; None = no TTL
    enqueue_t: float = 0.0


class AdmissionQueue:
    """Bounded, priority-aware admission queue with structured load shedding.

    ``submit`` either enqueues a ticket (stamped with its TTL deadline) or
    returns the :class:`ShedReason` that turned it away — the caller decides
    whether that raises (strict) or becomes a ``shed`` RequestResult.  The
    shedding policy runs against queue depth and the CALLER-OBSERVED KV
    utilization, so rejection happens before the request ever owns a block.
    ``clock`` is injectable (fault tests drive a fake clock).
    """

    def __init__(self, config: Optional[ServingResilienceConfig] = None, *,
                 clock=time.monotonic):
        self.config = config if config is not None else ServingResilienceConfig()
        self.clock = clock
        self._heap: List[Tuple[int, int, AdmissionTicket]] = []
        self._seq = 0  # FIFO tiebreak within a priority class
        self.shed_total = 0

    def __len__(self) -> int:
        return len(self._heap)

    # ------------------------------------------------------------- shedding
    def shed_reason(self, prompt_len: int, *, kv_utilization: Optional[float] = None,
                    token_cap: Optional[int] = None) -> Optional[ShedReason]:
        """The policy verdict for a prospective request; None = admit."""
        if prompt_len <= 0:
            return ShedReason("empty_prompt", "prompt has no tokens — a zero-pending "
                              "sequence can never be scheduled or retired", retryable=False)
        if token_cap is not None and prompt_len > token_cap:
            return ShedReason("prompt_over_cap",
                              f"prompt of {prompt_len} tokens exceeds the per-sequence "
                              f"KV cap of {token_cap} tokens", retryable=False)
        depth_cap = self.config.max_queue_depth
        if depth_cap and len(self) >= depth_cap:
            # retry hint ~ time to drain a full queue, clamped to [0.05s, 2s]
            return ShedReason("queue_full",
                              f"admission queue at max_queue_depth={depth_cap}",
                              retryable=True,
                              retry_after_s=min(2.0, max(0.05, 0.025 * depth_cap)))
        shed_at = self.config.shed_kv_utilization
        if kv_utilization is not None and shed_at < 1.0 and kv_utilization >= shed_at:
            # retry hint grows with the overshoot past the shed threshold
            return ShedReason("kv_pressure",
                              f"KV utilization {kv_utilization:.3f} >= shed threshold "
                              f"{shed_at} (pool pressure)", retryable=True,
                              retry_after_s=min(2.0, 0.1 + 4.0 * (kv_utilization - shed_at)))
        return None

    # --------------------------------------------------------------- intake
    def submit(self, uid: int, prompt: List[int], *, priority: int = 0,
               ttl_s: Optional[float] = None, kv_utilization: Optional[float] = None,
               token_cap: Optional[int] = None) -> Optional[ShedReason]:
        """Admit-or-shed.  Returns None on admission, else the ShedReason.
        ``ttl_s=None`` falls back to the config's ``default_ttl_s``."""
        reason = self.shed_reason(len(prompt), kv_utilization=kv_utilization,
                                  token_cap=token_cap)
        if reason is not None:
            self.shed_total += 1
            return reason
        now = self.clock()
        ttl = ttl_s if ttl_s is not None else self.config.default_ttl_s
        # `is not None`, not truthiness: an explicit ttl of 0.0 (a spent
        # budget) means "already expired", not "no deadline"
        ticket = AdmissionTicket(uid=int(uid), prompt=list(prompt), priority=int(priority),
                                 deadline=(now + ttl) if ttl is not None else None,
                                 enqueue_t=now)
        heapq.heappush(self._heap, (ticket.priority, self._seq, ticket))
        self._seq += 1
        return None

    # ---------------------------------------------------------------- drain
    def pop_ready(self) -> Tuple[Optional[AdmissionTicket], List[AdmissionTicket]]:
        """Pop the next ticket whose deadline has not passed.  Returns
        ``(ticket_or_none, expired)``: tickets that died waiting come back in
        ``expired`` (they never owned KV blocks)."""
        expired: List[AdmissionTicket] = []
        now = self.clock()
        while self._heap:
            _, _, ticket = heapq.heappop(self._heap)
            if ticket.deadline is not None and now >= ticket.deadline:
                expired.append(ticket)
                continue
            return ticket, expired
        return None, expired

    def drain(self) -> List[AdmissionTicket]:
        """Remove and return every queued ticket (stall cleanup), in pop order."""
        out = [entry[2] for entry in sorted(self._heap, key=lambda e: (e[0], e[1]))]
        self._heap = []
        return out
