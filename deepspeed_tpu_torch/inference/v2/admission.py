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
- :class:`RecoveredRequest` — one re-admission unit of supervised crash
  recovery (``supervisor.py`` → ``engine.serve_recovered``): a journaled
  request with the token prefix it already emitted and its remaining TTL.

With a multi-tenant QoS policy (``qos.py``) the single priority heap becomes
per-service-class heaps drained by deficit-round-robin on token cost, and
``submit`` adds the tenant's quota verdict after the structural checks.

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
    # machine-readable shed code: routers must distinguish a per-tenant
    # quota shed (rerouting to a sibling cannot help — the quota is
    # tenant-global) from replica-local pressure without parsing `reason`
    shed_code: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.status == OK


@dataclasses.dataclass(frozen=True)
class ShedReason:
    """Structured admission rejection, decided before any KV allocation.
    ``retry_after_s`` (retryable sheds only) estimates how long the pressure
    that caused the shed takes to clear; None on fatal sheds."""
    code: str      # empty_prompt | prompt_over_cap | queue_full | kv_pressure | quota_exceeded
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
    # crash-recovery re-admission provenance: tokens this request already
    # emitted in a previous engine life, replayed from the durable request
    # journal.  The pump admits ``prompt + prefix`` as the sequence's token
    # history with ``prompt_len`` pinned to the ORIGINAL prompt, so the
    # recovered decode continues from where it died (the prefix counts as
    # generated output, not prompt) instead of restarting from scratch.
    prefix: List[int] = dataclasses.field(default_factory=list)
    recovered: bool = False
    # multi-tenant QoS identity: who this request belongs to and which
    # service class it rides, carried end to end (ticket → sequence →
    # journal → recovery) so policy decisions always see the same identity
    tenant: str = "default"
    service_class: str = "interactive"

    @property
    def total_len(self) -> int:
        """Full token history, prompt + recovered prefix: the DRR and quota
        charging unit."""
        return len(self.prompt) + len(self.prefix)


@dataclasses.dataclass
class RecoveredRequest:
    """One re-admission unit for supervised crash recovery
    (``supervisor.py`` → ``engine.serve_recovered``): a journaled request
    plus its already-emitted token prefix and the REMAINING TTL budget
    (computed on the original wall-clock admit stamp, so a restart never
    refreshes a deadline).  ``prefix=[]`` re-admits a request that never
    emitted (or a brand-new one riding the same call)."""
    uid: int
    prompt: List[int]
    prefix: List[int] = dataclasses.field(default_factory=list)
    priority: int = 0
    ttl_s: Optional[float] = None      # remaining TTL; None = no deadline
    pin_ttl: bool = False              # True: ttl_s is authoritative AS-IS
    # (None = genuinely deadline-free) — a recovered request whose original
    # life had no TTL must not be handed one by the new engine's
    # default_ttl_s.  False (new requests): ttl_s=None falls through to the
    # config default exactly like generate().
    # QoS identity, replayed from the journal admit record, so a restart can
    # neither launder a best-effort request into interactive nor strip a
    # tenant of its quota accounting
    tenant: str = "default"
    service_class: str = "interactive"


class AdmissionQueue:
    """Bounded, priority-aware admission queue with structured load shedding.

    ``submit`` either enqueues a ticket (stamped with its TTL deadline) or
    returns the :class:`ShedReason` that turned it away — the caller decides
    whether that raises (strict) or becomes a ``shed`` RequestResult.  The
    shedding policy runs against queue depth and the CALLER-OBSERVED KV
    utilization, so rejection happens before the request ever owns a block.
    ``clock`` is injectable (fault tests drive a fake clock).  ``tracer``
    (``monitor/tracing.py`` ``RequestTracer``) hears about every intake
    decision: a ``queue_wait`` span opens at submit, a shed becomes a
    terminal trace event, and shed/submit land in the always-on flight
    recorder.  ``qos`` (an enabled ``qos.QosPolicy``) arms per-tenant quotas
    and the weighted-fair dequeue; None keeps the single priority heap.
    """

    def __init__(self, config: Optional[ServingResilienceConfig] = None, *,
                 clock=time.monotonic, tracer=None, qos=None):
        self.config = config if config is not None else ServingResilienceConfig()
        self.clock = clock
        self.tracer = tracer
        self._heap: List[Tuple[int, int, AdmissionTicket]] = []
        self._seq = 0  # FIFO tiebreak within a priority class
        self.shed_total = 0
        # per-code shed accounting: lifetime counts plus the last
        # retry_after_s hint issued per code, exported as the labeled
        # Prometheus shed families next to the unlabeled shed_total
        self.shed_by_code: Dict[str, int] = {}
        self.last_retry_after: Dict[str, float] = {}
        # multi-tenant QoS: with an enabled policy the single priority heap
        # becomes per-service-class heaps drained by deficit-round-robin on
        # token cost; quota sheds happen in submit.  qos=None keeps every
        # code path below byte-identical to the policy-free queue
        self.qos = qos if (qos is not None and qos.enabled) else None
        self._drr = self.qos.make_drr() if self.qos is not None else None
        self._classes: Dict[str, List[Tuple[int, int, AdmissionTicket]]] = {}

    def __len__(self) -> int:
        if self._drr is not None:
            return sum(len(h) for h in self._classes.values())
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
               token_cap: Optional[int] = None, prefix: Optional[List[int]] = None,
               apply_default_ttl: bool = True, recovered: bool = False,
               tenant: Optional[str] = None,
               service_class: Optional[str] = None) -> Optional[ShedReason]:
        """Admit-or-shed.  Returns None on admission, else the ShedReason.
        ``ttl_s=None`` falls back to the config's ``default_ttl_s``.

        ``prefix``/``recovered`` carry crash-recovery provenance: the
        shedding policy sees the FULL token history (prompt + prefix) — a
        recovered request whose history no longer fits the per-sequence KV
        cap is a genuine rejection, not an accounting accident.
        ``apply_default_ttl=False`` pins ``ttl_s`` as authoritative
        (None = deadline-free) so a re-admission never refreshes or invents
        a deadline the original request didn't have.

        ``tenant``/``service_class``: with a QoS policy armed the structural
        checks run first (an over-cap prompt is fatal no matter whose it
        is), then the tenant's token-rate/KV quotas — a quota violation is a
        retryable ``quota_exceeded`` shed whose ``retry_after_s`` is the
        bucket's exact refill time.  Recovered requests bypass quota
        enforcement: their cost was charged in the life that admitted them,
        and recovery must not double-charge (or shed) work the journal
        already accepted."""
        prefix = list(prefix) if prefix else []
        tenant = str(tenant) if tenant else "default"
        if self.qos is not None:
            service_class = self.qos.service_class(service_class)
        elif service_class is None:
            service_class = "interactive"
        reason = self.shed_reason(len(prompt) + len(prefix), kv_utilization=kv_utilization,
                                  token_cap=token_cap)
        if reason is None and self.qos is not None and not recovered:
            reason = self.qos.admission_check(tenant, service_class, len(prompt) + len(prefix))
        if reason is not None:
            self.shed_total += 1
            self.shed_by_code[reason.code] = self.shed_by_code.get(reason.code, 0) + 1
            if reason.retry_after_s is not None:
                self.last_retry_after[reason.code] = reason.retry_after_s
            if self.qos is not None:
                self.qos.note_shed(tenant, reason.code, reason.retry_after_s)
            if self.tracer is not None:
                if self.tracer.enabled:
                    # sheds never reach the ticket stamp below, so span
                    # tracing pays one clock read here; otherwise a fresh
                    # engine's shed records carry the stale last-ticked value
                    self.tracer.tick(self.clock())
                self.tracer.event("shed", uid=int(uid), code=reason.code)
                self.tracer.on_shed(int(uid), reason.code, retryable=reason.retryable,
                                    detail=reason.detail)
            return reason
        now = self.clock()
        if ttl_s is not None or not apply_default_ttl:
            ttl = ttl_s
        else:
            ttl = self.config.default_ttl_s
        # `is not None`, not truthiness: an explicit ttl of 0.0 (a spent
        # budget) means "already expired", not "no deadline"
        ticket = AdmissionTicket(uid=int(uid), prompt=list(prompt), priority=int(priority),
                                 deadline=(now + ttl) if ttl is not None else None,
                                 enqueue_t=now, prefix=prefix, recovered=bool(recovered),
                                 tenant=tenant, service_class=service_class)
        if self._drr is not None:
            heapq.heappush(self._classes.setdefault(service_class, []),
                           (ticket.priority, self._seq, ticket))
            self.qos.note_admit(tenant, service_class, ticket.total_len)
        else:
            heapq.heappush(self._heap, (ticket.priority, self._seq, ticket))
        self._seq += 1
        if self.tracer is not None:
            # the queue_wait span opens on the SAME clock value the ticket
            # was stamped with: tracing adds no clock read at this seam
            self.tracer.tick(now)
            self.tracer.event("submit", uid=ticket.uid, priority=ticket.priority)
            self.tracer.on_submit(ticket.uid, now, prompt_len=ticket.total_len,
                                  priority=ticket.priority,
                                  tenant=(tenant if self.qos is not None else None))
        return None

    # ---------------------------------------------------------------- drain
    def pop_ready(self) -> Tuple[Optional[AdmissionTicket], List[AdmissionTicket]]:
        """Pop the next ticket whose deadline has not passed.  Returns
        ``(ticket_or_none, expired)``: tickets that died waiting come back in
        ``expired`` (they never owned KV blocks)."""
        expired: List[AdmissionTicket] = []
        now = self.clock()
        if self.tracer is not None:
            self.tracer.tick(now)  # donate the already-read clock value
        if self._drr is not None:
            return self._pop_fair(now, expired), expired
        while self._heap:
            _, _, ticket = heapq.heappop(self._heap)
            if ticket.deadline is not None and now >= ticket.deadline:
                expired.append(ticket)
                continue
            return ticket, expired
        return None, expired

    def _pop_fair(self, now: float,
                  expired: List[AdmissionTicket]) -> Optional[AdmissionTicket]:
        """Weighted-fair pop: sweep each class's expired heads (they never
        reach the DRR — a dead ticket must not charge its class's deficit),
        then let the DRR pick among the live heads by token cost."""
        head_costs: Dict[str, int] = {}
        for cls, heap in list(self._classes.items()):
            while heap:
                ticket = heap[0][2]
                if ticket.deadline is not None and now >= ticket.deadline:
                    expired.append(heapq.heappop(heap)[2])
                    continue
                head_costs[cls] = max(1, ticket.total_len)
                break
            if not heap:
                del self._classes[cls]
        cls = self._drr.select(head_costs)
        if cls is None:
            return None
        ticket = heapq.heappop(self._classes[cls])[2]
        if not self._classes[cls]:
            del self._classes[cls]
        return ticket

    def _entries(self) -> List[Tuple[int, int, AdmissionTicket]]:
        if self._drr is not None:
            return [e for heap in self._classes.values() for e in heap]
        return self._heap

    def queued_stats(self) -> Tuple[int, int]:
        """(depth, longest queued history, prompt + recovered prefix) without
        mutating the queue: the serve-time prewarm sizes its candidate
        buckets from what is waiting."""
        entries = self._entries()
        if not entries:
            return 0, 0
        return len(entries), max(entry[2].total_len for entry in entries)

    def drain(self) -> List[AdmissionTicket]:
        """Remove and return every queued ticket (stall cleanup), in pop order."""
        out = [entry[2] for entry in sorted(self._entries(), key=lambda e: (e[0], e[1]))]
        self._heap = []
        self._classes = {}
        return out
