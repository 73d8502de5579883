"""Multi-tenant QoS policy for the v2 serving engine.

Counterpart of ``deepspeed_tpu/inference/v2/qos.py``, with its names,
arithmetic and shed structures.  The admission/scheduling stack has every
isolation *mechanism* (bounded priority queue, TTL deadlines, structured
retryable sheds, KV-pressure preemption, per-request spans); this module is
the *policy* layer on those mechanisms:

- :class:`QosPolicy` — per-tenant front-door quotas.  A token bucket
  rate-limits each tenant's admitted token volume and a resident-block cap
  bounds its KV footprint; both produce a structured, retryable
  ``quota_exceeded`` :class:`~.admission.ShedReason` whose ``retry_after_s``
  is the EXACT bucket refill time (rate sheds) or a pressure-scaled hint
  (KV sheds), riding the fleet router's backoff path.
- :class:`DeficitRoundRobin` — weighted-fair dequeue across the three
  service classes (``interactive`` / ``batch`` / ``best_effort``) on TOKEN
  cost, the classic DRR discipline: each round grants a class
  ``quantum * weight`` deficit, a class serves while its head ticket's
  token cost fits its deficit, and an emptied class forfeits its deficit.
  Pure arrival-sequence arithmetic — zero clock reads — so dequeue order
  is FakeClock-deterministic and rerun-identical, and no class can starve
  (every round strictly grows every backlogged class's deficit).
- victim steering for KV-pressure preemption: over-quota tenants first,
  then lower classes, then the newest-prefill heuristic as tie-break.

Everything here is host-side policy: the module imports neither torch nor
numpy.  With ``serving_qos.enabled=false`` the engine never constructs a
policy and all behavior is byte-identical to the policy-free stack.
"""

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .admission import ShedReason

# ------------------------------------------------------------ service classes
INTERACTIVE = "interactive"
BATCH = "batch"
BEST_EFFORT = "best_effort"
SERVICE_CLASSES = (INTERACTIVE, BATCH, BEST_EFFORT)

# preemption preference: HIGHER rank = preferred victim (a best-effort
# prefill dies before a batch one, batch before interactive)
CLASS_RANK = {INTERACTIVE: 0, BATCH: 1, BEST_EFFORT: 2}

DEFAULT_TENANT = "default"

QUOTA_EXCEEDED = "quota_exceeded"


def normalize_tenant(tenant: Optional[str]) -> str:
    return DEFAULT_TENANT if not tenant else str(tenant)


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Effective quota for one tenant (section defaults + per-tenant
    overrides, resolved once per lookup).  Zeros disable a dimension."""
    tokens_per_s: float = 0.0
    token_burst: float = 0.0
    max_kv_blocks: int = 0


class TokenBucket:
    """Deterministic token bucket on an injected clock.

    ``try_take(cost, now)`` refills by elapsed time, then either charges
    ``cost`` (returning ``(True, 0.0)``) or reports the EXACT time until
    the bucket holds ``cost`` tokens (``(False, retry_after_s)``) — the
    quota-derived backoff hint the shed carries."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.level = self.burst  # a fresh tenant starts with full burst
        self.last = None  # type: Optional[float]

    def _refill(self, now: float) -> None:
        if self.last is None:
            self.last = now
            return
        if now > self.last:
            self.level = min(self.burst, self.level + (now - self.last) * self.rate)
        self.last = now

    def try_take(self, cost: float, now: float) -> Tuple[bool, float]:
        self._refill(now)
        if cost <= self.level:
            self.level -= cost
            return True, 0.0
        deficit = cost - self.level
        # a cost above the burst capacity can never fit: report the time to
        # a FULL bucket (the best the tenant will ever have) — still finite
        if cost > self.burst:
            deficit = self.burst - self.level
        return False, deficit / self.rate if self.rate > 0 else float("inf")


class DeficitRoundRobin:
    """Token-cost deficit-round-robin over the fixed class order.

    State is (cursor, per-class deficit); :meth:`select` is a pure function
    of the call sequence — no clocks, no randomness — so two identical
    arrival traces dequeue in identical order."""

    def __init__(self, weights: Dict[str, float], quantum: int):
        self.order: Tuple[str, ...] = tuple(c for c in SERVICE_CLASSES)
        self.weights = {c: max(1.0, float(weights.get(c, 1.0))) for c in self.order}
        self.quantum = max(1, int(quantum))
        self.deficit: Dict[str, float] = {c: 0.0 for c in self.order}
        self._cursor = 0
        self._granted = False  # cursor class already got this visit's quantum

    def select(self, head_costs: Dict[str, int]) -> Optional[str]:
        """Pick the class whose head ticket is served next; charges its
        deficit.  ``head_costs`` maps each NON-EMPTY class to the token
        cost of the ticket that would pop from it.

        Textbook DRR visit semantics: the cursor class is granted
        ``quantum * weight`` ONCE per visit, serves heads while the deficit
        covers them, and the visit ends — deficit retained — the moment it
        cannot.  Serving must not re-grant (or interactive's big weight
        would cover every head forever and starve the other classes);
        a backlogged class's deficit therefore grows every full cycle,
        which is the starvation-freedom argument."""
        active = [c for c in self.order if c in head_costs]
        if not active:
            return None
        # an emptied class forfeits its deficit (standard DRR: idle queues
        # must not bank credit and later burst past their weight)
        for c in self.order:
            if c not in head_costs:
                self.deficit[c] = 0.0
        while True:
            c = self.order[self._cursor % len(self.order)]
            if c not in head_costs:
                self._cursor += 1
                self._granted = False
                continue
            if not self._granted:
                self.deficit[c] += self.quantum * self.weights[c]
                self._granted = True
            if self.deficit[c] >= head_costs[c]:
                self.deficit[c] -= head_costs[c]
                return c  # visit continues: no re-grant on the next call
            self._cursor += 1
            self._granted = False


class QosPolicy:
    """Per-tenant quota enforcement + class policy, owned by the engine.

    ``clock`` is the engine's injectable clock (fault tests drive a fake);
    the policy NEVER reads any other time source.  ``kv_blocks_of`` is
    installed by the engine (``manager.tenant_blocks``) so the KV quota
    check sees live resident usage without this module importing the
    manager.
    """

    def __init__(self, config=None, *, clock: Callable[[], float] = time.monotonic):
        from ...runtime.config import ServingQosConfig
        self.config = config if config is not None else ServingQosConfig()
        self.enabled = bool(self.config.enabled)
        self.clock = clock
        self.weights = {INTERACTIVE: float(self.config.interactive_weight),
                        BATCH: float(self.config.batch_weight),
                        BEST_EFFORT: float(self.config.best_effort_weight)}
        self._buckets: Dict[str, TokenBucket] = {}
        self.kv_blocks_of: Optional[Callable[[str], int]] = None
        # per-tenant lifetime accounting (exported as serving_tenant_*)
        self.admitted_by_tenant: Dict[Tuple[str, str], int] = {}
        self.tokens_by_tenant: Dict[str, int] = {}
        self.shed_by_tenant: Dict[Tuple[str, str], int] = {}
        self.last_retry_after_by_tenant: Dict[str, float] = {}

    # ------------------------------------------------------------- identity
    def service_class(self, cls: Optional[str]) -> str:
        """Normalize a caller-supplied class (None → section default)."""
        if cls is None:
            return str(self.config.default_class)
        if cls not in SERVICE_CLASSES:
            raise ValueError(f"unknown service class {cls!r} — expected one "
                             f"of {SERVICE_CLASSES}")
        return cls

    def make_drr(self) -> DeficitRoundRobin:
        return DeficitRoundRobin(self.weights, self.config.drr_quantum_tokens)

    # --------------------------------------------------------------- quotas
    def quota_for(self, tenant: str) -> TenantQuota:
        cfg = self.config
        over = cfg.tenants.get(tenant) if isinstance(cfg.tenants, dict) else None
        over = over if isinstance(over, dict) else {}
        rate = float(over.get("tokens_per_s", cfg.tenant_tokens_per_s))
        burst = float(over.get("token_burst", cfg.tenant_token_burst))
        if burst <= 0.0:
            burst = rate  # default burst: one second of rate
        return TenantQuota(tokens_per_s=rate, token_burst=burst,
                           max_kv_blocks=int(over.get("max_kv_blocks",
                                                      cfg.tenant_max_kv_blocks)))

    def _bucket(self, tenant: str, quota: TenantQuota) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None or b.rate != quota.tokens_per_s:
            b = TokenBucket(quota.tokens_per_s, quota.token_burst)
            self._buckets[tenant] = b
        return b

    def admission_check(self, tenant: str, cls: str,
                        token_cost: int) -> Optional[ShedReason]:
        """Front-door quota verdict; None = admit (bucket already charged).

        Runs AFTER the structural/pressure checks in ``shed_reason`` (an
        over-cap prompt is fatal regardless of whose it is) and BEFORE any
        KV allocation, like every other shed."""
        if not self.enabled:
            return None
        quota = self.quota_for(tenant)
        if quota.max_kv_blocks > 0 and self.kv_blocks_of is not None:
            used = int(self.kv_blocks_of(tenant))
            if used >= quota.max_kv_blocks:
                # resident-cap shed: blocks free as this tenant's own
                # requests retire — hint scales with the overshoot, same
                # clamped band as the kv_pressure hint
                return ShedReason(
                    QUOTA_EXCEEDED,
                    f"tenant {tenant!r} holds {used} KV blocks >= its quota "
                    f"of {quota.max_kv_blocks} (class {cls})", retryable=True,
                    retry_after_s=min(2.0, 0.1 + 0.05 * (used - quota.max_kv_blocks + 1)))
        if quota.tokens_per_s > 0.0:
            ok, wait = self._bucket(tenant, quota).try_take(
                float(token_cost), self.clock())
            if not ok:
                return ShedReason(
                    QUOTA_EXCEEDED,
                    f"tenant {tenant!r} over its token-rate quota of "
                    f"{quota.tokens_per_s:g} tok/s (cost {token_cost}, "
                    f"class {cls})", retryable=True,
                    retry_after_s=max(0.001, min(60.0, wait)))
        return None

    # ----------------------------------------------------------- accounting
    def note_admit(self, tenant: str, cls: str, token_cost: int) -> None:
        key = (tenant, cls)
        self.admitted_by_tenant[key] = self.admitted_by_tenant.get(key, 0) + 1
        self.tokens_by_tenant[tenant] = (self.tokens_by_tenant.get(tenant, 0)
                                         + int(token_cost))

    def note_shed(self, tenant: str, code: str,
                  retry_after_s: Optional[float]) -> None:
        key = (tenant, code)
        self.shed_by_tenant[key] = self.shed_by_tenant.get(key, 0) + 1
        if retry_after_s is not None:
            self.last_retry_after_by_tenant[tenant] = float(retry_after_s)

    def tenants_seen(self) -> List[str]:
        seen = set(self.tokens_by_tenant)
        seen.update(t for t, _ in self.admitted_by_tenant)
        seen.update(t for t, _ in self.shed_by_tenant)
        return sorted(seen)

    # ------------------------------------------------- preemption steering
    def over_kv_quota(self, tenant: str) -> bool:
        quota = self.quota_for(tenant)
        if quota.max_kv_blocks <= 0 or self.kv_blocks_of is None:
            return False
        return int(self.kv_blocks_of(tenant)) > quota.max_kv_blocks

    def victim_rank(self, seq) -> Tuple[int, int]:
        """Preemption preference prefix for a candidate victim: over-quota
        tenants outrank everything, then lower classes; the scheduler
        appends arrival as the final tie-break (the newest-prefill
        heuristic).  With steering disabled the rank is constant and the
        legacy newest-first choice is byte-identical."""
        if not self.enabled or not self.config.preempt_over_quota:
            return (0, 0)
        tenant = getattr(seq, "tenant", DEFAULT_TENANT)
        cls = getattr(seq, "service_class", INTERACTIVE)
        return (1 if self.over_kv_quota(tenant) else 0,
                CLASS_RANK.get(cls, 0))

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, Any]:
        """Host-side state for ``engine.health()`` and the ops plane."""
        return {
            "enabled": self.enabled,
            "tenants": self.tenants_seen(),
            "admitted_by_tenant": {f"{t}/{c}": n for (t, c), n
                                   in sorted(self.admitted_by_tenant.items())},
            "tokens_by_tenant": dict(sorted(self.tokens_by_tenant.items())),
            "shed_by_tenant": {f"{t}/{c}": n for (t, c), n
                               in sorted(self.shed_by_tenant.items())},
        }
