"""Serving fleet front-end: health-gated routing over N supervised replicas
with journaled failover and zero lost requests.

Counterpart of ``deepspeed_tpu/inference/v2/router.py``, with its names,
policy and counters.  One :class:`ServingSupervisor` can restart its own
engine, but when its restart budget runs out the service degrades to
drain-only — every queued request is finalized ``failed`` because there is
nowhere else for the journaled work to go.  The router owns N replicas (each
a supervisor + its own request journal) and composes the seams the stack
already ships:

- **Health-gated admission.**  Each request goes to the least-loaded
  *healthy* replica, scored from the engine's own ``health()`` gauges —
  queue depth, KV-pool utilization, and the capacity forecaster's
  steps-to-exhaustion (a replica forecasting imminent KV exhaustion is
  steered away from BEFORE it starts shedding).  A snapshot older than
  ``health_stale_s`` (by the injectable-clock ``generated_at`` stamp the
  engine embeds) marks the replica unhealthy: a frozen replica's last-good
  gauges must not attract traffic.
- **Prefix affinity.**  Requests sharing a prompt header hash to the same
  home replica (the chained ``block_hashes`` key the prefix cache itself
  uses, seeded with the tenant namespace), so each replica's CoW prefix tree
  stays hot instead of every replica cold-building the same shared header.
  Affinity is a preference, not a pin: an unhealthy home falls back to
  least-loaded.
- **Shed backoff.**  A retryable shed is NOT surfaced to the caller: the
  router re-routes it to a different replica after backing off for the
  shed's own ``retry_after_s`` hint (or exponential backoff when the hint
  is absent), up to ``max_reroutes`` rounds.  Only a shed that exhausts its
  reroute budget — or is non-retryable — reaches the caller.  A
  ``quota_exceeded`` shed is tenant-global and is never re-routed.
- **Journaled failover.**  A replica that exhausts its restart budget is
  drained and its journal replayed: already-terminal work is adopted as-is,
  and every in-flight entry is TRANSPLANTED into a healthy replica's
  journal — original prompt, emitted-token prefix, and the original
  ttl/wall pair, so the deadline keeps ticking on the request's own clock.
  The target's normal recovery path (``serve_recovered`` emitted-prefix
  re-admission) then continues each decode from where the dead replica left
  it.  Zero lost requests, and the migrated work is durable on the TARGET
  before it is served — a second crash mid-migration loses nothing either.
- **One merged ops surface.**  A :class:`FleetAggregator` absorbs every
  replica generation (rank = replica index, generation bumps carry counter
  totals), so fleet TTFT/TBT/e2e SLO histograms and monotone fleet counters
  come out of ONE ``/metrics`` endpoint no matter how many times any
  replica restarted.

On one GPU the replicas are in-process supervisors whose engines share the
card and serve in turn; each engine owns its KV pool and graphs.

Clock discipline: monotonic reads flow through the injectable ``clock``
seam, wall-clock through ``wall_clock``, and backoff through ``sleep`` —
all bound to the ``time`` functions as defaults — so fleet tests drive fake
time deterministically.  This module is host-side only (it imports neither
torch nor numpy): it reads health dicts and journal files, never a device
value.
"""

import dataclasses
import json
import logging
import os
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Set, Tuple)

from ...monitor.exposition import render
from ...monitor.metrics import (FleetAggregator, MetricsRegistry, populate_from_engine,
                                populate_from_router)
from ...monitor.ops_server import OpsCache, try_start_ops_server
from ...monitor.tracing import FlightRecorder
from ...runtime.config import (OpsServerConfig, ServingFaultToleranceConfig,
                               ServingFleetConfig)
from .admission import FAILED, SHED, RequestResult
from .journal import RequestJournal, replay_journal
from .kv_metrics import block_hashes, tenant_namespace
from .qos import QUOTA_EXCEEDED
from .supervisor import ServeSpec, ServingSupervisor, result_from_entry

logger = logging.getLogger(__name__)

UNROUTABLE_REASON = ("fleet: every replica is drained (all restart budgets "
                     "exhausted) — request finalized by the router; resubmit "
                     "once capacity returns")

# a replica forecasting KV exhaustion within the steering horizon is scored
# as-if carrying this much extra load: effectively last-resort, still legal
EXHAUSTION_PENALTY = 1000.0


@dataclasses.dataclass
class ReplicaHandle:
    """One fleet member: a supervised engine plus the router's view of it."""
    index: int
    supervisor: ServingSupervisor
    journal_path: str
    drained: bool = False            # restart budget exhausted; never routed to
    health: Optional[Dict[str, Any]] = None   # last observed health() snapshot
    observed_at: Optional[float] = None       # router-clock stamp of observe()


class FleetRouter:
    """Front-end over N supervised serving replicas (module docstring).

    ``engine_factories`` is a sequence of zero-arg engine builders, one per
    replica, OR a single callable replicated ``config.replicas`` times (each
    invocation must build a FRESH engine).  Each replica gets its own journal
    (``journal_paths[i]`` or ``journal_dir/replica<i>.journal``) and its own
    :class:`ServingSupervisor` built from ``ft_config``.

    Uids are a fleet-wide namespace: one router instance serves one workload
    namespace, and re-serving a uid the fleet already resolved would adopt
    the journaled terminal instead of serving (the recovery contract working
    as designed) — the router therefore refuses uid reuse across its
    lifetime.
    """

    def __init__(self, engine_factories, *,
                 journal_dir: Optional[str] = None,
                 journal_paths: Optional[Sequence[str]] = None,
                 config=None, ft_config=None, block_size: int = 16,
                 telemetry=None, ops_server=None,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep):
        if config is None:
            config = ServingFleetConfig()
        elif isinstance(config, dict):
            config = ServingFleetConfig(**config)
        self.cfg = config
        if callable(engine_factories):
            engine_factories = [engine_factories] * self.cfg.replicas
        factories = list(engine_factories)
        if not factories:
            raise ValueError("FleetRouter needs at least one engine factory")
        if journal_paths is None:
            if journal_dir is None:
                raise ValueError("FleetRouter needs journal_paths or journal_dir")
            journal_paths = [os.path.join(journal_dir, f"replica{r}.journal")
                             for r in range(len(factories))]
        if len(journal_paths) != len(factories):
            raise ValueError(f"{len(factories)} engine factories but "
                             f"{len(journal_paths)} journal paths")
        self.block_size = int(block_size)
        self.telemetry = telemetry
        self._clock = clock
        self._wall = wall_clock
        self._sleep = sleep
        if isinstance(ft_config, ServingFaultToleranceConfig):
            ft_config = ft_config.to_dict()
        self.replicas: List[ReplicaHandle] = []
        for r, (factory, path) in enumerate(zip(factories, journal_paths)):
            # each replica owns its own WAL: journal_path is spelled into the
            # per-replica fault-tolerance section so enabled=True validates
            replica_ft = dict(ft_config, journal_path=path) \
                if ft_config is not None else None
            sup = ServingSupervisor(factory, journal_path=path,
                                    config=replica_ft, telemetry=telemetry,
                                    clock=clock, wall_clock=wall_clock,
                                    sleep=sleep)
            self.replicas.append(ReplicaHandle(index=r, supervisor=sup,
                                               journal_path=path))
        # ---- routing / failover counters (host ints; populate_from_router
        # exports them, FleetAggregator merges them with replica counters)
        self.routed_total: List[int] = [0] * len(self.replicas)
        self.affinity_routed_total = 0       # home replica took the request
        self.affinity_overridden_total = 0   # home existed but was unhealthy
        self.reroutes_total = 0              # retryable sheds sent elsewhere
        self.backoff_seconds_total = 0.0
        self.migrations_total = 0            # replicas drained + migrated
        self.migrated_requests_total = 0     # entries transplanted
        self.adopted_from_journal_total = 0  # dead-journal terminals adopted
        self.lost_total = 0                  # the zero-lost-requests invariant
        # per-tenant fleet counters: placement and quota sheds by tenant — a
        # quota shed is tenant-global (rerouting to a sibling cannot help),
        # so it surfaces here instead of in reroutes_total
        self.routed_by_tenant: Dict[str, int] = {}
        self.quota_sheds_by_tenant: Dict[str, int] = {}
        self.recorder = FlightRecorder(256)
        self._served_uids: Set[int] = set()
        # ---- merged fleet ops surface: aggregator always on (host dicts are
        # cheap); the HTTP listener only when an ops_server config asks
        self.aggregator = FleetAggregator()
        self.ops = None
        self._ops_cache = None
        if ops_server is not None:
            ops_cfg = ops_server if isinstance(ops_server, OpsServerConfig) \
                else OpsServerConfig(**dict(ops_server))
            if ops_cfg.enabled:
                self._ops_cache = OpsCache()
                self.ops = try_start_ops_server(self._ops_cache,
                                                host=ops_cfg.host,
                                                port=ops_cfg.port,
                                                owner="fleet router")
                self._refresh_ops()

    # ------------------------------------------------------------- accounting
    def _event(self, event: str, **fields) -> None:
        self.recorder.record(event, t=self._wall(), **fields)
        if self.telemetry is not None:
            self.telemetry.record_resilience(f"fleet_{event}", **fields)

    # ---------------------------------------------------------- health gating
    def observe(self, index: int, health: Dict[str, Any]) -> None:
        """Record a replica's ``health()`` snapshot (absorbed automatically
        after every serve generation; tests inject synthetic ones)."""
        replica = self.replicas[index]
        replica.health = health
        replica.observed_at = self._clock()

    def _is_healthy(self, index: int, now: float) -> bool:
        """Routable AND trustworthy: not drained, supervisor not degraded,
        and the last health snapshot (if any) is inside the staleness
        horizon.  A never-observed replica is healthy-unknown — a fresh
        fleet must be routable before its first serve."""
        replica = self.replicas[index]
        if replica.drained or replica.supervisor.degraded:
            return False
        if replica.health is None:
            return True
        stamp = replica.health.get("generated_at", replica.observed_at)
        if stamp is None:
            return True
        return (now - float(stamp)) <= self.cfg.health_stale_s

    def _load_score(self, index: int) -> float:
        """Weighted load from the engine's own gauges: queue depth + KV
        utilization, plus a steering penalty when the capacity forecaster
        predicts exhaustion within ``exhaustion_steer_steps`` — the router
        moves traffic away BEFORE the replica starts shedding."""
        h = self.replicas[index].health
        if h is None:
            return 0.0
        score = (float(h.get("queue_depth", 0)) * self.cfg.queue_weight
                 + float(h.get("kv_utilization", 0.0)) * self.cfg.kv_weight)
        forecast = h.get("kv", {}).get("forecast", {}) or {}
        steps = forecast.get("steps_to_exhaustion")
        steer = self.cfg.exhaustion_steer_steps
        if steps is not None and float(steps) < steer:
            score += EXHAUSTION_PENALTY * (1.0 + (steer - float(steps)) / steer)
        return score

    def healthy_indices(self) -> List[int]:
        now = self._clock()
        return [r.index for r in self.replicas if self._is_healthy(r.index, now)]

    # --------------------------------------------------------------- routing
    def _affinity_home(self, prompt: Sequence[int],
                       tenant: str = "default") -> Optional[int]:
        """Home replica for a prompt header: the chained block hash at depth
        ``affinity_blocks`` (the SAME key the prefix cache indexes by, so
        prompts that would share cached blocks share a home).  The tenant
        namespace seeds the chain exactly as the cache's own key does — two
        tenants with byte-identical prompts get independent homes, so
        placement leaks nothing across the tenant boundary either.
        None when the prompt has no full block or affinity is off."""
        if self.cfg.affinity_blocks <= 0:
            return None
        depth = self.cfg.affinity_blocks * self.block_size
        hashes = block_hashes(list(prompt)[:depth], self.block_size,
                              tenant_namespace(tenant))
        if not hashes:
            return None
        return int.from_bytes(hashes[-1][:8], "big") % len(self.replicas)

    def route(self, prompt: Sequence[int], *,
              exclude: Iterable[int] = (),
              tenant: str = "default") -> Optional[int]:
        """Pick a replica for one prompt: the healthy affinity home when it
        has one, else the least-loaded healthy replica; when NO replica is
        healthy, any undrained one (best-effort beats refusal — staleness
        may be a probe gap, drain is definitive).  None only when every
        replica outside ``exclude`` is drained."""
        now = self._clock()
        excluded = set(exclude)
        candidates = [r.index for r in self.replicas
                      if not r.drained and r.index not in excluded]
        if not candidates:
            return None
        healthy = [i for i in candidates if self._is_healthy(i, now)]
        home = self._affinity_home(prompt, tenant)
        if home is not None and home in healthy \
                and self._load_score(home) < EXHAUSTION_PENALTY:
            self.affinity_routed_total += 1
            return home
        if home is not None and home in candidates:
            self.affinity_overridden_total += 1
        pool = healthy or candidates
        return min(pool, key=lambda i: (self._load_score(i), i))

    # ---------------------------------------------------------------- serving
    def serve(self, prompts: Sequence[Sequence[int]], *,
              uids: Optional[Sequence[int]] = None,
              max_new_tokens: int = 32, eos_token_id: Optional[int] = None,
              greedy: bool = True,
              priorities: Optional[Sequence[int]] = None,
              ttl_s: Optional[Sequence[Optional[float]]] = None,
              tenants: Optional[Sequence[str]] = None,
              service_classes: Optional[Sequence[str]] = None
              ) -> List[RequestResult]:
        """Serve a workload across the fleet; one terminal result per prompt,
        in input order.  Every request reaches exactly one terminal — sheds
        are re-routed with backoff, exhausted replicas are drained and their
        journaled in-flight work migrated — and the router never hangs: when
        the LAST replica drains, whatever is left is finalized ``failed``
        (and counted in ``lost_total``, which staying zero is the point)."""
        if uids is None:
            base = (max(self._served_uids) + 1) if self._served_uids else 0
            uids = list(range(base, base + len(prompts)))
        uid_list = [int(u) for u in uids]
        if len(uid_list) != len(prompts):
            raise ValueError(f"{len(prompts)} prompts but {len(uid_list)} uids")
        dupes = self._served_uids.intersection(uid_list)
        if len(set(uid_list)) != len(uid_list) or dupes:
            raise ValueError(
                f"fleet uids must be unique across the router's lifetime "
                f"(journals adopt prior terminals for reused uids); "
                f"clashing: {sorted(dupes) or 'within this call'}")
        self._served_uids.update(uid_list)
        specs = [ServeSpec(uid=uid, prompt=list(prompt),
                           priority=(int(priorities[i]) if priorities else 0),
                           ttl_s=(ttl_s[i] if ttl_s else None),
                           tenant=(str(tenants[i]) if tenants is not None
                                   and tenants[i] else "default"),
                           service_class=(str(service_classes[i])
                                          if service_classes is not None
                                          and service_classes[i]
                                          else "interactive"))
                 for i, (uid, prompt) in enumerate(zip(uid_list, prompts))]
        spec_by_uid = {s.uid: s for s in specs}
        results: Dict[int, RequestResult] = {}
        # which replicas already shed a uid: re-routes avoid them (their
        # journal holds a shed terminal that recovery would adopt)
        shed_at: Dict[int, Set[int]] = {}
        assignment: Dict[int, List[ServeSpec]] = {}
        for spec in specs:
            target = self.route(spec.prompt, tenant=spec.tenant)
            if target is None:
                results[spec.uid] = self._lost(spec.uid)
                continue
            assignment.setdefault(target, []).append(spec)
            self.routed_total[target] += 1
            self.routed_by_tenant[spec.tenant] = \
                self.routed_by_tenant.get(spec.tenant, 0) + 1
            self._event("route", uid=spec.uid, replica=target)

        attempt = 0
        while assignment:
            next_assignment: Dict[int, List[ServeSpec]] = {}
            retry_hints: List[float] = []
            rerouted_shed = False
            for index in sorted(assignment):
                replica = self.replicas[index]
                batch = assignment[index]
                got, exhausted = replica.supervisor.serve_specs(
                    batch, max_new_tokens=max_new_tokens,
                    eos_token_id=eos_token_id, greedy=greedy,
                    on_generation=lambda eng, gen, _i=index:
                        self._absorb(_i, eng, gen))
                if exhausted:
                    # the supervisor stopped INSIDE its budget contract: drain
                    # this replica and move the journaled in-flight work
                    replica.drained = True
                    self.migrations_total += 1
                    self._event("replica_exhausted", replica=index,
                                restarts=replica.supervisor.restarts_total)
                    logger.warning(f"fleet: replica {index} exhausted its "
                                   f"restart budget — draining and migrating "
                                   f"journaled work")
                    unresolved = [s for s in batch if s.uid not in got]
                    adopted, regrouped, lost = self._migrate(index, unresolved)
                    results.update(adopted)
                    results.update(lost)
                    for target, moved in regrouped.items():
                        next_assignment.setdefault(target, []).extend(moved)
                        self.routed_total[target] += len(moved)
                    results.update({u: r for u, r in got.items()})
                    continue
                for uid, result in got.items():
                    spec = spec_by_uid.get(uid)
                    if spec is None:
                        continue
                    if result.status == SHED \
                            and result.shed_code == QUOTA_EXCEEDED:
                        # a quota shed is TENANT-global, not replica-local:
                        # every sibling enforces the same per-tenant budget,
                        # so rerouting would just burn its admission door
                        # (and journal a second shed terminal that recovery
                        # would adopt).  Surface it to the caller with the
                        # quota-derived retry_after_s — the client backs off
                        # for the tenant's own refill window
                        self.quota_sheds_by_tenant[spec.tenant] = \
                            self.quota_sheds_by_tenant.get(spec.tenant, 0) + 1
                        if result.retry_after_s is not None:
                            # the quota window still floors THIS round's
                            # backoff: reroutes sharing the round must not
                            # land before the tenant's bucket can refill
                            retry_hints.append(float(result.retry_after_s))
                        self._event("quota_shed", uid=uid, replica=index,
                                    tenant=spec.tenant,
                                    retry_after_s=result.retry_after_s)
                        results[uid] = result
                        continue
                    if result.status == SHED and result.retryable \
                            and attempt < self.cfg.max_reroutes:
                        shed_at.setdefault(uid, set()).add(index)
                        target = self.route(spec.prompt,
                                            exclude=shed_at[uid],
                                            tenant=spec.tenant)
                        if target is not None:
                            next_assignment.setdefault(target, []).append(spec)
                            self.routed_total[target] += 1
                            self.reroutes_total += 1
                            rerouted_shed = True
                            if result.retry_after_s is not None:
                                retry_hints.append(float(result.retry_after_s))
                            self._event("reroute", uid=uid, shed_by=index,
                                        replica=target,
                                        retry_after_s=result.retry_after_s)
                            continue
                    results[uid] = result
            # migration rounds continue immediately; only shed re-routes wait
            # out the pressure that caused them
            if rerouted_shed:
                delay = self._backoff_delay(attempt, retry_hints)
                if delay > 0.0:
                    self.backoff_seconds_total += delay
                    self._event("backoff", delay_s=delay, attempt=attempt,
                                pending=sum(len(v) for v in
                                            next_assignment.values()))
                    self._sleep(delay)
            assignment = next_assignment
            attempt += 1
        self._refresh_ops()
        return [results[uid] for uid in uid_list]

    def _backoff_delay(self, attempt: int, hints: List[float]) -> float:
        """Honor the sheds' own ``retry_after_s`` estimates when present
        (the admission door knows its pressure better than a fixed curve),
        floor at exponential backoff, cap at ``backoff_max_s``."""
        base = self.cfg.backoff_base_s * (2.0 ** attempt)
        return min(self.cfg.backoff_max_s, max([base] + hints))

    def _lost(self, uid: int) -> RequestResult:
        self.lost_total += 1
        self._event("unroutable", uid=uid)
        return RequestResult(uid=uid, status=FAILED, retryable=True,
                             reason=UNROUTABLE_REASON)

    # --------------------------------------------------------------- failover
    def _migrate(self, dead_index: int, specs: Sequence[ServeSpec]
                 ) -> Tuple[Dict[int, RequestResult],
                            Dict[int, List[ServeSpec]],
                            Dict[int, RequestResult]]:
        """Replay the drained replica's journal and move every unresolved
        request: journaled terminals are adopted as results, in-flight
        entries are transplanted — prompt, emitted prefix, and the ORIGINAL
        ttl/wall pair — into per-target journals (durably, fsync-per-record)
        before any target serves them.  Returns (adopted, {target: specs},
        lost); ``lost`` is non-empty only when no undrained replica exists."""
        dead = self.replicas[dead_index]
        # read-only replay: the dead journal stays as forensic truth (the
        # work is not terminal THERE — it moved); truncation is for writers
        state = replay_journal(dead.journal_path, truncate=False)
        adopted: Dict[int, RequestResult] = {}
        regrouped: Dict[int, List[ServeSpec]] = {}
        lost: Dict[int, RequestResult] = {}
        writers: Dict[int, RequestJournal] = {}
        for spec in specs:
            entry = state.entries.get(spec.uid)
            if entry is not None and entry.done:
                adopted[spec.uid] = result_from_entry(entry)
                self.adopted_from_journal_total += 1
                continue
            target = self.route(spec.prompt, exclude={dead_index},
                                tenant=spec.tenant)
            if target is None:
                lost[spec.uid] = self._lost(spec.uid)
                continue
            journal = writers.get(target)
            if journal is None:
                journal = writers[target] = RequestJournal(
                    self.replicas[target].journal_path, fsync_every=1,
                    wall_clock=self._wall)
            if entry is not None:
                # identity migrates AS JOURNALED: the target's recovery reads
                # tenant/class from this record, never from the spec
                journal.record_admit(
                    spec.uid, entry.prompt, priority=entry.priority,
                    ttl_s=entry.ttl_s, max_new_tokens=entry.max_new_tokens,
                    eos_token_id=entry.eos_token_id, greedy=entry.greedy,
                    admit_wall=entry.admit_wall, tenant=entry.tenant,
                    service_class=entry.service_class)
                if entry.emitted:
                    journal.note_tokens(spec.uid, list(entry.emitted))
            # entry None = the replica died before durably admitting it:
            # nothing to transplant — the target admits it fresh
            regrouped.setdefault(target, []).append(spec)
            self.migrated_requests_total += 1
            self._event("migrate", uid=spec.uid, src=dead_index, dst=target,
                        emitted=len(entry.emitted) if entry is not None else 0)
        for journal in writers.values():
            journal.flush()
            journal.close()
        if dead.supervisor.ops is not None:
            dead.supervisor.close_ops()
        return adopted, regrouped, lost

    # ------------------------------------------------------------- ops plane
    def _absorb(self, index: int, engine, generation: int) -> None:
        """Fold one replica generation into the fleet aggregator (rank =
        replica index; generation bumps carry counters) and refresh the
        router's health view from the same engine."""
        try:
            reg = MetricsRegistry(namespace=self.cfg.namespace,
                                  generation=generation)
            populate_from_engine(reg, engine)
            self.aggregator.absorb(index, reg.snapshot())
            self.observe(index, engine.health())
        except Exception as exc:   # a crashed engine's gauges must never
            self._event("absorb_failed", replica=index,   # unwind serving
                        detail=f"{type(exc).__name__}: {exc}")

    def registry(self):
        """The merged fleet registry: every replica's carried counters and
        rank-blind-merged histograms, plus the router's own families."""
        reg = self.aggregator.registry(namespace=self.cfg.namespace)
        populate_from_router(reg, self)
        return reg

    def metrics_text(self) -> str:
        return render(self.registry(), collect=False)

    def health(self) -> Dict[str, Any]:
        """Fleet-level /healthz: per-replica state plus routing totals."""
        now = self._clock()
        return {
            "replicas": [{
                "index": r.index,
                "drained": r.drained,
                "degraded": r.supervisor.degraded,
                "healthy": self._is_healthy(r.index, now),
                "load_score": self._load_score(r.index),
                "generations": r.supervisor.generations,
                "restarts_total": r.supervisor.restarts_total,
            } for r in self.replicas],
            "healthy_replicas": len(self.healthy_indices()),
            "routed_total": list(self.routed_total),
            "affinity_routed_total": self.affinity_routed_total,
            "reroutes_total": self.reroutes_total,
            "migrations_total": self.migrations_total,
            "migrated_requests_total": self.migrated_requests_total,
            "lost_total": self.lost_total,
        }

    def _refresh_ops(self) -> None:
        if self._ops_cache is None:
            return
        self._ops_cache.update(
            metrics_text=self.metrics_text(),
            healthz=json.dumps(self.health()),
            statez=json.dumps({"events": self.recorder.tail()}))

    def close(self) -> None:
        """Shut the ops listener down (tests / clean teardown)."""
        if self.ops is not None:
            self.ops.close()
        for replica in self.replicas:
            replica.supervisor.close_ops()
