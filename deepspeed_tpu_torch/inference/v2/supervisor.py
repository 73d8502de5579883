"""Supervised serving restart + crash recovery with decode continuation.

Counterpart of ``deepspeed_tpu/inference/v2/supervisor.py``.  All of the v2
engine's admission,
deadline and watchdog resilience is in-process, so a serving-process crash
(OOM, preempted VM, wedged device) would destroy every queued and in-flight
request.  The supervisor composes the fsync+CRC request journal
(``journal.py``), the flight recorder (``monitor/tracing.py``) and the
heartbeat liveness stamps (``runtime/heartbeat.py``) into a supervisor of
serving engines:

- **Liveness.**  The engine stamps a phase-``serving`` heartbeat each serve
  iteration (zero device syncs — the writer only touches host ints).  In
  subprocess mode (:meth:`ServingSupervisor.supervise_command`) a stale
  stamp (``hang_timeout_s``, after ``startup_grace_s``) or a dead process
  both count as ONE failure: kill, reap, restart.  In-process mode
  (:meth:`ServingSupervisor.serve`) an engine exception is the failure
  signal; a wedged-but-live loop is already bounded by the engine's own
  stall watchdog, so in-process hang detection is intentionally not
  duplicated here.  The failure seam rebuilds the engine on the same
  device: recovery never moves work to the CPU or to a plain version.
- **Recovery.**  Each restart replays the journal (torn tail truncated),
  adopts already-terminal results, finalizes requests whose
  journaled prefix already satisfies their budget/eos/TTL, and re-admits the
  rest *with their emitted token prefix* (``engine.serve_recovered``) so
  recovered decodes continue from where they died instead of restarting from
  scratch.  Recovered requests keep their ORIGINAL TTL clock: remaining
  budget is computed against the journal's wall-clock admit stamp.
- **Budget.**  ``max_restarts`` within ``restart_window_s``; past it the
  supervisor degrades to drain-only mode — new (never-journaled) admissions
  are shed with a structured retryable reason, recoverable journal work gets
  ONE final attempt, and whatever still isn't terminal is finalized as
  ``failed`` directly in the journal.  Every request reaches exactly one
  terminal :class:`RequestResult`; the supervisor never hangs.
- **Fleet metrics.**  With ``ops_server`` the supervisor serves one
  ``/metrics`` for the fleet: workers publish per-generation registry
  snapshots (under the exported ``DSTPU_OPS_DIR`` in subprocess mode; the
  engine's final state is absorbed directly in process) and a
  ``FleetAggregator`` merges them, carrying counters across generations so a
  restart never makes a fleet counter go backwards.

Clock discipline: monotonic reads flow through the injectable ``clock`` seam
and wall-clock reads through ``wall_clock`` (both bound to the ``time``
functions as defaults), so fault tests drive fake time deterministically.
"""

import dataclasses
import json
import logging
import os
import shutil
import subprocess
import tempfile
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ...monitor.exposition import render
from ...monitor.metrics import (FleetAggregator, MetricsRegistry, populate_from_engine,
                                populate_from_supervisor)
from ...monitor.ops_server import OpsCache, read_rank_snapshots, try_start_ops_server
from ...monitor.tracing import FlightRecorder
from ...runtime.config import OpsServerConfig, ServingFaultToleranceConfig
from ...utils.env import warning_once
from ...runtime.heartbeat import (HEARTBEAT_DIR_ENV, HEARTBEAT_INTERVAL_ENV,
                                  OPS_DIR_ENV, SERVING_DRAIN_ENV,
                                  SERVING_FSYNC_ENV, SERVING_GENERATION_ENV,
                                  SERVING_JOURNAL_ENV, heartbeat_age,
                                  read_heartbeats)
from .admission import (DEADLINE_EXPIRED, FAILED, OK, SHED, RecoveredRequest,
                        RequestResult)
from .journal import JournalEntry, JournalState, RequestJournal, replay_journal

logger = logging.getLogger(__name__)

DRAIN_SHED_REASON = ("drain mode: serving restart budget exhausted — new "
                     "admissions are shed; resubmit once the service recovers")
FINALIZE_REASON = ("restart budget exhausted and the drain-only recovery "
                   "attempt also failed — request finalized by the supervisor")


@dataclasses.dataclass
class ServeSpec:
    """One request as the CALLER describes it (the workload side of
    recovery planning; the journal side is :class:`JournalEntry`)."""
    uid: int
    prompt: List[int]
    priority: int = 0
    ttl_s: Optional[float] = None
    # QoS identity: the caller's tenant + service class, carried through
    # admission, the journal and recovery unchanged
    tenant: str = "default"
    service_class: str = "interactive"


@dataclasses.dataclass
class RecoveryPlan:
    """What a journal replay means for one serve attempt."""
    adopted: Dict[int, RequestResult] = dataclasses.field(default_factory=dict)
    # terminals to append for requests PLANNING resolved (prefix already
    # complete, TTL spent in a dead generation, drain-mode shed): the journal
    # must reach terminal-everywhere without another serve touching them
    finalize: List[Tuple[int, str, Dict[str, Any]]] = dataclasses.field(default_factory=list)
    entries: List[RecoveredRequest] = dataclasses.field(default_factory=list)
    recovered: int = 0  # entries carrying a non-empty emitted prefix


def result_from_entry(entry: JournalEntry) -> RequestResult:
    """Rebuild the ``RequestResult`` a journaled terminal mirrors."""
    term = entry.terminal or {}
    status = term.get("status", FAILED)
    tokens = entry.prompt + entry.emitted if status != SHED else []
    return RequestResult(uid=entry.uid, status=status, tokens=tokens,
                         finish_reason=term.get("finish_reason"),
                         reason=term.get("reason"),
                         retryable=bool(term.get("retryable", False)),
                         shed_code=term.get("code"))


def plan_recovery(state: JournalState, specs: Sequence[ServeSpec], *,
                  max_new_tokens: int, eos_token_id: Optional[int] = None,
                  token_cap: Optional[int] = None, drain: bool = False,
                  now_wall: float = 0.0) -> RecoveryPlan:
    """Partition a workload against the replayed journal.

    Per spec uid: adopt a journaled terminal as-is; finalize incomplete
    entries whose prefix already satisfies the budget / eos / per-sequence
    cap (finish as ``ok`` without re-serving) or whose ORIGINAL TTL has run
    out (``deadline_expired`` — the deadline clock never resets across
    restarts); re-admit the rest with their emitted prefix and remaining
    TTL; and in drain mode shed anything the journal has never seen.
    """
    plan = RecoveryPlan()
    for spec in specs:
        uid = int(spec.uid)
        entry = state.entries.get(uid)
        if entry is None:
            if drain:
                plan.adopted[uid] = RequestResult(uid=uid, status=SHED,
                                                  reason=DRAIN_SHED_REASON,
                                                  retryable=True)
                plan.finalize.append((uid, SHED,
                                      {"reason": DRAIN_SHED_REASON,
                                       "retryable": True}))
            else:
                # an explicit caller TTL pins (serve_recovered only forwards
                # pinned TTLs); ttl_s=None stays unpinned so the engine's
                # default_ttl_s applies exactly like generate()
                plan.entries.append(RecoveredRequest(
                    uid=uid, prompt=list(spec.prompt), prefix=[],
                    priority=spec.priority, ttl_s=spec.ttl_s,
                    pin_ttl=spec.ttl_s is not None,
                    tenant=spec.tenant, service_class=spec.service_class))
            continue
        if entry.done:
            plan.adopted[uid] = result_from_entry(entry)
            continue
        prompt, emitted = entry.prompt, entry.emitted
        # the CALLER's budget/eos are authoritative — they are what
        # serve_recovered will enforce on the re-admitted sequence, so the
        # plan must judge completion by the same contract (judging by the
        # journaled values while the engine enforces the caller's would
        # silently truncate or over-run recovered decodes whenever the two
        # disagree; the journaled values remain for forensics)
        budget = max_new_tokens
        eos = eos_token_id
        remaining = entry.ttl_remaining(now_wall)
        if remaining is not None and remaining <= 0:
            reason = "original TTL exhausted across restart"
            plan.adopted[uid] = RequestResult(uid=uid, status=DEADLINE_EXPIRED,
                                              tokens=prompt + emitted,
                                              reason=reason, retryable=True)
            plan.finalize.append((uid, DEADLINE_EXPIRED,
                                  {"reason": reason, "retryable": True,
                                   "n_tokens": len(emitted)}))
            continue
        finish = None
        if emitted and eos is not None and emitted[-1] == eos:
            finish = "eos"
        elif len(emitted) >= budget:
            finish = "max_new_tokens"
        elif emitted and token_cap is not None \
                and len(prompt) + len(emitted) + 1 > token_cap:
            finish = "length_capped"
        if finish is not None:
            # the journaled prefix IS the complete answer: only the terminal
            # record died with the old process — finalize without re-serving
            plan.adopted[uid] = RequestResult(uid=uid, status=OK,
                                              tokens=prompt + emitted,
                                              finish_reason=finish)
            plan.finalize.append((uid, OK, {"finish_reason": finish,
                                            "n_tokens": len(emitted)}))
            continue
        # identity comes from the JOURNAL, not the spec: the journaled
        # tenant/class is what admission actually accepted — recovery must
        # not let a resubmitted spec launder a best-effort request into
        # interactive (or reassign its tenant) across a crash
        plan.entries.append(RecoveredRequest(
            uid=uid, prompt=list(prompt), prefix=list(emitted),
            priority=entry.priority, ttl_s=remaining, pin_ttl=True,
            tenant=entry.tenant, service_class=entry.service_class))
        if emitted:
            plan.recovered += 1
    return plan


def recover_and_serve(engine, specs: Sequence[ServeSpec], *,
                      max_new_tokens: int, eos_token_id: Optional[int] = None,
                      greedy: bool = True, drain: Optional[bool] = None,
                      wall_clock: Callable[[], float] = time.time
                      ) -> Dict[int, RequestResult]:
    """One generation's worth of work on a journal-armed engine: replay,
    plan, journal the planning's terminals, serve the rest.  The seam both
    the in-process supervisor and supervised worker processes call — a
    worker's whole body is ``recover_and_serve(engine, specs, ...)``.

    ``drain=None`` reads the supervisor-exported ``DSTPU_SERVING_DRAIN``
    env, so drain-only degradation needs no worker-side plumbing."""
    journal = engine.journal
    if journal is None:
        raise ValueError("recover_and_serve needs a journal-armed engine "
                         "(serving_fault_tolerance.journal_path, the "
                         "DSTPU_SERVING_JOURNAL env, or engine journal=)")
    if drain is None:
        drain = bool(os.environ.get(SERVING_DRAIN_ENV))
    state = replay_journal(journal.path, truncate=False)
    engine.tracer.event("replay", records=state.records,
                        requests=len(state.entries),
                        incomplete=len(state.incomplete()),
                        **({"truncated_tail": state.truncated_tail}
                           if state.truncated_tail else {}))
    token_cap = engine.manager.max_blocks_per_seq * engine.manager.block_size
    plan = plan_recovery(state, specs, max_new_tokens=max_new_tokens,
                         eos_token_id=eos_token_id, token_cap=token_cap,
                         drain=drain, now_wall=wall_clock())
    for uid, status, kw in plan.finalize:
        journal.record_terminal(uid, status, **kw)
        engine.tracer.event("finalized", uid=uid, status=status)
    results = dict(plan.adopted)
    if plan.entries:
        results.update(engine.serve_recovered(plan.entries,
                                              max_new_tokens=max_new_tokens,
                                              eos_token_id=eos_token_id,
                                              greedy=greedy, strict=False))
    return results


class ServingSupervisor:
    """Runs the v2 serving engine under liveness supervision with a
    crash-durable request journal (module docstring for the full story).

    ``engine_factory`` (in-process mode) builds a FRESH engine per
    generation — restart semantics are a clean device state; the supervisor
    attaches the journal and recovery counters.  Subprocess mode
    (:meth:`supervise_command`) needs no factory: the worker process builds
    its own engine from the supervisor-exported env.

    One journal per WORKLOAD: the journal is the workload's durable state,
    keyed by uid.  Serving a NEW workload against a journal that already
    holds terminals for the same uids adopts those results instead of
    serving (that is the recovery contract working as designed) — give a
    fresh workload a fresh ``journal_path``.

    ``ops_server`` (an ``OpsServerConfig`` or its dict; None leaves the plane
    off) serves the fleet endpoint; ``telemetry`` receives the lifecycle
    events as ``serving_<event>`` resilience records.
    """

    def __init__(self, engine_factory: Optional[Callable[[], Any]] = None, *,
                 journal_path: Optional[str] = None, config=None,
                 telemetry=None, clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep,
                 ops_server=None):
        if config is None:
            config = ServingFaultToleranceConfig(enabled=False)
        elif isinstance(config, dict):
            config = ServingFaultToleranceConfig(**{"enabled": False, **config})
        self.cfg = config
        self.engine_factory = engine_factory
        self.journal_path = journal_path or self.cfg.journal_path
        if not self.journal_path:
            raise ValueError("ServingSupervisor needs journal_path (argument "
                             "or serving_fault_tolerance.journal_path)")
        self.telemetry = telemetry
        self._clock = clock
        self._wall = wall_clock
        self._sleep = sleep
        self.restarts_total = 0
        self.recovered_requests_total = 0
        self.degraded = False
        self.generations = 0
        self._failure_times: deque = deque()
        # the supervisor's own postmortem ring of lifecycle events
        self.recorder = FlightRecorder(256)
        # fleet-level ops endpoint: the aggregator merges worker snapshots
        # (histograms exactly, counters carried across generations)
        self.ops_cfg: Optional[OpsServerConfig] = None
        self.ops = None
        self._ops_cache = None
        self._ops_agg = None
        self._ops_dir: Optional[str] = None
        self._ops_own_dir = False
        if ops_server is not None:
            cfg = ops_server if isinstance(ops_server, OpsServerConfig) \
                else OpsServerConfig(**dict(ops_server))
            if cfg.enabled or cfg.textfile_dir:
                self.ops_cfg = cfg
                self._ops_agg = FleetAggregator()
                self._ops_cache = OpsCache()
                self._ops_dir = cfg.textfile_dir
                if self._ops_dir is None:
                    self._ops_dir = tempfile.mkdtemp(prefix="dstpu_serving_ops_")
                    self._ops_own_dir = True
                if cfg.enabled:
                    self.ops = try_start_ops_server(self._ops_cache, host=cfg.host,
                                                    port=cfg.port, owner="serving supervisor")
                self._ops_last_refresh = -float("inf")
                self._refresh_ops(force=True)

    # ----------------------------------------------------------- ops endpoint
    def ops_health(self) -> Dict[str, Any]:
        """The supervisor's /healthz: restart budget, degradation, and which
        worker ranks have published metrics."""
        return {
            "restarts_total": self.restarts_total,
            "generations": self.generations,
            "degraded": self.degraded,
            "recovered_requests_total": self.recovered_requests_total,
            "failures_in_window": len(self._failure_times),
            "max_restarts": self.cfg.max_restarts,
            "ranks": self._ops_agg.ranks() if self._ops_agg is not None else [],
        }

    def _refresh_ops(self, force: bool = False) -> None:
        """Absorb fresh worker snapshots and re-render the merged fleet
        registry and the supervisor's health into the scrape cache, at most
        once per ``refresh_interval_s`` unless forced (the watch loop polls
        far more often)."""
        if self._ops_agg is None:
            return
        now = self._clock()
        if not force and now - self._ops_last_refresh < self.ops_cfg.refresh_interval_s:
            return
        self._ops_last_refresh = now
        self._ops_absorb_dir()
        merged = self._ops_agg.registry(namespace=self.ops_cfg.namespace)
        populate_from_supervisor(merged, self)
        self._ops_cache.update(
            metrics_text=render(merged, collect=False),
            healthz=json.dumps(self.ops_health()),
            statez=json.dumps({"events": self.recorder.tail(),
                               "ranks": self._ops_agg.ranks()}))

    def _ops_absorb_dir(self) -> None:
        """Fold every readable worker snapshot under the ops dir into the
        aggregator (subprocess mode; generation bumps roll counter carry)."""
        if self._ops_agg is None or self._ops_dir is None:
            return
        for rank, snap in read_rank_snapshots(self._ops_dir).items():
            try:
                self._ops_agg.absorb(rank, snap)
            except (ValueError, KeyError, TypeError) as exc:
                # a malformed-but-parseable snapshot degrades that rank's
                # freshness; it must never unwind the watch loop
                warning_once(f"ops: rank {rank} snapshot rejected ({exc!r}); "
                             f"keeping its last merged state")

    def _ops_absorb_engine(self, engine, generation: int) -> None:
        """Fold an in-process engine's final state into the aggregator (the
        in-process analog of a worker's published snapshot)."""
        if self._ops_agg is None or engine is None:
            return
        reg = MetricsRegistry(namespace=self.ops_cfg.namespace, generation=generation)
        populate_from_engine(reg, engine)
        self._ops_agg.absorb(0, reg.snapshot())

    def close_ops(self) -> None:
        """Shut the ops listener down."""
        if self.ops is not None:
            self.ops.close()

    # ------------------------------------------------------------- accounting
    def _event(self, event: str, **fields) -> None:
        self.recorder.record(event, t=self._wall(), **fields)
        if self.telemetry is not None:
            self.telemetry.record_resilience(f"serving_{event}", **fields)

    def _note_failure(self, detail: str) -> None:
        now = self._clock()
        self._failure_times.append(now)
        window = self.cfg.restart_window_s
        while self._failure_times and now - self._failure_times[0] > window:
            self._failure_times.popleft()
        self._event("worker_failed", detail=detail,
                    failures_in_window=len(self._failure_times))
        logger.warning(f"serving supervisor: worker failed ({detail}); "
                       f"{len(self._failure_times)} failure(s) in the last "
                       f"{window:.0f}s")

    def _budget_exhausted(self) -> bool:
        return len(self._failure_times) > self.cfg.max_restarts

    # --------------------------------------------------------- in-process mode
    def _build_engine(self, generation: int):
        engine = self.engine_factory()
        if engine.journal is not None \
                and os.path.abspath(engine.journal.path) != os.path.abspath(self.journal_path):
            # fail fast: recovery would replay one file while finalization
            # replays the other — every unresolved request would be
            # finalized FAILED while its real prefixes sit unread
            raise ValueError(
                f"engine_factory armed its own journal at "
                f"{engine.journal.path!r} but this supervisor owns "
                f"{self.journal_path!r} — point serving_fault_tolerance."
                f"journal_path at the supervisor's path (or leave the "
                f"engine journal-less and let the supervisor attach one)")
        if engine.journal is None:
            engine.journal = RequestJournal(self.journal_path,
                                            fsync_every=self.cfg.fsync_every,
                                            seed=engine.config.seed,
                                            wall_clock=self._wall)
            engine.journal.open_generation(generation)
        engine.ft_stats["restarts_total"] = self.restarts_total
        engine.ft_stats["degraded"] = self.degraded
        if generation > 0:
            engine.tracer.event("restart", generation=generation)
            self._event("restart", generation=generation)
        return engine

    def serve(self, prompts: Sequence[Sequence[int]], *, uids=None,
              max_new_tokens: int = 32, eos_token_id: Optional[int] = None,
              greedy: bool = True, priorities: Optional[Sequence[int]] = None,
              ttl_s: Optional[float] = None) -> List[RequestResult]:
        """Serve a batch to completion across engine crashes.

        Same surface as ``generate(strict=False)`` plus durability: any
        exception out of the engine counts one restart (fresh engine, journal
        replay, prefix re-admission); past the budget the final attempt runs
        drain-only, and if that fails too every unresolved request is
        finalized as ``failed``.  Always returns one terminal
        :class:`RequestResult` per request, in input order."""
        if self.engine_factory is None:
            raise ValueError("in-process serve() needs an engine_factory")
        uid_list = list(range(len(prompts))) if uids is None else [int(u) for u in uids]
        specs = [ServeSpec(uid=uid, prompt=[int(t) for t in prompt],
                           priority=int(priorities[i]) if priorities is not None else 0,
                           ttl_s=ttl_s)
                 for i, (uid, prompt) in enumerate(zip(uid_list, prompts))]
        results: Dict[int, RequestResult] = {}
        drain = False
        final_attempt = False
        generation = 0
        while any(s.uid not in results for s in specs):
            engine = None
            todo = [s for s in specs if s.uid not in results]
            try:
                engine = self._build_engine(generation)
                got = recover_and_serve(engine, todo,
                                        max_new_tokens=max_new_tokens,
                                        eos_token_id=eos_token_id,
                                        greedy=greedy, drain=drain,
                                        wall_clock=self._wall)
                self.recovered_requests_total += \
                    engine.ft_stats["recovered_requests_total"]
                results.update({u: r for u, r in got.items()
                                if u in {s.uid for s in todo}})
                self._event("run_complete", generation=generation,
                            served=len(got))
                break
            except Exception as exc:  # the crash seam: ANY engine failure
                self.restarts_total += 1
                self._note_failure(f"{type(exc).__name__}: {exc}")
                if final_attempt:
                    self._finalize_failed(results, todo)
                    break
                if self._budget_exhausted():
                    self.degraded = True
                    drain = True
                    final_attempt = True
                    self._event("degraded", reason="restart budget exhausted",
                                restarts=self.restarts_total)
                    logger.warning("serving supervisor: restart budget "
                                   "exhausted — degrading to drain-only mode")
            finally:
                self.generations = generation + 1
                if engine is not None and engine.journal is not None:
                    engine.journal.close()
                # this generation's final engine state joins the fleet view;
                # the next generation's counters restart at zero, which the
                # aggregator's generation carry absorbs
                self._ops_absorb_engine(engine, generation)
                self._refresh_ops(force=True)
            generation += 1
        return [results[u] for u in uid_list]

    def serve_specs(self, specs: Sequence[ServeSpec], *,
                    max_new_tokens: int = 32, eos_token_id: Optional[int] = None,
                    greedy: bool = True,
                    on_generation: Optional[Callable[[Any, int], None]] = None
                    ) -> Tuple[Dict[int, RequestResult], bool]:
        """In-process crash-restart serve that STOPS at budget exhaustion
        instead of degrading to drain-only: returns ``(results, exhausted)``.

        This is the fleet router's failover seam (``router.py``).  ``serve()``
        owns the single-replica endgame — drain-only final attempt, then
        finalize-as-failed — because a lone engine has nowhere else to send
        work.  A router DOES: on ``exhausted=True`` the journal still holds
        every unresolved request's emitted prefix and original wall-clock
        admit stamp, ready to migrate to a healthy replica's journal for
        byte-identical ``serve_recovered`` continuation.  ``on_generation``
        (called with each generation's engine, crashed or clean, before its
        journal closes) is the router's metrics-absorption hook."""
        if self.engine_factory is None:
            raise ValueError("serve_specs needs an engine_factory")
        results: Dict[int, RequestResult] = {}
        exhausted = False
        generation = self.generations  # resume numbering across serve calls
        while any(s.uid not in results for s in specs):
            engine = None
            todo = [s for s in specs if s.uid not in results]
            try:
                engine = self._build_engine(generation)
                got = recover_and_serve(engine, todo,
                                        max_new_tokens=max_new_tokens,
                                        eos_token_id=eos_token_id,
                                        greedy=greedy, drain=False,
                                        wall_clock=self._wall)
                self.recovered_requests_total += \
                    engine.ft_stats["recovered_requests_total"]
                results.update({u: r for u, r in got.items()
                                if u in {s.uid for s in todo}})
                self._event("run_complete", generation=generation,
                            served=len(got))
                break
            except Exception as exc:  # the crash seam: ANY engine failure
                self.restarts_total += 1
                self._note_failure(f"{type(exc).__name__}: {exc}")
                if self._budget_exhausted():
                    self.degraded = True
                    exhausted = True
                    self._event("budget_exhausted",
                                restarts=self.restarts_total,
                                unresolved=len([s for s in specs
                                                if s.uid not in results]))
                    logger.warning("serving supervisor: restart budget "
                                   "exhausted — handing journaled work back "
                                   "for migration")
            finally:
                self.generations = generation + 1
                if engine is not None and on_generation is not None:
                    # BEFORE the journal closes: the hook reads this
                    # generation's final engine state
                    on_generation(engine, generation)
                if engine is not None and engine.journal is not None:
                    engine.journal.close()
                self._ops_absorb_engine(engine, generation)
                self._refresh_ops(force=True)
            if exhausted:
                break
            generation += 1
        return results, exhausted

    def _finalize_failed(self, results: Dict[int, RequestResult],
                         todo: Sequence[ServeSpec]) -> None:
        """Drain failed too: every unresolved request becomes a structured
        ``failed`` result, durably terminal in the journal.  Never a hang."""
        journal = RequestJournal(self.journal_path, fsync_every=1,
                                 wall_clock=self._wall)
        state = replay_journal(self.journal_path, truncate=True)
        for spec in todo:
            if spec.uid in results:
                continue
            entry = state.entries.get(spec.uid)
            if entry is not None and entry.done:
                results[spec.uid] = result_from_entry(entry)
                continue
            tokens = (entry.prompt + entry.emitted) if entry is not None else []
            results[spec.uid] = RequestResult(uid=spec.uid, status=FAILED,
                                              tokens=tokens, retryable=True,
                                              reason=FINALIZE_REASON)
            journal.record_terminal(spec.uid, FAILED, reason=FINALIZE_REASON,
                                    retryable=True,
                                    n_tokens=len(entry.emitted) if entry else 0)
        journal.close()
        self._event("finalized", requests=len(todo))

    # --------------------------------------------------------- subprocess mode
    def supervise_command(self, argv: Sequence[str], *,
                          env: Optional[Dict[str, str]] = None,
                          cwd: Optional[str] = None,
                          heartbeat_base: Optional[str] = None) -> Dict[str, Any]:
        """Spawn + supervise a serving worker process: per-generation heartbeat dirs, exit-code
        AND heartbeat-staleness failure detection, kill-and-reap on every
        path (zero orphans), restart budget with drain-only degradation, and
        journal finalization when even the drain generation fails.

        The worker contract is environment-only: ``DSTPU_SERVING_JOURNAL``
        (arm the engine's journal), ``DSTPU_HEARTBEAT_DIR`` +
        ``DSTPU_HEARTBEAT_INTERVAL_S`` (arm serve-iteration stamps),
        ``DSTPU_SERVING_GENERATION``, and ``DSTPU_SERVING_DRAIN`` once
        degraded.  Exit 0 = all work terminal; any other exit or a stale
        heartbeat = one failure.

        Returns a report: generations, restarts, degraded, the final
        :class:`JournalState`, and per-uid ``results`` rebuilt from journaled
        terminals."""
        cfg = self.cfg
        hb_base = heartbeat_base or cfg.heartbeat_dir
        own_hb_base = hb_base is None
        if own_hb_base:
            hb_base = tempfile.mkdtemp(prefix="dstpu_serving_hb_")
        drain = False
        final_attempt = False
        clean_exit = False
        generation = 0
        while True:
            hb_dir = os.path.join(hb_base, f"gen{generation}")
            worker_env = dict(os.environ)
            worker_env.update(env or {})
            worker_env[SERVING_JOURNAL_ENV] = self.journal_path
            worker_env[SERVING_FSYNC_ENV] = str(cfg.fsync_every)
            worker_env[HEARTBEAT_DIR_ENV] = hb_dir
            worker_env[HEARTBEAT_INTERVAL_ENV] = str(cfg.heartbeat_interval_s)
            worker_env[SERVING_GENERATION_ENV] = str(generation)
            if self._ops_dir is not None:
                # workers publish per-rank registry snapshots the aggregator
                # merges into the fleet endpoint (generation-stamped, so the
                # counter carry engages across restarts)
                worker_env[OPS_DIR_ENV] = self._ops_dir
            else:
                # scrub an inherited dir: a foreign supervisor's aggregator
                # must not absorb THIS worker's snapshots as one of its ranks
                worker_env.pop(OPS_DIR_ENV, None)
            if drain:
                worker_env[SERVING_DRAIN_ENV] = "1"
            else:
                worker_env.pop(SERVING_DRAIN_ENV, None)
            self._event("generation_spawned", generation=generation,
                        drain=drain)
            proc = subprocess.Popen(list(argv), env=worker_env, cwd=cwd)
            failure = self._watch(proc, hb_dir)
            self.generations = generation + 1
            if failure is None:
                self._event("run_complete", generation=generation)
                clean_exit = True
                break
            self.restarts_total += 1
            self._note_failure(failure)
            if final_attempt:
                n = self._finalize_journal()
                self._event("finalized", requests=n)
                break
            if self._budget_exhausted():
                self.degraded = True
                drain = True
                final_attempt = True
                self._event("degraded", reason="restart budget exhausted",
                            restarts=self.restarts_total)
            generation += 1
        # final aggregation pass after the recovery accounting lands and
        # before any cleanup
        state = replay_journal(self.journal_path, truncate=True)
        self.recovered_requests_total = sum(
            1 for e in state.entries.values() if e.admits > 1)
        self._refresh_ops(force=True)
        if own_hb_base and clean_exit:
            # sweep OUR tempdir stamps on a clean run, keep them for
            # postmortem on any failure path; caller-provided dirs are never
            # touched
            shutil.rmtree(hb_base, ignore_errors=True)
        if self._ops_own_dir and clean_exit:
            shutil.rmtree(self._ops_dir, ignore_errors=True)
        return {"generations": self.generations,
                "restarts": self.restarts_total,
                "degraded": self.degraded,
                "state": state,
                "results": {uid: result_from_entry(e)
                            for uid, e in state.entries.items() if e.done}}

    def _watch(self, proc, hb_dir: str) -> Optional[str]:
        """Poll one worker generation to its end.  Returns None on a clean
        exit, else the failure description.  The process is ALWAYS reaped
        before returning — a hung worker is killed, never abandoned."""
        cfg = self.cfg
        start = self._clock()
        failure = None
        while True:
            rc = proc.poll()
            if rc is not None:
                if rc == 0:
                    return None
                failure = f"worker exited rc={rc}"
                break
            # fold fresh worker metrics into the fleet endpoint (the dir
            # scan and render ride _refresh_ops' throttle, not the poll rate)
            self._refresh_ops()
            record = read_heartbeats(hb_dir).get(0)
            if record is None:
                if self._clock() - start > cfg.startup_grace_s:
                    failure = (f"no heartbeat within startup_grace_s="
                               f"{cfg.startup_grace_s:.0f}s — worker wedged "
                               f"before its first serve iteration")
                    break
            else:
                age = heartbeat_age(record, self._wall())
                if age > cfg.hang_timeout_s:
                    failure = (f"heartbeat stale for {age:.1f}s "
                               f"(> hang_timeout_s={cfg.hang_timeout_s:.0f}s) "
                               f"at step {record.get('step', '?')} — serving "
                               f"loop hung")
                    self._event("hang_detected", age_s=round(age, 2),
                                step=record.get("step"))
                    break
            self._sleep(cfg.poll_interval_s)
        # reap on EVERY failure path: SIGKILL (a hung worker ignores less),
        # then wait() so no zombie/orphan survives the supervisor
        try:
            proc.kill()
        except OSError as exc:
            logger.warning(f"serving supervisor: kill failed ({exc}); "
                           f"worker may already be gone")
        proc.wait()
        return failure

    def _finalize_journal(self) -> int:
        """Terminal-ize every journal entry the drain generation left
        incomplete, so replay-side consumers see a fully-resolved log."""
        state = replay_journal(self.journal_path, truncate=True)
        incomplete = state.incomplete()
        if not incomplete:
            return 0
        journal = RequestJournal(self.journal_path, fsync_every=1,
                                 wall_clock=self._wall)
        for entry in incomplete:
            journal.record_terminal(entry.uid, FAILED, reason=FINALIZE_REASON,
                                    retryable=True,
                                    n_tokens=len(entry.emitted))
        journal.close()
        return len(incomplete)
