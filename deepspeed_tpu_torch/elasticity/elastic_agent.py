"""Elastic agent (JAX ``deepspeed_tpu/elasticity/elastic_agent.py``):
worker supervision with liveness monitoring, hang diagnosis, coordinated
checkpoint-aware restart, and world rescaling.

The agent spawns the training workers, monitors them, and on failure
re-forms the world at a size the elasticity config permits
(``elasticity.get_valid_gpus``), then restarts from the newest checkpoint
valid across every rank.  Membership is what the agent itself launches (a
single-host supervisor).  Beyond exit codes it supervises liveness:

- **Heartbeats**: workers stamp ``step + wall-clock + last-entered-
  collective`` to per-rank files (``runtime/heartbeat.py``; armed through
  the ``DSTPU_HEARTBEAT_DIR`` env this agent exports).  A stale stamp is a
  failure: a rank stuck in a collective while its peers wait is seen by no
  exit-code poll.
- **Hang diagnosis**: on staleness the agent logs a cross-rank snapshot of
  which ranks sat in which collective (``format_hang_report``), then
  restarts; stragglers (step lagging the group median) are flagged, not
  killed.
- **Coordinated checkpoint-aware restart**: before respawning, the agent
  selects the newest checkpoint tag valid across ALL ranks of the NEW world
  size (``select_consensus_tag``, the validation walk of
  ``load_checkpoint(fallback_to_valid=True)``) and pins it through
  ``DSTPU_RESUME_TAG`` and ``DSTPU_RESUME_DIR``; the engine's
  ``load_checkpoint`` honours the pin.
- **Graceful handoff**: SIGTERM, ``term_grace_secs`` (a worker's
  ``checkpoint.save_on_preemption`` takes its final save there), then
  SIGKILL, with children reaped on every path.
- **Lifecycle telemetry**: worker_failed / hang_detected / straggler /
  rescale / resume_tag events through ``record_resilience`` (when a
  collector is attached) and an always-on flight recorder
  (``monitor/tracing.FlightRecorder``) surfaced by ``state_snapshot()``;
  with ``ops_port`` a merged fleet endpoint (``/metrics``, ``/healthz``,
  ``/statez``) over the workers' per-rank snapshots.

Workers see RANK, WORLD_SIZE, DSTPU_ELASTIC_RESTART (the restart ordinal),
DSTPU_HEARTBEAT_DIR (+ interval) and, when one exists, the pinned tag.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..monitor.tracing import FlightRecorder
from ..runtime.checkpointing import is_valid_tag, list_tags
from ..runtime.heartbeat import (COLLECTIVE_TIMEOUT_ENV, HEARTBEAT_DIR_ENV,
                                 HEARTBEAT_INTERVAL_ENV, INIT_RETRIES_ENV,
                                 INIT_RETRY_BACKOFF_ENV, OPS_DIR_ENV,
                                 RESUME_DIR_ENV, RESUME_TAG_ENV,
                                 format_hang_report, heartbeat_age,
                                 read_heartbeats, stale_ranks, straggler_ranks)
from ..utils.logging import logger
from .elasticity import get_valid_gpus


class WorkerGroup:
    """One generation of worker processes."""

    def __init__(self, procs: List[subprocess.Popen], world_size: int, restart: int,
                 heartbeat_dir: Optional[str] = None):
        self.procs = procs
        self.world_size = world_size
        self.restart = restart
        self.heartbeat_dir = heartbeat_dir  # this generation's stamp dir
        self.spawned_at = time.time()

    def poll_failed(self) -> Optional[Tuple[int, int]]:
        """``(rank, exit_code)`` of the first failed worker, else None."""
        for rank, p in enumerate(self.procs):
            rc = p.poll()
            if rc is not None and rc != 0:
                return rank, rc
        return None

    def all_done(self) -> bool:
        return all(p.poll() == 0 for p in self.procs)

    def alive_ranks(self) -> List[int]:
        return [rank for rank, p in enumerate(self.procs) if p.poll() is None]

    def pids(self) -> List[int]:
        return [p.pid for p in self.procs]

    def terminate(self, grace_secs: float = 10.0):
        """Graceful handoff: SIGTERM every live worker, wait up to
        ``grace_secs`` (the ``save_on_preemption`` window: a final save at
        the failure moment beats resuming from the last periodic one), then
        SIGKILL survivors.  Every child is reaped before returning, so a
        respawn never races a dying worker and no zombies outlive the agent."""
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + max(grace_secs, 0.0)
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()  # reap: the respawn must not race a dying worker


def select_consensus_tag(checkpoint_dirs: Sequence[str],
                         verify_integrity: bool = False) -> Optional[str]:
    """Newest checkpoint tag valid across EVERY directory in
    ``checkpoint_dirs``: the resume-tag consensus for a new generation.

    Walks the first directory's tag order (checkpoint-index append order,
    newest first: the same walk ``load_checkpoint(fallback_to_valid=True)``
    uses) and returns the first tag that validates (manifest completeness +
    byte sizes; CRC32s too with ``verify_integrity``) in ALL directories.  A
    tag torn on any rank: e.g. the crash that triggered this restart
    interrupted that rank's save: is skipped everywhere, so divergent
    "newest" tags converge on the newest COMMON valid one.  None when no tag
    is valid across the board (fresh start)."""
    dirs = [d for d in checkpoint_dirs if d]
    if not dirs:
        return None
    for tag in reversed(list_tags(dirs[0])):
        if all(is_valid_tag(d, tag, verify_integrity=verify_integrity) for d in dirs):
            return tag
    return None


class DSElasticAgent:
    """Supervise ``world_size`` copies of a worker command.

    ``elastic_config``: the ds-config ``elasticity`` section (max batch,
    micro-batches, min/max gpus) constraining which world sizes are valid.
    On a worker failure or detected hang the agent assumes capacity loss,
    drops to the next smaller valid world size, and relaunches (up to
    ``max_restarts``): except exit codes in ``non_restartable_exit_codes``
    (config/usage errors: restarting cannot fix a bad flag), which are
    returned to the caller immediately.

    Liveness monitoring engages when ``heartbeat_timeout_s`` is set (with
    ``heartbeat_dir``: the constructor refuses one without the other):
    workers get a per-generation heartbeat dir via env, and a rank whose
    stamp goes stale (or that never stamps within ``startup_grace_s``) is
    treated as hung: cross-rank snapshot dumped, group restarted.

    ``checkpoint_dir`` (+ ``per_rank_checkpoints`` for node-local layouts
    ``<dir>/rank<R>/``) arms coordinated restart: each new generation is
    pinned to the newest tag valid across all ranks of its world size via
    ``DSTPU_RESUME_TAG``.
    """

    # merged-metrics rebuild throttle (the poll loop ticks much faster; a
    # scrape between rebuilds reads the cached strings)
    OPS_REFRESH_INTERVAL_S = 0.25

    def __init__(self, worker_cmd: Sequence[str], world_size: int,
                 elastic_config: Optional[Dict] = None, max_restarts: int = 3,
                 poll_interval: float = 0.2, env: Optional[Dict[str, str]] = None,
                 checkpoint_dir: Optional[str] = None,
                 per_rank_checkpoints: bool = False,
                 verify_checkpoint_integrity: bool = False,
                 heartbeat_dir: Optional[str] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 heartbeat_interval_s: float = 0.25,
                 startup_grace_s: Optional[float] = None,
                 straggler_lag_steps: Optional[int] = None,
                 io_grace_factor: float = 10.0,
                 term_grace_secs: float = 10.0,
                 non_restartable_exit_codes: Sequence[int] = (2, ),
                 collective_timeout_s: Optional[float] = None,
                 init_retries: Optional[int] = None,
                 init_retry_backoff_s: Optional[float] = None,
                 telemetry=None, recorder_events: int = 256,
                 ops_port: Optional[int] = None,
                 ops_dir: Optional[str] = None,
                 ops_host: str = "127.0.0.1"):
        self.worker_cmd = list(worker_cmd)
        self.initial_world = world_size
        self.elastic_config = elastic_config
        self.max_restarts = max_restarts
        self.poll_interval = poll_interval
        self.base_env = dict(env or os.environ)
        self.restart_count = 0
        self.checkpoint_dir = checkpoint_dir
        self.per_rank_checkpoints = per_rank_checkpoints
        self.verify_checkpoint_integrity = verify_checkpoint_integrity
        if heartbeat_timeout_s is not None and heartbeat_dir is None:
            # fail fast: without a stamp dir the liveness monitor is silently
            # inert and a wedged rank deadlocks the job: the exact failure
            # this knob exists to catch (the launcher's --heartbeat_timeout
            # derives a tempdir; direct callers must pass heartbeat_dir)
            raise ValueError("heartbeat_timeout_s is set but heartbeat_dir is "
                             "None: hang detection needs a directory for the "
                             "per-rank liveness stamps")
        self.heartbeat_dir = heartbeat_dir
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.heartbeat_interval_s = heartbeat_interval_s
        self.startup_grace_s = (startup_grace_s if startup_grace_s is not None
                                else (5.0 * heartbeat_timeout_s if heartbeat_timeout_s else None))
        self.straggler_lag_steps = straggler_lag_steps
        self.io_grace_factor = max(float(io_grace_factor), 1.0)
        self.term_grace_secs = term_grace_secs
        self.non_restartable_exit_codes = frozenset(int(c) for c in non_restartable_exit_codes)
        self.collective_timeout_s = collective_timeout_s
        self.init_retries = None if init_retries is None else int(init_retries)
        self.init_retry_backoff_s = init_retry_backoff_s
        self.telemetry = telemetry
        self.recorder = FlightRecorder(capacity=recorder_events)
        self.resume_tags: List[Optional[str]] = []  # per generation, for postmortems
        self._flagged_stragglers: set = set()
        self._last_heartbeats: Dict[int, dict] = {}
        self._interrupt_signum: Optional[int] = None
        self._prev_handlers: Dict[int, object] = {}
        # fleet-level ops endpoint: workers publish per-rank
        # registry snapshots under DSTPU_OPS_DIR (this agent exports it), the
        # poll loop merges them (generation carry keeps counters monotone
        # across restarts/rescales) and serves /metrics + /healthz + /statez
        # with per-rank liveness gauges on top: the health surface a fleet
        # router admits on.  `ops_port` arms it (0 = ephemeral; read
        # agent.ops.port); `ops_dir` defaults to a tempdir.
        self.ops = None
        self._ops_cache = None
        self._ops_agg = None
        self._ops_dir = ops_dir
        self._ops_own_dir = False
        self._current_world = world_size
        if ops_port is not None or ops_dir is not None:
            from ..monitor.metrics import FleetAggregator
            from ..monitor.ops_server import OpsCache, try_start_ops_server
            self._ops_agg = FleetAggregator()
            self._ops_cache = OpsCache()
            if self._ops_dir is None:
                self._ops_dir = tempfile.mkdtemp(prefix="dstpu_elastic_ops_")
                self._ops_own_dir = True
            if ops_port is not None:
                self.ops = try_start_ops_server(self._ops_cache, host=ops_host,
                                                port=ops_port,
                                                owner="elastic agent")
            self._ops_last_refresh = -float("inf")
            self._refresh_ops(group=None, force=True)

    # ------------------------------------------------------------- world math
    def valid_world_sizes(self) -> List[int]:
        if not self.elastic_config:
            return list(range(1, self.initial_world + 1))
        cfg = dict(self.elastic_config)
        valid = get_valid_gpus(
            int(cfg["max_train_batch_size"]),
            [int(m) for m in cfg["micro_batch_sizes"]],
            int(cfg.get("min_gpus", 1)),
            int(cfg.get("max_gpus", self.initial_world)))
        return sorted(w for w in valid if w <= self.initial_world)

    def next_world_size(self, current: int) -> Optional[int]:
        smaller = [w for w in self.valid_world_sizes() if w < current]
        return max(smaller) if smaller else None

    # ------------------------------------------------------------- lifecycle
    def _record(self, event: str, **fields):
        """One lifecycle event -> supervisor flight-recorder ring + (when a
        collector is attached) a ``kind: resilience`` JSONL record, mirroring
        the serving engine's event plumbing.  ``step`` defaults to the restart
        ordinal; events that carry a worker step (straggler) override it."""
        fields.setdefault("step", self.restart_count)
        self.recorder.record(event, t=time.time(), **fields)
        if self.telemetry is not None:
            self.telemetry.record_resilience(f"elastic_{event}", **fields)

    def state_snapshot(self) -> Dict:
        """Supervisor postmortem: restart budget, per-generation resume tags,
        the flight-recorder tail, and the last heartbeat sweep."""
        return {
            "restart_count": self.restart_count,
            "max_restarts": self.max_restarts,
            "resume_tags": list(self.resume_tags),
            "events": self.recorder.tail(),
            "heartbeats": dict(self._last_heartbeats),
        }

    # ----------------------------------------------------------- ops endpoint
    def ops_health(self, group: Optional[WorkerGroup] = None) -> Dict:
        """The agent's /healthz: world/restart state + per-rank liveness -
        host-side values the poll loop already maintains."""
        alive = group.alive_ranks() if group is not None else []
        return {
            "world_size": self._current_world,
            "restart_count": self.restart_count,
            "max_restarts": self.max_restarts,
            "alive_ranks": alive,
            "resume_tags": list(self.resume_tags),
            "ranks_reporting": (self._ops_agg.ranks()
                                if self._ops_agg is not None else []),
        }

    def _refresh_ops(self, group: Optional[WorkerGroup],
                     force: bool = False) -> None:
        """Merge worker snapshots + agent liveness into the scrape cache.
        Runs on the agent's poll loop (host-only file reads + string work),
        throttled to one rebuild per ``ops_server`` refresh interval so a
        fast poll_interval doesn't pay a dir-scan + render every tick."""
        if self._ops_agg is None:
            return
        now_mono = time.monotonic()
        if not force and now_mono - self._ops_last_refresh < self.OPS_REFRESH_INTERVAL_S:
            return
        self._ops_last_refresh = now_mono
        from ..monitor.exposition import render
        from ..monitor.metrics import populate_from_agent
        from ..monitor.ops_server import read_rank_snapshots
        from ..utils.logging import warning_once
        for rank, snap in read_rank_snapshots(self._ops_dir).items():
            try:
                self._ops_agg.absorb(rank, snap)
            except (ValueError, KeyError, TypeError) as exc:
                # a malformed-but-parseable snapshot degrades that rank's
                # freshness; it must never unwind the poll loop that owns
                # every worker's teardown
                warning_once(f"ops: rank {rank} snapshot rejected ({exc!r}); "
                             f"keeping its last merged state")
        merged = self._ops_agg.registry()
        populate_from_agent(merged, self,
                            heartbeats=self._last_heartbeats,
                            alive_ranks=group.alive_ranks() if group else None,
                            now=time.time())
        merged.set_gauge("dstpu_elastic_world_size", self._current_world,
                         help_text="current worker-group world size")
        self._ops_cache.update(metrics_text=render(merged, collect=False),
                               healthz=json.dumps(self.ops_health(group)),
                               statez=json.dumps(self.state_snapshot()))

    def close_ops(self) -> None:
        """Shut the ops listener down (tests / clean teardown)."""
        if self.ops is not None:
            self.ops.close()

    # -------------------------------------------------------- checkpoint pin
    def checkpoint_dirs(self, world_size: int) -> List[str]:
        if not self.checkpoint_dir:
            return []
        if self.per_rank_checkpoints:
            return [os.path.join(self.checkpoint_dir, f"rank{r}")
                    for r in range(world_size)]
        return [self.checkpoint_dir]

    def select_resume_tag(self, world_size: int) -> Optional[str]:
        """The consensus tag the next generation of ``world_size`` ranks must
        resume from (None = fresh start / no checkpointing configured)."""
        tag = select_consensus_tag(self.checkpoint_dirs(world_size),
                                   verify_integrity=self.verify_checkpoint_integrity)
        if tag is not None:
            self._record("resume_tag", tag=tag, world=world_size)
        return tag

    # --------------------------------------------------------------- spawning
    def _generation_heartbeat_dir(self) -> Optional[str]:
        """Per-generation subdir so stale stamps from a killed generation can
        never mask (or falsely indict) the new one."""
        if self.heartbeat_dir is None:
            return None
        d = os.path.join(self.heartbeat_dir, f"gen{self.restart_count}")
        os.makedirs(d, exist_ok=True)
        return d

    def _spawn(self, world_size: int) -> WorkerGroup:
        resume_tag = self.select_resume_tag(world_size)
        self.resume_tags.append(resume_tag)
        hb_dir = self._generation_heartbeat_dir()
        procs = []
        for rank in range(world_size):
            env = dict(self.base_env,
                       RANK=str(rank), WORLD_SIZE=str(world_size),
                       DSTPU_ELASTIC_RESTART=str(self.restart_count))
            if hb_dir is not None:
                env[HEARTBEAT_DIR_ENV] = hb_dir
                env[HEARTBEAT_INTERVAL_ENV] = str(self.heartbeat_interval_s)
            else:
                # same hygiene as the resume-tag scrub below: an inherited
                # heartbeat dir (outer agent, stale operator export) would
                # have these workers stamp into a FOREIGN generation dir,
                # corrupting whoever reads it with colliding rank numbers
                env.pop(HEARTBEAT_DIR_ENV, None)
                env.pop(HEARTBEAT_INTERVAL_ENV, None)
            # bounded-collective / init-retry knobs ride the same env contract
            # so a supervised worker fails fast instead of deadlocking even
            # when its own ds config never sets fault_tolerance.  Same scrub
            # hygiene as the rest of the contract: env wins over worker
            # config, so a value leaked from an operator shell or outer agent
            # would bound THIS job's collectives with a timeout nobody set
            for knob, var in ((self.collective_timeout_s, COLLECTIVE_TIMEOUT_ENV),
                              (self.init_retries, INIT_RETRIES_ENV),
                              (self.init_retry_backoff_s, INIT_RETRY_BACKOFF_ENV)):
                if knob is not None:
                    env[var] = str(knob)
                else:
                    env.pop(var, None)
            # ops-plane exchange dir: workers publish per-rank metrics
            # snapshots here for the agent's merged endpoint.  Same scrub
            # hygiene as every env knob above: an inherited dir would feed
            # this job's metrics into a FOREIGN aggregator as its ranks
            if self._ops_dir is not None:
                env[OPS_DIR_ENV] = self._ops_dir
            else:
                env.pop(OPS_DIR_ENV, None)
            if resume_tag is not None:
                env[RESUME_TAG_ENV] = resume_tag
                # scope the pin: tag names are the generic global_step<N>, so
                # without the dir a warm-start load from an UNRELATED base
                # checkpoint holding an identically-named tag would be
                # hijacked (engine applies the pin only under this dir)
                env[RESUME_DIR_ENV] = self.checkpoint_dir
            else:
                env.pop(RESUME_TAG_ENV, None)  # never leak a stale pin into gen 0
                env.pop(RESUME_DIR_ENV, None)
            procs.append(subprocess.Popen(self.worker_cmd, env=env))
        self._flagged_stragglers = set()
        self._last_heartbeats = {}
        self._record("generation_spawned", world=world_size,
                     generation=self.restart_count,
                     resume_tag=resume_tag, pids=[p.pid for p in procs])
        logger.info(f"elastic agent: launched {world_size} workers "
                    f"(restart {self.restart_count}, resume_tag={resume_tag})")
        return WorkerGroup(procs, world_size, self.restart_count, heartbeat_dir=hb_dir)

    # -------------------------------------------------------------- liveness
    def _check_liveness(self, group: WorkerGroup) -> Optional[List[int]]:
        """Stale ranks of the current generation (hang!), else None.  Also
        flags stragglers as a side effect.  A rank that never stamped counts
        as stale only after ``startup_grace_s`` (workers pay imports, the
        CUDA context and kernel builds before their first step); a rank whose
        last stamp is the engine's post-resume marker (``phase=resumed``)
        gets the same grace: it is warming up between load_checkpoint and
        its first step, which no heartbeat can tick through."""
        if self.heartbeat_timeout_s is None or group.heartbeat_dir is None:
            return None
        now = time.time()
        heartbeats = read_heartbeats(group.heartbeat_dir)
        self._last_heartbeats = heartbeats
        alive = group.alive_ranks()
        # ranks that already exited are the exit-code poll's business
        stale = [r for r in stale_ranks(heartbeats, alive, self.heartbeat_timeout_s, now)
                 if r in heartbeats]
        # a rank whose LAST stamp declared a checkpoint phase is in known-slow
        # IO (the engine force-stamps phase=checkpoint_save/load at entry and
        # writes nothing until the IO finishes): killing it would re-run the
        # same slow save every generation until the budget burns on a healthy
        # job, so those ranks get io_grace_factor x the timeout before
        # indictment
        stale = [r for r in stale
                 if not (str(heartbeats[r].get("phase", "")).startswith("checkpoint")
                         and heartbeat_age(heartbeats[r], now)
                         <= self.heartbeat_timeout_s * self.io_grace_factor)]
        # phase=resumed: the engine finished load_checkpoint and is warming
        # up before its first step: stale by the plain
        # timeout, but a healthy restarted generation, so it gets the same
        # grace a never-stamped launcher does
        stale = [r for r in stale
                 if not (heartbeats[r].get("phase") == "resumed"
                         and heartbeat_age(heartbeats[r], now)
                         <= (self.startup_grace_s or 0.0))]
        # a rank still at step 0 stamped (setup barrier, collective entry)
        # but hasn't trained yet: it is inside the same import+compile
        # window the never-stamped grace covers, and one early stamp must
        # not strip that grace from a healthy slow-starting launch
        stale = [r for r in stale
                 if not (int(heartbeats[r].get("step") or 0) == 0
                         and (now - group.spawned_at)
                         <= (self.startup_grace_s or 0.0))]
        never_stamped = [r for r in alive if r not in heartbeats]
        if never_stamped and (now - group.spawned_at) > (self.startup_grace_s or 0.0):
            stale = sorted(set(stale) | set(never_stamped))
        if stale:
            return stale
        # straggler math over LIVE ranks only: an exited rank's frozen stamp
        # is not a laggard (nothing is waiting on it) and would skew the
        # median the live ranks are measured against
        live_beats = {r: rec for r, rec in heartbeats.items() if r in alive}
        if self.straggler_lag_steps is not None and len(live_beats) >= 2:
            for rank in straggler_ranks(live_beats, self.straggler_lag_steps):
                key = (group.restart, rank)
                if key not in self._flagged_stragglers:
                    self._flagged_stragglers.add(key)
                    record = heartbeats.get(rank, {})
                    self._record("straggler", rank=rank, step=record.get("step"),
                                 generation=group.restart,
                                 lag_threshold=self.straggler_lag_steps)
                    logger.warning(f"elastic agent: rank {rank} is a straggler "
                                   f"(step {record.get('step')}, > "
                                   f"{self.straggler_lag_steps} steps behind the median)")
        return None

    def _dump_hang(self, group: WorkerGroup, stale: List[int]) -> None:
        report = format_hang_report(self._last_heartbeats, list(range(group.world_size)),
                                    self.heartbeat_timeout_s or 0.0)
        logger.error(f"elastic agent: hang detected: stale rank(s) {stale} "
                     f"(no heartbeat for > {self.heartbeat_timeout_s}s)\n{report}")
        collectives = {r: self._last_heartbeats.get(r, {}).get("collective")
                       for r in stale}
        ages = {r: round(heartbeat_age(self._last_heartbeats[r]), 2)
                for r in stale if r in self._last_heartbeats}
        self._record("hang_detected", ranks=stale, collectives=collectives,
                     stamp_ages_s=ages, generation=group.restart, report=report)

    # ---------------------------------------------------------------- signals
    def _install_signal_handlers(self):
        """SIGINT/SIGTERM to the agent must tear the worker group down (with
        the grace window) instead of orphaning it: handlers just set a flag
        the poll loop acts on, so teardown happens in one place."""
        if threading.current_thread() is not threading.main_thread():
            return  # signal.signal is main-thread-only; threaded callers own teardown

        def _on_signal(signum, frame):
            self._interrupt_signum = signum

        for signum in (signal.SIGINT, signal.SIGTERM):
            try:
                self._prev_handlers[signum] = signal.signal(signum, _on_signal)
            except (ValueError, OSError) as exc:
                logger.warning(f"elastic agent: could not install handler for "
                               f"signal {signum} ({exc})")

    def _restore_signal_handlers(self):
        for signum, prev in self._prev_handlers.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError):
                pass  # teardown best-effort: restore can only fail off the main thread, where none was installed
        self._prev_handlers = {}

    # -------------------------------------------------------------------- run
    def run(self) -> int:
        """Supervise until success (0), non-restartable worker failure (that
        worker's rc, immediately: restarting a config/usage error just burns
        the budget), interruption (128+signum after tearing the group down),
        or restart budget exhausted (1).  Restartable failures: nonzero
        exits outside ``non_restartable_exit_codes`` and detected hangs -
        trigger the terminate -> rescale -> pin-resume-tag -> respawn cycle.
        Children are reaped on every exit path."""
        world = self.initial_world
        valid = self.valid_world_sizes()
        if world not in valid:
            # launching at a size the elastic config forbids breaks the batch
            # math from step 0: clamp before the first generation
            fitting = [w for w in valid if w <= world]
            if not fitting:
                logger.error(f"elastic agent: no valid world size <= {world} "
                             f"(valid: {valid})")
                return 1
            logger.warning(f"elastic agent: world_size {world} is not elastic-valid "
                           f"{valid}; clamping to {max(fitting)}")
            world = max(fitting)
        # a leftover flag from a previous interrupted run() would kill the
        # fresh generation on the first poll: each run starts clean
        self._interrupt_signum = None
        self._install_signal_handlers()
        group: Optional[WorkerGroup] = None
        try:
            self._current_world = world
            group = self._spawn(world)
            while True:
                time.sleep(self.poll_interval)
                # merged fleet metrics + liveness gauges each poll (host-only)
                self._refresh_ops(group)
                if self._interrupt_signum is not None:
                    signum = self._interrupt_signum
                    logger.warning(f"elastic agent: received signal {signum}; "
                                   f"terminating worker group (grace "
                                   f"{self.term_grace_secs}s)")
                    self._record("agent_interrupted", signum=signum, world=world)
                    group.terminate(self.term_grace_secs)
                    return 128 + signum
                failure = group.poll_failed()
                hung: Optional[List[int]] = None
                if failure is not None:
                    rank, rc = failure
                    if rc in self.non_restartable_exit_codes:
                        logger.error(f"elastic agent: rank {rank} exited rc={rc} "
                                     f"(non-restartable class): returning it "
                                     f"instead of burning {self.max_restarts} restarts")
                        self._record("worker_failed", rank=rank, rc=rc,
                                     restartable=False, world=world)
                        group.terminate(self.term_grace_secs)
                        return rc
                    logger.warning(f"elastic agent: worker rank {rank} failed rc={rc} "
                                   f"(world={world}, restart {self.restart_count})")
                    self._record("worker_failed", rank=rank, rc=rc,
                                 restartable=True, world=world)
                else:
                    hung = self._check_liveness(group)
                    if hung is not None:
                        self._dump_hang(group, hung)
                    elif group.all_done():
                        logger.info("elastic agent: all workers finished cleanly")
                        self._record("run_complete", world=world,
                                     restarts=self.restart_count)
                        self._refresh_ops(group, force=True)  # final merged view
                        if self._ops_own_dir:
                            # launcher convention: sweep OUR tempdir exchange
                            # files on a clean run, keep them for postmortem
                            # on any failure path; caller dirs never touched
                            import shutil
                            shutil.rmtree(self._ops_dir, ignore_errors=True)
                        return 0
                    else:
                        continue
                # restartable failure or hang: graceful handoff, then respawn
                group.terminate(self.term_grace_secs)
                if self.restart_count >= self.max_restarts:
                    logger.error("elastic agent: restart budget exhausted")
                    self._record("budget_exhausted", world=world,
                                 restarts=self.restart_count)
                    return 1
                self.restart_count += 1
                shrunk = self.next_world_size(world)
                if shrunk is not None:
                    logger.info(f"elastic agent: rescaling {world} -> {shrunk}")
                    self._record("rescale", from_world=world, to_world=shrunk,
                                 reason="hang" if hung else "worker_failed")
                    world = shrunk
                # world == min valid size: respawn at the same size
                self._current_world = world
                group = self._spawn(world)
        finally:
            self._restore_signal_handlers()
            if group is not None and group.alive_ranks():
                # exception/interrupt path: never leave orphans behind
                group.terminate(self.term_grace_secs)
