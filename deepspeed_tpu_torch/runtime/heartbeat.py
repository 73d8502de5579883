"""Per-rank heartbeat seam for supervised fault tolerance.

Counterpart of ``deepspeed_tpu/runtime/heartbeat.py`` with the same env
names and stamp-file format, so either package's supervisor reads the
other's workers.  In the port the v2 serving engine stamps (one stamp per
serve iteration, read by ``inference/v2/supervisor.py``); the training
watchdog over the same stamps is not ported yet.

The dominant distributed failure mode is not a worker that *exits* — it is a
worker that *stops* (stuck in a collective while every peer waits, wedged on a
flaky storage mount, spinning in a data-loader).  A polling supervisor that
only watches exit codes deadlocks with the job.  The fix is a liveness
channel the supervisor can read without touching the workers: each rank
stamps ``step + wall-clock + last-entered-collective`` to a tiny per-rank
file, and the supervisor treats a stale stamp as a failure — kill,
diagnose, restart.

Design constraints (the reason this is its own module):

- **Zero device syncs.**  A stamp writes only values the host already owns:
  the engine's python-int step counter, ``time.time()``, and the collective
  name a wrapper pushed before blocking.  Nothing here may call ``float()``
  on a device value, ``.item()``, ``.cpu()``, ``np.asarray`` or
  ``torch.cuda.synchronize`` — each would stall the hot loop once a step.
- **Crash-consistent.**  Stamps are written tmp-then-``os.replace`` so the
  agent never reads a torn file; a reader treats unparseable/missing files
  as "no heartbeat yet", never as an exception.
- **Throttled.**  ``stamp()`` is called from the train hot loop; it early-outs
  on a monotonic-clock interval check (two float compares) unless forced, so
  the file write amortizes to ~1/interval regardless of step rate.

Activation is either config (``serving_fault_tolerance.heartbeat``) or
environment — the supervisor exports ``DSTPU_HEARTBEAT_DIR`` (+ ``RANK``)
to its workers, and the engine arms a writer automatically, so supervision
needs no config plumbing through user scripts.

Reader-side helpers (used by the supervisor, host-only):
``read_heartbeats`` / ``stale_ranks`` / ``straggler_ranks`` /
``format_hang_report`` — the last renders the cross-rank snapshot that turns
"the job hung" into "ranks 1,3 sat in all_reduce at step 41 while rank 2
never entered it" (the mismatched-collective deadlock diagnosis).
"""

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence

from ..utils.env import env_float, warning_once

logger = logging.getLogger(__name__)

HEARTBEAT_DIR_ENV = "DSTPU_HEARTBEAT_DIR"
HEARTBEAT_INTERVAL_ENV = "DSTPU_HEARTBEAT_INTERVAL_S"
# the rest of the JAX package's agent->worker env contract, kept whole
# (its training consumers are not ported yet): the consensus resume tag the
# agent pins for each restarted generation, the collective wall-clock
# bound, and the process-group setup retry knobs
RESUME_TAG_ENV = "DSTPU_RESUME_TAG"
RESUME_DIR_ENV = "DSTPU_RESUME_DIR"
COLLECTIVE_TIMEOUT_ENV = "DSTPU_COLLECTIVE_TIMEOUT_S"
INIT_RETRIES_ENV = "DSTPU_INIT_RETRIES"
INIT_RETRY_BACKOFF_ENV = "DSTPU_INIT_RETRY_BACKOFF_S"
# ServingSupervisor -> serving-worker contract (inference/v2/supervisor.py):
# the durable request-journal path, the generation ordinal of the current
# restart, and the drain-only flag the supervisor raises once the restart
# budget is exhausted (workers shed new admissions and only finish journaled
# work).  Same placement rationale as the training contract above.
SERVING_JOURNAL_ENV = "DSTPU_SERVING_JOURNAL"
SERVING_FSYNC_ENV = "DSTPU_SERVING_FSYNC_EVERY"
SERVING_GENERATION_ENV = "DSTPU_SERVING_GENERATION"
SERVING_DRAIN_ENV = "DSTPU_SERVING_DRAIN"
# ops-plane exchange dir of the JAX package's monitor/ops_server.py (the
# ops plane is not ported; the name is kept so the contract stays whole)
OPS_DIR_ENV = "DSTPU_OPS_DIR"
_FILE_PREFIX = "hb.rank"


def heartbeat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"{_FILE_PREFIX}{int(rank)}.json")


class HeartbeatWriter:
    """Stamps this rank's liveness to ``<dir>/hb.rank<R>.json``.

    All values host-native (see module docstring); writes are atomic
    (tmp + ``os.replace``) and throttled to one per ``interval_s`` unless
    ``force=True`` (collective entry/exit and terminal stamps force).  A
    failed write keeps the throttle cadence (a broken dir must not turn
    every hot-loop stamp into a fresh syscall + exception), and after
    ``MAX_WRITE_FAILURES`` consecutive failures the writer disables itself —
    degrade supervision, never training.
    """

    MAX_WRITE_FAILURES = 10

    def __init__(self, directory: str, rank: int, *, interval_s: float = 1.0,
                 generation: int = 0, clock=time.time, monotonic=time.monotonic):
        self.directory = directory
        self.rank = int(rank)
        self.interval_s = max(float(interval_s), 0.0)
        self.generation = int(generation)
        self.enabled = True
        self._clock = clock
        self._monotonic = monotonic
        self._path = heartbeat_path(directory, rank)
        self._tmp = self._path + ".tmp"
        self._last_stamp_mono = -float("inf")
        self._write_failures = 0
        self._last_step = 0
        self._collective: Optional[str] = None
        self._collective_t: Optional[float] = None
        self.stamps_written = 0
        try:
            os.makedirs(directory, exist_ok=True)
        except OSError as exc:
            # a broken heartbeat dir must degrade supervision, never training
            warning_once(f"heartbeat: cannot create {directory!r} ({exc}); "
                         f"liveness stamps disabled for rank {rank}")
            self.enabled = False

    # ------------------------------------------------------------------ stamps
    def stamp(self, step: int, *, phase: Optional[str] = None, force: bool = False) -> bool:
        """Record liveness at host step ``step``.  Returns True when a file
        write actually happened (throttle/disable make it False)."""
        if not self.enabled:
            return False
        now_mono = self._monotonic()
        self._last_step = int(step)
        if not force and (now_mono - self._last_stamp_mono) < self.interval_s:
            return False
        record = {
            "rank": self.rank,
            "pid": os.getpid(),
            "step": int(step),
            "time": self._clock(),
            "generation": self.generation,
            "collective": self._collective,
            "collective_t": self._collective_t,
        }
        if phase is not None:
            record["phase"] = phase
        try:
            with open(self._tmp, "w") as fh:
                fh.write(json.dumps(record))
            os.replace(self._tmp, self._path)
        except OSError as exc:
            self._last_stamp_mono = now_mono  # keep the throttle cadence
            self._write_failures += 1
            if self._write_failures >= self.MAX_WRITE_FAILURES:
                self.enabled = False
                warning_once(f"heartbeat: {self._write_failures} consecutive "
                             f"stamp failures to {self._path!r} (last: {exc}); "
                             f"liveness stamps disabled for rank {self.rank} — "
                             f"the agent will see this rank as stale")
            else:
                warning_once(f"heartbeat: stamp to {self._path!r} failed ({exc}); "
                             f"the agent may see this rank as stale")
            return False
        self._last_stamp_mono = now_mono
        self._write_failures = 0
        self.stamps_written += 1
        return True

    # ------------------------------------------------------------ collectives
    def enter_collective(self, name: str) -> None:
        """Stamp 'about to block in ``name``' — called by comm wrappers BEFORE
        the blocking wait, so a hang inside the collective leaves its name on
        disk for the agent's cross-rank dump."""
        self._collective = str(name)
        self._collective_t = self._clock()
        self.stamp(self._last_step, force=True)

    def exit_collective(self) -> None:
        self._collective = None
        self._collective_t = None
        self.stamp(self._last_step, force=True)

    def close(self) -> None:
        """Terminal stamp (clean shutdown) then stop writing."""
        if self.enabled:
            self.stamp(self._last_step, phase="closed", force=True)
        self.enabled = False


class _NullHeartbeat:
    """Disabled writer: every call a cheap no-op so call sites never branch."""
    enabled = False
    rank = -1
    stamps_written = 0

    def stamp(self, step, phase=None, force=False):
        return False

    def enter_collective(self, name):
        return None

    def exit_collective(self):
        return None

    def close(self):
        return None


NULL_HEARTBEAT = _NullHeartbeat()

# process-global writer so a comm layer can stamp collective entry/exit
# without threading a handle through every call site
_WRITER: Any = NULL_HEARTBEAT


def get_heartbeat():
    return _WRITER


def set_heartbeat(writer) -> None:
    global _WRITER
    _WRITER = writer if writer is not None else NULL_HEARTBEAT


def build_heartbeat(ft_config=None, *, rank: Optional[int] = None,
                    register_global: bool = True):
    """Resolve a writer from a training ``fault_tolerance`` config section
    (any object with ``heartbeat``, ``heartbeat_dir`` and
    ``heartbeat_interval_s``) and/or the agent-exported environment; its
    training-side caller is not ported yet.  Env wins on the *directory*
    (the agent owns placement); config wins on the interval unless the env
    pins one.  Returns the NULL writer when neither enables heartbeats."""
    env_dir = os.environ.get(HEARTBEAT_DIR_ENV)
    cfg_enabled = bool(ft_config is not None and ft_config.heartbeat)
    directory = env_dir or (ft_config.heartbeat_dir if cfg_enabled and ft_config.heartbeat_dir else None)
    if directory is None:
        if register_global:
            # one engine's writer must not leak into the next: a later
            # heartbeat-less engine would otherwise keep stamping comm
            # collectives into the previous engine's (possibly swept) dir
            set_heartbeat(NULL_HEARTBEAT)
        return NULL_HEARTBEAT
    interval = float(ft_config.heartbeat_interval_s) if ft_config is not None else 1.0
    interval = env_float(HEARTBEAT_INTERVAL_ENV, interval)
    if rank is None:
        rank = int(os.environ.get("RANK", "0") or 0)
    generation = int(os.environ.get("DSTPU_ELASTIC_RESTART", "0") or 0)
    writer = HeartbeatWriter(directory, rank, interval_s=interval, generation=generation)
    if register_global:
        set_heartbeat(writer)
    logger.info(f"heartbeat: rank {rank} stamping to {directory} "
                f"every {interval}s (generation {generation})")
    return writer


# ==========================================================================
# Reader side (agent / supervisor — host-only, tolerant of torn state)
# ==========================================================================

def read_heartbeats(directory: str) -> Dict[int, Dict[str, Any]]:
    """All parseable per-rank heartbeat records under ``directory``.  Missing
    dir, missing files, and half-written JSON all read as 'absent' — the
    agent distinguishes 'never stamped' from 'stale' itself."""
    out: Dict[int, Dict[str, Any]] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not (name.startswith(_FILE_PREFIX) and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as fh:
                record = json.load(fh)
            rank = int(record["rank"])
        except (OSError, ValueError, KeyError, TypeError):
            continue  # torn write or foreign file: absent this poll, not fatal
        out[rank] = record
    return out


def heartbeat_age(record: Dict[str, Any], now: Optional[float] = None) -> float:
    now = time.time() if now is None else now
    return max(now - float(record.get("time", 0.0)), 0.0)


def stale_ranks(heartbeats: Dict[int, Dict[str, Any]], ranks: Sequence[int],
                timeout_s: float, now: Optional[float] = None) -> List[int]:
    """Ranks whose newest stamp is older than ``timeout_s`` (or that never
    stamped at all) — the liveness failure set."""
    now = time.time() if now is None else now
    out = []
    for rank in ranks:
        record = heartbeats.get(rank)
        if record is None or heartbeat_age(record, now) > timeout_s:
            out.append(rank)
    return sorted(out)


def straggler_ranks(heartbeats: Dict[int, Dict[str, Any]],
                    lag_steps: int) -> List[int]:
    """Ranks whose stamped step trails the group median by more than
    ``lag_steps`` — alive but slow (flagged, not killed)."""
    steps = sorted(int(r.get("step", 0)) for r in heartbeats.values())
    if len(steps) < 2:
        return []
    median = steps[len(steps) // 2]
    return sorted(rank for rank, r in heartbeats.items()
                  if median - int(r.get("step", 0)) > lag_steps)


def format_hang_report(heartbeats: Dict[int, Dict[str, Any]], ranks: Sequence[int],
                       timeout_s: float, now: Optional[float] = None) -> str:
    """Cross-rank snapshot for the hang postmortem: one line per rank with
    step, stamp age, and the collective it last entered (if any) — the
    mismatched-collective deadlock shows up as different collective names (or
    one rank absent from the collective every peer is waiting in)."""
    now = time.time() if now is None else now
    stale = set(stale_ranks(heartbeats, ranks, timeout_s, now))
    lines = [f"cross-rank hang snapshot (heartbeat timeout {timeout_s:.1f}s):"]
    for rank in sorted(ranks):
        record = heartbeats.get(rank)
        if record is None:
            lines.append(f"  rank {rank}: NO HEARTBEAT ever written — worker "
                         f"wedged before its first stamp (or heartbeat dir torn)")
            continue
        age = heartbeat_age(record, now)
        state = "STALE" if rank in stale else "alive"
        coll = record.get("collective")
        if coll:
            coll_age = now - float(record.get("collective_t") or record.get("time", now))
            where = f"blocked in collective '{coll}' for {coll_age:.1f}s"
        else:
            where = "not in a collective"
        lines.append(f"  rank {rank}: {state}, step {record.get('step', '?')}, "
                     f"last stamp {age:.1f}s ago, {where}"
                     + (f" [{record['phase']}]" if record.get("phase") else ""))
    stuck = {r: heartbeats[r].get("collective") for r in stale if r in heartbeats}
    named = sorted({c for c in stuck.values() if c})
    if named:
        lines.append(f"  diagnosis: stale rank(s) {sorted(stuck)} inside "
                     f"collective(s) {named} — peers waiting on a collective "
                     f"the stuck rank(s) never completed")
    return "\n".join(lines)
