"""The port's elastic agent (``deepspeed_tpu_torch.elasticity``) through
every scenario of the JAX agent's tests (``tests/unit/test_elastic_agent.py``),
with real subprocess workers: restart and rescale, the restart budget, the
liveness monitor (heartbeat staleness, startup and checkpoint-IO grace,
stragglers), signal teardown, the non-restartable exit codes, the env
scrubbing, the pinned resume tag, the lifecycle events and the merged ops
endpoint; and ``select_consensus_tag`` over checkpoints the port's engine
wrote, against JAX's over the same directories.  The marks follow JAX's:
its slow scenarios are slow here too.  Subprocess scenarios keep the
heartbeat timeout at 5x or more the healthy workers' stamp interval."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from deepspeed_tpu_torch.elasticity import DSElasticAgent

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELASTIC = {"max_train_batch_size": 8, "micro_batch_sizes": [1, 2],
           "min_gpus": 1, "max_gpus": 8}


def test_valid_world_sizes_from_config():
    agent = DSElasticAgent(["true"], world_size=8, elastic_config=ELASTIC)
    assert agent.valid_world_sizes() == [1, 2, 4, 8]
    assert agent.next_world_size(8) == 4
    assert agent.next_world_size(1) is None


def test_clean_run_exits_zero(tmp_path):
    agent = DSElasticAgent([sys.executable, "-c", "import os; assert 'RANK' in os.environ"],
                           world_size=2, poll_interval=0.05)
    assert agent.run() == 0
    assert agent.restart_count == 0


@pytest.mark.slow
def test_failure_rescales_and_recovers(tmp_path):
    """Workers fail while a flag file is present (simulated lost capacity at
    world=4); the agent drops to the next valid size and succeeds."""
    flag = tmp_path / "broken"
    flag.write_text("x")
    script = (
        "import os, sys\n"
        f"flag = {str(flag)!r}\n"
        "world = int(os.environ['WORLD_SIZE'])\n"
        "if os.path.exists(flag) and world >= 4:\n"
        "    if os.environ['RANK'] == '3':\n"
        "        sys.exit(13)\n"
        "    import time; time.sleep(5)\n"  # healthy peers linger; agent kills them
        "sys.exit(0)\n")
    agent = DSElasticAgent([sys.executable, "-c", script], world_size=4,
                           elastic_config=ELASTIC, max_restarts=2, poll_interval=0.05)
    assert agent.run() == 0
    assert agent.restart_count == 1


@pytest.mark.slow
def test_restart_budget_exhausted(tmp_path):
    agent = DSElasticAgent([sys.executable, "-c", "import sys; sys.exit(7)"],
                           world_size=2, elastic_config=ELASTIC,
                           max_restarts=1, poll_interval=0.05)
    assert agent.run() == 1
    assert agent.restart_count == 1


@pytest.mark.slow
def test_initial_world_clamped_to_valid():
    """world_size not permitted by the elastic config clamps before launch."""
    agent = DSElasticAgent(
        [sys.executable, "-c",
         "import os, sys; sys.exit(0 if os.environ['WORLD_SIZE'] == '4' else 3)"],
        world_size=6, elastic_config=ELASTIC, poll_interval=0.05)
    assert agent.run() == 0


# ------------------------------------------------------- solver edge cases
def test_valid_world_sizes_with_duplicate_micro_batches():
    # duplicates must not double-count or reorder the valid set
    cfg = dict(ELASTIC, micro_batch_sizes=[2, 2, 1, 1])
    agent = DSElasticAgent(["true"], world_size=8, elastic_config=cfg)
    assert agent.valid_world_sizes() == [1, 2, 4, 8]


def test_min_gpus_exceeding_max_gpus_yields_no_valid_world():
    cfg = dict(ELASTIC, min_gpus=6, max_gpus=4)
    agent = DSElasticAgent(["true"], world_size=8, elastic_config=cfg)
    assert agent.valid_world_sizes() == []
    # run() must refuse to launch rather than spawn an invalid world
    assert agent.run() == 1
    assert agent.restart_count == 0


def test_next_world_size_at_minimum_valid_world():
    # at the smallest valid world there is nothing to shrink to: the agent
    # respawns at the SAME size (next_world_size None drives that branch)
    agent = DSElasticAgent(["true"], world_size=8, elastic_config=ELASTIC)
    assert agent.next_world_size(1) is None
    cfg = dict(ELASTIC, min_gpus=4)
    agent = DSElasticAgent(["true"], world_size=8, elastic_config=cfg)
    assert agent.valid_world_sizes() == [4, 8]
    assert agent.next_world_size(4) is None


@pytest.mark.slow
def test_failure_at_min_world_respawns_same_size(tmp_path):
    flag = tmp_path / "fail_once"
    flag.write_text("x")
    script = (
        "import os, sys\n"
        f"flag = {str(flag)!r}\n"
        "if os.path.exists(flag):\n"
        "    os.remove(flag); sys.exit(9)\n"
        "sys.exit(0 if os.environ['WORLD_SIZE'] == '1' else 5)\n")
    agent = DSElasticAgent([sys.executable, "-c", script], world_size=1,
                           elastic_config=ELASTIC, max_restarts=2, poll_interval=0.05)
    assert agent.run() == 0
    assert agent.restart_count == 1  # respawned, same world


def test_agent_exports_collective_and_init_retry_env():
    """The bounded-collective / init-retry knobs ride the agent->worker env
    contract: without the export, the advertised fast CollectiveTimeoutError
    path is inert in exactly the supervised deployment it exists for."""
    script = (
        "import os\n"
        "assert os.environ['DSTPU_COLLECTIVE_TIMEOUT_S'] == '2.5'\n"
        "assert os.environ['DSTPU_INIT_RETRIES'] == '5'\n"
        "assert os.environ['DSTPU_INIT_RETRY_BACKOFF_S'] == '0.1'\n")
    agent = DSElasticAgent([sys.executable, "-c", script], world_size=2,
                           poll_interval=0.05, collective_timeout_s=2.5,
                           init_retries=5, init_retry_backoff_s=0.1)
    assert agent.run() == 0


def test_agent_scrubs_stale_fault_tolerance_env_by_default():
    """Env wins over worker config for these knobs, so a value leaked from an
    operator shell or outer agent would bound THIS job's collectives with a
    timeout nobody set — unset agent knobs must scrub, not pass through."""
    stale = dict(os.environ, DSTPU_COLLECTIVE_TIMEOUT_S="5",
                 DSTPU_INIT_RETRIES="9", DSTPU_INIT_RETRY_BACKOFF_S="2.0")
    script = (
        "import os\n"
        "assert 'DSTPU_COLLECTIVE_TIMEOUT_S' not in os.environ\n"
        "assert 'DSTPU_INIT_RETRIES' not in os.environ\n"
        "assert 'DSTPU_INIT_RETRY_BACKOFF_S' not in os.environ\n")
    agent = DSElasticAgent([sys.executable, "-c", script], world_size=1,
                           poll_interval=0.05, env=stale)
    assert agent.run() == 0


def test_heartbeat_timeout_without_dir_refused_at_construction():
    """heartbeat_timeout_s with no stamp dir would make the liveness monitor
    silently inert — the exact silent-deadlock failure it exists to catch —
    so the constructor must refuse rather than arm nothing."""
    with pytest.raises(ValueError, match="heartbeat_dir"):
        DSElasticAgent(["true"], world_size=2, heartbeat_timeout_s=5.0)


def test_stale_heartbeat_env_scrubbed_when_unsupervised():
    """An agent NOT supervising heartbeats must scrub an inherited
    DSTPU_HEARTBEAT_DIR (outer agent, stale operator export) — otherwise its
    workers stamp into a FOREIGN generation dir with colliding rank numbers,
    corrupting whoever reads it (same hygiene as the resume-tag scrub)."""
    stale = dict(os.environ, DSTPU_HEARTBEAT_DIR="/tmp/outer_agent_gen0",
                 DSTPU_HEARTBEAT_INTERVAL_S="0.5")
    script = (
        "import os\n"
        "assert 'DSTPU_HEARTBEAT_DIR' not in os.environ\n"
        "assert 'DSTPU_HEARTBEAT_INTERVAL_S' not in os.environ\n")
    agent = DSElasticAgent([sys.executable, "-c", script], world_size=1,
                           poll_interval=0.05, env=stale)
    assert agent.run() == 0


def test_run_resets_stale_interrupt_flag():
    """run() must start with a clean interrupt flag: a leftover from a
    previous interrupted run() would kill the fresh generation on the first
    poll and return 128+signum with no failure having occurred."""
    agent = DSElasticAgent([sys.executable, "-c", "pass"], world_size=1,
                           poll_interval=0.05)
    agent._interrupt_signum = signal.SIGTERM  # stale from an interrupted run
    assert agent.run() == 0


# -------------------------------------------- non-restartable exit codes
@pytest.mark.slow
def test_non_restartable_rc_returned_immediately():
    """rc 2 (config/usage error class): restarting cannot fix a bad flag, so
    the agent returns the worker's rc without burning the restart budget."""
    agent = DSElasticAgent([sys.executable, "-c", "import sys; sys.exit(2)"],
                           world_size=2, elastic_config=ELASTIC,
                           max_restarts=3, poll_interval=0.05)
    assert agent.run() == 2
    assert agent.restart_count == 0
    events = [e["event"] for e in agent.recorder.tail()]
    assert "worker_failed" in events and "rescale" not in events


@pytest.mark.slow
def test_non_restartable_class_is_configurable():
    agent = DSElasticAgent([sys.executable, "-c", "import sys; sys.exit(2)"],
                           world_size=1, elastic_config=ELASTIC, max_restarts=1,
                           poll_interval=0.05, non_restartable_exit_codes=(77, ))
    assert agent.run() == 1  # rc 2 is restartable now; budget exhausts
    assert agent.restart_count == 1


# ------------------------------------------------------- signal teardown
@pytest.mark.slow
def test_interrupt_tears_down_worker_group(tmp_path):
    """An interrupted agent terminates its workers (grace window) and returns
    128+signum — never orphans.  Driven via the interrupt flag the real
    signal handlers set (handlers install on the main thread only)."""
    pid_file = tmp_path / "pids"
    script = ("import os, time\n"
              f"open({str(pid_file)!r}, 'a').write(str(os.getpid()) + chr(10))\n"
              "time.sleep(60)\n")
    agent = DSElasticAgent([sys.executable, "-c", script], world_size=2,
                           poll_interval=0.05, term_grace_secs=2.0)
    result = {}
    runner = threading.Thread(target=lambda: result.update(rc=agent.run()))
    runner.start()
    deadline = time.time() + 10
    while time.time() < deadline:
        if pid_file.exists() and len(pid_file.read_text().splitlines()) == 2:
            break
        time.sleep(0.05)
    agent._interrupt_signum = signal.SIGTERM
    runner.join(timeout=15)
    assert not runner.is_alive()
    assert result["rc"] == 128 + signal.SIGTERM
    for pid in pid_file.read_text().split():
        assert not os.path.exists(f"/proc/{pid}"), f"worker {pid} orphaned"
    assert "agent_interrupted" in [e["event"] for e in agent.recorder.tail()]


@pytest.mark.slow
def test_sigterm_to_agent_process_reaps_workers(tmp_path):
    """End-to-end: SIGTERM the agent PROCESS (real handler install path) and
    verify the workers die with it."""
    pid_file = tmp_path / "pids"
    worker = (f"import os, time; open({str(pid_file)!r}, 'a')"
              ".write(str(os.getpid()) + chr(10)); time.sleep(60)")
    driver = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from deepspeed_tpu_torch.elasticity import DSElasticAgent\n"
        f"agent = DSElasticAgent([sys.executable, '-c', {worker!r}], world_size=2,\n"
        "                       poll_interval=0.05, term_grace_secs=2.0)\n"
        "sys.exit(agent.run())\n")
    proc = subprocess.Popen([sys.executable, "-c", driver])
    deadline = time.time() + 20
    while time.time() < deadline:
        if pid_file.exists() and len(pid_file.read_text().splitlines()) == 2:
            break
        time.sleep(0.05)
    else:
        proc.kill()
        pytest.fail("workers never started")
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=20)
    assert rc == 128 + signal.SIGTERM
    time.sleep(0.2)
    for pid in pid_file.read_text().split():
        assert not os.path.exists(f"/proc/{pid}"), f"worker {pid} orphaned"


# --------------------------------------------------------- hang detection
def _heartbeat_worker(mode: str) -> str:
    """Worker that stamps its own heartbeat (no engine import: fast), then
    follows ``mode``: 'hang' stamps a collective and sleeps forever in gen 0
    but exits clean in later generations; 'ok' stamps briefly and exits 0."""
    return (
        "import json, os, sys, time\n"
        "rank = os.environ['RANK']; gen = int(os.environ['DSTPU_ELASTIC_RESTART'])\n"
        "d = os.environ['DSTPU_HEARTBEAT_DIR']\n"
        "def stamp(coll=None):\n"
        "    rec = {'rank': int(rank), 'step': 3, 'time': time.time(),\n"
        "           'collective': coll, 'collective_t': time.time()}\n"
        "    p = os.path.join(d, 'hb.rank%s.json' % rank)\n"
        "    open(p + '.tmp', 'w').write(json.dumps(rec)); os.replace(p + '.tmp', p)\n"
        f"mode = {mode!r}\n"
        "if mode == 'hang' and gen == 0 and rank == '1':\n"
        "    stamp('all_reduce')\n"
        "    time.sleep(120)\n"
        "for _ in range(4):\n"
        "    stamp(); time.sleep(0.05)\n"
        "sys.exit(0)\n")


@pytest.mark.slow
def test_hang_detected_by_heartbeat_staleness(tmp_path):
    """A rank that stamps 'entered all_reduce' then stops is NOT an exit-code
    failure — only the liveness monitor can see it.  The agent must dump the
    cross-rank snapshot naming the collective, restart, and finish."""
    agent = DSElasticAgent([sys.executable, "-c", _heartbeat_worker("hang")],
                           world_size=2, elastic_config=ELASTIC, max_restarts=2,
                           poll_interval=0.05, term_grace_secs=1.0,
                           heartbeat_dir=str(tmp_path / "hb"),
                           heartbeat_timeout_s=1.0, startup_grace_s=30.0)
    assert agent.run() == 0
    assert agent.restart_count == 1
    hangs = [e for e in agent.recorder.tail() if e["event"] == "hang_detected"]
    assert len(hangs) == 1
    assert hangs[0]["ranks"] == [1]
    assert hangs[0]["collectives"] == {1: "all_reduce"}
    assert "blocked in collective 'all_reduce'" in hangs[0]["report"]


@pytest.mark.slow
def test_never_stamping_rank_caught_after_startup_grace(tmp_path):
    """A worker wedged before its FIRST stamp (import deadlock, bad mount) is
    only distinguishable from a slow starter by the startup grace window."""
    script = ("import os, sys, time\n"
              "time.sleep(60 if os.environ['RANK'] == '0' else 0)\n"
              "sys.exit(0)\n")
    agent = DSElasticAgent([sys.executable, "-c", script], world_size=2,
                           elastic_config=ELASTIC, max_restarts=1,
                           poll_interval=0.05, term_grace_secs=1.0,
                           heartbeat_dir=str(tmp_path / "hb"),
                           heartbeat_timeout_s=0.5, startup_grace_s=1.5)
    agent.run()
    hangs = [e for e in agent.recorder.tail() if e["event"] == "hang_detected"]
    assert hangs and 0 in hangs[0]["ranks"]


class _FakeGroup:
    """Duck-typed WorkerGroup for liveness-math tests (no subprocesses)."""

    def __init__(self, world_size, restart=0, heartbeat_dir=None):
        self.world_size = world_size
        self.restart = restart
        self.heartbeat_dir = heartbeat_dir
        self.spawned_at = time.time()

    def alive_ranks(self):
        return list(range(self.world_size))


def test_resumed_phase_gets_startup_grace(tmp_path):
    """A rank whose last stamp is the engine's post-resume marker is paying
    the jit recompile after load_checkpoint — stale by the plain timeout, but
    a healthy restart: indicted only after startup_grace_s, like a
    never-stamped launcher (regression: the clearing stamp used to strip the
    checkpoint phase and with it ALL grace, so every restarted generation
    whose compile outlasted the timeout was killed as hung)."""
    hb_dir = tmp_path / "hb" / "gen0"
    hb_dir.mkdir(parents=True)
    old = time.time() - 2.0  # stale for a 0.5s timeout
    for rank, phase in [(0, "resumed"), (1, None)]:
        rec = {"rank": rank, "step": 5, "time": old, "collective": None}
        if phase:
            rec["phase"] = phase
        (hb_dir / f"hb.rank{rank}.json").write_text(json.dumps(rec))
    agent = DSElasticAgent(["true"], world_size=2,
                           heartbeat_dir=str(tmp_path / "hb"),
                           heartbeat_timeout_s=0.5, startup_grace_s=10.0)
    # rank 1 hung mid-training; rank 0 is a resumed rank still compiling
    assert agent._check_liveness(_FakeGroup(2, heartbeat_dir=str(hb_dir))) == [1]
    agent2 = DSElasticAgent(["true"], world_size=2,
                            heartbeat_dir=str(tmp_path / "hb"),
                            heartbeat_timeout_s=0.5, startup_grace_s=1.0)
    # past the grace window a 'resumed' rank is as hung as anyone
    assert agent2._check_liveness(_FakeGroup(2, heartbeat_dir=str(hb_dir))) == [0, 1]


def test_step_zero_stamp_keeps_startup_grace(tmp_path):
    """One setup-collective stamp before the first train step must not void
    the startup grace: the rank is still inside the same import+compile
    window the never-stamped grace exists for, and indicting it would kill
    a healthy slow-compiling launch every generation."""
    hb_dir = tmp_path / "hb" / "gen0"
    hb_dir.mkdir(parents=True)
    (hb_dir / "hb.rank0.json").write_text(json.dumps(
        {"rank": 0, "step": 0, "time": time.time() - 3.0, "collective": "barrier"}))
    agent = DSElasticAgent(["true"], world_size=1,
                           heartbeat_dir=str(tmp_path / "hb"),
                           heartbeat_timeout_s=0.5, startup_grace_s=60.0)
    assert agent._check_liveness(_FakeGroup(1, heartbeat_dir=str(hb_dir))) is None
    expired = _FakeGroup(1, heartbeat_dir=str(hb_dir))
    expired.spawned_at = time.time() - 120.0  # grace over: a step-0 hang is a hang
    assert agent._check_liveness(expired) == [0]


def test_straggler_flagged_once_not_killed(tmp_path):
    hb_dir = tmp_path / "hb" / "gen0"
    hb_dir.mkdir(parents=True)
    for rank, step in [(0, 50), (1, 49), (2, 51), (3, 30)]:
        (hb_dir / f"hb.rank{rank}.json").write_text(json.dumps(
            {"rank": rank, "step": step, "time": time.time(), "collective": None}))
    agent = DSElasticAgent(["true"], world_size=4,
                           heartbeat_dir=str(tmp_path / "hb"),
                           heartbeat_timeout_s=30.0, straggler_lag_steps=10)
    group = _FakeGroup(4, heartbeat_dir=str(hb_dir))
    assert agent._check_liveness(group) is None  # flagged, NOT a failure
    assert agent._check_liveness(group) is None  # and only flagged once
    events = [e for e in agent.recorder.tail() if e["event"] == "straggler"]
    assert len(events) == 1 and events[0]["rank"] == 3


# ------------------------------------------------------ resume-tag pinning
@pytest.mark.slow
def test_resume_tag_pinned_via_env(tmp_path, monkeypatch):
    out = tmp_path / "seen"
    script = ("import os, sys\n"
              f"open({str(out)!r}, 'a').write(os.environ.get('DSTPU_RESUME_TAG', '<none>') + chr(10))\n"
              "sys.exit(0)\n")
    agent = DSElasticAgent([sys.executable, "-c", script], world_size=2,
                           poll_interval=0.05, checkpoint_dir=str(tmp_path / "ck"))
    monkeypatch.setattr(agent, "select_resume_tag", lambda world: "global_step7")
    assert agent.run() == 0
    assert out.read_text().split() == ["global_step7"] * 2


@pytest.mark.slow
def test_stale_resume_tag_never_leaks_from_parent_env(tmp_path):
    out = tmp_path / "seen"
    script = ("import os, sys\n"
              f"open({str(out)!r}, 'a').write(os.environ.get('DSTPU_RESUME_TAG', '<none>') + chr(10))\n"
              "sys.exit(0)\n")
    env = dict(os.environ, DSTPU_RESUME_TAG="stale_tag_from_previous_life")
    agent = DSElasticAgent([sys.executable, "-c", script], world_size=1,
                           poll_interval=0.05, env=env)
    assert agent.run() == 0
    assert out.read_text().split() == ["<none>"]  # no checkpoint dir -> no pin


# ------------------------------------------------------ lifecycle telemetry
def test_lifecycle_events_forward_to_telemetry():
    class FakeTelemetry:
        def __init__(self):
            self.calls = []

        def record_resilience(self, event, **fields):
            self.calls.append((event, fields))

    telemetry = FakeTelemetry()
    agent = DSElasticAgent(["true"], world_size=2, telemetry=telemetry)
    agent._record("rescale", from_world=4, to_world=2, reason="hang")
    agent._record("straggler", rank=3, step=30)
    assert telemetry.calls[0][0] == "elastic_rescale"
    assert telemetry.calls[0][1]["from_world"] == 4
    assert telemetry.calls[1][1]["step"] == 30  # worker step wins over ordinal
    # the flight recorder mirrors both, in order, for state_snapshot()
    events = agent.recorder.tail()
    assert [e["event"] for e in events] == ["rescale", "straggler"]
    snap = agent.state_snapshot()
    assert snap["restart_count"] == 0 and snap["events"] == events


@pytest.mark.slow
def test_straggler_then_dropped_heartbeat_with_real_workers(tmp_path):
    """Harness modes 'slow' + 'drop_heartbeat' end-to-end: a lagging rank is
    FLAGGED (straggler event, not killed) while it still stamps, and becomes
    a liveness failure the moment its stamps stop — even though the process
    itself stays healthy (the wedged-runtime-thread analog)."""
    # the JAX package's fault-injectable worker: only its heartbeat files
    # meet the agent, and their format is the port's
    root = ROOT
    worker_cmd = [sys.executable, "-u",
                  os.path.join(root, "tests", "unit", "elastic_worker.py")]
    # slow_s x remaining-steps must outlast the staleness timeout, or the
    # healthy-but-silent rank finishes before the monitor can catch it; rank 0
    # is mildly slowed too so it stays ALIVE through the lag window (straggler
    # math deliberately ignores exited ranks)
    faults = [{"mode": "slow", "rank": 0, "step": 1, "gen": 0, "slow_s": 0.4},
              {"mode": "slow", "rank": 1, "step": 1, "gen": 0, "slow_s": 1.0},
              {"mode": "drop_heartbeat", "rank": 1, "step": 4, "gen": 0}]
    env = dict(os.environ, ELASTIC_TMP=str(tmp_path), ELASTIC_STEPS="8",
               ELASTIC_FAULTS=json.dumps(faults))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    agent = DSElasticAgent(
        worker_cmd, world_size=2,
        elastic_config={"max_train_batch_size": 8, "micro_batch_sizes": [1, 2],
                        "min_gpus": 1, "max_gpus": 2},
        max_restarts=2, poll_interval=0.1, env=env,
        heartbeat_dir=str(tmp_path / "hb"), heartbeat_timeout_s=2.0,
        heartbeat_interval_s=0.1, startup_grace_s=180.0,
        straggler_lag_steps=2, term_grace_secs=5.0)
    assert agent.run() == 0
    assert agent.restart_count == 1
    events = agent.recorder.tail()
    stragglers = [e for e in events if e["event"] == "straggler"]
    assert stragglers and stragglers[0]["rank"] == 1
    hangs = [e for e in events if e["event"] == "hang_detected"]
    assert hangs and hangs[0]["ranks"] == [1]
    assert hangs[0]["collectives"] == {1: None}  # stopped stamping OUTSIDE a collective
    # straggling alone never killed it: the flag predates the hang
    assert events.index(stragglers[0]) < events.index(hangs[0])


def test_checkpoint_phase_gets_io_grace_before_indictment(tmp_path):
    """A rank whose last stamp declares a checkpoint phase is in known-slow IO
    (the engine stamps once at save entry, then silence until the save ends):
    it gets io_grace_factor x the timeout before being called hung."""
    hb_dir = tmp_path / "hb" / "gen0"
    hb_dir.mkdir(parents=True)
    now = time.time()
    (hb_dir / "hb.rank0.json").write_text(json.dumps(
        {"rank": 0, "step": 5, "time": now, "collective": None}))
    (hb_dir / "hb.rank1.json").write_text(json.dumps(
        {"rank": 1, "step": 5, "time": now - 3.0, "collective": None,
         "phase": "checkpoint_save"}))
    agent = DSElasticAgent(["true"], world_size=2,
                           heartbeat_dir=str(tmp_path / "hb"),
                           heartbeat_timeout_s=1.0, io_grace_factor=10.0)
    # 3s stale > 1s timeout, but inside the 10s IO grace: NOT hung
    assert agent._check_liveness(_FakeGroup(2, heartbeat_dir=str(hb_dir))) is None
    # past the IO grace the slow-save excuse expires
    (hb_dir / "hb.rank1.json").write_text(json.dumps(
        {"rank": 1, "step": 5, "time": now - 30.0, "collective": None,
         "phase": "checkpoint_save"}))
    assert agent._check_liveness(_FakeGroup(2, heartbeat_dir=str(hb_dir))) == [1]
    # and a PHASELESS rank never gets the excuse
    (hb_dir / "hb.rank1.json").write_text(json.dumps(
        {"rank": 1, "step": 5, "time": now - 3.0, "collective": None}))
    assert agent._check_liveness(_FakeGroup(2, heartbeat_dir=str(hb_dir))) == [1]


# ------------------------------------------------------------ ops endpoint
def test_agent_serves_merged_fleet_metrics(tmp_path):
    """Workers publish per-rank registry snapshots under the
    agent-exported DSTPU_OPS_DIR; the agent merges them (rank labels, fleet
    histograms) and serves /metrics + /healthz with liveness gauges."""
    from deepspeed_tpu_torch.monitor.exposition import parse_exposition
    from deepspeed_tpu_torch.monitor.ops_server import scrape

    # each worker writes one counter + a heartbeat-style snapshot, then exits
    script = (
        "import json, os, time\n"
        "from deepspeed_tpu_torch.monitor.metrics import MetricsRegistry\n"
        "from deepspeed_tpu_torch.monitor.ops_server import write_rank_files\n"
        "rank = int(os.environ['RANK'])\n"
        "gen = int(os.environ.get('DSTPU_ELASTIC_RESTART', '0'))\n"
        "reg = MetricsRegistry(generation=gen)\n"
        "reg.set_counter('dstpu_worker_steps_total', 10 + rank)\n"
        "write_rank_files(os.environ['DSTPU_OPS_DIR'], rank, reg)\n"
        "time.sleep(0.5)\n")  # linger so the poll loop sees the files live
    agent = DSElasticAgent([sys.executable, "-c", script], world_size=2,
                           poll_interval=0.05, ops_port=0,
                           ops_dir=str(tmp_path / "ops"),
                           env=dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                                    + os.environ.get("PYTHONPATH", "")))
    try:
        assert agent.ops is not None and agent.ops.port > 0
        assert agent.run() == 0
        agent._refresh_ops(group=None)  # final sweep after the run
        body = scrape(agent.ops.url("/metrics"))
        fams = parse_exposition(body)
        steps = fams["dstpu_worker_steps_total"]["samples"]
        by_rank = {labels["rank"]: value for _, labels, value in steps}
        assert by_rank == {"0": 10.0, "1": 11.0}
        [(_, _, restarts)] = fams["dstpu_elastic_restarts_total"]["samples"]
        assert restarts == 0
        hz = json.loads(scrape(agent.ops.url("/healthz")))
        assert hz["world_size"] == 2 and hz["ranks_reporting"] == [0, 1]
        sz = json.loads(scrape(agent.ops.url("/statez")))
        assert "events" in sz and "restart_count" in sz
    finally:
        agent.close_ops()


def test_agent_default_ops_tempdir_swept_on_clean_run(tmp_path):
    # ops_port with no ops_dir derives a tempdir; a clean run must sweep it
    # (launcher convention) — caller-provided dirs are never touched
    agent = DSElasticAgent([sys.executable, "-c", "pass"], world_size=1,
                           poll_interval=0.05, ops_port=0)
    try:
        derived = agent._ops_dir
        assert agent._ops_own_dir and os.path.isdir(derived)
        assert agent.run() == 0
        assert not os.path.exists(derived), "tempdir exchange files leaked"
    finally:
        agent.close_ops()


def test_agent_without_ops_flags_scrubs_inherited_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DSTPU_OPS_DIR", str(tmp_path / "foreign"))
    seen = tmp_path / "env.txt"
    script = (f"import os; open({str(seen)!r}, 'w').write("
              "os.environ.get('DSTPU_OPS_DIR', '<none>'))")
    agent = DSElasticAgent([sys.executable, "-c", script], world_size=1,
                           poll_interval=0.05)
    assert agent.run() == 0
    assert seen.read_text() == "<none>"


# ------------------------------------------- consensus over port checkpoints
@pytest.fixture(scope="module")
def port_checkpoints(tmp_path_factory):
    """Two rank directories of checkpoints the port's engine wrote at steps
    1-3 (a tiny Llama on the CPU): rank 1's newest tag is torn (a leaf file
    truncated), rank 0's middle tag has a flipped byte of the same size."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama
    root = tmp_path_factory.mktemp("consensus")
    cfg = llama.LlamaConfig.tiny(vocab=64, hidden=32, layers=1, heads=2, kv_heads=2, seq=16)
    batch = llama.causal_lm_batch(np.random.default_rng(0).integers(0, 64, (2, 16)))
    dirs = [str(root / f"rank{r}") for r in range(2)]
    for d in dirs:
        engine = deepspeed_tpu_torch.initialize(
            loss_fn=llama.make_loss_fn(cfg), device="cpu",
            model_parameters=llama.init_params(cfg, torch.Generator().manual_seed(0)),
            config={"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": False},
                    "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}})[0]
        for _ in range(3):
            engine.train_batch(batch)
            engine.save_checkpoint(d)

    def leaf_file(d, tag):
        files = sorted(p for p in (root / d / tag).rglob("*") if p.is_file()
                       and p.suffix == ".npy")
        return max(files, key=lambda p: p.stat().st_size)

    torn = leaf_file("rank1", "global_step3")
    torn.write_bytes(torn.read_bytes()[:-8])
    flipped = leaf_file("rank0", "global_step2")
    data = bytearray(flipped.read_bytes())
    data[-1] ^= 0xFF
    flipped.write_bytes(bytes(data))
    return dirs


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("which", ["both", "rank0", "rank1", "none"])
def test_consensus_tag_over_port_checkpoints_equals_jax_s(port_checkpoints, verify, which):
    from deepspeed_tpu.elasticity.elastic_agent import select_consensus_tag as jax_select
    from deepspeed_tpu_torch.elasticity import select_consensus_tag
    dirs = {"both": port_checkpoints, "rank0": port_checkpoints[:1],
            "rank1": port_checkpoints[1:], "none": []}[which]
    got = select_consensus_tag(dirs, verify_integrity=verify)
    assert got == jax_select(dirs, verify_integrity=verify)
    want = {("both", False): "global_step2", ("both", True): "global_step1",
            ("rank0", False): "global_step3", ("rank0", True): "global_step3",
            ("rank1", False): "global_step2", ("rank1", True): "global_step2",
            ("none", False): None, ("none", True): None}[(which, verify)]
    assert got == want
