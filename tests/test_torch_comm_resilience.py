"""Bounded collectives and process-group setup retries in the port
(``deepspeed_tpu_torch/comm/comm.py``), the cases of
``tests/unit/test_comm_resilience.py``: a deadlocked collective becomes a
fast, named ``CollectiveTimeoutError``; the heartbeat is stamped around the
blocking wait; ``init_process_group`` retries transient failures under the
env's or the config's budget; ``initialize`` and the engine apply the
``fault_tolerance`` knobs.  The timeout's resolution is held to the JAX
package's on the same inputs.  One real 2-rank gloo barrier that rank 1
never reaches (``tests/torch_dist_workers.py``, scenario
``barrier_timeout``) must raise on rank 0 within the timeout plus 5 s."""

import json
import os
import time

import pytest
import torch
import torch.distributed as dist

import deepspeed_tpu_torch
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu_torch.comm import (CollectiveTimeoutError, barrier, bounded_collective,
                                      set_default_collective_timeout)
from deepspeed_tpu_torch.comm import comm as comm_mod
from deepspeed_tpu_torch.runtime.heartbeat import HeartbeatWriter, heartbeat_path, set_heartbeat

from . import torch_dist_workers as W

BASE = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 1000, "bf16": {"enabled": False},
        "optimizer": {"type": "adamw", "params": {"lr": 1e-2}}}


def _loss_fn(params, batch, rng):
    return ((batch @ params["w"]) ** 2).mean()


def _initialize(**conf):
    return deepspeed_tpu_torch.initialize(loss_fn=_loss_fn, model_parameters={"w": torch.ones(4, 2)},
                                          config=dict(BASE, **conf), device="cpu")


def test_bounded_collective_passes_result_and_args():
    assert bounded_collective(lambda a, b: a + b, 2, b=3, timeout_s=5.0) == 5
    assert bounded_collective(lambda: "unbounded") == "unbounded"  # no default set


def test_bounded_collective_timeout_names_collective_and_rank():
    with pytest.raises(CollectiveTimeoutError) as err:
        bounded_collective(lambda: time.sleep(30), timeout_s=0.2, name="all_gather")
    e = err.value
    assert e.collective == "all_gather" and e.timeout_s == 0.2
    assert e.elapsed_s >= 0.2 and e.rank == 0
    assert "all_gather" in str(e) and "rank 0" in str(e)


def test_bounded_collective_propagates_worker_exception():
    def boom():
        raise ValueError("mismatched shapes")

    with pytest.raises(ValueError, match="mismatched shapes"):
        bounded_collective(boom, timeout_s=5.0)


def test_bounded_collective_stamps_heartbeat(tmp_path):
    writer = HeartbeatWriter(str(tmp_path), 0, interval_s=0.0)
    set_heartbeat(writer)
    try:
        seen = {}

        def inside():
            seen.update(json.load(open(heartbeat_path(str(tmp_path), 0))))
            return 1

        assert bounded_collective(inside, timeout_s=5.0, name="reduce_scatter") == 1
        assert seen["collective"] == "reduce_scatter"  # stamped BEFORE blocking
        after = json.load(open(heartbeat_path(str(tmp_path), 0)))
        assert after["collective"] is None  # cleared on exit
    finally:
        set_heartbeat(None)


def test_collective_name_retained_on_timeout(tmp_path):
    """On timeout the worker thread is still inside the collective: the
    stamp keeps naming it, so that the agent's hang dump can attribute the
    deadlock."""
    writer = HeartbeatWriter(str(tmp_path), 0, interval_s=0.0)
    set_heartbeat(writer)
    try:
        with pytest.raises(CollectiveTimeoutError):
            bounded_collective(lambda: time.sleep(30), timeout_s=0.1, name="barrier")
        after = json.load(open(heartbeat_path(str(tmp_path), 0)))
        assert after["collective"] == "barrier"
    finally:
        set_heartbeat(None)


def test_collective_timeout_default_resolution_matches_jax(monkeypatch):
    """Argument over env over module default; 0 or less is unbounded; a bad
    env falls through.  Each read equals the JAX package's on the same
    state."""
    monkeypatch.delenv(comm_mod.COLLECTIVE_TIMEOUT_ENV, raising=False)

    def both(arg):
        got, want = comm_mod._resolve_timeout(arg), jcomm._resolve_timeout(arg)
        assert got == want
        return got

    assert both(None) is None
    set_default_collective_timeout(7.0)
    jcomm.set_default_collective_timeout(7.0)
    try:
        assert both(None) == 7.0
        assert both(3.0) == 3.0  # the argument wins
        assert both(0) is None  # 0 or negative: unbounded
        monkeypatch.setenv(comm_mod.COLLECTIVE_TIMEOUT_ENV, "2.5")
        assert both(None) == 2.5  # env beats the module default
        monkeypatch.setenv(comm_mod.COLLECTIVE_TIMEOUT_ENV, "not_a_float")
        assert both(None) == 7.0  # a bad env falls through
    finally:
        set_default_collective_timeout(None)
        jcomm.set_default_collective_timeout(None)


def test_barrier_completes_under_timeout():
    barrier(timeout_s=30.0)  # one process: returns well inside the bound


def _flaky_group(monkeypatch, fail_times, attempts, resets):
    """``init_process_group`` that fails ``fail_times`` times, each failure
    leaving a group behind (``is_initialized`` True until it is destroyed)."""
    state = {"left": False}

    def flaky(**kwargs):
        attempts.append(kwargs)
        if len(attempts) <= fail_times:
            state["left"] = True
            raise RuntimeError("master not listening yet")

    def destroy():
        resets.append(1)
        state["left"] = False

    monkeypatch.setattr(dist, "init_process_group", flaky)
    monkeypatch.setattr(dist, "is_initialized", lambda: state["left"])
    monkeypatch.setattr(dist, "destroy_process_group", destroy)


def test_init_distributed_retries_transient_setup_failures(monkeypatch):
    attempts, resets, naps = [], [], []
    _flaky_group(monkeypatch, 2, attempts, resets)
    monkeypatch.setattr(comm_mod.time, "sleep", lambda s: naps.append(s))
    monkeypatch.setenv(comm_mod.INIT_RETRIES_ENV, "3")
    monkeypatch.setenv(comm_mod.INIT_RETRY_BACKOFF_ENV, "0.5")
    comm_mod._initialize_with_retries("tcp://host:1234", 2, 0)
    assert len(attempts) == 3
    assert naps == [0.5, 1.0]  # exponential backoff
    assert attempts[0] == {"backend": "gloo", "init_method": "tcp://host:1234", "world_size": 2,
                           "rank": 0}
    # the group a failed attempt left behind is destroyed before the next
    assert len(resets) == 2


def test_init_distributed_retry_budget_exhausts(monkeypatch):
    def always_fails(**kwargs):
        raise RuntimeError("port held by previous generation")

    monkeypatch.setattr(dist, "init_process_group", always_fails)
    monkeypatch.setattr(comm_mod.time, "sleep", lambda s: None)
    monkeypatch.setenv(comm_mod.INIT_RETRIES_ENV, "2")
    with pytest.raises(RuntimeError, match="port held"):
        comm_mod._initialize_with_retries("tcp://host:1234", 2, 0)


def test_init_retry_module_defaults_and_env_precedence(monkeypatch):
    """set_init_retry_defaults (the config seam) drives the retry loop when
    the agent exported no env; the env wins when present."""
    monkeypatch.delenv(comm_mod.INIT_RETRIES_ENV, raising=False)
    monkeypatch.delenv(comm_mod.INIT_RETRY_BACKOFF_ENV, raising=False)
    attempts, naps = [], []

    def always_fails(**kwargs):
        attempts.append(kwargs)
        raise RuntimeError("master down")

    monkeypatch.setattr(dist, "init_process_group", always_fails)
    monkeypatch.setattr(comm_mod.time, "sleep", lambda s: naps.append(s))
    comm_mod.set_init_retry_defaults(1, 0.25)
    try:
        with pytest.raises(RuntimeError, match="master down"):
            comm_mod._initialize_with_retries("tcp://host:1234", 2, 0)
        assert len(attempts) == 2 and naps == [0.25]
        attempts.clear()
        monkeypatch.setenv(comm_mod.INIT_RETRIES_ENV, "0")  # agent env beats config
        with pytest.raises(RuntimeError):
            comm_mod._initialize_with_retries("tcp://host:1234", 2, 0)
        assert len(attempts) == 1
    finally:
        comm_mod.set_init_retry_defaults(3, 0.5)


def test_init_distributed_reads_the_launcher_env(monkeypatch):
    """With WORLD_SIZE above 1, MASTER_ADDR/MASTER_PORT/RANK make the group
    (gloo without a GPU); with WORLD_SIZE 1 nothing starts."""
    calls = []
    monkeypatch.setattr(comm_mod, "_initialize_with_retries",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(comm_mod, "_INITIALIZED", False)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29555")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    comm_mod.init_distributed(dist_backend="gloo")
    assert calls == [] and comm_mod.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    comm_mod.init_distributed(dist_backend="gloo")
    assert calls == [(("tcp://10.0.0.1:29555", 4, 3, None), {"backend": "gloo"})]


def test_initialize_applies_fault_tolerance_retry_defaults():
    """initialize() lands fault_tolerance.init_retries / init_retry_backoff_s
    in comm BEFORE init_distributed runs."""
    try:
        _initialize(fault_tolerance={"init_retries": 7, "init_retry_backoff_s": 0.125})
        assert comm_mod._DEFAULT_INIT_RETRIES == 7
        assert comm_mod._DEFAULT_INIT_RETRY_BACKOFF_S == 0.125
    finally:
        comm_mod.set_init_retry_defaults(3, 0.5)


def test_engine_config_owns_collective_timeout_default():
    """The engine applies its fault_tolerance.collective_timeout_s to the
    process default unconditionally: one engine's timeout never leaks into
    a later engine built without one."""
    _initialize(fault_tolerance={"collective_timeout_s": 1.5})
    assert comm_mod._resolve_timeout(None) == 1.5
    _initialize()
    assert comm_mod._resolve_timeout(None) is None  # reset, not leaked


def test_two_rank_barrier_that_rank_1_never_reaches_times_out(tmp_path):
    logs = W.spawn("barrier_timeout", 2, str(tmp_path), 60)
    assert all(rc == 0 for rc, _ in logs), "\n".join(text[-2000:] for _, text in logs)
    rec = json.load(open(os.path.join(str(tmp_path), "rank0.json")))
    assert rec["raised"] == "CollectiveTimeoutError", rec
    assert rec["collective"] == "barrier" and rec["rank"] == 0
    assert "barrier" in rec["message"] and "rank 0" in rec["message"]
    assert W.BARRIER_TIMEOUT_S <= rec["elapsed_s"] <= W.BARRIER_TIMEOUT_S + 5.0
