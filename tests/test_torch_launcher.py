"""The port's launcher (``deepspeed_tpu_torch.launcher``) against the JAX
package's (``tests/unit/test_launcher.py``'s cases): the hostfile and its
errors, include/exclude, the world info byte for byte, each runner's
command (the port's per-node module), ``--elastic`` routed to the agent,
the local path; and the per-node entry starting one process per local
GPU with torch.distributed's environment."""

import argparse
import json
import os
import sys

import pytest

from deepspeed_tpu.launcher import runner as jrunner
from deepspeed_tpu_torch.launcher import (PDSHRunner, SSHRunner, decode_world_info,
                                          encode_world_info, fetch_hostfile,
                                          parse_inclusion_exclusion)
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.launcher import runner as prunner

MODULE = "deepspeed_tpu_torch.launcher.launch"


@pytest.fixture
def hostfile(tmp_path):
    p = tmp_path / "hostfile"
    p.write_text("# comment\nworker-0 slots=4\nworker-1 slots=4\nworker-2 slots=8\n")
    return str(p)


def test_fetch_hostfile_matches_jax(hostfile, tmp_path):
    assert fetch_hostfile(hostfile) == jrunner.fetch_hostfile(hostfile) == \
        {"worker-0": 4, "worker-1": 4, "worker-2": 8}
    with pytest.raises(FileNotFoundError):
        fetch_hostfile(str(tmp_path / "nope"))
    for name, text, match in (("dup", "h1 slots=2\nh1 slots=4\n", "duplicate"),
                              ("bad", "h1 slots=x\n", "bad slots"), ("empty", "# none\n", "empty")):
        bad = tmp_path / name
        bad.write_text(text)
        with pytest.raises(ValueError, match=match):
            fetch_hostfile(str(bad))
        with pytest.raises(ValueError, match=match):
            jrunner.fetch_hostfile(str(bad))


@pytest.mark.parametrize("include,exclude", [
    ("worker-0@worker-2", ""), ("worker-2:0,1,2,3", ""), ("", "worker-1"), ("", "worker-2:0,1"),
    ("", "worker-0@worker-1:0,1,2,3"), ("", ""),
])
def test_include_exclude_match_jax(hostfile, include, exclude):
    r = fetch_hostfile(hostfile)
    assert parse_inclusion_exclusion(r, include, exclude) == \
        jrunner.parse_inclusion_exclusion(r, include, exclude)


def test_include_exclude_errors(hostfile):
    r = fetch_hostfile(hostfile)
    for kw in ({"include": "x", "exclude": "y"}, {"include": "missing-host"},
               {"exclude": "missing-host"}):
        with pytest.raises(ValueError):
            parse_inclusion_exclusion(r, **kw)
        with pytest.raises(ValueError):
            jrunner.parse_inclusion_exclusion(r, **kw)


@pytest.mark.parametrize("world", [{"a": 4, "b": 8}, {"worker-0": 1}, {}, {"h-1.example": 16}])
def test_world_info_is_byte_identical_to_jax(world):
    assert encode_world_info(world) == jrunner.encode_world_info(world)
    assert decode_world_info(encode_world_info(world)) == world


def test_launch_env_is_torch_distributed_s():
    env = prunner.build_launch_env({"h1": 8, "h2": 4}, "h1", 29500)
    assert env == {"DSTPU_WORLD_INFO": jrunner.encode_world_info({"h1": 8, "h2": 4}),
                   "MASTER_ADDR": "h1", "MASTER_PORT": "29500", "WORLD_SIZE": "12"}


class _Args:
    user_script = "train.py"
    user_args = ["--foo", "1"]


def _args(**kw):
    ns = argparse.Namespace(user_script="train.py", user_args=["--lr", "1"],
                            hostfile="/job/hostfile", slurm_comment="")
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def _both(name, args, env, resources):
    return (prunner.RUNNER_CLASSES[name](args, resources).get_cmd(env, resources),
            jrunner.RUNNER_CLASSES[name](args, resources).get_cmd(env, resources))


def test_pdsh_and_ssh_commands():
    r = PDSHRunner(_Args(), {"h1": 4, "h2": 4})
    cmd = r.get_cmd({"MASTER_ADDR": "h1"}, {"h1": 4, "h2": 4})
    assert cmd[0] == "pdsh" and "h1,h2" in cmd
    assert MODULE in cmd[-1] and "train.py" in cmd[-1]
    cmds = SSHRunner(_Args(), {"h1": 4, "h2": 4}).get_cmds({"WORLD_SIZE": "8"}, {"h1": 4, "h2": 4})
    assert len(cmds) == 2
    assert "NODE_RANK=0" in cmds[0][-1] and "NODE_RANK=1" in cmds[1][-1]
    assert all(MODULE in c[-1] for c in cmds)


@pytest.mark.parametrize("name,kw", [("pdsh", {}), ("openmpi", {}), ("openmpi",
                                                                      {"mpi_interface": "ens5"}),
                                     ("mpich", {}), ("slurm", {"slurm_comment": "prod"}),
                                     ("slurm", {})])
def test_runner_commands_are_jax_s_with_the_port_s_module(name, kw):
    """Each runner's command equals JAX's, but for the per-node module."""
    env = {"DSTPU_WORLD_INFO": "abc", "K": "V", "COMMA": "a,b"}
    resources = {"hostA": 4, "hostB": 4}
    port, ref = _both(name, _args(**kw), env, resources)
    ref = [c.replace("deepspeed_tpu.launcher.launch", MODULE) for c in ref]
    assert port == ref
    assert any(MODULE in c for c in port)


def test_mvapich_writes_a_bare_hostfile_as_jax_does():
    port, ref = _both("mvapich", _args(), {"E": "2"}, {"h1": 8, "h2": 8})
    hp, hj = port[port.index("-hostfile") + 1], ref[ref.index("-hostfile") + 1]
    assert open(hp).read() == open(hj).read() and open(hp).read().split() == ["h1", "h2"]
    assert port[:3] == ["mpirun_rsh", "-np", "2"] and "E=2" in port
    assert [c for c in port if c != hp] == [c.replace("deepspeed_tpu.launcher.launch", MODULE)
                                             for c in ref if c != hj]


def test_runner_registry_covers_launcher_choices():
    assert set(prunner.RUNNER_CLASSES) == set(jrunner.RUNNER_CLASSES) == \
        {"pdsh", "ssh", "openmpi", "mpich", "slurm", "mvapich"}


def test_elastic_flag_routes_to_agent(tmp_path, monkeypatch):
    cfg = tmp_path / "ds.json"
    cfg.write_text(json.dumps({"elasticity": {"max_train_batch_size": 8,
                                              "micro_batch_sizes": [2]}}))
    captured = {}

    class FakeAgent:
        def __init__(self, cmd, world_size, **kwargs):
            captured.update(cmd=cmd, world_size=world_size, **kwargs)

        def run(self):
            return 42

    import deepspeed_tpu_torch.elasticity as elasticity_pkg
    monkeypatch.setattr(elasticity_pkg, "DSElasticAgent", FakeAgent)
    rc = prunner.main(["--elastic", "4", "--max_restarts", "5",
                       "--heartbeat_timeout", "3.0", "--ds_config", str(cfg),
                       "--checkpoint_dir", str(tmp_path / "ck"),
                       "--collective_timeout", "7.5", "--ops_port", "0",
                       "--verify_checkpoint_integrity", "--per_rank_checkpoints",
                       "train.py", "--lr", "0.1"])
    assert rc == 42
    assert captured["cmd"] == [sys.executable, "-u", "train.py", "--lr", "0.1"]
    assert captured["world_size"] == 4 and captured["max_restarts"] == 5
    assert captured["heartbeat_timeout_s"] == 3.0 and captured["collective_timeout_s"] == 7.5
    assert captured["verify_checkpoint_integrity"] is True
    assert captured["per_rank_checkpoints"] is True and captured["ops_port"] == 0
    assert captured["heartbeat_dir"] and os.path.isdir(captured["heartbeat_dir"])
    assert captured["checkpoint_dir"] == str(tmp_path / "ck")
    assert captured["elastic_config"] == {"max_train_batch_size": 8, "micro_batch_sizes": [2]}
    os.rmdir(captured["heartbeat_dir"])  # rc 42: the launcher keeps it for a postmortem


def test_elastic_flag_without_heartbeat_timeout_leaves_liveness_off(monkeypatch):
    captured = {}

    class FakeAgent:
        def __init__(self, cmd, world_size, **kwargs):
            captured.update(kwargs)

        def run(self):
            return 0

    import deepspeed_tpu_torch.elasticity as elasticity_pkg
    monkeypatch.setattr(elasticity_pkg, "DSElasticAgent", FakeAgent)
    assert prunner.main(["--elastic", "2", "train.py"]) == 0
    assert not {"heartbeat_dir", "heartbeat_timeout_s", "collective_timeout_s"} & set(captured)


def test_local_launch_path_goes_through_the_per_node_entry(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(prunner.subprocess, "call", lambda cmd: seen.update(cmd=cmd) or 0)
    assert prunner.main(["--hostfile", str(tmp_path / "nope"), "train.py", "--epochs", "2"]) == 0
    assert seen["cmd"][-3:] == ["train.py", "--epochs", "2"]
    assert seen["cmd"][1:4] == ["-u", "-m", MODULE]


def _env_script(tmp_path):
    script = tmp_path / "env_dump.py"
    script.write_text(
        "import json, os, sys\n"
        "keys = ('RANK', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE', 'WORLD_SIZE', 'NODE_RANK')\n"
        "path = sys.argv[1] + '.' + os.environ['RANK']\n"
        "open(path, 'w').write(json.dumps({k: os.environ[k] for k in keys}))\n"
        "sys.exit(int(sys.argv[2]) if len(sys.argv) > 2 and os.environ['RANK'] == '1' else 0)\n")
    return str(script)


def test_launch_starts_one_process_per_local_gpu(tmp_path, monkeypatch):
    monkeypatch.setenv("DSTPU_WORLD_INFO", encode_world_info({"this-host": 2}))
    monkeypatch.setenv("NODE_RANK", "0")
    out = str(tmp_path / "env")
    assert launch.main([_env_script(tmp_path), out]) == 0
    seen = [json.loads(open(f"{out}.{r}").read()) for r in (0, 1)]
    assert [(s["RANK"], s["LOCAL_RANK"]) for s in seen] == [("0", "0"), ("1", "1")]
    assert {s["WORLD_SIZE"] for s in seen} == {s["LOCAL_WORLD_SIZE"] for s in seen} == {"2"}


def test_launch_places_a_node_from_the_world_info_and_returns_a_failure(tmp_path, monkeypatch):
    monkeypatch.setenv("DSTPU_WORLD_INFO", encode_world_info({"n0": 2, "n1": 2, "n2": 1}))
    for node, layout in ((0, (0, 2, 0, 5)), (1, (1, 2, 2, 5)), (2, (2, 1, 4, 5))):
        monkeypatch.setenv("NODE_RANK", str(node))
        assert launch._node_layout() == layout
    monkeypatch.setenv("DSTPU_WORLD_INFO", encode_world_info({"n0": 1, "n1": 1}))
    monkeypatch.setenv("NODE_RANK", "1")
    out = str(tmp_path / "env")
    assert launch.main([_env_script(tmp_path), out, "7"]) == 7  # global rank 1 exits 7
    seen = json.loads(open(f"{out}.1").read())
    assert (seen["RANK"], seen["LOCAL_RANK"], seen["NODE_RANK"], seen["WORLD_SIZE"]) == \
        ("1", "0", "1", "2")
