"""The port's comm layer (``deepspeed_tpu_torch/comm``, ``parallel/mesh.py``)
against the JAX package's, on the CPU.

One module-scoped spawn of 4 gloo ranks over the mesh ``{"data": 2,
"tensor": 2}`` (``tests/torch_dist_workers.py``, scenario ``comm``) runs every
collective of the facade on each rank's row of a seeded numpy input, the
``ProcessGroup`` accessors of the six named groups, the host collectives,
a bounded barrier, the comms logger and the bandwidth microbench.  Here the
same global inputs go through the JAX facade inside ``shard_map`` on
``jax.devices()[:4]`` laid out as the same mesh, and rank ``r``'s result must
equal shard ``r`` of JAX's output: small integers exactly, other values
within 1e-6.  The cases follow ``tests/unit/test_comm.py``.  A second spawn
runs ``python -m deepspeed_tpu_torch.comm.benchmark`` under the per-node
launcher on 2 gloo ranks and holds its table to JAX's CLI's."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deepspeed_tpu import comm as jcomm
from deepspeed_tpu.comm import benchmark as jbench
from deepspeed_tpu.compat import shard_map
from deepspeed_tpu.parallel import MeshTopology as JMesh
from deepspeed_tpu.parallel import set_topology as jset_topology
from deepspeed_tpu.utils.comms_logging import calc_bw_log as jcalc_bw_log
from deepspeed_tpu.utils.comms_logging import get_comms_logger as jget_comms_logger
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm import benchmark
from deepspeed_tpu_torch.launcher.runner import encode_world_info
from deepspeed_tpu_torch.parallel import MeshTopology
from deepspeed_tpu_torch.utils.comms_logging import calc_bw_log

from . import torch_dist_workers as W

SPAWN_TIMEOUT_S = 90


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of the ``comm`` scenario (one spawn for the file)."""
    out = str(tmp_path_factory.mktemp("comm"))
    logs = W.spawn("comm", W.COMM_WORLD, out, SPAWN_TIMEOUT_S)
    assert all(rc == 0 for rc, _ in logs), "\n".join(text[-3000:] for _, text in logs)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(W.COMM_WORLD)]


@pytest.fixture(scope="module")
def jtopo():
    return JMesh.from_axis_dict(W.COMM_MESH, devices=jax.devices()[:W.COMM_WORLD])


def _per_device(jtopo, body, x=None):
    """``body`` run on each device's block of ``x`` ([4, ...], row r device
    r's) inside shard_map; returns [4, ...]: row r device r's result."""
    if x is None:
        x = np.zeros((W.COMM_WORLD, 1), np.float32)
    g = jnp.asarray(x.reshape((2, 2) + x.shape[1:]))
    fn = jax.jit(shard_map(lambda v: jnp.asarray(body(v[0, 0]))[None, None], mesh=jtopo.mesh,
                           in_specs=P("data", "tensor"), out_specs=P("data", "tensor"),
                           check_vma=False))
    out = np.asarray(fn(g))
    return out.reshape((W.COMM_WORLD, ) + out.shape[2:])


def test_rank_layout_is_jax_s(ranks, jtopo):
    """Rank r sits at the coordinate JAX gives device r."""
    devices = list(jtopo.mesh.devices.flat)
    names = jtopo.mesh.axis_names
    for r, res in enumerate(ranks):
        coord = dict(zip(names, (int(i) for i in np.argwhere(jtopo.mesh.devices
                                                              == devices[r])[0])))
        assert res["coordinate"] == coord
        assert res["world"] == 4 and res["rank"] == r


@pytest.mark.parametrize("name,op,axis,kw,shape,kind", W.COMM_CASES, ids=[c[0] for c in W.COMM_CASES])
def test_collective_matches_shard_r_of_jax(ranks, jtopo, name, op, axis, kw, shape, kind):
    x = W.comm_input(name)
    want = _per_device(jtopo, lambda v: getattr(jcomm, op)(v, axis, **kw), x)
    for r, res in enumerate(ranks):
        got = res[name].numpy()
        assert got.shape == want[r].shape, (r, got.shape, want[r].shape)
        if kind == "float":
            np.testing.assert_allclose(got, want[r], rtol=1e-6, atol=1e-6, err_msg=f"rank {r}")
        else:
            np.testing.assert_array_equal(got, want[r], err_msg=f"rank {r}")
    if kind == "inf":  # the non-source inf reaches no rank
        assert all(np.isfinite(res[name].numpy()).all() for res in ranks)


@pytest.mark.parametrize("axis", ["data", "tensor", ("tensor", "data")])
def test_axis_index_matches_jax(ranks, jtopo, axis):
    jaxis = jcomm.ProcessGroup(axis, jtopo) if isinstance(axis, tuple) else axis
    want = _per_device(jtopo, lambda v: jcomm.axis_index(jaxis))
    assert [res[f"axis_index_{axis}"] for res in ranks] == [int(w) for w in want]


@pytest.mark.parametrize("group", W.GROUPS)
def test_process_group_size_rank_and_axis_index(ranks, jtopo, group):
    """size() as JAX's; rank(), axis_index() and get_rank(group) each rank's
    in-graph axis_index of JAX's group; get_world_size(group) its size."""
    jg = getattr(jcomm, f"get_{group}_group")(jtopo)
    want = _per_device(jtopo, lambda v: jg.axis_index())
    for r, res in enumerate(ranks):
        size, rank, index, world, grank = res[f"group_{group}"]
        assert size == world == jg.size() == jcomm.get_world_size(jg)
        assert rank == index == grank == int(want[r])


def test_process_group_construction_and_errors():
    topo = MeshTopology.from_axis_dict({"data": 1}, world_size=1)
    g = comm.new_group(axes=("data", "tensor"), topology=topo)
    assert g.size() == 1 and g.rank() == 0 and g.members() == [0]
    assert comm.new_group(topology=topo).axes == topo.axis_names
    with pytest.raises(NotImplementedError, match="mesh axis"):
        comm.new_group(ranks=[0, 1])
    with pytest.raises(ValueError):
        comm.ProcessGroup("bogus", topo)


@pytest.mark.parametrize("op", W.HOST_OPS)
def test_host_all_reduce_matches_jax(ranks, jtopo, op):
    """Every rank's contribution row, reduced over the contributors: each
    rank holds JAX's reduction of the stacked rows."""
    jset_topology(jtopo)
    rows = np.stack([np.arange(3, dtype=np.float32) * (r + 1) - r for r in range(4)])
    want = np.asarray(jcomm.host_all_reduce(jnp.asarray(rows), op=op))
    for res in ranks:
        np.testing.assert_allclose(res[f"host_all_reduce_{op}"].numpy(), want, rtol=1e-6)
        assert res["host_all_reduce_errors"] == [True, True]  # a scalar, op "xor"


def test_host_broadcast_is_rank0_s(ranks):
    for res in ranks:
        np.testing.assert_array_equal(res["host_broadcast"].numpy(), [7.0, 7.0])


def test_world_one_collectives_are_the_identity():
    """Over one rank, with no process group, every collective is the
    identity, as JAX's over a one-device axis."""
    from deepspeed_tpu_torch.parallel import set_topology
    set_topology(MeshTopology.from_axis_dict({"data": 1}, world_size=1))
    x = torch.arange(12.0).reshape(3, 4)
    assert comm.get_rank() == 0 and comm.get_world_size() == 1
    for got in (comm.all_reduce(x, "data"), comm.all_reduce(x, "data", op="avg"),
                comm.all_gather(x, "data"), comm.reduce_scatter(x, "data"),
                comm.all_to_all(x, "data", split_dim=0, concat_dim=1),
                comm.ppermute(x, "data", [(0, 0)]), comm.broadcast(x, "data")):
        assert torch.equal(got, x)
    assert comm.axis_index("data") == 0
    comm.barrier()  # no group: returns at once


def test_calc_bw_log_formulas_match_jax():
    for op in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "broadcast"):
        assert calc_bw_log(op, 10**9, 1.0, 8) == jcalc_bw_log(op, 10**9, 1.0, 8)
    alg, bus = calc_bw_log("all_reduce", 10**9, 1.0, 8)
    assert abs(alg - 8.0) < 1e-6 and abs(bus - 14.0) < 1e-6


def test_comms_logger_records_as_jax_s(ranks, jtopo):
    """host_all_reduce of a [1, 4] fp32 tensor records one all_reduce of 16
    bytes, as JAX's logger records it; the eager collectives record under
    their ops with their inputs' bytes; the summary and events name them."""
    jset_topology(jtopo)
    cl = jget_comms_logger()
    cl.enabled = True
    cl.comms_dict.clear()
    try:
        jcomm.host_all_reduce(jnp.ones((1, 4)))
        want = {op: {str(size): e[0] for size, e in sizes.items()}
                for op, sizes in cl.comms_dict.items()}
    finally:
        cl.enabled = False
        cl.comms_dict.clear()
    for res in ranks:
        assert want == {"all_reduce": {"16": 1}}
        assert res["logged"] == {"all_reduce": {"16": 1, "32": 1}, "all_gather": {"8": 1}}
        assert res["summary_has_all_reduce"]
        assert {"Comms/all_reduce/count", "Comms/all_gather/count"} <= set(res["events"])


def test_collective_bandwidth_keys_at_world_two(ranks, jtopo):
    """The microbench over the data axis (2 ranks): JAX's keys, world 2,
    JAX's byte count and ring factor; the sweep in the order asked."""
    want = jbench.collective_bandwidth("all_gather", elems=W.BENCH_ELEMS, dtype=jnp.float32,
                                       axis="data", topology=jtopo, iters=1)
    for res in ranks:
        r = res["bench"]
        assert set(r) == set(want) and r["world"] == want["world"] == 2
        assert r["bytes"] == want["bytes"] and r["time_ms"] > 0
        assert abs(r["busbw_gbps"] - r["algbw_gbps"] / 2) < 1e-12
        assert res["sweep"] == ["all_reduce", "reduce_scatter"]
    topo = MeshTopology.from_axis_dict({"data": 1}, world_size=1)
    assert benchmark.run_sweep(topology=topo) == []


def test_collective_bandwidth_measures_on_the_gpu_unless_asked_for_the_cpu(monkeypatch):
    """The microbench and its CLI default to the GPU and raise without one:
    no bandwidth figure is taken on the CPU unless the caller asks for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = MeshTopology.from_axis_dict({"data": 1}, world_size=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmark.collective_bandwidth("all_reduce", elems=4096, topology=topo, iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmark.main(["--elems", "4096", "--iters", "1"])
    r = benchmark.collective_bandwidth("all_reduce", elems=4096, topology=topo, iters=1,
                                       device="cpu")
    assert r["world"] == 1 and r["time_ms"] > 0


def test_benchmark_cli_under_the_launcher_prints_jax_s_table(tmp_path, jtopo, capsys):
    """``launch -m deepspeed_tpu_torch.comm.benchmark`` on 2 gloo ranks of
    this host: rank 0 prints JAX's header and a row an op."""
    argv = ["--elems", "4096", "--iters", "1", "--ops", "all_gather", "all_reduce"]
    jset_topology(JMesh.from_axis_dict({"data": 2}, devices=jax.devices()[:2]))
    jbench.main(argv)
    want = capsys.readouterr().out.splitlines()
    env = dict(os.environ, DSTPU_WORLD_INFO=encode_world_info({"localhost": 2}), NODE_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(W.free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (W.REPO, os.environ.get("PYTHONPATH")) if p))
    run = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch", "-m",
                          "deepspeed_tpu_torch.comm.benchmark"] + argv + ["--device", "cpu"],
                         env=env, cwd=W.REPO,
                         capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    got = [line for line in run.stdout.splitlines() if line.startswith(("op ", "all_"))]
    assert got[0] == want[0]  # the header
    assert [line.split()[:2] for line in got[1:]] == [line.split()[:2] for line in want[1:]]


def test_engine_comms_logger_section_configures_the_logger_and_feeds_the_monitor(tmp_path):
    """``comms_logger.enabled`` acts: the engine configures the logger from
    the section, a profiled collective is recorded, and the steps_per_print
    report adds its summary to the monitor events, as JAX's engine does."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.utils.comms_logging import get_comms_logger
    conf = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 1,
            "bf16": {"enabled": False}, "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
            "comms_logger": {"enabled": True, "prof_all": False, "prof_ops": ["all_reduce"]},
            "csv_monitor": {"enabled": True, "output_path": str(tmp_path)}}
    cl = get_comms_logger()
    try:
        engine, *_ = deepspeed_tpu_torch.initialize(
            loss_fn=lambda p, b, rng: ((b @ p["w"]) ** 2).mean(),
            model_parameters={"w": torch.ones(4, 2)}, config=conf, device="cpu")
        assert cl.enabled and not cl.prof_all and cl.prof_ops == ["all_reduce"]
        cl.comms_dict.clear()
        comm.all_reduce(torch.ones(8), "data")
        comm.all_gather(torch.ones(8), "data")  # not among prof_ops: not recorded
        events = []
        engine.monitor.write_events = events.extend
        engine.train_batch(torch.ones(2, 3, 4))
        tags = {tag for tag, _, _ in events}
        assert {"Comms/all_reduce/count", "Comms/all_reduce/avg_latency_ms"} <= tags
        assert not any(tag.startswith("Comms/all_gather") for tag in tags)
    finally:
        cl.enabled, cl.prof_all, cl.prof_ops = False, True, []
        cl.comms_dict.clear()
