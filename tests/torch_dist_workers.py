"""Multi-process workers for the port's ``torch.distributed`` tests.

``spawn(scenario, world, ...)`` (or ``start`` then ``wait``) runs ``world``
processes of this file,
``python tests/torch_dist_workers.py SCENARIO RANK WORLD PORT OUT``, joined
in one gloo process group on a free localhost port from the OS, and waits
for them under a time limit of its own (a hung rank is killed and fails the
caller's test, never the run).  Each rank writes what it computed under
``OUT`` (``rank<R>.pt``, a dict of tensors and numbers, or ``rank<R>.json``);
the pytest process compares those with the JAX package's results.

Nothing here imports ``jax`` or ``deepspeed_tpu``: the workers run the port
alone.  The inputs of the collective cases are made from seeds with numpy,
by ``comm_cases``/``comm_input``, which the test and the workers share.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --------------------------------------------------------------- spawning


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(scenario: str, world: int, out: str, timeout_s: float, env=None):
    """Start ``scenario`` on ``world`` gloo ranks; ``wait`` on what it returns."""
    port = free_port()
    os.makedirs(out, exist_ok=True)
    base = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p), OMP_NUM_THREADS="1")
    base.update(env or {})
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, str(r),
                               str(world), str(port), out],
                              env=base, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return scenario, procs, time.monotonic() + timeout_s, timeout_s


def wait(started):
    """Each rank's (exit code, stdout+stderr).  Raises ``TimeoutError`` after
    killing every rank when they outlast their time limit."""
    scenario, procs, deadline, timeout_s = started
    logs = []
    try:
        for p in procs:
            try:
                text, _ = p.communicate(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"{scenario}: ranks still running after {timeout_s} s")
            logs.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def spawn(scenario: str, world: int, out: str, timeout_s: float, env=None):
    """``start`` then ``wait``."""
    return wait(start(scenario, world, out, timeout_s, env))


def init(rank: int, world: int, port: int, timeout_s: float = 60.0):
    from deepspeed_tpu_torch import comm
    comm.init_distributed(dist_backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                          rank=rank, world_size=world, timeout=timeout_s)
    return comm


# --------------------------------------------------------------- collectives

# the mesh of the collective cases: rank r sits at (data r // 2, tensor r % 2)
COMM_MESH = {"data": 2, "tensor": 2}
COMM_WORLD = 4

# (name, op, axis, kwargs, local shape, kind): kind "int" draws small
# integers (compared exactly), "float" normals (within 1e-6), "inf" integers
# with an inf on a rank that is not the broadcast's source
COMM_CASES = [
    ("all_reduce_sum_data", "all_reduce", "data", {}, (3, 5), "int"),
    ("all_reduce_avg_world", "all_reduce", ("data", "tensor"), {"op": "avg"}, (3, 5), "float"),
    ("all_reduce_max_tensor", "all_reduce", "tensor", {"op": "max"}, (4, ), "float"),
    ("all_reduce_min_data", "all_reduce", "data", {"op": "min"}, (4, ), "float"),
    ("all_reduce_sum_tensor_data", "all_reduce", ("tensor", "data"), {}, (2, 3), "int"),
    ("all_gather_data_dim0", "all_gather", "data", {}, (2, 3), "int"),
    ("all_gather_tensor_dim1", "all_gather", "tensor", {"gather_dim": 1}, (2, 3), "int"),
    ("all_gather_tensor_data", "all_gather", ("tensor", "data"), {}, (1, 3), "int"),
    ("all_gather_data_untiled", "all_gather", "data", {"tiled": False, "gather_dim": 1},
     (2, 3), "int"),
    ("reduce_scatter_data", "reduce_scatter", "data", {}, (4, 3), "int"),
    ("reduce_scatter_tensor_data_dim1", "reduce_scatter", ("tensor", "data"),
     {"scatter_dim": 1}, (2, 8), "int"),
    ("reduce_scatter_tensor_untiled", "reduce_scatter", "tensor", {"tiled": False}, (2, 3),
     "int"),
    ("all_to_all_tensor", "all_to_all", "tensor", {"split_dim": 1, "concat_dim": 0}, (4, 6),
     "int"),
    ("all_to_all_world", "all_to_all", ("data", "tensor"), {"split_dim": 0, "concat_dim": 1},
     (8, 2), "int"),
    ("ppermute_data_swap", "ppermute", "data", {"perm": [(0, 1), (1, 0)]}, (2, 3), "int"),
    ("ppermute_world_ring", "ppermute", ("data", "tensor"),
     {"perm": [(i, (i + 1) % 4) for i in range(4)]}, (3, ), "int"),
    ("ppermute_partial", "ppermute", "tensor", {"perm": [(0, 1)]}, (3, ), "int"),
    ("broadcast_data_src1", "broadcast", "data", {"src": 1}, (2, 3), "int"),
    ("broadcast_world_src3_inf", "broadcast", ("data", "tensor"), {"src": 3}, (4, ), "inf"),
]


def comm_input(name: str) -> np.ndarray:
    """The global input of a case: [4, *local shape], row r rank r's."""
    case = next(c for c in COMM_CASES if c[0] == name)
    shape, kind = case[4], case[5]
    rng = np.random.default_rng(sum(map(ord, name)))
    if kind == "float":
        return rng.normal(size=(COMM_WORLD, ) + shape).astype(np.float32)
    x = rng.integers(-8, 9, size=(COMM_WORLD, ) + shape).astype(np.float32)
    if kind == "inf":
        x[1, 0] = np.inf  # rank 1 is no source
    return x


# the six named groups and their mesh axes
GROUPS = ("world", "data_parallel", "model_parallel", "expert_parallel", "sequence_parallel",
          "pipe_parallel")
HOST_OPS = ("sum", "max", "min", "avg")
BENCH_ELEMS = 2 * 1024


def run_comm(rank, world, port, out):
    import torch

    from deepspeed_tpu_torch import comm as C
    from deepspeed_tpu_torch.comm import benchmark
    from deepspeed_tpu_torch.parallel import MeshTopology, set_topology
    from deepspeed_tpu_torch.utils.comms_logging import get_comms_logger
    init(rank, world, port)
    topo = MeshTopology.from_axis_dict(COMM_MESH)
    set_topology(topo)
    res = {"coordinate": topo.coordinate()}
    for name, op, axis, kw, _, _ in COMM_CASES:
        x = torch.from_numpy(comm_input(name)[rank])
        res[name] = getattr(C, op)(x, axis, **kw)
    for axis in ("data", "tensor", ("tensor", "data")):
        res[f"axis_index_{axis}"] = C.axis_index(axis)
    for g in GROUPS:
        pg = getattr(C, f"get_{g}_group")(topo)
        res[f"group_{g}"] = (pg.size(), pg.rank(), pg.axis_index(), C.get_world_size(pg),
                             C.get_rank(pg))
    contrib = torch.arange(3, dtype=torch.float32)[None] * (rank + 1) - rank
    for op in HOST_OPS:
        res[f"host_all_reduce_{op}"] = C.host_all_reduce(contrib, op=op)
    res["host_all_reduce_errors"] = [_raises(lambda: C.host_all_reduce(torch.tensor(1.0))),
                                     _raises(lambda: C.host_all_reduce(contrib, op="xor"))]
    res["host_broadcast"] = C.host_broadcast(torch.full((2, ), float(rank + 7)))
    C.barrier(timeout_s=30.0)
    res["world"], res["rank"] = C.get_world_size(), C.get_rank()
    # the comms logger: enabled, every collective above records under its op
    cl = get_comms_logger()
    cl.enabled, cl.prof_all = True, True
    cl.comms_dict.clear()
    C.host_all_reduce(torch.ones(1, 4))
    C.all_reduce(torch.ones(8), "data")
    C.all_gather(torch.ones(2), "tensor")
    res["logged"] = {op: {str(size): entry[0] for size, entry in sizes.items()}
                     for op, sizes in cl.comms_dict.items()}
    res["summary_has_all_reduce"] = "all_reduce" in C.log_summary()
    res["events"] = [tag for tag, _, _ in C.monitor_events(5)]
    cl.enabled = False
    cl.comms_dict.clear()
    # the bandwidth microbench over the data axis (2 ranks)
    r = benchmark.collective_bandwidth("all_gather", elems=BENCH_ELEMS, axis="data",
                                       topology=topo, iters=2, dtype=torch.float32,
                                       device="cpu")
    res["bench"] = r
    res["sweep"] = [x["op"] for x in benchmark.run_sweep(ops=("all_reduce", "reduce_scatter"),
                                                       elems=BENCH_ELEMS, topology=topo,
                                                       iters=1, device="cpu")]
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


# ------------------------------------------------------------ barrier timeout
BARRIER_TIMEOUT_S = 2.0


def run_barrier_timeout(rank, world, port, out):
    """Rank 1 never reaches the barrier; rank 0's bounded barrier raises.
    Rank 1 stays alive (a peer that exits would fail the barrier at once)
    until rank 0 has written its result."""
    C = init(rank, world, port)
    done = os.path.join(out, "rank0.json")
    if rank == 1:
        deadline = time.monotonic() + 60
        while not os.path.exists(done) and time.monotonic() < deadline:
            time.sleep(0.05)
        os._exit(0)
    t0 = time.monotonic()
    rec = {"raised": None}
    try:
        C.barrier(timeout_s=BARRIER_TIMEOUT_S)
    except C.CollectiveTimeoutError as exc:
        rec = {"raised": type(exc).__name__, "collective": exc.collective, "rank": exc.rank,
               "message": str(exc)}
    rec["elapsed_s"] = time.monotonic() - t0
    with open(done + ".tmp", "w") as fh:
        json.dump(rec, fh)
    os.rename(done + ".tmp", done)
    sys.stdout.flush()
    os._exit(0)  # the barrier's thread is still parked in the collective


# ------------------------------------------------------------ data parallel
DP_STEPS = 3


def dp_config(**kw):
    """The parity config: fused_adam, micro 2 a rank x gas 2, clipping,
    WarmupLR, fp32 (the JAX side runs it over {"data": 2})."""
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "bf16": {"enabled": False}, "steps_per_print": 100,
            "optimizer": {"type": "fused_adam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_max_lr": 1e-3, "warmup_num_steps": 5}}}
    conf.update(kw)
    return conf


TELEMETRY = {"enabled": True, "peak_flops_per_chip": 1e12}


def dp_batches(vocab, seq, rows=8, steps=DP_STEPS, seed=70):
    """The global batches, [rows, seq] token ids a step."""
    return [np.random.default_rng(seed + s).integers(0, vocab, (rows, seq)).astype(np.int32)
            for s in range(steps)]


def _digest(params):
    import hashlib

    from deepspeed_tpu_torch.runtime.tree import tree_leaves
    h = hashlib.sha256()
    for p in tree_leaves(params):
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_dp(rank, world, port, out):
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.runtime import checkpointing
    from deepspeed_tpu_torch.runtime.tree import tree_map
    from deepspeed_tpu_torch.utils.comms_logging import get_comms_logger
    spec = torch.load(os.path.join(out, "spec.pt"), weights_only=False)
    cfg, params = spec["cfg"], spec["params"]
    if rank == 1:  # the engine must start every rank from rank 0's params
        params = tree_map(lambda p: p + 1.0, params)
    init(rank, world, port)
    res = {}

    def build(conf, loss_fn=None):
        return deepspeed_tpu_torch.initialize(
            loss_fn=loss_fn or llama.make_loss_fn(cfg), model_parameters=params,
            config={k: v for k, v in conf.items() if v is not None}, device="cpu")[0]

    # 1. training parity with JAX's engine on {"data": 2}, the comms logger on
    engine = build(dp_config(comms_logger={"enabled": True}))
    get_comms_logger().comms_dict.clear()
    res["sizes"] = (engine.world_size, engine.dp_world_size, engine.train_batch_size,
                    engine.micro_batch_size, engine.gradient_accumulation_steps)
    steps = []
    for ids in dp_batches(cfg.vocab_size, cfg.max_seq_len):
        m = engine.train_batch(llama.causal_lm_batch(ids))
        steps.append({"loss": float(m.loss), "grad_norm": float(m.grad_norm), "lr": m.lr,
                      "digest": _digest(engine.state.params)})
    res["steps"] = steps
    cl = get_comms_logger()
    res["logged"] = {op: {size: entry[0] for size, entry in sizes.items()}
                     for op, sizes in cl.comms_dict.items()}
    res["n_params"] = sum(p.numel() for _, p in _flat(engine.state.params))
    cl.enabled = False
    res["params"] = {k: v.detach().clone() for k, v in _flat(engine.state.params)}
    res["eval"] = float(engine.eval_batch(llama.causal_lm_batch(dp_batches(
        cfg.vocab_size, cfg.max_seq_len, seed=90, steps=1)[0])))
    # 3. a checkpoint saved at world size 2: rank 0 alone writes
    ck = os.path.join(out, "ckpt")
    writes = []
    real = checkpointing.save_checkpoint_dir
    checkpointing.save_checkpoint_dir = lambda *a, **k: (writes.append(1), real(*a, **k))[1]
    try:
        res["tag"] = engine.save_checkpoint(ck)
    finally:
        checkpointing.save_checkpoint_dir = real
    res["writes"] = len(writes)
    reloaded = build(dp_config(telemetry=TELEMETRY))
    reloaded.load_checkpoint(ck)
    res["reloaded_digest"] = _digest(reloaded.state.params)
    res["reloaded_step"] = (reloaded.global_steps, reloaded.state.step)
    # 5. telemetry counts the whole job: its first step counts the FLOPs, the
    # second runs under a count of this rank's own
    from deepspeed_tpu_torch.profiling.flops_profiler import count_ops
    ids = dp_batches(cfg.vocab_size, cfg.max_seq_len, steps=1, seed=95)[0]
    reloaded.train_batch(llama.causal_lm_batch(ids))
    with count_ops() as own:
        reloaded.train_batch(llama.causal_lm_batch(ids))
    res["telemetry"] = {"record": reloaded._last_telemetry_record,
                        "n_chips": reloaded.telemetry.n_chips, "rank_flops": own.flops}
    # 6. a save that fails on rank 0 raises on every rank
    def failing(*a, **k):
        raise RuntimeError("the disk is gone")

    checkpointing.save_checkpoint_dir = failing
    try:
        reloaded.save_checkpoint(os.path.join(out, "ckpt_failed"))
        res["failed_save"] = None
    except Exception as exc:
        res["failed_save"] = {"type": type(exc).__name__, "message": str(exc),
                              "checkpoint_error": isinstance(exc, checkpointing.CheckpointError)}
    finally:
        checkpointing.save_checkpoint_dir = real
    # 2. fp16: an inf planted in rank 1's loss alone makes both ranks skip
    plant = {"on": False}
    base_loss = llama.make_loss_fn(cfg)

    def planted(p, batch, rng):
        loss = base_loss(p, batch, rng)
        return loss * float("inf") if plant["on"] and rank == 1 else loss

    fp16 = build(dp_config(fp16={"enabled": True, "initial_scale_power": 8, "hysteresis": 1}, bf16=None),
                 loss_fn=planted)
    ids = dp_batches(cfg.vocab_size, cfg.max_seq_len, steps=2, seed=80)
    m1 = fp16.train_batch(llama.causal_lm_batch(ids[0]))
    before = _digest(fp16.state.params)
    scale = fp16.state.loss_scale.cur_scale
    plant["on"] = True
    m2 = fp16.train_batch(llama.causal_lm_batch(ids[1]))
    res["fp16"] = {"first_skipped": m1.skipped, "skipped": m2.skipped,
                   "params_kept": _digest(fp16.state.params) == before,
                   "step": fp16.state.step, "scale_before": scale,
                   "scale_after": fp16.state.loss_scale.cur_scale,
                   "digest": _digest(fp16.state.params)}
    # 4. refusals above one rank
    refusals = {}
    for name, kw in (("zero1", {"zero_optimization": {"stage": 1}}),
                     ("zero2", {"zero_optimization": {"stage": 2}}),
                     ("zero3", {"zero_optimization": {"stage": 3}}),
                     ("offload_optimizer", {"zero_optimization": {
                         "stage": 0, "offload_optimizer": {"device": "cpu"}},
                         "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}),
                     ("tensor", {"mesh": {"data": 1, "tensor": 2}})):
        try:
            build(dp_config(**kw))
            refusals[name] = None
        except NotImplementedError as exc:
            refusals[name] = str(exc)
    res["refusals"] = refusals
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


SCENARIOS = {"comm": run_comm, "barrier_timeout": run_barrier_timeout, "dp": run_dp}

if __name__ == "__main__":
    scenario, rank, world, port, out = sys.argv[1:6]
    SCENARIOS[scenario](int(rank), int(world), int(port), out)
