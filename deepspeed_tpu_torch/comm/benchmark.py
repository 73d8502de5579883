"""Collective bandwidth microbenchmarks (JAX ``deepspeed_tpu/comm/benchmark.py``),
the ``ds_bench`` analog.

Each op is timed as the facade's collective (``comm/comm.py``) over one mesh
axis of the live topology, on each rank's local tensor of the layout JAX
gives its shard: the gathered and all-to-all inputs are ``elems / world``
elements a rank, the reduced ones ``elems``.  The reported **algbw** is
message_bytes/time and **busbw** applies the ring factor ((n-1)/n for
all-gather, reduce-scatter and all-to-all, 2(n-1)/n for all-reduce), so the
numbers compare with NCCL-tests and the comms logger's accounting.

``python -m deepspeed_tpu_torch.comm.benchmark`` starts the process group
from the launcher's env (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``; at one rank too), sweeps the ops over ``--axis`` and prints JAX's
table on rank 0 (over one rank, JAX's "nothing to measure").  It measures on
the GPU, and raises without one, unless ``--device cpu`` asks for the CPU
(then over gloo).
"""

import os
import time
from typing import Dict, Optional

import torch

from ..parallel.mesh import MeshTopology, get_topology
from . import comm


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch sees no CUDA device; pass device='cpu' "
                           "to measure the collectives on the CPU")
    return device


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_op(fn, x, iters: int, device) -> float:
    # one warm call, then the original input again each iteration
    fn(x)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    _sync(device)
    return (time.perf_counter() - t0) / iters


def collective_bandwidth(op: str = "all_gather",
                         elems: int = int(5e8 // 2),
                         dtype=torch.bfloat16,
                         axis: str = "data",
                         topology: Optional[MeshTopology] = None,
                         iters: int = 10,
                         compiled_loop: bool = False,
                         device="cuda") -> Dict[str, float]:
    """Measure one collective's bandwidth over a mesh axis.

    ``elems`` is the GLOBAL bucket element count (default: the reference's
    5e8-element all-gather bucket in bf16 bytes), rounded down to a multiple
    of ``world * 128`` as JAX rounds it.  Returns {op, time_ms, algbw_gbps,
    busbw_gbps, world, bytes}.  ``compiled_loop`` (JAX: the iterations in one
    program, for relay transports) times the same eager loop here: torch
    dispatches each collective without a host round trip.  ``device`` holds
    the tensors: the GPU unless the caller asks for the CPU."""
    topo = topology or get_topology()
    world = topo.axis_size(axis)
    elems = int(elems) // (world * 128) * (world * 128) or world * 128
    device = _device(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    shard = elems // world
    if op == "all_gather":
        n, body, factor = shard, lambda x: comm.all_gather(x, axis), (world - 1) / world
    elif op == "reduce_scatter":
        n, body, factor = elems, lambda x: comm.reduce_scatter(x, axis), (world - 1) / world
    elif op == "all_reduce":
        n, body, factor = elems, lambda x: comm.all_reduce(x, axis), 2 * (world - 1) / world
    elif op == "all_to_all":
        n = shard
        body = lambda x: comm.all_to_all(x, axis, split_dim=0, concat_dim=0)
        factor = (world - 1) / world
    else:
        raise ValueError(f"unknown op {op!r}")
    x = torch.zeros((n, ), dtype=dtype, device=device)
    dt = _time_op(body, x, iters, device)
    nbytes = elems * itemsize
    algbw = nbytes / dt / 1e9
    return {
        "op": op,
        "time_ms": dt * 1e3,
        "algbw_gbps": algbw,
        "busbw_gbps": algbw * factor,
        "world": world,
        "bytes": nbytes,
    }


def run_sweep(ops=("all_gather", "all_reduce", "reduce_scatter", "all_to_all"),
              elems: int = int(5e8 // 2), axis: str = "data",
              topology: Optional[MeshTopology] = None, iters: int = 10, device="cuda"):
    """Sweep the standard ops at the reference bucket size: a list of result
    dicts (empty when the axis has one rank)."""
    topo = topology or get_topology()
    if topo.axis_size(axis) <= 1:
        return []
    return [collective_bandwidth(op, elems=elems, axis=axis, topology=topo, iters=iters,
                                 device=device)
            for op in ops]


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description="dstpu collective microbench (ds_bench analog)")
    parser.add_argument("--elems", type=float, default=5e8 / 2)
    parser.add_argument("--axis", default="data")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--ops", nargs="*", default=["all_gather", "all_reduce", "reduce_scatter",
                                                     "all_to_all"])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the tensors live; cpu runs the group over gloo")
    args = parser.parse_args(argv)
    device = _device(args.device)
    # under the launcher the group starts from its env, at one rank too
    master = os.environ.get("MASTER_ADDR")
    comm.init_distributed(dist_backend="gloo" if device.type == "cpu" else None,
                          init_method=(f"tcp://{master}:{os.environ.get('MASTER_PORT', '29500')}"
                                       if master else None))
    try:
        results = run_sweep(args.ops, elems=int(args.elems), axis=args.axis,
                            topology=get_topology(), iters=args.iters, device=device)
        rank = comm.get_rank()
        comm.barrier()  # every rank done before any tears the group down
    finally:
        comm.destroy_process_group()
    if rank != 0:
        return
    if not results:
        print(f"axis {args.axis!r} has world size 1 — nothing to measure")
        return
    print(f"{'op':<16}{'bytes':>14}{'time_ms':>10}{'algbw GB/s':>12}{'busbw GB/s':>12}")
    for r in results:
        print(f"{r['op']:<16}{r['bytes']:>14}{r['time_ms']:>10.2f}{r['algbw_gbps']:>12.2f}"
              f"{r['busbw_gbps']:>12.2f}")


if __name__ == "__main__":
    main()
