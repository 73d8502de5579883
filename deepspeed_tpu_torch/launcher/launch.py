"""The per-node entry: ``python -m deepspeed_tpu_torch.launcher.launch
script [args...]``.

It starts one process per local GPU, the PyTorch idiom (JAX's entry runs
the script once per host, because the JAX runtime owns every local chip).
The node's place comes from the world info (``DSTPU_WORLD_INFO``, which the
runner exports): ``NODE_RANK`` where the runner set it, else this host's
position in the hostfile order; its GPU count is its slots.  Without world
info the node is alone and runs a process for each of its GPUs (at least
one).  Each process gets ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``WORLD_SIZE`` and ``NODE_RANK``, takes
``cuda:LOCAL_RANK`` when a GPU is present, and runs the script as
``__main__`` (with ``-m``/``--module``, the script is a module name, run as
``python -m`` runs it: ``launch -m deepspeed_tpu_torch.comm.benchmark``).
Nothing here calls ``init_process_group``: the script does, from that env
(``MASTER_ADDR``/``MASTER_PORT`` come from the runner), as
``deepspeed_tpu_torch.initialize`` and ``init_distributed`` do.

The exit code is the first failing process's; a failure ends the node's
other processes (SIGTERM, a grace, then SIGKILL), and each is reaped.
"""

import argparse
import os
import runpy
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List

from ..utils.logging import logger
from .runner import decode_world_info

TERM_GRACE_S = 10.0
# the directory that holds the package, put on the processes' PYTHONPATH so
# that ``-m deepspeed_tpu_torch...`` resolves from any working directory
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _node_layout():
    """(node rank, local processes, first global rank, world size)."""
    world = decode_world_info(os.environ.get("DSTPU_WORLD_INFO", "e30="))
    if not world:
        import torch
        local = max(1, torch.cuda.device_count())
        return 0, local, 0, local
    hosts = list(world)
    if "NODE_RANK" in os.environ:
        node = int(os.environ["NODE_RANK"])
    else:
        hostname = socket.gethostname()
        matches = [i for i, h in enumerate(hosts) if h in (hostname, hostname.split(".")[0])]
        if not matches:
            logger.warning(f"host {hostname} not in world info {hosts}; defaulting NODE_RANK=0")
        node = matches[0] if matches else 0
    return (node, int(world[hosts[node]]), sum(int(world[h]) for h in hosts[:node]),
            sum(map(int, world.values())))


def _worker(argv: List[str]) -> None:
    """One process: take cuda:LOCAL_RANK where there is a GPU (the
    ``/dev/nvidiactl`` device node exists; torch is imported only then),
    then run the script (or, after ``--module``, the module) as ``__main__``."""
    if os.path.exists("/dev/nvidiactl"):
        import torch
        if torch.cuda.is_available():
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    module = argv[:1] == ["--module"]
    script, args = argv[int(module)], argv[int(module) + 1:]
    sys.argv = [script] + list(args)
    if module:
        runpy.run_module(script, run_name="__main__", alter_sys=True)
    else:
        runpy.run_path(script, run_name="__main__")


def _stop(procs, grace_s):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + grace_s
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    if argv[:1] == ["--local_worker"]:
        _worker(argv[1:])
        return 0
    parser = argparse.ArgumentParser(description="per-node launcher: one process per local GPU")
    parser.add_argument("-m", "--module", action="store_true",
                        help="user_script is a module name, run as python -m runs it")
    parser.add_argument("user_script")
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    node, local, first, world_size = _node_layout()
    procs = []
    path = os.pathsep.join(p for p in (_PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p)
    for local_rank in range(local):
        env = dict(os.environ, RANK=str(first + local_rank), LOCAL_RANK=str(local_rank),
                   LOCAL_WORLD_SIZE=str(local), WORLD_SIZE=str(world_size), NODE_RANK=str(node),
                   PYTHONPATH=path)
        procs.append(subprocess.Popen(
            [sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch", "--local_worker"]
            + (["--module"] if args.module else []) + [args.user_script] + list(args.user_args),
            env=env))
    logger.info(f"node {node}: {local} processes, ranks {first}-{first + local - 1} of "
                f"{world_size}")
    prev = {}

    def _on_signal(signum, frame):
        raise KeyboardInterrupt(signum)

    if threading.current_thread() is threading.main_thread():
        for signum in (signal.SIGINT, signal.SIGTERM):
            prev[signum] = signal.signal(signum, _on_signal)
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [rc for rc in codes if rc not in (None, 0)]
            if failed:
                _stop(procs, TERM_GRACE_S)
                return failed[0]
            if all(rc == 0 for rc in codes):
                return 0
            time.sleep(0.05)
    except KeyboardInterrupt as exc:
        _stop(procs, TERM_GRACE_S)
        return 128 + int(exc.args[0]) if exc.args else 130
    finally:
        for signum, handler in prev.items():
            signal.signal(signum, handler)
        _stop(procs, 0.0)


if __name__ == "__main__":
    sys.exit(main())
