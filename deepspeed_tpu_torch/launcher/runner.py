"""Cluster launcher CLI (JAX ``deepspeed_tpu/launcher/runner.py``), run as
``python -m deepspeed_tpu_torch.launcher.runner``: parses a hostfile,
filters it with --include/--exclude, encodes the world info, and launches
the training script on every host through the multi-node runners (pdsh,
ssh, Open MPI, MPICH, Slurm, MVAPICH), or locally.

Each host runs ``python -m deepspeed_tpu_torch.launcher.launch``, which
starts one process per local GPU (the PyTorch idiom; the JAX launcher runs
one process per host, since the JAX runtime owns every local chip).  The
environment is torch.distributed's: ``MASTER_ADDR``, ``MASTER_PORT`` and
``WORLD_SIZE`` (the GPUs over all hosts), where JAX exports
jax.distributed's ``COORDINATOR_ADDRESS`` and ``NUM_PROCESSES``.  The
world info payload is byte-identical to JAX's.  ``--elastic N`` supervises
N local workers under the elastic agent.
"""

import argparse
import base64
import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional

from ..utils.logging import logger

DEFAULT_SSH_PORT = 22


def fetch_hostfile(path: str) -> Dict[str, int]:
    """Parse 'hostname slots=N' lines (N: the host's GPUs)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"hostfile {path} not found")
    resources: Dict[str, int] = {}
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            host = parts[0]
            slots = 1
            for p in parts[1:]:
                if p.startswith("slots="):
                    try:
                        slots = int(p[len("slots="):])
                    except ValueError:
                        raise ValueError(f"{path}:{lineno}: bad slots in {line!r}")
            if host in resources:
                raise ValueError(f"{path}:{lineno}: duplicate host {host}")
            resources[host] = slots
    if not resources:
        raise ValueError(f"hostfile {path} is empty")
    return resources


def parse_inclusion_exclusion(resources: Dict[str, int], include: str = "",
                              exclude: str = "") -> Dict[str, int]:
    """--include/--exclude 'host1@host2:0,2' filtering.  As in JAX, a
    per-host selection sets the host's GPU COUNT, not device ids: the
    per-node launcher takes cuda:0 .. cuda:count-1."""
    if include and exclude:
        raise ValueError("--include and --exclude are mutually exclusive")

    def parse_spec(spec: str) -> Dict[str, Optional[List[int]]]:
        out: Dict[str, Optional[List[int]]] = {}
        for part in spec.split("@"):
            part = part.strip()
            if not part:
                continue
            if ":" in part:
                host, ids = part.split(":")
                out[host] = [int(i) for i in ids.split(",")]
            else:
                out[part] = None
        return out

    if include:
        spec = parse_spec(include)
        filtered = {}
        for host, ids in spec.items():
            if host not in resources:
                raise ValueError(f"--include host {host} not in hostfile")
            filtered[host] = len(ids) if ids is not None else resources[host]
        return filtered
    if exclude:
        spec = parse_spec(exclude)
        filtered = dict(resources)
        for host, ids in spec.items():
            if host not in filtered:
                raise ValueError(f"--exclude host {host} not in hostfile")
            if ids is None:
                del filtered[host]
            else:
                filtered[host] = max(0, filtered[host] - len(ids))
        return {h: s for h, s in filtered.items() if s > 0}
    return dict(resources)


def encode_world_info(resources: Dict[str, int]) -> str:
    """The base64 world info payload of ``DSTPU_WORLD_INFO``."""
    return base64.urlsafe_b64encode(json.dumps(resources).encode()).decode()


def decode_world_info(encoded: str) -> Dict[str, int]:
    return json.loads(base64.urlsafe_b64decode(encoded.encode()).decode())


class MultiNodeRunner:
    """Base remote runner."""
    name = "base"
    # env for the spawned launcher process; None = inherit os.environ.  Set by
    # runners whose transport can't inline every variable (Slurm comma values).
    spawn_env: Optional[Dict[str, str]] = None

    def __init__(self, args, world_info: Dict[str, int]):
        self.args = args
        self.world_info = world_info

    def backend_exists(self) -> bool:
        raise NotImplementedError

    def get_cmd(self, environment: Dict[str, str], active_resources: Dict[str, int]) -> List[str]:
        raise NotImplementedError

    @property
    def user_arguments(self) -> List[str]:
        return [self.args.user_script] + list(self.args.user_args)


class PDSHRunner(MultiNodeRunner):
    """pdsh fan-out."""
    name = "pdsh"

    def backend_exists(self) -> bool:
        return shutil.which("pdsh") is not None

    def get_cmd(self, environment, active_resources):
        env_exports = [f"export {k}={v};" for k, v in sorted(environment.items())]
        hosts = ",".join(active_resources.keys())
        remote_cmd = " ".join(env_exports + [sys.executable, "-u", "-m",
                                             "deepspeed_tpu_torch.launcher.launch"] + self.user_arguments)
        return ["pdsh", "-S", "-f", "1024", "-w", hosts, remote_cmd]


class SSHRunner(MultiNodeRunner):
    """Plain-ssh loop fallback when pdsh is absent."""
    name = "ssh"

    def backend_exists(self) -> bool:
        return shutil.which("ssh") is not None

    def get_cmds(self, environment, active_resources):
        cmds = []
        for rank, host in enumerate(active_resources):
            env = dict(environment, NODE_RANK=str(rank))
            exports = [f"export {k}={v};" for k, v in sorted(env.items())]
            remote = " ".join(exports + [sys.executable, "-u", "-m",
                                         "deepspeed_tpu_torch.launcher.launch"] + self.user_arguments)
            cmds.append(["ssh", "-o", "StrictHostKeyChecking=no", host, remote])
        return cmds

    def get_cmd(self, environment, active_resources):
        return self.get_cmds(environment, active_resources)[0]


class OpenMPIRunner(MultiNodeRunner):
    """mpirun (Open MPI dialect): one rank per host, each the per-node
    launcher; the env rides ``-x`` exports."""
    name = "openmpi"

    def backend_exists(self) -> bool:
        return shutil.which("ompi_info") is not None and shutil.which("mpirun") is not None

    def get_cmd(self, environment, active_resources):
        total = len(active_resources)
        exports = []
        for k, v in sorted(environment.items()):
            exports += ["-x", f"{k}={v}"]
        hosts = ",".join(active_resources.keys())
        cmd = ["mpirun", "-n", str(total), "--host", hosts, "--mca", "btl", "^openib"]
        iface = getattr(self.args, "mpi_interface", "")
        if iface:  # only pin the NIC when the user names one (eth0 is not universal)
            cmd += ["--mca", "btl_tcp_if_include", iface]
        return (cmd + exports
                + [sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch"]
                + self.user_arguments)


class MPICHRunner(MultiNodeRunner):
    """mpirun (MPICH dialect, ``-genv`` exports)."""
    name = "mpich"

    def backend_exists(self) -> bool:
        # Open MPI also installs an 'mpirun'; require an MPICH marker so the
        # MPICH-only flags (-hosts/-genv) don't fail cryptically at runtime
        if shutil.which("mpiexec.hydra") is not None:
            return True
        mpirun = shutil.which("mpirun")
        if mpirun is None:
            return False
        try:
            out = subprocess.run([mpirun, "--version"], capture_output=True,
                                 text=True, timeout=5).stdout
        except Exception:
            return False
        return "mpich" in out.lower() or "hydra" in out.lower()

    def get_cmd(self, environment, active_resources):
        total = len(active_resources)
        exports = []
        for k, v in sorted(environment.items()):
            exports += ["-genv", k, str(v)]
        hosts = ",".join(active_resources.keys())
        return (["mpirun", "-n", str(total), "-hosts", hosts] + exports
                + [sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch"]
                + self.user_arguments)


class SlurmRunner(MultiNodeRunner):
    """srun allocation launch.  Env propagates via ``--export`` (Slurm
    forwards it to every task)."""
    name = "slurm"

    def backend_exists(self) -> bool:
        return shutil.which("srun") is not None

    def get_cmd(self, environment, active_resources):
        total = len(active_resources)
        # --export splits on commas with no escape syntax: a comma-containing
        # value inlined as K=V would silently corrupt every later pair.  Those
        # values ride the parent environment instead: srun forwards it under
        # the leading ALL (the launcher spawns srun with os.environ inherited).
        inline, via_parent = {}, {}
        for k, v in sorted(environment.items()):
            (via_parent if "," in str(v) else inline)[k] = str(v)
        self.spawn_env = {**os.environ, **via_parent} if via_parent else None
        exports = "ALL" + "".join(f",{k}={v}" for k, v in inline.items())
        cmd = ["srun", "-n", str(total)]
        if active_resources:
            cmd += ["-w", ",".join(active_resources.keys())]
        if getattr(self.args, "slurm_comment", ""):
            cmd += ["--comment", self.args.slurm_comment]
        cmd += [f"--export={exports}", sys.executable, "-u", "-m",
                "deepspeed_tpu_torch.launcher.launch"] + self.user_arguments
        return cmd


class MVAPICHRunner(MultiNodeRunner):
    """mpirun_rsh (MVAPICH2); env as KEY=VALUE operands.  mpirun_rsh wants a
    bare-hostname file (no ``slots=N`` tokens), so the runner writes one
    from the already include/exclude-filtered resources."""
    name = "mvapich"

    def backend_exists(self) -> bool:
        return shutil.which("mpirun_rsh") is not None

    def get_cmd(self, environment, active_resources):
        import tempfile
        total = len(active_resources)
        fh = tempfile.NamedTemporaryFile("w", prefix="dstpu_mvapich_hosts_",
                                         suffix=".txt", delete=False)
        fh.write("\n".join(active_resources.keys()) + "\n")
        fh.close()
        import atexit
        atexit.register(lambda p=fh.name: os.path.exists(p) and os.unlink(p))
        env_kv = [f"{k}={v}" for k, v in sorted(environment.items())]
        return (["mpirun_rsh", "-np", str(total), "-hostfile", fh.name]
                + env_kv + [sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch"]
                + self.user_arguments)


RUNNER_CLASSES = {cls.name: cls for cls in
                  (PDSHRunner, SSHRunner, OpenMPIRunner, MPICHRunner,
                   SlurmRunner, MVAPICHRunner)}


def build_launch_env(resources: Dict[str, int], master_addr: str, master_port: int) -> Dict[str, str]:
    """torch.distributed's rendezvous env: ``WORLD_SIZE`` is every host's
    GPUs together (one process a GPU)."""
    return {
        "DSTPU_WORLD_INFO": encode_world_info(resources),
        "MASTER_ADDR": str(master_addr),
        "MASTER_PORT": str(master_port),
        "WORLD_SIZE": str(sum(resources.values())),
    }


def run_elastic(args) -> int:
    """Single-host elastic supervision (``--elastic N``): the agent spawns N
    copies of the user script, watches exit codes AND per-rank heartbeats,
    and on failure rescales to the next valid world size, pinning the new
    generation to the newest checkpoint tag valid across all of its ranks."""
    import tempfile

    from ..elasticity import DSElasticAgent

    elastic_config = None
    if args.ds_config:
        with open(args.ds_config) as fh:
            elastic_config = json.load(fh).get("elasticity")
    kwargs = {}
    if args.heartbeat_timeout is not None:
        kwargs.update(heartbeat_dir=tempfile.mkdtemp(prefix="dstpu_hb_"),
                      heartbeat_timeout_s=args.heartbeat_timeout)
    if args.collective_timeout is not None:
        kwargs.update(collective_timeout_s=args.collective_timeout)
    if args.ops_port is not None:
        # merged fleet /metrics + /healthz over the agent (workers publish
        # per-rank snapshots via the DSTPU_OPS_DIR export; monitor/ops_server)
        kwargs.update(ops_port=args.ops_port)
    agent = DSElasticAgent(
        [sys.executable, "-u", args.user_script] + list(args.user_args),
        world_size=args.elastic, elastic_config=elastic_config,
        max_restarts=args.max_restarts, checkpoint_dir=args.checkpoint_dir,
        per_rank_checkpoints=args.per_rank_checkpoints,
        verify_checkpoint_integrity=args.verify_checkpoint_integrity,
        **kwargs)
    logger.info(f"launching {args.elastic} workers under the elastic agent "
                f"(max_restarts={args.max_restarts})")
    rc = agent.run()
    hb_dir = kwargs.get("heartbeat_dir")
    if hb_dir:
        if rc == 0:
            shutil.rmtree(hb_dir, ignore_errors=True)  # don't leak /tmp stamps
        else:
            logger.warning(f"keeping heartbeat stamps for postmortem: {hb_dir}")
    return rc


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="deepspeed_tpu_torch launcher (one process per GPU on every host)")
    parser.add_argument("-H", "--hostfile", default="/job/hostfile")
    parser.add_argument("--include", default="")
    parser.add_argument("--exclude", default="")
    parser.add_argument("--master_addr", default=None)
    parser.add_argument("--master_port", type=int, default=29500)
    parser.add_argument("--launcher", default="pdsh",
                        choices=("pdsh", "ssh", "local", "openmpi", "mpich", "slurm", "mvapich"))
    parser.add_argument("--slurm_comment", default="")
    parser.add_argument("--mpi_interface", default="",
                        help="NIC for Open MPI's TCP BTL (omit to let OMPI pick)")
    parser.add_argument("--force_multi", action="store_true")
    parser.add_argument("--elastic", type=int, default=0, metavar="N",
                        help="supervise N local worker processes under the elastic "
                             "agent (heartbeat liveness, hang detection, rescale + "
                             "checkpoint-pinned restart) instead of one exec")
    parser.add_argument("--max_restarts", type=int, default=3)
    parser.add_argument("--checkpoint_dir", default=None,
                        help="with --elastic: restart generations resume from the "
                             "newest tag valid across all ranks (DSTPU_RESUME_TAG)")
    parser.add_argument("--per_rank_checkpoints", action="store_true",
                        help="with --elastic: workers save node-locally to "
                             "<checkpoint_dir>/rank<R>/ — consensus must walk every "
                             "rank's dir (without this the walk sees the rank<R> "
                             "subdirs as invalid tags and pins nothing)")
    parser.add_argument("--verify_checkpoint_integrity", action="store_true",
                        help="with --elastic: consensus tag selection also CRC-checks "
                             "every rank's copy (a size-only check can pin a tag a "
                             "worker's own verify_integrity pass then rejects)")
    parser.add_argument("--heartbeat_timeout", type=float, default=None,
                        help="with --elastic: a rank whose heartbeat stamp is older "
                             "than this many seconds is treated as hung")
    parser.add_argument("--ops_port", type=int, default=None, metavar="PORT",
                        help="with --elastic: serve merged fleet metrics + health "
                             "on this port (Prometheus /metrics, JSON /healthz and "
                             "/statez; 0 picks an ephemeral port).  Workers publish "
                             "per-rank snapshots via the agent-exported "
                             "DSTPU_OPS_DIR; counters stay monotone across worker "
                             "restarts")
    parser.add_argument("--collective_timeout", type=float, default=None,
                        help="with --elastic: wall-clock bound (seconds) exported to "
                             "workers (DSTPU_COLLECTIVE_TIMEOUT_S) so a wedged host "
                             "collective raises CollectiveTimeoutError instead of "
                             "deadlocking the generation")
    parser.add_argument("--ds_config", default=None,
                        help="with --elastic: ds config JSON whose 'elasticity' "
                             "section constrains the valid world sizes")
    parser.add_argument("user_script")
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    if args.elastic > 0:
        return run_elastic(args)

    # --launcher local always runs on this host, hostfile or not
    multi_node = (os.path.isfile(args.hostfile) or args.force_multi) and args.launcher != "local"
    if not multi_node:
        logger.info("launching locally (one host, one process per local GPU)")
        cmd = ([sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch", args.user_script]
               + list(args.user_args))
        return subprocess.call(cmd)

    resources = fetch_hostfile(args.hostfile)
    resources = parse_inclusion_exclusion(resources, args.include, args.exclude)
    master_addr = args.master_addr or next(iter(resources))
    env = build_launch_env(resources, master_addr, args.master_port)

    runner: MultiNodeRunner
    if args.launcher == "pdsh":
        runner = PDSHRunner(args, resources)
        if not runner.backend_exists():
            logger.warning("pdsh not found; falling back to ssh")
            runner = SSHRunner(args, resources)
    elif args.launcher in RUNNER_CLASSES and args.launcher != "ssh":
        runner = RUNNER_CLASSES[args.launcher](args, resources)
    else:
        runner = SSHRunner(args, resources)
    if not runner.backend_exists():
        raise RuntimeError(f"launcher backend '{runner.name}' not available")

    if isinstance(runner, SSHRunner):
        procs = [subprocess.Popen(c) for c in runner.get_cmds(env, resources)]
        rc = 0
        for p in procs:
            rc |= p.wait()
        return rc
    cmd = runner.get_cmd(env, resources)
    logger.info(f"launching: {' '.join(cmd)}")
    return subprocess.call(cmd, env=runner.spawn_env)


if __name__ == "__main__":
    sys.exit(main())
