"""Distributed communication facade (JAX ``deepspeed_tpu/comm/comm.py``).

The JAX facade runs its collectives inside ``shard_map`` on a global array,
over named mesh axes.  Here they run eagerly over ``torch.distributed``, on
each rank's local tensor: for the same global input, rank ``r``'s result is
shard ``r`` of JAX's output.  Each collective takes a mesh axis, a tuple of
axes or a ``comm.groups.ProcessGroup`` and runs over that scope's torch
subgroup; over one rank it is the identity and needs no process group.
Results are new tensors (JAX's functional form); ``all_reduce`` can also
reduce in place (``inplace=True``, torch's form).

Every collective goes through the comms logger (``utils/comms_logging.py``):
when the logger profiles the op, the call is timed between two device
syncs and recorded with its message size (the input's bytes) and the
group's size; otherwise no sync is added.

``init_distributed`` starts the process group from the env that the
launcher exports (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``) or from its arguments, with bounded retries
(``DSTPU_INIT_RETRIES`` / ``DSTPU_INIT_RETRY_BACKOFF_S`` over the config's
defaults).  ``bounded_collective`` bounds a blocking host-level collective
by wall clock (``DSTPU_COLLECTIVE_TIMEOUT_S`` over the config's
``fault_tolerance.collective_timeout_s``) and stamps the heartbeat around it.
"""

import datetime
import os
import threading
import time
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..parallel.mesh import MeshTopology, get_topology
from ..runtime.heartbeat import (COLLECTIVE_TIMEOUT_ENV, INIT_RETRIES_ENV, INIT_RETRY_BACKOFF_ENV,
                                 get_heartbeat)
from ..utils.comms_logging import get_comms_logger
from ..utils.env import env_float, env_int
from ..utils.logging import logger
from . import groups as _groups

ReduceOp = type("ReduceOp", (), {"SUM": "sum", "AVG": "avg", "MAX": "max", "MIN": "min",
                                 "PRODUCT": "prod"})

_INITIALIZED = False

# -------------------------------------------------------- bounded collectives
# Default wall-clock bound for HOST-LEVEL collectives (barrier and anything
# routed through bounded_collective).  None = unbounded.  Set from config
# (fault_tolerance.collective_timeout_s, by initialize() and the engine),
# set_default_collective_timeout(), or the env the elastic agent exports.
_DEFAULT_COLLECTIVE_TIMEOUT_S: Optional[float] = None


class CollectiveTimeoutError(RuntimeError):
    """A host-level collective exceeded its wall-clock bound: a rank stuck in
    (or absent from) a collective would otherwise deadlock every peer
    silently.  The error names the collective, this process's rank and the
    elapsed time, so the supervisor (the elastic agent) gets a fast,
    attributable failure to restart from."""

    def __init__(self, collective: str, rank: int, elapsed_s: float, timeout_s: float):
        self.collective = collective
        self.rank = rank
        self.elapsed_s = elapsed_s
        self.timeout_s = timeout_s
        super().__init__(
            f"collective '{collective}' timed out on rank {rank} after "
            f"{elapsed_s:.1f}s (timeout {timeout_s:.1f}s) - a peer likely "
            f"crashed, hung, or entered a different collective; check the "
            f"elastic agent's cross-rank hang snapshot for the stuck ranks")


def set_default_collective_timeout(timeout_s: Optional[float]) -> None:
    global _DEFAULT_COLLECTIVE_TIMEOUT_S
    _DEFAULT_COLLECTIVE_TIMEOUT_S = None if timeout_s is None else float(timeout_s)


def _resolve_timeout(timeout_s) -> Optional[float]:
    if timeout_s is not None:
        return float(timeout_s) if timeout_s > 0 else None
    env_val = env_float(COLLECTIVE_TIMEOUT_ENV)
    if env_val is not None:
        return env_val if env_val > 0 else None
    return _DEFAULT_COLLECTIVE_TIMEOUT_S


def bounded_collective(fn, *args, timeout_s: Optional[float] = None,
                       name: str = "collective", **kwargs):
    """Run a blocking host-level collective with a wall-clock bound.

    Stamps the heartbeat (``enter_collective(name)`` / ``exit_collective``)
    around the wait, then runs ``fn`` on a daemon thread and joins it with
    the resolved timeout; on expiry raises :class:`CollectiveTimeoutError`.
    The thread stays parked on the wedged collective (it cannot be
    cancelled), and the collective's name stays stamped so that the agent's
    hang dump names it: the expected response is process exit and a
    restart.  With no timeout resolved the call is direct, still stamped."""
    timeout = _resolve_timeout(timeout_s)
    hb = get_heartbeat()
    hb.enter_collective(name)
    timed_out = False
    try:
        if timeout is None:
            return fn(*args, **kwargs)
        result: list = []
        failure: list = []

        def _run():
            try:
                result.append(fn(*args, **kwargs))
            except BaseException as exc:  # re-raised on the caller's thread below
                failure.append(exc)

        t0 = time.monotonic()
        worker = threading.Thread(target=_run, name=f"dstpu-{name}", daemon=True)
        worker.start()
        worker.join(timeout)
        if worker.is_alive():
            timed_out = True
            raise CollectiveTimeoutError(name, get_rank(), time.monotonic() - t0, timeout)
        if failure:
            raise failure[0]
        return result[0]
    finally:
        if not timed_out:
            hb.exit_collective()


def init_distributed(dist_backend: Optional[str] = None,
                     auto_mpi_discovery: bool = True,
                     init_method: Optional[str] = None,
                     rank: int = -1,
                     world_size: int = -1,
                     timeout=None,
                     verbose=True):
    """Start the process group (reference ``deepspeed.init_distributed``).

    ``init_method`` (e.g. ``"tcp://host:port"``), else ``MASTER_ADDR`` and
    ``MASTER_PORT`` from the env when ``WORLD_SIZE`` is above 1; otherwise
    this is a single process and nothing starts.  ``world_size`` and
    ``rank`` default to ``WORLD_SIZE`` and ``RANK``.  ``dist_backend`` defaults to ``nccl`` with a GPU and
    ``gloo`` without; under ``nccl`` the process takes ``cuda:LOCAL_RANK``.
    ``timeout`` (seconds) bounds the group's collectives.  A process group
    that is already up (started here or elsewhere) is adopted as it is."""
    global _INITIALIZED
    if not dist.is_initialized():
        nproc = world_size if world_size > 0 else int(os.environ.get("WORLD_SIZE", "1") or 1)
        pid = rank if rank >= 0 else int(os.environ.get("RANK", "0") or 0)
        if init_method is None and os.environ.get("MASTER_ADDR") and nproc > 1:
            init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                           f"{os.environ.get('MASTER_PORT', '29500')}")
        if init_method:
            backend = dist_backend or ("nccl" if torch.cuda.is_available() else "gloo")
            if backend == "nccl":
                torch.cuda.set_device(get_local_rank())
            _initialize_with_retries(init_method, nproc, pid, timeout, backend=backend)
            if verbose:
                logger.info(f"torch.distributed initialized: rank {pid}/{nproc} via "
                            f"{init_method} ({backend})")
    if dist.is_initialized():  # a single process keeps logging's RANK-env provider
        from ..utils import logging as _logging
        _logging.set_rank_provider(get_rank)
    _INITIALIZED = True


# Module defaults for the process-group setup retry loop.  Set from config
# (fault_tolerance.init_retries / init_retry_backoff_s, applied by
# initialize() BEFORE init_distributed runs) via set_init_retry_defaults();
# the agent-exported env wins over both.
_DEFAULT_INIT_RETRIES = 3
_DEFAULT_INIT_RETRY_BACKOFF_S = 0.5


def set_init_retry_defaults(retries: Optional[int] = None,
                            backoff_s: Optional[float] = None) -> None:
    """Default attempts/backoff for ``_initialize_with_retries`` (None keeps
    the current value for that knob)."""
    global _DEFAULT_INIT_RETRIES, _DEFAULT_INIT_RETRY_BACKOFF_S
    if retries is not None:
        _DEFAULT_INIT_RETRIES = max(int(retries), 0)
    if backoff_s is not None:
        _DEFAULT_INIT_RETRY_BACKOFF_S = max(float(backoff_s), 0.0)


def _initialize_with_retries(init_method: str, world_size: int, rank: int, timeout=None,
                             backend: str = "gloo") -> None:
    """``torch.distributed.init_process_group`` under bounded exponential
    backoff: setup fails transiently in exactly the situations elastic
    training creates (a restarted master not listening yet, a peer of the
    previous generation still holding the port).  Attempts/backoff come
    from ``DSTPU_INIT_RETRIES`` / ``DSTPU_INIT_RETRY_BACKOFF_S``, else the
    module defaults; a group that a failed attempt left behind is destroyed
    before the next; the last failure propagates unchanged."""
    retries = max(env_int(INIT_RETRIES_ENV, _DEFAULT_INIT_RETRIES), 0)
    backoff = max(env_float(INIT_RETRY_BACKOFF_ENV, _DEFAULT_INIT_RETRY_BACKOFF_S), 0.0)
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=float(timeout))}
    for attempt in range(retries + 1):
        try:
            dist.init_process_group(backend=backend, init_method=init_method,
                                    world_size=world_size, rank=rank, **kwargs)
            return
        except Exception as exc:
            if attempt >= retries:
                raise
            if dist.is_initialized():
                try:
                    dist.destroy_process_group()
                except Exception as reset_exc:
                    logger.debug(f"init_distributed: group reset between retries raised "
                                 f"{reset_exc!r} (continuing)")
            delay = backoff * (2 ** attempt)
            logger.warning(f"init_distributed: attempt {attempt + 1}/{retries + 1} "
                           f"failed ({exc!r}); retrying in {delay:.2f}s")
            if delay > 0:
                time.sleep(delay)


def destroy_process_group() -> None:
    """Tear the process group down (reference ``comm.destroy_process_group``)
    and forget the subgroups and this module's initialised state."""
    global _INITIALIZED
    if dist.is_initialized():
        dist.destroy_process_group()
    _groups.reset_group_cache()
    _INITIALIZED = False


def is_initialized() -> bool:
    return _INITIALIZED


def get_rank(group=None) -> int:
    """Rank within ``group`` (a ``ProcessGroup``) or in the world."""
    if group is not None and hasattr(group, "rank"):
        return group.rank()
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size(group=None) -> int:
    """Size of ``group`` (its ranks over its mesh axes) or of the world."""
    if group is not None and hasattr(group, "size"):
        return group.size()
    return dist.get_world_size() if dist.is_initialized() else 1


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def barrier(group=None, timeout_s: Optional[float] = None):
    """Synchronize the ranks (of ``group``, else all), bounded: with a
    resolved timeout a barrier that a peer never reaches raises
    :class:`CollectiveTimeoutError`; the heartbeat records 'in barrier'
    either way."""

    def _sync():
        if not dist.is_initialized():
            return None
        pg = _scope(group).torch_group() if group is not None else None
        if group is not None and pg is None:
            return None
        return dist.barrier(group=pg)

    return bounded_collective(_sync, timeout_s=timeout_s, name="barrier")


# --------------------------------------------------------------------------
# Collectives over mesh axes, eager on each rank's local tensor
# --------------------------------------------------------------------------

AxisArg = Union[str, Sequence[str]]  # or a comm.groups.ProcessGroup


def _scope(axis) -> "_groups.ProcessGroup":
    if isinstance(axis, _groups.ProcessGroup):
        return axis
    return _groups.ProcessGroup(axis)


def _order(g) -> list:
    """Linear index of the member at each torch group rank (torch orders a
    group's ranks by global rank)."""
    members = g.members()
    return sorted(range(len(members)), key=lambda i: members[i])


def _logged(op: str, x: torch.Tensor, n: int, log_name: Optional[str], run):
    cl = get_comms_logger()
    if not cl.should_profile(op):
        return run()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    out = run()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    cl.append(op, log_name or op, time.perf_counter() - t0, x.numel() * x.element_size(), n)
    return out


_TORCH_OPS = {"sum": "SUM", "avg": "SUM", "mean": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(x, axis: AxisArg, op: str = "sum", *, inplace: bool = False,
               log_name: Optional[str] = None):
    """Sum, mean, max or min over the scope (JAX ``lax.psum``/``pmean``/
    ``pmax``/``pmin``); the mean is the sum divided by the scope's size.
    ``inplace`` reduces ``x`` itself, as ``torch.distributed.all_reduce``."""
    if op not in _TORCH_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    g = _scope(axis)
    n = g.size()

    def run():
        out = x if inplace else x.clone()
        pg = g.torch_group()
        if pg is not None:
            dist.all_reduce(out, op=getattr(dist.ReduceOp, _TORCH_OPS[op]), group=pg)
        if op in ("avg", "mean"):
            out.div_(n)
        return out

    return _logged("all_reduce", x, n, log_name, run)


def _gather(x, g, tiled: bool, gather_dim: int):
    pg = g.torch_group()
    if pg is None:
        parts = [x.clone()]
    else:
        got = [torch.empty_like(x, memory_format=torch.contiguous_format)
               for _ in range(g.size())]
        dist.all_gather(got, x.contiguous(), group=pg)
        parts = [None] * len(got)
        for t, lin in enumerate(_order(g)):
            parts[lin] = got[t]
    return torch.cat(parts, gather_dim) if tiled else torch.stack(parts, gather_dim)


def all_gather(x, axis: AxisArg, *, tiled: bool = True, gather_dim: int = 0,
               log_name: Optional[str] = None):
    """Every rank's ``x`` in scope order, concatenated along ``gather_dim``
    (``tiled``) or stacked on a new dim there (JAX ``lax.all_gather``)."""
    g = _scope(axis)
    return _logged("all_gather", x, g.size(), log_name,
                   lambda: _gather(x, g, tiled, gather_dim))


def reduce_scatter(x, axis: AxisArg, *, scatter_dim: int = 0, tiled: bool = True,
                   log_name: Optional[str] = None):
    """Sum over the scope, then rank ``i`` keeps chunk ``i`` of
    ``scatter_dim`` (JAX ``lax.psum_scatter``; untiled, that dim is of the
    scope's size and goes)."""
    g = _scope(axis)
    n = g.size()
    size = x.shape[scatter_dim]
    if (size % n) if tiled else (size != n):
        raise ValueError(f"reduce_scatter: dim {scatter_dim} of size {size} does not split "
                         f"over {n} ranks" + ("" if tiled else " (untiled: must equal it)"))

    def run():
        front = x.movedim(scatter_dim, 0)
        chunks = front.reshape(n, size // n, *front.shape[1:])
        pg = g.torch_group()
        if pg is None:
            out = chunks[0].clone()
        else:
            out = torch.empty_like(chunks[0], memory_format=torch.contiguous_format)
            dist.reduce_scatter(out, [chunks[lin].contiguous() for lin in _order(g)], group=pg)
        out = out.movedim(0, scatter_dim)
        return out if tiled else out.squeeze(scatter_dim)

    return _logged("reduce_scatter", x, n, log_name, run)


def all_to_all(x, axis: AxisArg, *, split_dim: int, concat_dim: int, tiled: bool = True,
               log_name: Optional[str] = None):
    """Chunk ``i`` of ``split_dim`` goes to rank ``i``; the chunks received
    are concatenated along ``concat_dim`` in scope order (JAX
    ``lax.all_to_all``; untiled, ``split_dim`` is of the scope's size and
    goes, and the chunks stack on a new ``concat_dim``)."""
    g = _scope(axis)
    n = g.size()
    size = x.shape[split_dim]
    if (size % n) if tiled else (size != n):
        raise ValueError(f"all_to_all: dim {split_dim} of size {size} does not split over "
                         f"{n} ranks" + ("" if tiled else " (untiled: must equal it)"))

    def run():
        front = x.movedim(split_dim, 0)
        chunks = front.reshape(n, size // n, *front.shape[1:])
        pg = g.torch_group()
        if pg is None:
            got = chunks.clone()
        else:
            order = _order(g)
            send = chunks[order].contiguous()
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=pg)
            got = torch.empty_like(recv)
            got[order] = recv
        parts = [c.movedim(0, split_dim) for c in got]
        if tiled:
            return torch.cat(parts, concat_dim)
        return torch.stack([p.squeeze(split_dim) for p in parts], concat_dim)

    return _logged("all_to_all", x, n, log_name, run)


def ppermute(x, axis: AxisArg, perm, *, log_name: Optional[str] = None):
    """Point-to-point shift over the scope: ``perm`` is ``[(src, dst), ...]``
    in scope ranks; a rank that no pair sends to gets zeros (JAX
    ``lax.ppermute``).  Sends and receives go as one ``batch_isend_irecv``."""
    g = _scope(axis)
    n = g.size()

    def run():
        me = g.rank()
        members = g.members()
        out = torch.zeros_like(x)
        pg = g.torch_group()
        ops = []
        for src, dst in perm:
            if src == me and dst == me:
                out.copy_(x)
            elif src == me:
                ops.append(dist.P2POp(dist.isend, x.contiguous(), members[dst], group=pg))
            elif dst == me:
                ops.append(dist.P2POp(dist.irecv, out, members[src], group=pg))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    return _logged("ppermute", x, n, log_name, run)


def axis_index(axis: AxisArg) -> int:
    """This rank's index along ``axis`` (a ProcessGroup: linearised over its
    axes)."""
    return _scope(axis).axis_index()


def broadcast(x, axis: AxisArg, src: int = 0, *, log_name: Optional[str] = None):
    """Scope rank ``src``'s ``x`` on every rank of the scope; what other ranks
    hold (an inf, a NaN) never reaches the result."""
    g = _scope(axis)
    n = g.size()

    def run():
        out = x.clone()
        pg = g.torch_group()
        if pg is not None:
            dist.broadcast(out, src=g.members()[src], group=pg)
        return out

    return _logged("broadcast", x, n, log_name, run)


# --------------------------------------------------------------------------
# Host-level collectives over the whole topology
# --------------------------------------------------------------------------


_REDUCERS = {
    "sum": lambda v: v.sum(0),
    "avg": lambda v: v.mean(0),
    "mean": lambda v: v.mean(0),
    "max": lambda v: v.amax(0),
    "min": lambda v: v.amin(0),
    "prod": lambda v: v.prod(0),
}


def host_all_reduce(x, topo: Optional[MeshTopology] = None, op: str = "sum", *,
                    log_name: Optional[str] = None):
    """Reduction over the leading ("per-contributor") axis of every rank's
    contributions: each rank's ``x`` is gathered along axis 0, then reduced
    over it.  At one rank this is JAX's function exactly (a reduce over
    axis 0 of the one global array)."""
    if op not in _REDUCERS:
        raise ValueError(f"unsupported reduce op {op!r}; one of {sorted(_REDUCERS)}")
    x = torch.as_tensor(x)
    if x.dim() == 0:
        raise ValueError("host_all_reduce expects a leading contributor axis; got a scalar")
    topo = topo or get_topology()

    def run():
        g = _groups.get_world_group(topo)
        return _REDUCERS[op](_gather(x, g, True, 0) if topo.world_size > 1 else x)

    # logged as JAX's host op is: one all_reduce of the input's bytes, the
    # world's size
    return _logged("all_reduce", x, topo.world_size, log_name, run)


def host_broadcast(x, topo: Optional[MeshTopology] = None):
    """Rank 0's value on every rank (reference ``_broadcast_model``)."""
    topo = topo or get_topology()
    x = torch.as_tensor(x)
    if topo.world_size == 1:
        return x
    return broadcast(x, _groups.get_world_group(topo), src=0)


def log_summary(show_straggler=False):
    """Reference ``dist.log_summary``."""
    return get_comms_logger().log_summary(show_straggler=show_straggler)


def monitor_events(step: int = 0):
    """Comms-logger summary as monitor ``(tag, value, step)`` events, for the
    telemetry collector's event stream (empty when nothing was profiled)."""
    return get_comms_logger().as_events(step)


def configure(comms_config=None):
    if comms_config is not None:
        get_comms_logger().configure(comms_config)
