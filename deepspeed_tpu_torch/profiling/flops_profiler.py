"""FLOPs profiler.

Counterpart of ``deepspeed_tpu/profiling/flops_profiler.py``.  The JAX
profiler reads XLA's cost analysis of a compiled function; here a function
runs once inside :class:`count_ops`, which counts:

- **FLOPs** with ``torch.utils.flop_counter.FlopCounterMode``: every aten
  product (``mm``, ``bmm``, ``addmm``, convolutions, SDPA), forward and
  backward.  The hand kernels run through ``ctypes``, out of the
  dispatcher's sight, so each kernel wrapper adds what its plain version
  would add (``ops.count_kernel``: the plain version replayed on meta
  tensors).  A step therefore counts the same FLOPs on the CPU, where the
  plain versions run, and on the card.  XLA counts elementwise ops too;
  this count holds products only.
- **bytes_accessed**: the bytes of every executed aten op's tensor operands
  and results (views and allocations move nothing and are left out), plus
  each hand kernel's own reads and writes.  It is unfused, so an upper bound
  of the traffic where XLA's count is after fusion.

The engine's telemetry counts ``flops_per_step`` with the same
:class:`count_ops`.  ``per_module_profile`` and ``format_module_table`` are
shape and name arithmetic, identical to JAX's.
"""

import dataclasses
import logging
import re
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..runtime.checkpointing import flatten_with_paths
from ..runtime.tree import tree_leaves

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ProfileResult:
    flops: float  # per invocation
    bytes_accessed: float
    params: int
    flops_per_param: float

    def human(self) -> str:
        return (f"flops/step={_num(self.flops)}  hbm bytes/step={_num(self.bytes_accessed)}  "
                f"params={_num(self.params)}")


def _num(x: float) -> str:
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(x) < 1000:
            return f"{x:.2f}{unit}"
        x /= 1000
    return f"{x:.2f}E"


_NO_TRAFFIC = ("aten::empty", "aten::empty_like", "aten::empty_strided", "aten::lift_fresh")


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of each executed op's tensor operands and results;
    ``ops.count_kernel`` adds the hand kernels' own.  Ops on meta tensors
    (the kernels' FLOP replays) move nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def add_kernel_bytes(self, nbytes: int) -> None:
        self.bytes += int(nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func._schema.name not in _NO_TRAFFIC:
            tensors = [t for t in tree_flatten((args, kwargs, out))[0]
                       if isinstance(t, torch.Tensor)]
            if not any(t.device.type == "meta" for t in tensors):
                self.bytes += sum(t.numel() * t.element_size() for t in tensors)
        return out


class count_ops:
    """``with count_ops() as count: ...`` then ``count.flops`` and
    ``count.bytes_accessed`` of everything that ran inside, on any device."""

    def __enter__(self):
        self._flops = FlopCounterMode(display=False)
        self._bytes = _BytesMode()
        self._flops.__enter__()
        self._bytes.__enter__()
        return self

    def __exit__(self, *exc):
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        return False

    @property
    def flops(self) -> int:
        return self._flops.get_total_flops()

    @property
    def bytes_accessed(self) -> int:
        return self._bytes.bytes


def _numel(tree) -> int:
    return sum(int(t.numel()) for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def profile_fn(fn: Callable, *example_args, static_argnums=()) -> ProfileResult:
    """Run ``fn(*example_args)`` once and count it (JAX compiles it and reads
    the cost analysis).  ``static_argnums`` is accepted for JAX's signature:
    nothing is traced here."""
    with count_ops() as count:
        fn(*example_args)
    params = _numel(example_args)
    return ProfileResult(flops=float(count.flops), bytes_accessed=float(count.bytes_accessed),
                         params=params, flops_per_param=count.flops / max(params, 1))


def get_model_profile(loss_fn: Callable, params: Any, batch: Any, rng=None,
                      print_profile: bool = True) -> ProfileResult:
    """Profile one ``loss_fn(params, batch, rng)`` forward (JAX
    ``get_model_profile``); ``rng`` defaults to a generator seeded 0 on the
    params' device."""
    if rng is None:
        rng = torch.Generator(device=tree_leaves(params)[0].device).manual_seed(0)
    with torch.no_grad():
        res = profile_fn(loss_fn, params, batch, rng)
    n_params = _numel(params)
    res = ProfileResult(flops=res.flops, bytes_accessed=res.bytes_accessed, params=n_params,
                        flops_per_param=res.flops / max(n_params, 1))
    if print_profile:
        logger.info(f"flops profile: {res.human()}")
    return res


def per_module_profile(params: Any, tokens: int, top_k: int = 0):
    """Per-module parameter and FLOP attribution (JAX ``per_module_profile``,
    the reference's per-module MACs table): the unit is the param leaf, keyed
    by its dotted path.  Norm, bias and scale leaves are elementwise (one
    multiply-add an element and token, every stacked layer), ``embed``-like
    tables lookups (a copy of a row a token, plus the logits product when no
    unembedding leaf exists: tied embeddings), every other leaf of two or
    more dims a product applied once a token (2 tokens nelem).  Returns rows
    ``{'module', 'params', 'flops', 'flops_pct'}`` by FLOPs, all or
    ``top_k``."""
    flat = list(flatten_with_paths(params))
    elementwise_pat = re.compile(r"(?:^|[._])(?:\w*norm\w*|bias|b|scale|ln\w*|g)(?:$|[._])")
    pos_pat = re.compile(r"(?:^|[._])(?:pos\w*|wpe)(?:$|[._])")
    lookup_pat = re.compile(r"(?:^|[._])(?:embed\w*|wte|wpe|pos\w*|tok\w*)(?:$|[._])")
    head_pat = re.compile(r"(?:^|[._])(?:lm_head|unembed|output\w*)(?:$|[._])")

    all_keys = [".".join(str(p) for p in path) for path, _ in flat]
    tied_unembed = not any(head_pat.search(k) for k in all_keys)

    rows = []
    for (_, leaf), key in zip(flat, all_keys):
        n = int(leaf.numel())
        if elementwise_pat.search(key) or leaf.dim() < 2:
            flops = float(tokens * max(n, 1))
        elif lookup_pat.search(key):
            flops = float(tokens * int(leaf.shape[-1]))  # the gather's copy
            if tied_unembed and not pos_pat.search(key):
                flops += 2.0 * tokens * n  # the tied logits product
        else:
            flops = 2.0 * tokens * n
        rows.append({"module": key, "params": n, "flops": flops})
    total = sum(r["flops"] for r in rows) or 1.0
    for r in rows:
        r["flops_pct"] = 100.0 * r["flops"] / total
    rows.sort(key=lambda r: r["flops"], reverse=True)
    return rows[:top_k] if top_k else rows


def format_module_table(rows, top_k: int = 10) -> str:
    lines = [f"{'module':<48} {'params':>10} {'flops':>10} {'%':>6}"]
    for r in rows[:top_k]:
        lines.append(f"{r['module']:<48} {_num(r['params']):>10} "
                     f"{_num(r['flops']):>10} {r['flops_pct']:>5.1f}%")
    shown = sum(r['flops_pct'] for r in rows[:top_k])
    if len(rows) > top_k:
        lines.append(f"... {len(rows) - top_k} more modules ({100 - shown:.1f}% of flops)")
    return "\n".join(lines)


class FlopsProfiler:
    """Engine-attached profiler (JAX ``FlopsProfiler``)."""

    def __init__(self, engine=None):
        self.engine = engine
        self._result: Optional[ProfileResult] = None

    def profile_train_step(self, batch) -> ProfileResult:
        """Count one train step's work without taking it: the forward and
        backward of every micro-batch and the grad norm, as the step runs
        them.  The optimizer update (elementwise, no products; the fused
        kernels' bytes) is not run, so the engine's state does not move, as
        JAX's profile lowers the step without running it."""
        from ..runtime.optimizers import global_grad_norm
        eng = self.engine
        with count_ops() as count:
            grads, _ = eng.accumulate_gradients(batch)
            global_grad_norm(grads)
        del grads
        n_params = _numel(eng._master_params())
        self._result = ProfileResult(flops=float(count.flops),
                                     bytes_accessed=float(count.bytes_accessed),
                                     params=n_params,
                                     flops_per_param=count.flops / max(n_params, 1))
        return self._result

    def print_model_profile(self, tokens: Optional[int] = None, top_k: int = 10) -> str:
        """Whole-step totals and the per-module table; logs them and returns
        the text."""
        text = []
        if self._result is not None:
            text.append(f"train-step profile: {self._result.human()}")
        if self.engine is not None and tokens is not None:
            rows = per_module_profile(self.engine._master_params(), tokens)
            text.append(format_module_table(rows, top_k=top_k))
        out = "\n".join(text)
        logger.info(out)
        return out
