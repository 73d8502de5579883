"""Activation checkpointing (rematerialisation) with named policies.

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing.py``.  A
policy is named by a string, as a model config carries it
(``LlamaConfig.remat_policy``); :func:`resolve_policy` accepts exactly the
names the JAX package accepts and raises the same ``ValueError`` for any
other.  The names map onto ``torch.utils.checkpoint`` (non-reentrant) with
selective checkpointing, whose policy sees every aten op the wrapped
function runs:

  nothing_saveable, None           full recompute: plain checkpointing, which
                                   stops the recompute at the last activation
                                   the backward needs
  dots_with_no_batch_dims_saveable the outputs of ``aten.mm``/``aten.addmm``
  (checkpoint_dots_with_no_batch_dims)  (the ``x @ W`` projections) are kept,
                                   everything else is recomputed
  dots_saveable (checkpoint_dots)  also ``aten.bmm`` outputs
  everything_saveable              no remat wrapper at all
  save_anything_except_these_names everything but the two planted residuals
  offload_dot, offload_residuals,  refused (``NotImplementedError``): see
  cpu_checkpointing                below

Allocations (``aten.empty`` and its kin) are recomputed under every policy:
the flash and block-sparse kernels are called through ``ctypes`` inside
autograd Functions and write into such buffers, so a saved one would be a
buffer the recompute's kernel writes over.  Those kernels are invisible to
the policy and rerun under every policy but ``everything_saveable``, as a
``pallas_call`` is no dot to JAX's policies.

Residual names are planted by :func:`checkpoint_name` in the model layers
(Llama tags its two residual adds ``attn_resid`` / ``mlp_resid``).  It is
the identity unless a naming policy is active, when it becomes the
``dstpu::checkpoint_name`` op (a copy the policy can recognise by name).

Host offload.  :func:`offload_checkpoint` is the JAX package's working
``cpu_checkpointing``: an autograd Function whose forward parks the layer's
input in pinned host memory and whose backward fetches it back and
recomputes the layer.  The policy-based offloads (``offload_dot``,
``offload_residuals``) would have to move the tensors that selective
checkpointing keeps; it keeps them in its own cache, which
``torch.autograd.graph.saved_tensors_hooks`` around it never see (the hooks
see only the checkpoint's inputs), so those names raise
``NotImplementedError`` naming ROADMAP item 9e rather than recompute
silently.
"""

import functools
from typing import Iterable, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from .tree import tree_leaves

# Residual-stream names models plant; the naming policies target these.
RESIDUAL_NAMES = ("attn_resid", "mlp_resid")

# the names jax.checkpoint_policies holds as policies (not factories)
_DIRECT = ("everything_saveable", "nothing_saveable", "dots_saveable",
           "dots_with_no_batch_dims_saveable", "checkpoint_dots",
           "checkpoint_dots_with_no_batch_dims")
_OFFLOAD = ("offload_dot", "offload_residuals", "cpu_checkpointing")

_aten = torch.ops.aten
_MM = (_aten.mm.default, _aten.addmm.default)
_BMM = (_aten.bmm.default, _aten.baddbmm.default)
_ALLOCATIONS = (_aten.empty.memory_format, _aten.empty_like.default,
                _aten.empty_strided.default, _aten.new_empty.default,
                _aten.new_empty_strided.default)


@torch.library.custom_op("dstpu::checkpoint_name", mutates_args=())
def _named(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_named.register_fake
def _(x, name):
    return torch.empty_like(x)


_named.register_autograd(lambda ctx, grad: (grad, None))

# whether a naming policy's function is running (forward or its recompute)
_NAMING = {"active": 0}


def checkpoint_name(x, name: str):
    """``x`` tagged ``name`` for a naming policy; ``x`` itself otherwise."""
    if not _NAMING["active"]:
        return x
    return torch.ops.dstpu.checkpoint_name(x, name)


class Policy:
    """A resolved remat policy: ``save`` decides per aten op whether its
    output is kept for the backward; ``naming`` asks for the planted names;
    ``remat`` False is ``everything_saveable`` (no wrapper)."""

    def __init__(self, name: str, save, naming: bool = False, remat: bool = True):
        self.name, self.save, self.naming, self.remat = name, save, naming, remat

    def __repr__(self):
        return f"Policy({self.name!r})"


def _save_dots(op, args):
    return op in _MM


def _save_all_dots(op, args):
    return op in _MM or op in _BMM


def _except_names(names):
    names = tuple(names)

    def save(op, args):
        if op is torch.ops.dstpu.checkpoint_name.default:
            return args[1] not in names
        return op not in _ALLOCATIONS

    return save


def resolve_policy(name: Optional[str], offload_names: Iterable[str] = RESIDUAL_NAMES):
    """A config policy name -> :class:`Policy`, or None for full recompute
    (None/"" and ``nothing_saveable``, as ``jax.checkpoint``'s default)."""
    if name in (None, "", "nothing_saveable"):
        return None
    if name in _OFFLOAD:
        raise NotImplementedError(
            f"remat policy {name!r}: the tensors it names would have to leave the device, and "
            f"selective checkpointing keeps them where saved_tensors_hooks cannot reach "
            f"(ROADMAP item 9e); use remat_policy='offload_inputs' (offload_checkpoint, the "
            f"layer's input parked on the host) instead")
    if name == "save_anything_except_these_names":
        return Policy(name, _except_names(offload_names), naming=True)
    if name == "everything_saveable":
        return Policy(name, None, remat=False)
    if name in ("dots_saveable", "checkpoint_dots"):
        return Policy(name, _save_all_dots)
    if name in ("dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims"):
        return Policy(name, _save_dots)
    raise ValueError(f"unknown remat policy {name!r}; known: {', '.join(_DIRECT)}, "
                     f"offload_dot, offload_residuals, save_anything_except_these_names")


def policy_from_config(cfg) -> Optional[Policy]:
    """ActivationCheckpointingConfig -> policy; ``cpu_checkpointing: true``
    selects the host-offload policy as in the JAX package."""
    if cfg.cpu_checkpointing:
        return resolve_policy("offload_residuals")
    return resolve_policy(cfg.policy)


def _context_fn(policy: Policy):
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    def decide(ctx, op, *args, **kwargs):
        if policy.save(op, args):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(decide)


def checkpoint(fn, policy_name: Optional[str] = "nothing_saveable"):
    """``fn`` recomputed in the backward under the named policy
    (non-reentrant, so nested params dicts and autograd Functions inside
    ``fn`` work); the math is unchanged."""
    policy = resolve_policy(policy_name)
    if policy is not None and not policy.remat:
        return fn
    kwargs = {}
    body = fn
    if policy is not None:
        kwargs["context_fn"] = functools.partial(_context_fn, policy)
        if policy.naming:
            # the names must be planted in the forward and in its recompute
            @functools.wraps(fn)
            def body(*args):
                _NAMING["active"] += 1
                try:
                    return fn(*args)
                finally:
                    _NAMING["active"] -= 1

    @functools.wraps(fn)
    def wrapped(*args):
        return torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False, **kwargs)

    return wrapped


def _guard_rest(rest):
    """Extra args get no gradient from :func:`offload_checkpoint`: a float
    extra (bf16 included) would train with a zero gradient, so it is refused;
    integer extras (positions) and numpy constants pass."""
    for leaf in rest:
        if isinstance(leaf, np.ndarray):
            continue
        if isinstance(leaf, torch.Tensor) and (leaf.is_floating_point() or leaf.is_complex()):
            raise TypeError("offload_checkpoint: extra args (*rest) receive no gradient; found "
                            "a float-dtype extra - pass differentiable values through `params` "
                            "instead")


class _Offloaded(torch.autograd.Function):
    """The forward runs the layer without a graph and parks its input on the
    host; the backward brings it back and recomputes the layer with one."""

    @staticmethod
    def forward(ctx, layer_fn, rebuild, rest, x, *leaves):
        with torch.no_grad():
            y = layer_fn(x, rebuild(leaves), *rest)
        if x.is_cuda:
            host = torch.empty(x.shape, dtype=x.dtype, device="cpu", pin_memory=True)
            host.copy_(x, non_blocking=True)
            ctx.parked = torch.cuda.Event()
            ctx.parked.record()
            offload_checkpoint.host_bytes += host.nbytes
            offload_checkpoint.peak_host_bytes = max(offload_checkpoint.peak_host_bytes,
                                                     offload_checkpoint.host_bytes)
        else:
            host, ctx.parked = x.detach(), None
        ctx.host, ctx.device = host, x.device
        ctx.layer_fn, ctx.rebuild, ctx.rest = layer_fn, rebuild, rest
        ctx.save_for_backward(*leaves)
        return y

    @staticmethod
    def backward(ctx, grad):
        leaves = [leaf.detach().requires_grad_(leaf.requires_grad) for leaf in ctx.saved_tensors]
        if ctx.parked is not None:
            torch.cuda.current_stream(ctx.device).wait_event(ctx.parked)
            x = ctx.host.to(ctx.device, non_blocking=True)
            offload_checkpoint.host_bytes -= ctx.host.nbytes
        else:
            x = ctx.host
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            y = ctx.layer_fn(x, ctx.rebuild(leaves), *ctx.rest)
        wants = [x] + [leaf for leaf in leaves if leaf.requires_grad]
        got = iter(torch.autograd.grad(y, wants, grad, allow_unused=True))
        dx = next(got)
        dleaves = [next(got) if leaf.requires_grad else None for leaf in leaves]
        ctx.host = None
        return (None, None, None, dx, *dleaves)


def _rebuilder(params):
    """(leaves of ``params``, a function that rebuilds the tree from them)."""
    def rebuild(tree, it):
        if isinstance(tree, dict):
            return {k: rebuild(v, it) for k, v in tree.items()}
        return next(it)

    return tree_leaves(params), lambda leaves: rebuild(params, iter(leaves))


def offload_checkpoint(layer_fn):
    """Host-offloaded activation checkpointing for a layer ``layer_fn(x,
    params, *rest) -> y`` (the port's layers return one tensor).

    The forward runs the layer without keeping its activations and copies
    its input ``x`` into pinned host memory (``non_blocking``, ordered by a
    CUDA event); the backward waits on that event, copies it back, and
    recomputes the layer under ``torch.enable_grad()`` to take its grads:
    the saved activations on the card fall to nothing a layer, at one copy
    each way of the input.  Params and the extras ``rest`` stay where they
    are.  Float extras are refused (:func:`_guard_rest`).  On the CPU the
    input is already in host memory and is kept as it is.

    ``offload_checkpoint.host_bytes`` counts the pinned bytes parked now
    (a forward adds, its backward takes away) and ``peak_host_bytes`` the
    most since it was last set to 0."""

    @functools.wraps(layer_fn)
    def wrapped(x, params, *rest):
        _guard_rest(rest)
        leaves, rebuild = _rebuilder(params)
        return _Offloaded.apply(layer_fn, rebuild, rest, x, *leaves)

    return wrapped


offload_checkpoint.host_bytes = 0
offload_checkpoint.peak_host_bytes = 0
