"""Optimizers: Adam/AdamW in delta form, the fused AdamW step, AdamW with
8-bit moments, Lion, SGD, Adagrad and LAMB; fp16 loss scaling.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py`` for adam, adamw,
fused_adam, fused_adam8bit, lion, sgd, adagrad and lamb; the 1-bit family
waits for multi-GPU training (ROADMAP item 11).  Interface as in JAX: ``opt =
get_optimizer(name, **hyper)``; ``state = opt.init(params)``; ``updates, state
= opt.update(grads, state, params, lr)`` with ``updates`` deltas for the
master params, or, where ``opt.step_fn`` is set, ``params, state =
opt.step_fn(grads, state, params, lr)``, which updates params and state IN
PLACE through the fused AdamW kernel (``ops/adam/fused_adam.py``) or the
AdamW-8bit kernel (``ops/adam/adam8bit.py``), one launch per leaf as in JAX.
Trees are nested dicts of tensors.  Scalars (bias corrections, 1 - beta) are
float32 as the JAX code computes them.

The loss-scale state (``LossScaleState``) lives on the host as Python
numbers: the engine reads each fp16 step's overflow flag once, so the
update is host arithmetic, in float32 where JAX's is.
"""

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.adam.adam8bit import (GROUP, fused_adamw8bit_flat,
                                 fused_adamw8bit_flat_reference, init_quantized_moment)
from ..ops.adam.fused_adam import fused_adamw_flat
from .tree import tree_leaves, tree_map

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (updates, new_state)
    name: str = "optimizer"
    # fused whole step: (grads, state, params, lr) -> (params, state), in place
    step_fn: Optional[Callable] = None


class AdamState(NamedTuple):
    step: int
    exp_avg: Any  # m
    exp_avg_sq: Any  # v


def _bias_corrections(b1, b2, step, bias_correction):
    if not bias_correction:
        return f32(1.0), f32(1.0)
    stepf = f32(step)
    return f32(1.0) - np.power(f32(b1), stepf), f32(1.0) - np.power(f32(b2), stepf)


def adam(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, adam_w_mode=True,
         bias_correction=True) -> Optimizer:
    """FusedAdam semantics: ``adam_w_mode`` decouples the weight decay
    (AdamW); otherwise it is added to the grad (L2)."""
    b1, b2 = betas

    def init(params):
        return AdamState(step=0, exp_avg=tree_map(torch.zeros_like, params),
                         exp_avg_sq=tree_map(torch.zeros_like, params))

    def update(grads, state, params, lr):
        step = state.step + 1
        bc1, bc2 = (float(x) for x in _bias_corrections(b1, b2, step, bias_correction))
        lr = float(f32(lr))
        # Python constants the JAX code folds in double precision, then rounds
        c1, c2 = float(f32(1.0 - b1)), float(f32(1.0 - b2))
        fb1, fb2, feps, fwd = (float(f32(x)) for x in (b1, b2, eps, weight_decay))

        def leaf(g, m, v, p):
            if not adam_w_mode and weight_decay != 0.0:
                g = g + fwd * p
            m_new = fb1 * m + c1 * g
            v_new = fb2 * v + c2 * (g * g)
            denom = torch.sqrt(v_new / bc2) + feps
            upd = -lr * (m_new / bc1) / denom
            if adam_w_mode and weight_decay != 0.0:
                upd = upd - float(f32(lr) * f32(weight_decay)) * p
            return upd, m_new, v_new

        out = tree_map(leaf, grads, state.exp_avg, state.exp_avg_sq, params)
        updates, m, v = (tree_map(lambda t, i=i: t[i], out) for i in range(3))
        return updates, AdamState(step=step, exp_avg=m, exp_avg_sq=v)

    return Optimizer(init=init, update=update, name="adamw" if adam_w_mode else "adam")


def fused_adam(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, adam_w_mode=True,
               bias_correction=True) -> Optimizer:
    """FusedAdam backed by the fused AdamW kernel: ``step_fn`` updates each
    leaf's flat p/m/v in place, one kernel launch per leaf.  The kernel
    hard-codes decoupled decay and bias correction; other modes keep only the
    delta-form ``update``."""
    base = adam(betas=betas, eps=eps, weight_decay=weight_decay, adam_w_mode=adam_w_mode,
                bias_correction=bias_correction)
    b1, b2 = betas

    def step_fn(grads, state, params, lr):
        step = state.step + 1
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.exp_avg),
                              tree_leaves(state.exp_avg_sq), tree_leaves(params)):
            fused_adamw_flat(p.view(-1), m.view(-1), v.view(-1), g.reshape(-1), lr=lr,
                             beta1=b1, beta2=b2, eps=eps, weight_decay=weight_decay, step=step)
        return params, AdamState(step=step, exp_avg=state.exp_avg, exp_avg_sq=state.exp_avg_sq)

    return Optimizer(init=base.init, update=base.update, name="fused_adam",
                     step_fn=step_fn if (adam_w_mode and bias_correction) else None)


class Adam8bitState(NamedTuple):
    step: int
    exp_avg: Any  # int8 [groups, group_size] per leaf
    exp_avg_sq: Any  # int8 codes of sqrt(v), [groups, group_size] per leaf
    scale_m: Any  # fp32 [groups, 1] per leaf
    scale_v: Any  # fp32 [groups, 1] per leaf


def fused_adam8bit(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, group_size: int = GROUP,
                   bias_correction: bool = True) -> Optimizer:
    """AdamW with blockwise int8 moments (``ops/adam/adam8bit.py``): the
    optimizer state shrinks from 8 to about 2.01 bytes a param.  ``step_fn``
    updates each leaf's p, codes and scales in place, one kernel launch per
    leaf; ``update`` is the delta form over the plain version (JAX: over its
    XLA fallback).  Decoupled decay and bias correction only, as the kernel."""
    if not bias_correction:
        raise ValueError("fused_adam8bit implements AdamW with bias correction; "
                         "set bias_correction true or use adamw/fused_adam")
    if group_size != GROUP:
        raise NotImplementedError(f"fused_adam8bit: the kernel's group is {GROUP} elements, "
                                  f"got group_size={group_size}")
    b1, b2 = betas

    def init(params):
        def moment(i):
            return tree_map(lambda p: init_quantized_moment(p.numel(), group_size, p.device)[i],
                            params)

        return Adam8bitState(step=0, exp_avg=moment(0), exp_avg_sq=moment(0), scale_m=moment(1),
                             scale_v=moment(1))

    def apply(step_leaf, grads, state, params, lr):
        step = state.step + 1
        for g, m8, v8, sm, sv, p in zip(tree_leaves(grads), *map(tree_leaves, state[1:]),
                                        tree_leaves(params)):
            step_leaf(p.view(-1), m8, v8, sm, sv, g.reshape(-1), lr=lr, beta1=b1, beta2=b2,
                      eps=eps, weight_decay=weight_decay, step=step)
        return params, state._replace(step=step)

    def update(grads, state, params, lr):
        copies = Adam8bitState(state.step, *(tree_map(torch.clone, t) for t in state[1:]))
        new_params, new_state = apply(fused_adamw8bit_flat_reference, grads, copies,
                                      tree_map(lambda p: p.detach().clone(), params), lr)
        return tree_map(torch.sub, new_params, params), new_state

    return Optimizer(init=init, update=update, name="fused_adam8bit",
                     step_fn=functools.partial(apply, fused_adamw8bit_flat))


class LionState(NamedTuple):
    exp_avg: Any  # m


def lion(betas=(0.9, 0.99), weight_decay=0.0) -> Optimizer:
    """FusedLion semantics: the update is the sign of an interpolation of the
    momentum and the grad, with decoupled weight decay.  Delta form only, as
    in JAX (``optimizers.py:226-247``): it has no ``step_fn``, so the engine
    never takes the fused Lion kernel; that kernel is the public
    ``ops.adam.fused_lion_flat``."""
    b1, b2 = betas
    # Python constants the JAX code folds in double precision, then rounds
    fb1, fb2 = float(f32(b1)), float(f32(b2))
    c1, c2 = float(f32(1.0 - b1)), float(f32(1.0 - b2))

    def init(params):
        return LionState(exp_avg=tree_map(torch.zeros_like, params))

    def update(grads, state, params, lr):
        lr32 = float(f32(lr))
        decay = float(f32(lr) * f32(weight_decay))

        def leaf(g, m, p):
            upd = -lr32 * torch.sign(fb1 * m + c1 * g)
            if weight_decay != 0.0:
                upd = upd - decay * p
            return upd, fb2 * m + c2 * g

        out = tree_map(leaf, grads, state.exp_avg, params)
        updates, m = (tree_map(lambda t, i=i: t[i], out) for i in range(2))
        return updates, LionState(exp_avg=m)

    return Optimizer(init=init, update=update, name="lion")


class SGDState(NamedTuple):
    momentum_buf: Any


def sgd(momentum=0.0, weight_decay=0.0, nesterov=False) -> Optimizer:
    """SGD with L2 weight decay, momentum and Nesterov momentum, in delta
    form (``optimizers.py:201-219``)."""
    fm, fwd = float(f32(momentum)), float(f32(weight_decay))

    def init(params):
        return SGDState(momentum_buf=tree_map(torch.zeros_like, params))

    def update(grads, state, params, lr):
        lr32 = float(f32(lr))

        def leaf(g, buf, p):
            if weight_decay != 0.0:
                g = g + fwd * p
            buf_new = fm * buf + g
            d = (g + fm * buf_new) if nesterov else (buf_new if momentum != 0.0 else g)
            return -lr32 * d, buf_new

        out = tree_map(leaf, grads, state.momentum_buf, params)
        updates, buf = (tree_map(lambda t, i=i: t[i], out) for i in range(2))
        return updates, SGDState(momentum_buf=buf)

    return Optimizer(init=init, update=update, name="sgd")


class AdagradState(NamedTuple):
    accum: Any


def adagrad(eps=1e-10, weight_decay=0.0) -> Optimizer:
    """Adagrad with L2 weight decay, in delta form (``optimizers.py:254-272``,
    DeepSpeedCPUAdagrad semantics)."""
    feps, fwd = float(f32(eps)), float(f32(weight_decay))

    def init(params):
        return AdagradState(accum=tree_map(torch.zeros_like, params))

    def update(grads, state, params, lr):
        lr32 = float(f32(lr))

        def leaf(g, acc, p):
            if weight_decay != 0.0:
                g = g + fwd * p
            acc_new = acc + g * g
            return (-lr32 * g) / (torch.sqrt(acc_new) + feps), acc_new

        out = tree_map(leaf, grads, state.accum, params)
        updates, acc = (tree_map(lambda t, i=i: t[i], out) for i in range(2))
        return updates, AdagradState(accum=acc)

    return Optimizer(init=init, update=update, name="adagrad")


class LambState(NamedTuple):
    step: int
    exp_avg: Any
    exp_avg_sq: Any


def lamb(betas=(0.9, 0.999), eps=1e-6, weight_decay=0.0, max_coeff=10.0,
         min_coeff=0.01) -> Optimizer:
    """FusedLamb semantics in delta form (``optimizers.py:281-307``): the
    Adam direction without bias correction, rescaled per leaf by the trust
    ratio ||p|| / ||update|| clamped to [min_coeff, max_coeff] (1 where
    either norm is 0)."""
    b1, b2 = betas
    fb1, fb2, feps, fwd = (float(f32(x)) for x in (b1, b2, eps, weight_decay))
    c1, c2 = float(f32(1.0 - b1)), float(f32(1.0 - b2))

    def init(params):
        return LambState(step=0, exp_avg=tree_map(torch.zeros_like, params),
                         exp_avg_sq=tree_map(torch.zeros_like, params))

    def update(grads, state, params, lr):
        lr32 = float(f32(lr))

        def leaf(g, m, v, p):
            m_new = fb1 * m + c1 * g
            v_new = fb2 * v + c2 * (g * g)
            u = m_new / (torch.sqrt(v_new) + feps)
            if weight_decay != 0.0:
                u = u + fwd * p
            p_norm = torch.linalg.vector_norm(p.float())
            u_norm = torch.linalg.vector_norm(u.float())
            trust = torch.where((p_norm > 0) & (u_norm > 0),
                                torch.clamp(p_norm / u_norm, min_coeff, max_coeff),
                                torch.ones_like(p_norm))
            return (-lr32 * trust) * u, m_new, v_new

        out = tree_map(leaf, grads, state.exp_avg, state.exp_avg_sq, params)
        updates, m, v = (tree_map(lambda t, i=i: t[i], out) for i in range(3))
        return updates, LambState(step=state.step + 1, exp_avg=m, exp_avg_sq=v)

    return Optimizer(init=init, update=update, name="lamb")


_OPTIMIZERS = {
    "adam": lambda **kw: adam(adam_w_mode=False, **kw),
    "adamw": lambda **kw: adam(adam_w_mode=True, **kw),
    "fusedadam": fused_adam,
    "fused_adam": fused_adam,
    "fusedadam8bit": fused_adam8bit,
    "fused_adam8bit": fused_adam8bit,
    "adam8bit": fused_adam8bit,
    "lion": lion,
    "fusedlion": lion,
    "sgd": sgd,
    "adagrad": adagrad,
    "lamb": lamb,
    "fusedlamb": lamb,
}
# the JAX package's 1-bit optimizers: comm-coupled, they wait for multi-GPU
# training (ROADMAP item 11)
_UNPORTED = ("onebitadam", "onebit_adam", "onebitlamb", "onebit_lamb", "zerooneadam",
             "zero_one_adam")
# torch-style kwargs that do not map (dropped, as the JAX package drops them)
_DROPPED = {"lr", "torch_adam", "fused", "cuda_aware", "adam_w_mode", "comm_backend_name",
            "check_overflow", "pipeline_enabled"}


def get_optimizer(name: str, **params) -> Optimizer:
    key = name.lower()
    if key in _UNPORTED:
        raise NotImplementedError(f"optimizer {name!r} is not ported to PyTorch yet: the 1-bit "
                                  f"optimizers come with multi-GPU training (ROADMAP item 11); "
                                  f"ported: {sorted(_OPTIMIZERS)}")
    if key not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; supported: {sorted(_OPTIMIZERS)}")
    kw = {k: v for k, v in params.items() if k not in _DROPPED}
    if "betas" in kw:
        kw["betas"] = tuple(kw["betas"])
    return _OPTIMIZERS[key](**kw)


def adam_state_from_jax(state_np, device, dtype=torch.float32) -> AdamState:
    """A JAX ``AdamState`` (``step``, ``exp_avg``, ``exp_avg_sq``; leaves as numpy
    arrays or anything ``np.array`` takes) -> this package's, on ``device``."""
    to = lambda x: torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)
    return AdamState(step=int(np.asarray(state_np.step)),
                     exp_avg=tree_map(to, state_np.exp_avg),
                     exp_avg_sq=tree_map(to, state_np.exp_avg_sq))


def adam8bit_state_from_jax(state_np, device) -> Adam8bitState:
    """A JAX ``Adam8bitState`` (``step``, int8 ``exp_avg``/``exp_avg_sq``, fp32
    ``scale_m``/``scale_v``; leaves as numpy arrays or anything ``np.array``
    takes) -> this package's, on ``device``."""
    to = lambda dtype: lambda x: torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)
    return Adam8bitState(step=int(np.asarray(state_np.step)),
                         exp_avg=tree_map(to(torch.int8), state_np.exp_avg),
                         exp_avg_sq=tree_map(to(torch.int8), state_np.exp_avg_sq),
                         scale_m=tree_map(to(torch.float32), state_np.scale_m),
                         scale_v=tree_map(to(torch.float32), state_np.scale_v))


def lion_state_from_jax(state_np, device, dtype=torch.float32) -> LionState:
    """A JAX ``LionState`` (``exp_avg``; leaves as numpy arrays or anything
    ``np.array`` takes) -> this package's, on ``device``."""
    to = lambda x: torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)
    return LionState(exp_avg=tree_map(to, state_np.exp_avg))


def sgd_state_from_jax(state_np, device, dtype=torch.float32) -> SGDState:
    """A JAX ``SGDState`` (``momentum_buf``) -> this package's, on ``device``."""
    to = lambda x: torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)
    return SGDState(momentum_buf=tree_map(to, state_np.momentum_buf))


def adagrad_state_from_jax(state_np, device, dtype=torch.float32) -> AdagradState:
    """A JAX ``AdagradState`` (``accum``) -> this package's, on ``device``."""
    to = lambda x: torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)
    return AdagradState(accum=tree_map(to, state_np.accum))


def lamb_state_from_jax(state_np, device, dtype=torch.float32) -> LambState:
    """A JAX ``LambState`` (``step``, ``exp_avg``, ``exp_avg_sq``) -> this
    package's, on ``device``."""
    to = lambda x: torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)
    return LambState(step=int(np.asarray(state_np.step)), exp_avg=tree_map(to, state_np.exp_avg),
                     exp_avg_sq=tree_map(to, state_np.exp_avg_sq))


# ---------------------------------------------------------------------------
# fp16 loss scaling (optimizers.py:371-426; reference runtime/fp16/loss_scaler.py)
# ---------------------------------------------------------------------------
class LossScaleState(NamedTuple):
    cur_scale: float  # a float32 value
    growth_counter: int  # consecutive non-overflow steps
    hysteresis: int


def _is_static(fp16_cfg) -> bool:
    return bool(fp16_cfg.loss_scale and fp16_cfg.loss_scale > 0)


def init_loss_scale(fp16_cfg) -> LossScaleState:
    """A static ``loss_scale > 0``, else ``2**initial_scale_power``."""
    scale = fp16_cfg.loss_scale if _is_static(fp16_cfg) else 2.0**fp16_cfg.initial_scale_power
    return LossScaleState(cur_scale=float(f32(scale)), growth_counter=0,
                          hysteresis=int(fp16_cfg.hysteresis))


def update_loss_scale(state: LossScaleState, overflow: bool, fp16_cfg) -> LossScaleState:
    """DynamicLossScaler.update_scale as JAX computes it: on overflow,
    count the hysteresis down and halve the scale (not below
    ``max(min_loss_scale, 1)``) when it reaches 0, resetting it; on a clean
    step, double the scale after ``loss_scale_window`` clean steps in a row,
    and restore the hysteresis unless ``consecutive_hysteresis``.  A static
    scale never changes."""
    if _is_static(fp16_cfg):
        return state
    if overflow:
        hyst = state.hysteresis - 1
        if hyst > 0:
            return LossScaleState(cur_scale=state.cur_scale, growth_counter=0, hysteresis=hyst)
        min_scale = f32(max(fp16_cfg.min_loss_scale, 1.0))
        return LossScaleState(cur_scale=float(max(f32(state.cur_scale) / f32(2.0), min_scale)),
                              growth_counter=0, hysteresis=int(fp16_cfg.hysteresis))
    counter = state.growth_counter + 1
    grow = counter >= fp16_cfg.loss_scale_window
    with np.errstate(over="ignore"):  # float32 overflows to inf, as in JAX
        scale = float(f32(state.cur_scale) * f32(2.0)) if grow else state.cur_scale
    return LossScaleState(cur_scale=scale, growth_counter=0 if grow else counter,
                          hysteresis=(state.hysteresis if fp16_cfg.consecutive_hysteresis
                                      else int(fp16_cfg.hysteresis)))


def has_overflow(grads) -> torch.Tensor:
    """A 0-d bool on the grads' device: some leaf holds an inf or a NaN."""
    return torch.stack([~torch.isfinite(g).all() for g in tree_leaves(grads)]).any()


def loss_scale_from_jax(state_np) -> LossScaleState:
    """A JAX ``LossScaleState`` (0-d ``cur_scale``, ``growth_counter``,
    ``hysteresis``) -> this package's host numbers."""
    return LossScaleState(cur_scale=float(np.asarray(state_np.cur_scale)),
                          growth_counter=int(np.asarray(state_np.growth_counter)),
                          hysteresis=int(np.asarray(state_np.hysteresis)))


def global_grad_norm(grads) -> torch.Tensor:
    """fp32 L2 norm over every leaf of the gradient tree."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))


def clip_by_global_norm(grads, max_norm: float, precomputed_norm=None):
    """Scale every leaf IN PLACE by min(1, max_norm / (norm + 1e-6)); returns
    (grads, norm).  The engine owns its fp32 grad sums, so no copy is made."""
    norm = precomputed_norm if precomputed_norm is not None else global_grad_norm(grads)
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(coef)
    return grads, norm
