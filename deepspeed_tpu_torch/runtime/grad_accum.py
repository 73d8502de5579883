"""Micro-batch gradient accumulation.

Counterpart of ``deepspeed_tpu/runtime/grad_accum.py``: the JAX ``lax.scan``
over micro-batches becomes a Python loop, ``jax.value_and_grad`` becomes
``torch.autograd.grad``.  Grads come back in the params' (compute) dtype and
are summed in fp32, one fp32 buffer per leaf.
"""

from typing import Any, Callable, Tuple

import torch

from .tree import tree_leaves, tree_map


def accumulate_micro_grads(loss_fn: Callable, params16, batch, micro_rngs,
                           scale: float) -> Tuple[Any, torch.Tensor]:
    """Sum of the grads of ``loss * scale`` over micro-batches.

    ``batch`` leaves are [gas, ...]; ``params16`` leaves require grad.  Returns
    (summed fp32 grads, a tree like ``params16``; summed unscaled fp32 loss).
    ``scale`` is the fp16 loss scale (1.0 for bf16 and fp32).
    """
    leaves = tree_leaves(params16)
    gas = tree_leaves(batch)[0].shape[0]
    acc = None
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i in range(gas):
        micro_batch = tree_map(lambda x: x[i], batch)
        out = loss_fn(params16, micro_batch, micro_rngs[i])
        loss = (out[0] if isinstance(out, tuple) else out).float() * scale
        grads = torch.autograd.grad(loss, leaves)
        if acc is None:
            acc = [g.float() if g.dtype != torch.float32 else g.clone() for g in grads]
        else:
            for a, g in zip(acc, grads):
                a.add_(g)
        loss_sum = loss_sum + loss.detach() / scale
    it = iter(acc)
    return tree_map(lambda _: next(it), params16), loss_sum
