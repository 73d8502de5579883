"""Micro-batch gradient accumulation.

Counterpart of ``deepspeed_tpu/runtime/grad_accum.py``: the JAX ``lax.scan``
over micro-batches becomes a Python loop, ``jax.value_and_grad`` becomes
``torch.autograd.grad``.  Grads come back in the params' (compute) dtype and
are summed in fp32 into one flat fp32 buffer, each leaf's sum a view of it,
so that a data-parallel engine all-reduces the buffer in place.
"""

from typing import Any, Callable, Tuple

import torch

from .tree import tree_leaves, tree_map

_ALIGN = 4  # fp32 elements in 16 bytes


def accumulate_micro_grads(loss_fn: Callable, params16, batch, micro_rngs,
                           scale: float) -> Tuple[Any, torch.Tensor]:
    """Sum of the grads of ``loss * scale`` over micro-batches.

    ``batch`` leaves are [gas, ...]; ``params16`` leaves require grad.  Returns
    (summed fp32 grads, a tree like ``params16``; summed unscaled fp32 loss).
    ``scale`` is the fp16 loss scale (1.0 for bf16 and fp32).
    """
    _, grads, loss_sum = accumulate_micro_grads_flat(loss_fn, params16, batch, micro_rngs,
                                                     scale)
    return grads, loss_sum


def accumulate_micro_grads_flat(loss_fn: Callable, params16, batch, micro_rngs,
                                scale: float) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """:func:`accumulate_micro_grads`, with the flat fp32 buffer that holds
    the summed grads first: (flat, grads, loss_sum), each leaf of ``grads``
    a view of ``flat`` in the order of ``tree_leaves(params16)``, starting on
    a 16-byte boundary (zeros fill the gaps)."""
    leaves = tree_leaves(params16)
    gas = tree_leaves(batch)[0].shape[0]
    # each leaf starts on a 16-byte boundary, as the optimizer kernels take
    # it; the few padding elements stay zero
    starts = [0]
    for p in leaves:
        starts.append(starts[-1] + -(-p.numel() // _ALIGN) * _ALIGN)
    flat = torch.zeros(starts[-1], dtype=torch.float32, device=leaves[0].device)
    acc = [flat[start:start + p.numel()].view(p.shape) for start, p in zip(starts, leaves)]
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i in range(gas):
        micro_batch = tree_map(lambda x: x[i], batch)
        out = loss_fn(params16, micro_batch, micro_rngs[i])
        loss = (out[0] if isinstance(out, tuple) else out).float() * scale
        # a leaf the loss does not read (BERT's type_emb without token types)
        # gets a zero grad, as jax.value_and_grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        for a, g in zip(acc, grads):
            if i == 0:
                a.copy_(g)
            else:
                a.add_(g)
        loss_sum = loss_sum + loss.detach() / scale
    it = iter(acc)
    return flat, tree_map(lambda _: next(it), params16), loss_sum
