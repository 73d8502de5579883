"""Compression primitives: structured pruning masks, activation quantization,
layer reduction.

Counterpart of ``deepspeed_tpu/compression/basic_layer.py``: every method is
a pure function of tensors that runs wherever its inputs lie, composed over
a params tree by ``compress.init_compression``.  A pruning threshold is the
k-th largest score, and every score at or above it is kept, ties included,
as JAX's ``sort(...)[-k]`` and ``>=``.
"""

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..runtime.tree import tree_leaves, tree_map


def kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest element of ``x`` (flattened), JAX's
    ``jnp.sort(x.reshape(-1))[-k]``: a sort, which on the card is a radix
    sort over the whole leaf (``kthvalue`` selects in one thread block per
    slice)."""
    return torch.sort(x.reshape(-1)).values[-k]


# ------------------------------------------------------------ structured masks
def head_prune_mask(w: torch.Tensor, num_heads: int, density: float,
                    head_axis: str = "in") -> torch.Tensor:
    """Attention-head pruning mask: heads tile the ``in`` axis (dim 0, the
    output projection's rows) or the ``out`` axis (dim 1, the q/k/v case),
    ranked by L1 norm; the weakest are zeroed whole, keeping ``density`` of
    them.  Stacked ``[L, d, d]`` leaves prune each layer on its own."""
    if w.dim() == 3:
        return torch.stack([head_prune_mask(lw, num_heads, density, head_axis) for lw in w])
    if w.dim() != 2:
        raise ValueError("head pruning applies to 2D projections (or [L, d, d] stacks)")
    axis = 0 if head_axis == "in" else 1
    if w.shape[axis] % num_heads != 0:
        raise ValueError(f"axis {axis} size {w.shape[axis]} not divisible by {num_heads} heads")
    head_dim = w.shape[axis] // num_heads
    if axis == 0:
        per_head = w.abs().reshape(num_heads, head_dim, w.shape[1]).sum(dim=(1, 2))
    else:
        per_head = w.abs().reshape(w.shape[0], num_heads, head_dim).sum(dim=(0, 2))
    k = max(1, int(round(num_heads * density)))
    keep = (per_head >= kth_largest(per_head, k)).to(w.dtype)
    mask = keep.repeat_interleave(head_dim)
    mask = mask[:, None] if axis == 0 else mask[None, :]
    return mask.expand(w.shape)


def channel_prune_mask(w: torch.Tensor, density: float) -> torch.Tensor:
    """Structured channel (dim-0, input-feature) pruning by L1 norm."""
    norms = w.abs().sum(dim=tuple(range(1, w.dim())))
    k = max(1, int(round(norms.numel() * density)))
    keep = (norms >= kth_largest(norms, k)).to(w.dtype)
    return keep.reshape((-1, ) + (1, ) * (w.dim() - 1)).expand(w.shape)


# ------------------------------------------------------ activation quantization
def _capturing() -> bool:
    return torch.compiler.is_compiling() or (torch.cuda.is_available()
                                             and torch.cuda.is_current_stream_capturing())


class QuantAct:
    """Activation fake-quantizer (JAX ``QuantAct``).

    ``dynamic=True`` takes the range of each call's activation.  Static mode
    tracks a running max (momentum EMA) on the host: calibrate by calling it
    on eager tensors, then ``freeze()``; the frozen scale is a Python
    constant.  Calibrating under ``torch.compile`` or during CUDA-graph
    capture cannot update host state and raises ``RuntimeError``, as JAX's
    does under a tracer."""

    def __init__(self, bits: int = 8, dynamic: bool = True, momentum: float = 0.95):
        self.bits = bits
        self.dynamic = dynamic
        self.momentum = momentum
        self.running_max: Optional[float] = None
        self.frozen = False

    def freeze(self):
        self.frozen = True

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        qmax = 2.0**(self.bits - 1) - 1
        if self.dynamic:
            scale = x.abs().max().clamp_min(1e-8) / qmax
        else:
            if not self.frozen:
                if _capturing():
                    raise RuntimeError(
                        "QuantAct static calibration saw a traced array — run calibration "
                        "passes EAGERLY (outside torch.compile and CUDA-graph capture), then "
                        "freeze(); or use dynamic=True for in-graph ranges")
                cur = float(x.abs().max())
                self.running_max = (cur if self.running_max is None else
                                    self.momentum * self.running_max + (1 - self.momentum) * cur)
            scale = max(self.running_max or 1e-8, 1e-8) / qmax
        q = torch.clamp(torch.round(x / scale), -qmax, qmax)
        return (q * scale).to(x.dtype)


# ------------------------------------------------------------- layer reduction
def layer_reduction(stacked_params: Any, keep_layers: Sequence[int]) -> Any:
    """Depth reduction of layer-stacked params: the student keeps the
    teacher's layers ``keep_layers``.  A tree whose leaves do not share one
    leading dim is not a layer stack and is refused."""
    idx = np.asarray(keep_layers, np.int64)
    lead = {(int(leaf.shape[0]) if leaf.dim() >= 1 else 0)
            for leaf in tree_leaves(stacked_params)}
    if len(lead) != 1:
        raise ValueError(
            f"layer_reduction needs a homogeneous [L, ...] stack; got leading "
            f"dims {sorted(lead)} — select the stacked subtree explicitly")
    (num_layers, ) = lead
    if num_layers <= int(idx.max()):
        raise ValueError(f"keep_layers index {int(idx.max())} out of range for "
                         f"{num_layers} layers")
    return tree_map(lambda leaf: leaf[torch.as_tensor(idx, device=leaf.device)], stacked_params)


# --------------------------------------------------------- physical shrinking
def shrink_rows(w: torch.Tensor, mask_row_keep) -> torch.Tensor:
    """Row pruning made physical: the kept rows (last dim) sliced out."""
    if isinstance(mask_row_keep, torch.Tensor):
        mask_row_keep = mask_row_keep.cpu().numpy()
    keep = np.nonzero(np.asarray(mask_row_keep))[0]
    return w.index_select(w.dim() - 1, torch.as_tensor(keep, device=w.device))
