"""Weight-only quantization (WOQ) for the v1 inference engine.

Counterpart of ``deepspeed_tpu/inference/quantization.py``: matched weights of
two or more dimensions are stored PACKED (int8, or int4 two to a byte) with
one fp32 scale per group, and dequantized to the serving dtype when the
forward reaches them.  The JAX engine dequantizes the whole tree inside its
jitted forward and leaves it to XLA and the layer scan to keep one layer
dense at a time.  Eager PyTorch would make every weight dense at once, so
here a stacked packed leaf answers ``leaf[i]`` with layer i alone, built from
the groups that cover it (``models/llama.py::forward_with_cache`` asks layer
by layer), and ``leaf[ids]`` with the rows a tensor of indices names (the
embedding).  Groups are cut from the flattened leaf, so a group may straddle
two layers or rows; each element is ``code * scale`` in fp32 cast to the
dtype, as the whole-leaf dequantization computes it.
"""

import logging
import re
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.quantizer.quantize import (dequantize_int4, dequantize_int8, quantize_int4,
                                      quantize_int8, unpack_int4)
from ..runtime.tree import tree_leaves, tree_map

logger = logging.getLogger(__name__)


class WOQLeaf:
    """One packed weight: quantized ints ``q`` [G, g] (int4: [G, g // 2]) and
    scales ``s`` [G, 1] of the flattened weight of ``shape`` (``size``
    elements), dequantized to ``dtype``."""

    def __init__(self, q, s, bits: int, size: int, shape: Tuple[int, ...],
                 dtype=torch.float32):
        self.q = q
        self.s = s
        self.bits = bits
        self.size = size
        self.shape = tuple(shape)
        self.dtype = dtype

    @property
    def group(self) -> int:
        """Elements a group covers."""
        return self.q.shape[1] * (2 if self.bits == 4 else 1)

    def _codes(self, q):
        """fp32 codes [..., group] of the packed rows ``q`` [..., q.shape[-1]]."""
        if self.bits == 8:
            return q.float()
        return unpack_int4(q.reshape(-1, q.shape[-1])).reshape(*q.shape[:-1], self.group)

    def dequantize(self, dtype=None):
        """The whole dense weight, in ``dtype`` (default: the leaf's)."""
        return dequantize_leaf(self, dtype or self.dtype)

    def __getitem__(self, idx):
        """Dense rows along dim 0: an int gives one row (one layer of a
        stacked leaf), a tensor of indices one row for each index."""
        rows = self.shape[0]
        per = self.size // rows
        g = self.group
        if isinstance(idx, int):
            if not -rows <= idx < rows:
                raise IndexError(f"index {idx} out of range for a packed leaf of {rows} rows")
            start = (idx % rows) * per
            g0, g1 = start // g, (start + per - 1) // g + 1
            flat = (self._codes(self.q[g0:g1]) * self.s[g0:g1]).reshape(-1)
            off = start - g0 * g
            return flat[off:off + per].to(self.dtype).reshape(self.shape[1:])
        idx = torch.as_tensor(idx, device=self.q.device).long()
        start = idx.reshape(-1) * per
        g0 = start // g
        span = (per - 1) // g + 2  # groups a row can touch
        groups = (g0[:, None] + torch.arange(span, device=start.device)).clamp(
            max=self.q.shape[0] - 1)
        dense = (self._codes(self.q[groups]) * self.s[groups]).reshape(len(start), span * g)
        cols = (start - g0 * g)[:, None] + torch.arange(per, device=start.device)
        rows_out = torch.gather(dense, 1, cols).to(self.dtype)
        return rows_out.reshape(*idx.shape, *self.shape[1:])

    def __repr__(self):
        return f"WOQLeaf(int{self.bits}, shape={self.shape}, dtype={self.dtype})"


def is_woq_leaf(x) -> bool:
    return isinstance(x, WOQLeaf)


def quantize_leaf(w, bits: int = 8, group_size: int = 128, dtype=None) -> WOQLeaf:
    """Pack one weight (on its device: the int8 kernel on CUDA) into quantized
    ints and scales; ``dtype`` (default ``w.dtype``) is the dtype it
    dequantizes to."""
    if bits == 8:
        q, s, n = quantize_int8(w.contiguous(), group_size)
    elif bits == 4:
        q, s, n = quantize_int4(w, group_size)
    else:
        raise ValueError(f"WOQ supports 4/8 bits, got {bits}")
    return WOQLeaf(q, s, bits, int(n), tuple(w.shape), dtype or w.dtype)


def dequantize_leaf(leaf: WOQLeaf, dtype=torch.bfloat16):
    fn = dequantize_int8 if leaf.bits == 8 else dequantize_int4
    return fn(leaf.q, leaf.s, leaf.size, shape=leaf.shape, dtype=dtype)


def _map_with_paths(fn, tree, prefix=""):
    """``fn(dotted path, leaf)`` applied leaf-wise over a nested-dict tree."""
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def quantize_tree(params: Any, bits: int = 8, group_size: int = 128,
                  modules: Optional[Sequence[str]] = None, min_size: int = 4096,
                  device=None, dtype=None) -> Any:
    """Pack every matching leaf of two or more dimensions and at least
    ``min_size`` elements (``modules``: regexes over dotted leaf paths; None
    matches all).  Leaf by leaf: each is moved to ``device`` (when given),
    packed there and its dense copy dropped before the next, so at most one
    dense leaf is added to the caller's.  Packed leaves dequantize to
    ``dtype`` (default: their own); the others are returned as they are."""
    totals = {"packed": 0, "dense_bytes": 0, "packed_bytes": 0}

    def pack(key, leaf):
        if not (leaf.dim() >= 2 and leaf.numel() >= min_size
                and (modules is None or any(re.search(m, key) for m in modules))):
            return leaf
        packed = quantize_leaf(leaf if device is None else leaf.to(device), bits=bits,
                               group_size=group_size, dtype=dtype)
        totals["packed"] += 1
        totals["dense_bytes"] += leaf.numel() * 2  # vs a bf16 serving copy
        totals["packed_bytes"] += packed.q.numel() + packed.s.numel() * 4
        return packed

    out = _map_with_paths(pack, params)
    logger.info(f"WOQ int{bits}: packed {totals['packed']} weights "
                f"({totals['dense_bytes'] / 1e6:.1f} MB bf16 -> "
                f"{totals['packed_bytes'] / 1e6:.1f} MB packed)")
    return out


def dequantize_tree(params: Any, dtype=torch.bfloat16) -> Any:
    """A dense copy of a (partially) packed tree."""
    return tree_map(lambda x: dequantize_leaf(x, dtype) if is_woq_leaf(x) else x, params)


def packed_nbytes(params: Any) -> int:
    """Serving-resident bytes of a (possibly partially) packed tree."""
    return sum(x.q.numel() + x.s.numel() * 4 if is_woq_leaf(x) else x.numel() * x.element_size()
               for x in tree_leaves(params))


def woq_tree_from_jax(tree_np, device, dtype=torch.float32) -> Any:
    """A JAX params tree with ``WOQLeaf``s (their ``q``/``s`` as numpy arrays,
    or anything ``np.array`` takes) -> this package's: packed leaves
    dequantizing to ``dtype``, the others as ``dtype`` tensors on ``device``."""
    to = lambda x, dt: torch.from_numpy(np.array(x)).to(device=device, dtype=dt)
    if isinstance(tree_np, dict):
        return {k: woq_tree_from_jax(v, device, dtype) for k, v in tree_np.items()}
    if hasattr(tree_np, "bits"):
        return WOQLeaf(to(tree_np.q, torch.int8), to(tree_np.s, torch.float32), tree_np.bits,
                       int(tree_np.size), tuple(tree_np.shape), dtype)
    return to(tree_np, dtype)
