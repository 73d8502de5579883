"""Compression library: weight quantization and pruning over a params tree.

Counterpart of ``deepspeed_tpu/compression/compress.py``: compression is a
tree transform (masks and fake quantization applied to the leaves whose
dotted keys match a group's ``modules`` regexes) plus a scheduler that ramps
it over steps.  The keys are the ones JAX's ``key_of`` makes
(``runtime/checkpointing.flatten_with_paths``), so one config selects the
same leaves in both packages.  Per leaf of two or more dims the methods run
in JAX's order: weight quantization, then sparse, row, head and channel
pruning, each taking only the first group that matches.  Leaves no group
touches are returned as they are.
"""

import logging
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..runtime.checkpointing import flatten_with_paths
from .basic_layer import channel_prune_mask, head_prune_mask, kth_largest, layer_reduction

logger = logging.getLogger(__name__)


def _match(path: str, patterns) -> bool:
    return any(re.search(p, path) for p in patterns)


def fake_quantize(w: torch.Tensor, bits: int = 8, group_size: int = 0) -> torch.Tensor:
    """Symmetric fake quantization, one scale for the tensor or for each
    group of ``group_size`` elements."""
    qmax = 2.0**(bits - 1) - 1
    if group_size and w.numel() % group_size == 0:
        flat = w.reshape(-1, group_size)
        scale = flat.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / qmax
        q = torch.clamp(torch.round(flat / scale), -qmax, qmax)
        return (q * scale).reshape(w.shape).to(w.dtype)
    scale = w.abs().max().clamp_min(1e-8) / qmax
    return (torch.clamp(torch.round(w / scale), -qmax, qmax) * scale).to(w.dtype)


def sparse_prune_mask(w: torch.Tensor, density: float) -> torch.Tensor:
    """Unstructured magnitude pruning mask keeping ``density`` of the
    elements (every tie with the threshold too)."""
    k = max(1, int(round(w.numel() * density)))
    mag = w.abs()
    return (mag >= kth_largest(mag, k)).to(w.dtype)


def row_prune_mask(w: torch.Tensor, density: float) -> torch.Tensor:
    """Structured row pruning by L1 norm (rows = output features, the last
    dim)."""
    norms = w.abs().sum(dim=tuple(range(w.dim() - 1)))
    k = max(1, int(round(norms.numel() * density)))
    keep = (norms >= kth_largest(norms, k)).to(w.dtype)
    return keep.expand(w.shape)


class CompressionScheduler:
    """Ramp compression over steps: no-op until ``schedule_offset``, then
    active every ``frequency`` steps."""

    def __init__(self, schedule_offset: int = 0, frequency: int = 1):
        self.schedule_offset = schedule_offset
        self.frequency = max(1, frequency)

    def is_active(self, global_step: int) -> bool:
        return global_step >= self.schedule_offset and \
            (global_step - self.schedule_offset) % self.frequency == 0


def _set_path(tree, path, leaf):
    """``tree`` with the leaf at ``path`` replaced, dicts copied along the
    path only."""
    if not path:
        return leaf
    out = dict(tree)
    out[path[0]] = _set_path(tree[path[0]], path[1:], leaf)
    return out


def init_compression(params: Any, config: Dict, paths: Optional[Any] = None) -> Any:
    """Apply the configured compression to the matching leaves (JAX
    ``init_compression``).  ``config`` takes the reference's shape, e.g.
    ``{"weight_quantization": {"different_groups": {"wq1": {"params":
    {"target_bits": 8}, "modules": ["attn\\\\."]}}}, "sparse_pruning":
    {"different_groups": {"sp1": {"params": {"dense_ratio": 0.5},
    "modules": [".*mlp.*"]}}}}``; ``head_pruning`` takes ``num_heads`` from
    the group's params or its ``shared_parameters``."""
    wq = config.get("weight_quantization", {}).get("different_groups", {})
    sp = config.get("sparse_pruning", {}).get("different_groups", {})
    rp = config.get("row_pruning", {}).get("different_groups", {})
    hp = config.get("head_pruning", {}).get("different_groups", {})
    cp = config.get("channel_pruning", {}).get("different_groups", {})
    hp_shared = config.get("head_pruning", {}).get("shared_parameters", {})

    def first(groups, key):
        return next((g for g in groups.values() if _match(key, g.get("modules", [".*"]))), None)

    out = params
    counts = dict.fromkeys(("quantized", "sparse", "row", "head", "channel"), 0)
    for path, leaf in list(flatten_with_paths(params)):
        key = ".".join(str(p) for p in path)
        if leaf.dim() < 2:
            continue
        new = leaf
        group = first(wq, key)
        if group is not None:
            new = fake_quantize(new, bits=int(group.get("params", {}).get("target_bits", 8)))
            counts["quantized"] += 1
        group = first(sp, key)
        if group is not None:
            density = float(group.get("params", {}).get("dense_ratio", 0.5))
            new = new * sparse_prune_mask(new, density)
            counts["sparse"] += 1
        group = first(rp, key)
        if group is not None:
            density = float(group.get("params", {}).get("dense_ratio", 0.5))
            new = new * row_prune_mask(new, density)
            counts["row"] += 1
        group = first(hp, key)
        if group is not None:
            gp = group.get("params", {})
            heads = int(gp.get("num_heads", hp_shared.get("num_heads", 0)))
            if heads <= 0:
                raise ValueError("head_pruning needs num_heads (group params "
                                 "or shared_parameters)")
            density = float(gp.get("dense_ratio", 0.5))
            new = new * head_prune_mask(new, heads, density, head_axis=gp.get("head_axis", "in"))
            counts["head"] += 1
        group = first(cp, key)
        if group is not None:
            density = float(group.get("params", {}).get("dense_ratio", 0.5))
            new = new * channel_prune_mask(new, density)
            counts["channel"] += 1
        if new is not leaf:
            out = _set_path(out, path, new)
    logger.info("compression: " + " ".join(f"{k}={v}" for k, v in counts.items()) + " leaves")
    return out


def redundancy_clean(params: Any, config: Dict) -> Any:
    """Make compression permanent (JAX ``redundancy_clean``): the masks are
    applied again, then, when ``layer_reduction.enabled``, the student keeps
    the teacher's layers ``keep_layers``, or ``keep_number_layer`` of
    ``teacher_layer`` spread by ``linspace(...).round()``, of the stacked
    subtree at ``module_name_prefix`` (dotted) or of the whole tree."""
    params = init_compression(params, config)
    lr_cfg = config.get("layer_reduction", {})
    if lr_cfg.get("enabled"):
        keep = lr_cfg.get("keep_layers")
        if keep is None:
            num = int(lr_cfg["keep_number_layer"])
            total = int(lr_cfg["teacher_layer"])
            keep = np.linspace(0, total - 1, num).round().astype(int).tolist()
        target = lr_cfg.get("module_name_prefix")
        if target:
            parts = target.split(".")
            sub = params
            for part in parts:
                sub = sub[part]
            params = _set_path(params, tuple(parts), layer_reduction(sub, keep))
        else:
            params = layer_reduction(params, keep)
    return params
