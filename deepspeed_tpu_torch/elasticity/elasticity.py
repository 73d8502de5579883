"""Elastic training configuration solver.

Counterpart of ``deepspeed_tpu/elasticity/elasticity.py``: given a target
batch-size range and micro-batch candidates, find the total batch size that
the most admissible GPU counts fit, so a scaling event never changes the
effective batch.  Host arithmetic only; the training config's
``elasticity`` dict is its input.
"""

import math
from functools import reduce
from typing import Dict, List, Optional, Tuple

from ..runtime.config_utils import ConfigModel, Field


class ElasticityConfig(ConfigModel):
    """Reference elasticity config block (elasticity/config.py)."""
    enabled: bool = False
    max_train_batch_size: int = Field(2000, ge=1)
    micro_batch_sizes: List[int] = Field(lambda: [2, 4, 6])
    min_gpus: int = Field(1, ge=1)
    max_gpus: int = Field(10000, ge=1)
    min_time: int = Field(0, ge=0)
    version: float = 0.2
    ignore_non_elastic_batch_info: bool = False
    prefer_larger_batch: bool = True


def _lcm(nums: List[int]) -> int:
    return reduce(lambda a, b: a * b // math.gcd(a, b), nums, 1)


def get_valid_gpus(batch_size: int, micro_batches: List[int], min_gpus: int,
                   max_gpus: int) -> List[int]:
    """GPU counts that evenly fit batch = micro * gas * world for some micro
    (reference elasticity.py:60)."""
    valid = set()
    for mb in micro_batches:
        if batch_size % mb != 0:
            continue
        max_world = batch_size // mb
        for world in range(min_gpus, min(max_gpus, max_world) + 1):
            if max_world % world == 0:
                valid.add(world)
    return sorted(valid)


def get_best_candidates(max_batch: int, micro_batches: List[int], min_gpus: int, max_gpus: int,
                        prefer_larger: bool = True) -> Tuple[int, List[int], Optional[int]]:
    """v0.1 solver (reference elasticity.py:83): candidate batches are
    lcm(micro_batches) * k; pick the one admitting the most GPU counts."""
    base = _lcm(micro_batches)
    best = (0, [], None)
    for batch in range(base, max_batch + 1, base):
        valid = get_valid_gpus(batch, micro_batches, min_gpus, max_gpus)
        better = len(valid) > len(best[1]) or (len(valid) == len(best[1]) and prefer_larger
                                               and best[2] is not None and batch > best[2])
        if valid and (best[2] is None or better):
            best = (len(valid), valid, batch)
    return best[2], best[1], None if best[2] is None else best[2]


def compute_elastic_config(ds_config: Dict, target_deepspeed_version: str = "",
                           world_size: int = 0, return_microbatch: bool = False):
    """Reference compute_elastic_config (elasticity.py:233): resolve the final
    (train_batch_size, valid_gpus[, micro_batch]) for this world size."""
    ecfg = ElasticityConfig(**ds_config.get("elasticity", {}))
    if not ecfg.enabled:
        raise ValueError("elasticity section missing or disabled")
    batch, valid_gpus, _ = get_best_candidates(ecfg.max_train_batch_size,
                                               list(ecfg.micro_batch_sizes),
                                               ecfg.min_gpus, ecfg.max_gpus,
                                               ecfg.prefer_larger_batch)
    if batch is None:
        raise ValueError("no elastic batch size satisfies the constraints")
    if world_size > 0 and world_size not in valid_gpus:
        raise ValueError(f"world size {world_size} is not in the elastic-compatible set "
                         f"{valid_gpus}")
    if not return_microbatch:
        return batch, valid_gpus
    micro = None
    if world_size > 0:
        per_gpu = batch // world_size
        for mb in sorted(ecfg.micro_batch_sizes, reverse=ecfg.prefer_larger_batch):
            if per_gpu % mb == 0:
                micro = mb
                break
    return batch, valid_gpus, micro
