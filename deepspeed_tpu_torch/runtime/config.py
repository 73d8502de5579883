"""Config sections shared by training and serving.

Counterpart of ``deepspeed_tpu/runtime/config.py``; the port carries the
``serving_resilience`` section and the training sections its single-GPU
engine reads (:class:`TrainingConfig`), ``sparse_attention`` among them.
"""

import json
from typing import Any, Dict, List, Optional, Union

import torch

from .config_utils import ConfigModel, Field


class ServingResilienceConfig(ConfigModel):
    """Serving-side overload policy for the v2 ragged engine
    (inference/v2/admission.py).

    Admission: requests enter a bounded, priority-aware queue and are load-shed
    with a structured retryable/fatal reason BEFORE any KV allocation when
    ``max_queue_depth`` or ``shed_kv_utilization`` is crossed
    (``shed_kv_utilization=1.0`` disables pressure shedding: requests queue
    until the pool frees instead).  ``default_ttl_s`` gives every request a
    deadline (per-call ``generate(ttl_s=...)`` overrides); expired requests are
    evicted between steps — never mid-forward — with their blocks reclaimed.

    Scheduling: ``preemption`` lets a starved decode step reclaim KV blocks
    from the newest prefilling sequence (rolled back to a block boundary and
    requeued, at most ``max_preemptions`` times; once every candidate victim
    is exhausted the newest is evicted with status
    ``preempt_requeued_exhausted``).  ``stall_watchdog_steps`` bounds
    live-but-unschedulable loops: after that many steps without progress the
    engine raises ``ServingStalledError`` carrying a full state snapshot
    (strict mode) or fails the stuck requests and keeps serving the rest.
    """
    max_queue_depth: int = Field(0, ge=0)  # 0 => unbounded admission queue
    shed_kv_utilization: float = Field(1.0, gt=0.0, le=1.0)
    default_ttl_s: Optional[float] = Field(None, gt=0.0)
    max_live_seqs: int = Field(0, ge=0)  # 0 => bounded only by the scheduler
    preemption: bool = True
    max_preemptions: int = Field(2, ge=0)
    stall_watchdog_steps: int = Field(100, ge=1)


# ------------------------------------------------------------------ training
class FP16Config(ConfigModel):
    """Only ``enabled: false`` is accepted: fp16 loss scaling is not ported."""
    enabled: bool = False


class BF16Config(ConfigModel):
    """bf16 compute; on unless fp16 is asked for, as in the JAX package."""
    enabled: bool = True


class OffloadConfig(ConfigModel):
    """``offload_param`` / ``offload_optimizer``: only ``device: none`` is
    accepted; offload is not ported."""
    device: str = Field("none", choices=("none", "cpu", "nvme"))


class ZeroConfig(ConfigModel):
    """ZeRO stage.  Every stage is accepted: the port trains on one device,
    where ZeRO has no data-parallel group to partition params, grads or
    optimizer state over, so each stage runs the same step."""
    stage: int = Field(0, ge=0, le=3)
    offload_param: Optional[OffloadConfig] = None
    offload_optimizer: Optional[OffloadConfig] = None


class OptimizerConfig(ConfigModel):
    type: str = "adamw"
    params: Dict[str, Any] = Field(dict)


class SchedulerConfig(ConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = Field(dict)


class SparseAttentionConfig(ConfigModel):
    """Block-sparse attention section (``deepspeed_tpu/runtime/config.py``
    SparseAttentionConfig: mode and per-mode knobs).  ``build(num_heads)``
    resolves the matching SparsityConfig from ``ops/sparse_attention``."""
    mode: str = Field("fixed", choices=("dense", "fixed", "variable", "bigbird", "bslongformer",
                                        "local"))
    block: int = Field(16, ge=8)  # a multiple of 8; see model_validate
    different_layout_per_head: bool = False
    # fixed / variable
    num_local_blocks: int = Field(4, ge=1)
    num_global_blocks: int = Field(1, ge=1)
    # None -> per-mode default: "unidirectional" for local, "bidirectional" elsewhere
    attention: Optional[str] = Field(None, choices=(None, "unidirectional", "bidirectional"))
    horizontal_global_attention: bool = False
    num_different_global_patterns: int = Field(1, ge=1)
    # variable / bigbird; None -> per-mode default (bigbird: 1, variable: 0)
    num_random_blocks: Optional[int] = Field(None, ge=0)
    local_window_blocks: Optional[List[int]] = None
    global_block_indices: Optional[List[int]] = None
    global_block_end_indices: Optional[List[int]] = None
    # bigbird / bslongformer / local
    num_sliding_window_blocks: int = Field(3, ge=1)
    # seeds the random-block placement (variable / bigbird), so that every
    # process derives the same layout from the config alone
    seed: int = Field(1234, ge=0)

    def model_validate(self):
        if self.block % 8 != 0:
            raise ValueError(f"sparse_attention.block={self.block} must be a multiple of 8, as in "
                             f"the JAX package; the kernels take any multiple of 8")

    def build(self, num_heads: int):
        from ..ops.sparse_attention import (BigBirdSparsityConfig, BSLongformerSparsityConfig,
                                            DenseSparsityConfig, FixedSparsityConfig,
                                            LocalSlidingWindowSparsityConfig,
                                            VariableSparsityConfig)
        attention = self.attention or ("unidirectional" if self.mode == "local" else
                                       "bidirectional")
        if self.mode == "dense":
            return DenseSparsityConfig(num_heads, self.block, self.different_layout_per_head)
        if self.mode == "fixed":
            return FixedSparsityConfig(
                num_heads, self.block, self.different_layout_per_head, self.num_local_blocks,
                self.num_global_blocks, attention, self.horizontal_global_attention,
                self.num_different_global_patterns)
        if self.mode == "variable":
            return VariableSparsityConfig(
                num_heads, self.block, self.different_layout_per_head,
                self.num_random_blocks or 0, self.local_window_blocks, self.global_block_indices,
                self.global_block_end_indices, attention, self.horizontal_global_attention,
                seed=self.seed)
        if self.mode == "bigbird":
            num_random = self.num_random_blocks if self.num_random_blocks is not None else 1
            return BigBirdSparsityConfig(
                num_heads, self.block, self.different_layout_per_head, num_random,
                self.num_sliding_window_blocks, self.num_global_blocks, attention, seed=self.seed)
        if self.mode == "bslongformer":
            return BSLongformerSparsityConfig(
                num_heads, self.block, self.different_layout_per_head,
                self.num_sliding_window_blocks, self.global_block_indices,
                self.global_block_end_indices, attention)
        return LocalSlidingWindowSparsityConfig(num_heads, self.block,
                                                self.num_sliding_window_blocks, attention)


# sections of the JAX TrainingConfig that change what a step computes and are
# not ported yet; any other key the port does not know raises ValueError
UNPORTED_TRAINING_SECTIONS = ("data_efficiency", "telemetry", "ops_server")


class TrainingConfig(ConfigModel):
    """The training config the port's engine reads: the batch triple,
    optimizer, scheduler, precision (bf16 by default, fp32 with
    ``"bf16": {"enabled": false}``), gradient clipping, seed, print cadence,
    the ZeRO stage and block-sparse attention.  Load it with :func:`load_config`, which refuses the JAX
    package's other sections."""
    train_batch_size: Optional[int] = Field(None, ge=1)
    train_micro_batch_size_per_gpu: Optional[int] = Field(None, ge=1)
    gradient_accumulation_steps: Optional[int] = Field(None, ge=1)
    steps_per_print: int = Field(10, ge=1)
    gradient_clipping: float = Field(0.0, ge=0.0)
    seed: int = 1234
    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    fp16: FP16Config = Field(FP16Config)
    bf16: Optional[BF16Config] = None
    zero_optimization: ZeroConfig = Field(ZeroConfig)
    sparse_attention: Optional[SparseAttentionConfig] = None

    def model_validate(self):
        if self.fp16.enabled:
            raise NotImplementedError("fp16 training (dynamic loss scaling) is not ported to "
                                      "PyTorch yet: use bf16 or fp32")
        if self.bf16 is None:
            object.__setattr__(self, "bf16", BF16Config(enabled=True))
        for name in ("offload_param", "offload_optimizer"):
            section = getattr(self.zero_optimization, name)
            if section is not None and section.device != "none":
                raise NotImplementedError(f"zero_optimization.{name} (device "
                                          f"{section.device!r}) is not ported to PyTorch yet")

    def resolve_batch_sizes(self, dp_world_size: int):
        """(train_batch, micro_batch, gas), solving for any missing member of
        train_batch = micro_batch * gas * dp_world_size; raises on an
        inconsistent triple."""
        tb, mb, gas = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp_world_size:
                raise ValueError(f"train_batch_size={tb} != micro_batch({mb}) * gas({gas}) * "
                                 f"dp_world({dp_world_size})")
        elif tb is not None and mb is not None:
            if tb % (mb * dp_world_size) != 0:
                raise ValueError(f"train_batch_size={tb} not divisible by micro_batch*dp="
                                 f"{mb * dp_world_size}")
            gas = tb // (mb * dp_world_size)
        elif tb is not None and gas is not None:
            if tb % (gas * dp_world_size) != 0:
                raise ValueError(f"train_batch_size={tb} not divisible by gas*dp="
                                 f"{gas * dp_world_size}")
            mb = tb // (gas * dp_world_size)
        elif mb is not None:
            gas = gas or 1
            tb = mb * gas * dp_world_size
        elif tb is not None:
            mb = tb // dp_world_size
            if mb == 0 or tb % dp_world_size != 0:
                raise ValueError(f"train_batch_size={tb} not divisible by dp_world_size="
                                 f"{dp_world_size}")
            gas = 1
        else:
            raise ValueError("One of train_batch_size or train_micro_batch_size_per_gpu must "
                             "be set")
        object.__setattr__(self, "train_batch_size", tb)
        object.__setattr__(self, "train_micro_batch_size_per_gpu", mb)
        object.__setattr__(self, "gradient_accumulation_steps", gas)
        return tb, mb, gas

    @property
    def precision_dtype(self):
        return torch.bfloat16 if self.bf16.enabled else torch.float32


def load_config(config: Union[str, dict, TrainingConfig, None]) -> TrainingConfig:
    """A TrainingConfig from a JSON file path, a dict or a TrainingConfig.
    A section in ``UNPORTED_TRAINING_SECTIONS`` raises ``NotImplementedError``
    naming it and any other unknown key raises ``ValueError``, so a config is
    never half-applied."""
    if config is None:
        return TrainingConfig()
    if isinstance(config, TrainingConfig):
        return config
    if isinstance(config, str):
        with open(config, "r") as fh:
            config = json.load(fh)
    if not isinstance(config, dict):
        raise TypeError(f"config must be a path, dict, or TrainingConfig; got {type(config)}")
    unported = [k for k in UNPORTED_TRAINING_SECTIONS if k in config]
    if unported:
        raise NotImplementedError(f"the PyTorch port does not implement the training config "
                                  f"section(s) {unported} yet")
    return TrainingConfig(**config)
