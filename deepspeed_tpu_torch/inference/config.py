"""Inference configuration for the v1 and v2 serving engines.

Counterpart of ``deepspeed_tpu/inference/config.py``.  The port carries the
fields its serving paths read; a section of the JAX config that the port does
not implement yet raises ``NotImplementedError`` naming it, and so does a
tensor-parallel size above 1, so a config is never silently half-applied.
"""

from typing import Optional

import torch

from ..runtime.config import ServingResilienceConfig
from ..runtime.config_utils import ConfigModel, Field

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

# sections of the JAX InferenceConfig the port does not implement yet
UNPORTED_SECTIONS = ("serving_fastpath", "serving_prefix_cache", "serving_tracing",
                     "serving_fault_tolerance", "serving_qos", "serving_spec_decode",
                     "serving_perf", "ops_server", "serving_fleet",
                     "serving_kv_observability")


class TPConfig(ConfigModel):
    """Tensor parallelism (``tp_size`` 1 only: TP serving is ROADMAP Queue 1
    item 12)."""
    enabled: bool = True
    tp_size: int = Field(1, ge=1)


class QuantConfig(ConfigModel):
    """Weight-only quantization for serving (``inference/quantization.py``)."""
    enabled: bool = False
    bits: int = Field(8, choices=(4, 8))
    group_size: int = Field(2048, ge=8)


class InferenceConfig(ConfigModel):
    dtype: str = Field("bfloat16", choices=("float32", "bfloat16", "float16"))
    tensor_parallel: Optional[TPConfig] = None
    max_out_tokens: int = Field(1024, ge=1)
    min_out_tokens: int = Field(1, ge=1)
    max_seq_len: Optional[int] = None
    replace_with_kernel_inject: bool = False  # accepted and unused, as in JAX
    quant: Optional[QuantConfig] = None
    # sampling defaults
    temperature: float = Field(1.0, ge=0.0)
    top_k: int = Field(0, ge=0)
    top_p: float = Field(1.0, gt=0.0, le=1.0)
    seed: int = 0
    # admission control / load shedding / preemption / stall watchdog
    serving_resilience: ServingResilienceConfig = Field(ServingResilienceConfig)

    def model_validate(self):
        if self.tensor_parallel is None:
            object.__setattr__(self, "tensor_parallel", TPConfig())
        if self.quant is None:
            object.__setattr__(self, "quant", QuantConfig())
        if self.tensor_parallel.tp_size > 1:
            raise NotImplementedError(f"tensor_parallel.tp_size={self.tensor_parallel.tp_size}: "
                                      f"the PyTorch port serves on one GPU; TP serving is ROADMAP "
                                      f"Queue 1 item 12")


def load_inference_config(config) -> InferenceConfig:
    if config is None:
        return InferenceConfig()
    if isinstance(config, InferenceConfig):
        return config
    config = dict(config)
    unported = [k for k in UNPORTED_SECTIONS if k in config]
    if unported:
        raise NotImplementedError(f"the PyTorch port does not implement the config "
                                  f"section(s) {unported} yet")
    return InferenceConfig(**config)
