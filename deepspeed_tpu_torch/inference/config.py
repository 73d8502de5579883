"""Inference configuration for the v2 serving engine.

Counterpart of ``deepspeed_tpu/inference/config.py``.  The port carries the
fields its serving path reads; a section of the JAX config that the port does
not implement yet raises ``NotImplementedError`` naming it, so a config is
never silently half-applied.
"""

import torch

from ..runtime.config import ServingResilienceConfig
from ..runtime.config_utils import ConfigModel, Field

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

# sections of the JAX InferenceConfig the port does not implement yet
UNPORTED_SECTIONS = ("serving_fastpath", "serving_prefix_cache", "serving_tracing",
                     "serving_fault_tolerance", "serving_qos", "serving_spec_decode",
                     "serving_perf", "ops_server", "serving_fleet",
                     "serving_kv_observability")


class InferenceConfig(ConfigModel):
    dtype: str = Field("bfloat16", choices=("float32", "bfloat16", "float16"))
    # sampling defaults
    temperature: float = Field(1.0, ge=0.0)
    top_k: int = Field(0, ge=0)
    top_p: float = Field(1.0, gt=0.0, le=1.0)
    seed: int = 0
    # admission control / load shedding / preemption / stall watchdog
    serving_resilience: ServingResilienceConfig = Field(ServingResilienceConfig)


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
