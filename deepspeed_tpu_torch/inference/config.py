"""Inference configuration for the v1 and v2 serving engines.

Counterpart of ``deepspeed_tpu/inference/config.py``.  The port carries the
fields its serving paths read; a section of the JAX config that the port does
not implement yet raises ``NotImplementedError`` naming it, and so does a
tensor-parallel size above 1, so a config is never silently half-applied.
"""

from typing import Optional

import torch

from ..runtime.config import (KVObservabilityConfig, OpsServerConfig, ServingFastpathConfig,
                              ServingFaultToleranceConfig, ServingFleetConfig, ServingPerfConfig,
                              ServingPrefixCacheConfig, ServingQosConfig,
                              ServingResilienceConfig, ServingSpecDecodeConfig,
                              ServingTracingConfig)
from ..runtime.config_utils import ConfigModel, Field

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

# sections of the JAX InferenceConfig the port does not implement yet
UNPORTED_SECTIONS = ()


class TPConfig(ConfigModel):
    """Tensor parallelism (``tp_size`` 1 only: TP serving is ROADMAP Queue 1
    item 11)."""
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
    # device-resident batch state, pipelined dispatch, fused decode bursts and
    # per-bucket CUDA graphs (inference/v2/fastpath.py, cuda_graphs.py)
    serving_fastpath: ServingFastpathConfig = Field(ServingFastpathConfig)
    # speculative decoding on the fused decode path: draft/verify with
    # rejection sampling on the device (inference/v2/spec_decode.py)
    serving_spec_decode: ServingSpecDecodeConfig = Field(ServingSpecDecodeConfig)
    # block census, counterfactual prefix observatory, capacity forecast
    # (inference/v2/kv_metrics.py)
    serving_kv_observability: KVObservabilityConfig = Field(KVObservabilityConfig)
    # copy-on-write prefix caching (inference/v2/ragged_manager.py PrefixCache)
    serving_prefix_cache: ServingPrefixCacheConfig = Field(ServingPrefixCacheConfig)
    # request tracing, SLO latency histograms and the always-on flight
    # recorder (monitor/tracing.py)
    serving_tracing: ServingTracingConfig = Field(ServingTracingConfig)
    # durable request journal, serve-iteration heartbeat and the supervisor's
    # restart budget (inference/v2/journal.py, supervisor.py)
    serving_fault_tolerance: ServingFaultToleranceConfig = Field(ServingFaultToleranceConfig)
    # fleet front-end over N supervised replicas (inference/v2/router.py)
    serving_fleet: ServingFleetConfig = Field(ServingFleetConfig)
    # multi-tenant QoS: per-tenant quotas, weighted-fair dequeue across
    # service classes, preemption steering (inference/v2/qos.py)
    serving_qos: ServingQosConfig = Field(ServingQosConfig)
    # phase attribution of the serve loop, the compile ledger's snapshot and
    # the live roofline (monitor/perf.py)
    serving_perf: ServingPerfConfig = Field(ServingPerfConfig)
    # Prometheus /metrics and JSON /healthz, /statez (monitor/ops_server.py)
    ops_server: OpsServerConfig = Field(OpsServerConfig)

    def model_validate(self):
        if self.tensor_parallel is None:
            object.__setattr__(self, "tensor_parallel", TPConfig())
        if self.quant is None:
            object.__setattr__(self, "quant", QuantConfig())
        if self.tensor_parallel.tp_size > 1:
            raise NotImplementedError(f"tensor_parallel.tp_size={self.tensor_parallel.tp_size}: "
                                      f"the PyTorch port serves on one GPU; TP serving is ROADMAP "
                                      f"Queue 1 item 11")


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
