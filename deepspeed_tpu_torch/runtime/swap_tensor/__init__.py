"""Tensor offload and swap (``deepspeed_tpu/runtime/swap_tensor``): host or
disk optimizer state, and disk-resident layers streamed through training."""
from .optimizer_swapper import OffloadedAdamState
from .partitioned_param_swapper import AsyncPartitionedParameterSwapper, SwappedLayerTrainer
