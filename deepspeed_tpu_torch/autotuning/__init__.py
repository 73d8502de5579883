"""Autotuning (JAX ``deepspeed_tpu/autotuning/``): search over the ZeRO
stage, the micro-batch size and, outside fast mode, the remat policy, with
short measured runs in this process, one engine a candidate, and write the
best config.  The command is ``python -m deepspeed_tpu_torch.autotuning``."""

from .autotuner import Autotuner, ModelInfo
from .config import AutotuningConfig
from .tuner import GridSearchTuner, ModelBasedTuner, RandomTuner
