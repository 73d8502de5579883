"""Checkpoint engine plug-ins (``deepspeed_tpu/runtime/checkpoint_engine/``)."""
from .checkpoint_engine import (AsyncCheckpointEngine, CheckpointEngine, NativeCheckpointEngine,
                                build_checkpoint_engine)
