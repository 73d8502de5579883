"""v2 ragged serving: continuous batching with SplitFuse over a paged KV pool."""

from .admission import AdmissionQueue, RequestResult, ServingStalledError, ShedReason
from .blocked_allocator import BlockedAllocator, KVAllocationError
from .engine_factory import build_engine
from .engine_v2 import InferenceEngineV2
from .ragged_manager import RaggedStateManager
from .scheduler import SplitFuseScheduler

__all__ = ["AdmissionQueue", "BlockedAllocator", "InferenceEngineV2", "KVAllocationError",
           "RaggedStateManager", "RequestResult", "ServingStalledError", "ShedReason",
           "SplitFuseScheduler", "build_engine"]
