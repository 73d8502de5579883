"""v2 ragged serving: continuous batching with SplitFuse over a paged KV pool."""

from .admission import AdmissionQueue, RequestResult, ServingStalledError, ShedReason
from .blocked_allocator import BlockedAllocator, KVAllocationError
from .engine_factory import build_engine
from .engine_v2 import InferenceEngineV2
from .kv_metrics import (BlockCensus, CapacityForecaster, CensusInvariantError, KVObservability,
                         PrefixObservatory, block_hashes, tenant_namespace)
from .ragged_manager import PrefixCache, RaggedStateManager
from .scheduler import SplitFuseScheduler

__all__ = ["AdmissionQueue", "BlockCensus", "BlockedAllocator", "CapacityForecaster",
           "CensusInvariantError", "InferenceEngineV2", "KVAllocationError", "KVObservability",
           "PrefixCache", "PrefixObservatory", "RaggedStateManager", "RequestResult",
           "ServingStalledError", "ShedReason", "SplitFuseScheduler", "block_hashes",
           "build_engine", "tenant_namespace"]
