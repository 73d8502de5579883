"""v2 ragged serving: continuous batching with SplitFuse over a paged KV pool,
with the durable request journal and the serving supervisor."""

from .admission import (AdmissionQueue, RecoveredRequest, RequestResult, ServingStalledError,
                        ShedReason)
from .blocked_allocator import BlockedAllocator, KVAllocationError
from .engine_factory import build_engine
from .engine_v2 import InferenceEngineV2
from .journal import JournalEntry, JournalState, RequestJournal, replay_journal
from .kv_metrics import (BlockCensus, CapacityForecaster, CensusInvariantError, KVObservability,
                         PrefixObservatory, block_hashes, tenant_namespace)
from .ragged_manager import PrefixCache, RaggedStateManager
from .scheduler import SplitFuseScheduler
from .supervisor import (RecoveryPlan, ServeSpec, ServingSupervisor, plan_recovery,
                         recover_and_serve)

__all__ = ["AdmissionQueue", "BlockCensus", "BlockedAllocator", "CapacityForecaster",
           "CensusInvariantError", "InferenceEngineV2", "JournalEntry", "JournalState",
           "KVAllocationError", "KVObservability", "PrefixCache", "PrefixObservatory",
           "RaggedStateManager", "RecoveredRequest", "RecoveryPlan", "RequestJournal",
           "RequestResult", "ServeSpec", "ServingStalledError", "ServingSupervisor", "ShedReason",
           "SplitFuseScheduler", "block_hashes", "build_engine", "plan_recovery",
           "recover_and_serve", "replay_journal", "tenant_namespace"]
