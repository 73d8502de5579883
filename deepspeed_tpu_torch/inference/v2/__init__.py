"""v2 ragged serving: continuous batching with SplitFuse over a paged KV pool,
with speculative decoding, the durable request journal, the serving
supervisor, multi-tenant QoS and the fleet router."""

from .admission import (REQUEST_STATUSES, AdmissionQueue, RecoveredRequest, RequestResult,
                        ServingStalledError, ShedReason)
from .blocked_allocator import BlockedAllocator, KVAllocationError
from .engine_factory import build_engine, build_hf_engine
from .engine_v2 import InferenceEngineV2
from .fastpath import PENDING_TOKEN, DeferredRuns, DeferredTokens, DeviceBatchState, ServeCounters
from .journal import JournalEntry, JournalState, RequestJournal, replay_journal
from .kv_metrics import (BlockCensus, CapacityForecaster, CensusInvariantError, KVObservability,
                         PrefixObservatory, block_hashes, tenant_namespace)
from .qos import QUOTA_EXCEEDED, DeficitRoundRobin, QosPolicy, TenantQuota, TokenBucket
from .ragged_manager import (EmptyPromptError, PrefixCache, PrefixEntry, RaggedStateManager,
                             SequenceDescriptor, UnknownSequenceError)
from .router import FleetRouter, ReplicaHandle
from .scheduler import ScheduledChunk, SplitFuseScheduler
from .spec_decode import (AdaptiveKController, ModelDrafter, NgramDrafter, SpecDecodeStats,
                          rejection_select, spec_k_ladder)
from .supervisor import (RecoveryPlan, ServeSpec, ServingSupervisor, plan_recovery,
                         recover_and_serve)

__all__ = ["AdaptiveKController", "AdmissionQueue", "BlockCensus", "BlockedAllocator",
           "CapacityForecaster", "CensusInvariantError", "DeferredRuns", "DeferredTokens",
           "DeficitRoundRobin", "DeviceBatchState", "EmptyPromptError", "FleetRouter",
           "InferenceEngineV2", "JournalEntry", "JournalState", "KVAllocationError",
           "KVObservability", "ModelDrafter", "NgramDrafter", "PENDING_TOKEN", "PrefixCache",
           "PrefixEntry", "PrefixObservatory", "QUOTA_EXCEEDED", "QosPolicy", "REQUEST_STATUSES",
           "RaggedStateManager", "RecoveredRequest", "RecoveryPlan", "ReplicaHandle",
           "RequestJournal", "RequestResult", "ScheduledChunk", "SequenceDescriptor",
           "ServeCounters", "ServeSpec", "ServingStalledError", "ServingSupervisor", "ShedReason",
           "SpecDecodeStats", "SplitFuseScheduler", "TenantQuota", "TokenBucket",
           "UnknownSequenceError", "block_hashes", "build_engine", "build_hf_engine",
           "plan_recovery", "recover_and_serve", "rejection_select", "replay_journal",
           "spec_k_ladder", "tenant_namespace"]
