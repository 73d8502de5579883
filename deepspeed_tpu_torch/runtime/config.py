"""Config sections shared by training and serving.

Counterpart of ``deepspeed_tpu/runtime/config.py``; the port carries the
``serving_resilience``, ``serving_fastpath``, ``serving_spec_decode``,
``serving_kv_observability``, ``serving_prefix_cache``, ``serving_tracing``,
``serving_fault_tolerance``,
``serving_fleet``, ``serving_qos``, ``serving_perf`` and ``ops_server``
sections and the training sections its single-GPU engine reads (:class:`TrainingConfig`), ``sparse_attention``,
``telemetry`` and the monitor writers among them.
"""

import json
import logging
from typing import Any, Dict, List, Optional, Union

import torch

from .config_utils import ConfigModel, Field


class ServingResilienceConfig(ConfigModel):
    """Serving-side overload policy for the v2 ragged engine
    (inference/v2/admission.py).

    Admission: requests enter a bounded, priority-aware queue and are load-shed
    with a structured retryable/fatal reason BEFORE any KV allocation when
    ``max_queue_depth`` or ``shed_kv_utilization`` is crossed
    (``shed_kv_utilization=1.0`` disables pressure shedding: requests queue
    until the pool frees instead).  ``default_ttl_s`` gives every request a
    deadline (per-call ``generate(ttl_s=...)`` overrides); expired requests are
    evicted between steps — never mid-forward — with their blocks reclaimed.

    Scheduling: ``preemption`` lets a starved decode step reclaim KV blocks
    from the newest prefilling sequence (rolled back to a block boundary and
    requeued, at most ``max_preemptions`` times; once every candidate victim
    is exhausted the newest is evicted with status
    ``preempt_requeued_exhausted``).  ``stall_watchdog_steps`` bounds
    live-but-unschedulable loops: after that many steps without progress the
    engine raises ``ServingStalledError`` carrying a full state snapshot
    (strict mode) or fails the stuck requests and keeps serving the rest.
    """
    max_queue_depth: int = Field(0, ge=0)  # 0 => unbounded admission queue
    shed_kv_utilization: float = Field(1.0, gt=0.0, le=1.0)
    default_ttl_s: Optional[float] = Field(None, gt=0.0)
    max_live_seqs: int = Field(0, ge=0)  # 0 => bounded only by the scheduler
    preemption: bool = True
    max_preemptions: int = Field(2, ge=0)
    stall_watchdog_steps: int = Field(100, ge=1)


class ServingFastpathConfig(ConfigModel):
    """Serving hot-path policy for the v2 ragged engine
    (``inference/v2/fastpath.py``, ``inference/v2/cuda_graphs.py``).

    ``enabled`` turns the whole fast path off, falling back to the
    rebuild-and-upload-per-step reference loop (the equivalence oracle the
    fast-path tests diff against; on the card it runs eagerly, without CUDA
    graphs).  ``pipeline_depth=1`` defers the sampled-token fetch by one step
    so host-side scheduling of step N+1 overlaps device execution of step N
    (0 = fully synchronous); the pipeline disengages whenever admission
    tickets are queued or any live sequence carries a deadline, so eviction
    semantics match the synchronous loop exactly.  ``fusion_min_steps`` is
    the smallest remaining-token window worth fusing into one on-device
    decode burst.  ``prewarm_buckets`` bounds how many (batch, chunk, table)
    bucket programs ``generate()`` builds (captures, on the card) at intake.
    """
    enabled: bool = True
    pipeline_depth: int = Field(1, choices=(0, 1))
    fusion_min_steps: int = Field(2, ge=2)
    prewarm_buckets: int = Field(4, ge=0)


class ServingSpecDecodeConfig(ConfigModel):
    """Speculative decoding on the v2 engine's fused decode path
    (``inference/v2/spec_decode.py``), with the JAX package's fields,
    defaults and bounds.

    ``enabled`` arms draft/verify: on every pure-decode fused window a
    drafter proposes ``k`` tokens per sequence, the target scores all of
    them in ONE batched forward over the paged KV pool, and rejection
    sampling on the device accepts the longest valid prefix plus one
    resampled token (1 to k+1 tokens per sequence a round).  Greedy output
    is token-identical to spec off; sampled output has its distribution.
    Off (the default) the engine builds no drafter, controller or stats.

    ``drafter``: ``"ngram"`` is prompt lookup over the sequence's own token
    history on the host; ``"model"`` is a draft model attached with
    ``InferenceEngineV2.attach_draft_model(...)``, greedy over a paged pool
    of its own.

    ``k`` caps the draft length.  The adaptive controller moves the live k
    over a static ladder (1, 3, 7, 15, ... capped at ``k``) on an EWMA of
    the acceptance (``ewma_alpha``; up above ``raise_threshold``, down
    below ``lower_threshold``), so every verify width is a prewarmed
    bucket.  At the k=1 floor the engine runs the plain burst and re-probes
    every ``probe_every`` fused rounds.  ``adaptive_k=False`` pins k.
    ``ngram_max``/``ngram_min`` bound the suffix match the n-gram drafter
    tries, longest first.
    """
    enabled: bool = False
    drafter: str = Field("ngram", choices=("ngram", "model"))
    k: int = Field(4, ge=1)
    adaptive_k: bool = True
    ewma_alpha: float = Field(0.3, gt=0.0, le=1.0)
    raise_threshold: float = Field(0.7, ge=0.0, le=1.0)
    lower_threshold: float = Field(0.3, ge=0.0, le=1.0)
    probe_every: int = Field(16, ge=1)
    ngram_max: int = Field(3, ge=1)
    ngram_min: int = Field(1, ge=1)


class KVObservabilityConfig(ConfigModel):
    """Block-level observability over the paged KV pool for the v2 ragged
    engine (``inference/v2/kv_metrics.py``), with the JAX package's fields,
    defaults and bounds.

    ``enabled`` arms the block census (per-block owners/age/residency with
    utilization, fragmentation and block-age rollups), the
    ``PrefixObservatory`` (the counterfactual prefix-cache win per serve
    pass) and the capacity forecaster (EWMA block alloc/free rates per step
    yielding a steps-to-exhaustion gauge).  Everything reads host ints the
    allocator and ragged manager already own: no device syncs, so the fast
    path's ``ServeCounters`` are byte-identical on and off.

    ``invariant_check`` re-verifies after every serve pass that the census's
    owned-block set exactly partitions against the allocator free list, that
    every shared block's owners agree with its refcount, and that every
    mapper of a shared block holds the same tokens (``CensusInvariantError``
    names the offending uid/block).  ``pressure_steps`` is the
    steps-to-exhaustion threshold of the pressure edge detector;
    ``ewma_alpha`` smooths the forecaster's rates.
    """
    enabled: bool = True
    invariant_check: bool = True
    ewma_alpha: float = Field(0.2, gt=0.0, le=1.0)
    pressure_steps: float = Field(64.0, gt=0.0)
    age_buckets_per_decade: int = Field(6, ge=1, le=100)


class ServingPrefixCacheConfig(ConfigModel):
    """Copy-on-write prefix caching over the paged KV pool for the v2 ragged
    engine (``inference/v2/ragged_manager.py`` ``PrefixCache``), with the JAX
    package's fields and defaults.

    ``enabled`` arms the tree: an admitted request whose leading FULL prompt
    blocks match live, fully-computed blocks maps them read-only (allocator
    refcount +1 per mapping) and only prefills its divergent tail.  On a
    workload where nothing is shared the fast path's ``ServeCounters`` are
    byte-identical with the cache on and off.

    ``cow`` allows the copy-on-write block copy for prompts cached to their
    LAST token: the final block's KV is copied into a private block so the
    one recomputed position (needed for first-token logits) never writes a
    shared block.  Off, such prompts recompute their final block.

    ``defer_shared_prefill`` lets the scheduler hold a prefill chunk for ONE
    step when a sequence already scheduled this step is computing the exact
    block it needs — same-wave duplicates of one header become a one-step
    delay plus a cache hit instead of duplicate prefill.
    """
    enabled: bool = True
    cow: bool = True
    defer_shared_prefill: bool = True


class ServingTracingConfig(ConfigModel):
    """Request-lifecycle tracing and SLO latency histograms for the v2 ragged
    engine (``monitor/tracing.py`` wired through ``inference/v2``), with the
    JAX package's fields and defaults.

    ``enabled`` turns on per-uid span recording (queue_wait -> prefill ->
    decode, requeue spans around preemptions, one terminal event matching
    the request's ``RequestResult`` status) and the TTFT/TBT/e2e histograms.
    Tracing reads ONLY the engine's injectable clock at host-touch points
    (admission, wave boundaries, token materialization) and adds no device
    syncs: the fast path's ``ServeCounters`` are byte-identical on and off.
    ``trace_jsonl`` exports each completed trace as a ``kind: trace`` record
    through an attached telemetry collector's ``record_trace`` (the port's
    engine attaches none yet); ``chrome_trace_path`` additionally buffers
    Chrome-trace-event JSON (load in Perfetto / chrome://tracing), which the
    engine writes at the end of each ``generate()`` call.

    The flight recorder, a bounded ring of the last ``flight_recorder_events``
    engine events dumped into ``ServingStalledError`` snapshots and
    ``health()``, is ALWAYS on; the knob only sizes the ring.

    Histogram buckets are logarithmic: ``histogram_buckets_per_decade``
    buckets per decade from ``histogram_min_s`` seconds; quantiles return
    deterministic bucket representatives (relative error bounded by one
    bucket width), and same-shaped histograms merge exactly.
    """
    enabled: bool = False
    trace_jsonl: bool = True
    chrome_trace_path: Optional[str] = None
    flight_recorder_events: int = Field(256, ge=16)
    histogram_buckets_per_decade: int = Field(6, ge=1, le=100)
    histogram_min_s: float = Field(1e-5, gt=0.0)


class ServingFaultToleranceConfig(ConfigModel):
    """Serving-side crash durability + supervised restart for the v2 ragged
    engine (``inference/v2/journal.py`` + ``inference/v2/supervisor.py``),
    with the JAX package's fields, defaults and validation.

    ``enabled`` arms the durable request journal: one CRC-framed record per
    admitted request (uid, prompt, priority, TTL, budget, sampling key),
    batched emitted-token deltas appended at wave-boundary flushes (the host
    already holds those tokens — zero extra device syncs), and a terminal
    record mirroring each ``RequestResult``.  ``journal_path`` names the WAL
    file (the supervisor-exported ``DSTPU_SERVING_JOURNAL`` env arms it with
    no config changes); ``fsync_every`` fsyncs the journal every N
    wave-boundary flushes (strict mode also writes + fsyncs admits and
    terminals eagerly).  0 is throughput mode: no fsync until close, but
    every record reaches OS pages at the NEXT wave boundary (the serve loop
    flushes each iteration; the serve call's exit always flushes), so a
    process crash loses at most one iteration's records — which recovery
    absorbs by re-serving from the surviving journaled prefix.

    ``heartbeat`` stamps a serve-iteration liveness file (phase ``serving``)
    through ``runtime/heartbeat.py`` — zero device syncs; ``ServingSupervisor``
    arms it via env for its workers, and a stale stamp (``hang_timeout_s``,
    after ``startup_grace_s``) or a dead process both count as one failure.

    ``max_restarts`` within ``restart_window_s`` bounds the supervisor's
    restart budget; past it the supervisor degrades to drain-only mode —
    new admissions are shed with a structured retryable reason, recoverable
    journal work gets one final attempt, and anything still unfinished is
    finalized as ``failed`` directly in the journal.  Never a hang.
    """
    enabled: bool = False
    journal_path: Optional[str] = None
    fsync_every: int = Field(1, ge=0)
    heartbeat: bool = False
    heartbeat_dir: Optional[str] = None
    heartbeat_interval_s: float = Field(0.2, ge=0.0)
    max_restarts: int = Field(2, ge=0)
    restart_window_s: float = Field(300.0, gt=0.0)
    hang_timeout_s: float = Field(30.0, gt=0.0)
    startup_grace_s: float = Field(120.0, ge=0.0)
    poll_interval_s: float = Field(0.05, gt=0.0)

    def model_validate(self):
        import os

        from .heartbeat import HEARTBEAT_DIR_ENV, SERVING_JOURNAL_ENV
        # a worker under ServingSupervisor gets both paths from the
        # environment, so enabling the section without explicit paths is
        # only an error when nothing supervises the process
        if self.enabled and not self.journal_path \
                and not os.environ.get(SERVING_JOURNAL_ENV):
            raise ValueError("serving_fault_tolerance.enabled=true needs "
                             "journal_path (or launch under ServingSupervisor, "
                             "which exports DSTPU_SERVING_JOURNAL and overrides "
                             "this section)")
        if self.heartbeat and not self.heartbeat_dir \
                and not os.environ.get(HEARTBEAT_DIR_ENV):
            raise ValueError("serving_fault_tolerance.heartbeat=true needs "
                             "heartbeat_dir (or launch under ServingSupervisor, "
                             "which exports DSTPU_HEARTBEAT_DIR)")


class ServingFleetConfig(ConfigModel):
    """Fleet front-end over N supervised serving replicas
    (``inference/v2/router.py``), with the JAX package's fields, defaults
    and bounds.

    ``replicas`` sizes the fleet the router fronts.  Admission is
    least-loaded-healthy: the router scores each replica from its last
    ``health()`` snapshot (queue depth weighted by ``queue_weight``, KV
    utilization by ``kv_weight``) and steers AWAY from any replica whose
    ``CapacityForecaster`` predicts KV exhaustion within
    ``exhaustion_steer_steps`` serve steps — pressure-avoidance before the
    replica ever sheds.  A snapshot older than ``health_stale_s`` (per its
    ``generated_at`` stamp) marks the replica unhealthy: a frozen replica's
    last-good gauges must not keep attracting traffic.

    ``affinity_blocks`` > 0 routes shared-header prompts by prefix
    affinity: the chained token-block hash (the ``PrefixCache`` keying) of
    the prompt's leading full blocks picks a stable home replica, so one
    header's prefix tree stays hot on one replica instead of lukewarm on all
    of them.  0 disables affinity (pure least-loaded).

    A retryable per-replica shed is never surfaced to the caller while
    budget remains: the router re-routes it up to ``max_reroutes`` times
    with exponential backoff (``backoff_base_s`` doubling per attempt,
    capped at ``backoff_max_s``), honoring the shed's ``retry_after_s``
    hint when the admission door supplied one.

    Failover: each replica keeps its own journal under its own
    ``ServingSupervisor`` (restart budget per ``serving_fault_tolerance``);
    a replica that exhausts its budget is drained and its journaled
    in-flight work MIGRATES to a healthy replica — emitted prefixes are
    copied into the target's journal with their ORIGINAL wall-clock admit
    stamps, so ``serve_recovered`` continues them byte-identically on
    their original TTL clocks.  Zero lost requests.
    """
    enabled: bool = False
    replicas: int = Field(2, ge=1)
    health_stale_s: float = Field(5.0, gt=0.0)
    affinity_blocks: int = Field(1, ge=0)  # full prompt blocks hashed; 0 = off
    max_reroutes: int = Field(3, ge=0)
    backoff_base_s: float = Field(0.05, ge=0.0)
    backoff_max_s: float = Field(2.0, gt=0.0)
    exhaustion_steer_steps: float = Field(32.0, gt=0.0)
    queue_weight: float = Field(1.0, ge=0.0)
    kv_weight: float = Field(8.0, ge=0.0)
    namespace: str = "dstpu"


class ServingQosConfig(ConfigModel):
    """Multi-tenant QoS policy over the v2 serving engine
    (``inference/v2/qos.py``: the *policy* layer on the admission,
    preemption and prefix-cache *mechanisms*), with the JAX package's
    fields, defaults and bounds.

    Every request carries a ``tenant`` id and a service class
    (``interactive`` / ``batch`` / ``best_effort``).  With
    ``enabled=false`` (the default) the layer is inert: requests get the
    default tenant, and dequeue order, prefix-cache keying and preemption
    victims are byte-identical to the policy-free engine.

    Front-door quotas (checked BEFORE any KV allocation, like every other
    shed): ``tenant_tokens_per_s`` rate-limits each tenant's admitted
    token volume through a token bucket of capacity ``tenant_token_burst``
    (0 disables; burst defaults to one second of rate).
    ``tenant_max_kv_blocks`` caps a tenant's RESIDENT KV blocks; a tenant
    at its cap is shed rather than allowed to starve its neighbors' pool.
    Both produce a structured, retryable ``quota_exceeded`` shed whose
    ``retry_after_s`` is the exact bucket refill time (rate) or a
    pressure-scaled hint (KV).  ``tenants`` maps tenant id to per-tenant
    overrides (``tokens_per_s`` / ``token_burst`` / ``max_kv_blocks``).

    Weighted-fair dequeue: the admission queue becomes per-class with
    deficit-round-robin on TOKEN cost — each visit grants a class
    ``drr_quantum_tokens * weight`` deficit, so interactive (weight 8 by
    default) drains ~8x the token volume of best-effort per round while
    best-effort still makes progress.  Priority ordering within a class is
    preserved.  The DRR state is pure arrival-sequence arithmetic (no clock
    reads), so dequeue order is deterministic and rerun-identical.

    ``preempt_over_quota`` steers KV-pressure preemption: victims are
    preferred over-quota-tenant first, then lower class, then the
    newest-prefill heuristic as the tie-break.

    Isolation: the tenant id is folded into the chained block-hash key, so
    cross-tenant prompts can NEVER share prefix blocks; the default tenant
    keeps the single-tenant keying, so its sharing is unchanged.
    """
    enabled: bool = False
    default_class: str = Field("interactive", choices=("interactive", "batch", "best_effort"))
    interactive_weight: int = Field(8, ge=1)
    batch_weight: int = Field(2, ge=1)
    best_effort_weight: int = Field(1, ge=1)
    drr_quantum_tokens: int = Field(64, ge=1)
    tenant_tokens_per_s: float = Field(0.0, ge=0.0)  # 0 => no rate quota
    tenant_token_burst: float = Field(0.0, ge=0.0)  # 0 => 1s of rate
    tenant_max_kv_blocks: int = Field(0, ge=0)  # 0 => no KV quota
    tenants: Dict[str, Any] = Field(dict)  # per-tenant quota overrides
    preempt_over_quota: bool = True


class ServingPerfConfig(ConfigModel):
    """Serving performance observatory for the v2 ragged engine
    (``monitor/perf.py`` wired through ``inference/v2``), with the JAX
    package's fields and defaults but one: ``hbm_gbps_spec`` defaults to the
    H100 SXM's 3350 GB/s.

    ``enabled`` turns on the StepPhaseProfiler: per-iteration phase spans
    (admission_pump / scatter_upload / dispatch / absorb_patch / burst /
    flush / expire / other) charged by reading the engine's injectable clock
    at phase boundaries, accumulated into deterministic-quantile streaming
    histograms, exported as ``serving_phase_*`` metric families, Chrome-trace
    phase tracks and an every-``phase_budget_every``-iterations phase-budget
    flight-recorder line, plus the live roofline gauges
    (``serving_hbm_bytes_per_token`` / ``serving_roofline_fraction`` /
    ``serving_model_flops_utilization``) against ``hbm_gbps_spec`` and
    ``peak_flops_per_chip``.  Off by default: phase marks READ the clock, and
    with the observatory off the engine performs no additional clock reads,
    so tokens and ``ServeCounters`` are byte-identical either way.

    The CompileLedger and the per-bucket cost notes are ALWAYS on regardless
    of ``enabled``: they add no clock reads and no device work.  The port's
    bucket cost is analytic (``models.llama.paged_bucket_cost``: the least
    FLOPs and bytes the bucket's forward must do and move), noted once at
    each bucket's build; ``capture_cost_analysis`` gates that note.
    """
    enabled: bool = False
    # emit a phase-budget flight-recorder line every N serve iterations
    phase_budget_every: int = Field(50, ge=1)
    # phase-span histogram shape; min_s is two decades below the request
    # histograms' 1e-5: phase spans are sub-iteration slivers
    histogram_buckets_per_decade: int = Field(6, ge=1, le=100)
    histogram_min_s: float = Field(1e-7, gt=0.0)
    # device-memory bandwidth for the roofline denominator (GB/s; 3350 is
    # the H100 SXM's HBM3)
    hbm_gbps_spec: float = Field(3350.0, gt=0.0)
    # per-device peak FLOPs for serving MFU; None leaves the MFU gauge at 0
    peak_flops_per_chip: Optional[float] = Field(None, gt=0.0)
    capture_cost_analysis: bool = True


class OpsServerConfig(ConfigModel):
    """Pull-based ops endpoints (``monitor/metrics.py`` +
    ``monitor/ops_server.py``), with the JAX package's fields and defaults: a
    Prometheus ``/metrics`` endpoint plus JSON ``/healthz``/``/statez``.

    ``enabled`` starts a stdlib ``ThreadingHTTPServer`` on ``host:port``
    (``port=0`` = ephemeral; read it from the owner's ``.ops.port``) serving
    ONLY host-side cached snapshots: the owning loop refreshes the cache at
    host-touch points it already pays for, at most once per
    ``refresh_interval_s``, so a scrape can never read a device value or race
    a mutating step.  The serving engine refreshes on its injectable clock;
    training refreshes at the telemetry record boundary.

    ``textfile_dir`` additionally publishes this process's registry as
    atomic per-rank files (``ops.rank<R>.json`` exact-merge snapshot +
    ``ops.rank<R>.prom`` rendered textfile).  ``ServingSupervisor`` exports
    ``DSTPU_OPS_DIR`` to its workers and merges their snapshots into one
    fleet-level endpoint whose counters stay monotone across worker
    restarts; the env wins over this field.
    """
    enabled: bool = False
    host: str = "127.0.0.1"
    port: int = Field(0, ge=0, le=65535)  # 0 => ephemeral
    refresh_interval_s: float = Field(0.25, ge=0.0)
    textfile_dir: Optional[str] = None
    namespace: str = "dstpu"


# ------------------------------------------------------------------ training
class TensorBoardConfig(ConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTPUJobName"


class WandbConfig(ConfigModel):
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed_tpu"


class CSVConfig(ConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTPUJobName"


class MonitorConfig(ConfigModel):
    """Reference: DeepSpeedMonitorConfig (monitor/config.py)."""
    tensorboard: TensorBoardConfig = Field(TensorBoardConfig)
    wandb: WandbConfig = Field(WandbConfig)
    csv_monitor: CSVConfig = Field(CSVConfig)


class CommsLoggerConfig(ConfigModel):
    """The ``comms_logger`` section (JAX ``runtime/config.py:154``).  The JAX
    engine logs its ``comm/`` collectives with it; the single-GPU port runs
    none, so ``enabled`` raises ``NotImplementedError`` naming ROADMAP item
    11 and the other fields are accepted."""
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = Field(list)

    def model_validate(self):
        if self.enabled:
            raise NotImplementedError("comms_logger.enabled=True: the collectives it logs belong "
                                      "to multi-GPU training, which is not ported to PyTorch yet "
                                      "(ROADMAP item 11)")


class FlopsProfilerConfig(ConfigModel):
    """The ``flops_profiler`` section (JAX ``runtime/config.py:189``), with
    its fields and bounds.  No JAX code reads them (``profiling/`` is driven
    by its callers), and none here either."""
    enabled: bool = False
    profile_step: int = Field(1, ge=0)
    module_depth: int = -1
    top_modules: int = Field(1, ge=1)
    detailed: bool = True
    output_file: Optional[str] = None


class MeshConfig(ConfigModel):
    """The ``mesh`` section (JAX ``runtime/config.py:258``): device-mesh axis
    sizes, one of which may be -1 (the devices left).  JAX's validation, then:
    a mesh that resolves to one device (every axis 1, or one axis -1 and the
    rest 1) is the port's one GPU; any larger size raises
    ``NotImplementedError`` naming ROADMAP item 11."""
    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1
    expert: int = 1
    pipe: int = 1
    axis_order: List[str] = Field(lambda: ["pipe", "data", "fsdp", "expert", "sequence",
                                           "tensor"])

    def model_validate(self):
        sizes = self.axis_sizes()
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"MeshConfig: at most one axis may be -1, got {wild}")
        for a, s in sizes.items():
            if s < 1 and s != -1:
                raise ValueError(f"MeshConfig.{a}={s} must be >=1 or -1")
        known = set(sizes)
        seen = set()
        for a in self.axis_order:
            if a not in known:
                raise ValueError(f"MeshConfig.axis_order: unknown axis {a!r}; valid axes: "
                                 f"{sorted(known)}")
            if a in seen:
                raise ValueError(f"MeshConfig.axis_order: duplicate axis {a!r}")
            seen.add(a)
        wide = {a: s for a, s in sizes.items() if s > 1}
        if wide:
            raise NotImplementedError(f"mesh {wide}: a mesh over more than one device belongs "
                                      f"to multi-GPU training, which is not ported to PyTorch "
                                      f"yet (ROADMAP item 11)")

    def axis_sizes(self):
        return {a: getattr(self, a) for a in ("data", "fsdp", "tensor", "sequence", "expert",
                                              "pipe")}


class GradientCompressionConfig(ConfigModel):
    """The ``gradient_compression`` section (JAX ``runtime/config.py:364``):
    accepted and read by no code, as in JAX."""
    enabled: bool = False
    freeze_step: int = Field(100, ge=0)


class TelemetryConfig(ConfigModel):
    """Unified telemetry (``monitor/telemetry.py``), with the JAX package's
    fields, defaults and validation.

    ``enabled`` (or a non-None ``jsonl_path``) turns on per-step structured
    records: loss, grad-norm, lr, step wall-time, samples/sec, tokens/sec, MFU
    and device-memory stats, fanned out to MonitorMaster and a rank-0 JSONL
    sink.

    ``profile_step_start``/``profile_step_stop`` open a ``torch.profiler``
    window over those global steps (a Chrome trace written into
    ``profile_dir`` when it closes), with a ``train_step#<n>`` range on each
    step and a ``batch_prep`` range; ``profile_serve_iteration_start``/
    ``_stop`` do the same over serve-loop iterations, one window per
    ``generate()``, with a range per serve phase.

    Cost: a per-step record needs the step's loss and wall-time, so enabling
    telemetry adds ONE host value-fetch (device sync) per train step: host
    work stops overlapping device execution, like ``wall_clock_breakdown``.
    """
    enabled: bool = False
    jsonl_path: Optional[str] = None
    # flush the JSONL sink every N records (1 = after every record; raise it
    # for high-rate streams such as per-request serving traces; close()
    # always flushes whatever is buffered)
    jsonl_flush_every: int = Field(1, ge=1)
    # -1 disables; [start, stop) in global steps
    profile_step_start: int = Field(-1, ge=-1)
    profile_step_stop: int = Field(-1, ge=-1)
    profile_dir: str = "profiler_traces"
    # -1 disables; [start, stop) in serve-loop iterations, one window per
    # generate() call
    profile_serve_iteration_start: int = Field(-1, ge=-1)
    profile_serve_iteration_stop: int = Field(-1, ge=-1)
    # see_memory_usage(tag) at each steps_per_print boundary (also honors the
    # reference's top-level memory_breakdown key)
    memory_breakdown: bool = False
    # per-device peak FLOPs override for MFU; None => detect from the device name
    peak_flops_per_chip: Optional[float] = Field(None, gt=0.0)

    def model_validate(self):
        if self.jsonl_path is not None and not self.enabled:
            object.__setattr__(self, "enabled", True)
        if (self.profile_step_stop >= 0 and self.profile_step_start >= 0
                and self.profile_step_stop <= self.profile_step_start):
            raise ValueError(f"telemetry: profile_step_stop={self.profile_step_stop} must be "
                             f"> profile_step_start={self.profile_step_start}")
        if (self.profile_serve_iteration_stop >= 0
                and self.profile_serve_iteration_start >= 0
                and self.profile_serve_iteration_stop <= self.profile_serve_iteration_start):
            raise ValueError(
                f"telemetry: profile_serve_iteration_stop={self.profile_serve_iteration_stop} "
                f"must be > profile_serve_iteration_start={self.profile_serve_iteration_start}")


class FP16Config(ConfigModel):
    """fp16 compute with loss scaling (``deepspeed_tpu/runtime/config.py``
    FP16Config): ``loss_scale`` 0 is dynamic, starting at
    ``2**initial_scale_power``, halved on overflow after ``hysteresis``
    overflows and doubled after ``loss_scale_window`` clean steps, never
    below ``min_loss_scale``; ``loss_scale > 0`` is a static scale.
    ``auto_cast`` is parsed and read by nothing, as in JAX."""
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = Field(0.0, ge=0.0)  # 0 => dynamic
    initial_scale_power: int = Field(16, ge=0)
    loss_scale_window: int = Field(1000, ge=1)
    hysteresis: int = Field(2, ge=1)
    consecutive_hysteresis: bool = False
    min_loss_scale: float = Field(1.0, ge=0.0)


class BF16Config(ConfigModel):
    """bf16 compute; on unless fp16 is asked for, as in the JAX package."""
    enabled: bool = True


class CheckpointSectionConfig(ConfigModel):
    """The ``checkpoint`` section (``deepspeed_tpu/runtime/config.py``
    CheckpointSectionConfig): ``checkpoint_engine`` selects the plug-in of
    ``runtime/checkpoint_engine`` (``native``/``torch`` synchronous,
    ``async``/``nebula`` a background writer).  ``keep_last_n`` deletes tags
    beyond the newest N after each save (never the newest VALID one);
    ``verify_integrity`` re-checks each leaf's CRC32 at load;
    ``save_retries``/``retry_backoff_secs`` bound the exponential-backoff
    retries of a save over a transient ``OSError``; ``save_on_preemption``
    installs a SIGTERM handler that makes one best-effort final save (tag
    ``preempt_step<N>``, ``client_state["preempted"]`` true) before the
    process dies.  ``tag_validation``, ``use_node_local_storage`` and
    ``parallel_write`` are parsed as JAX parses them and read by nothing: the
    port saves from one process.  An unknown key raises, where JAX keeps
    it."""
    checkpoint_engine: str = Field("native", choices=("native", "torch", "async", "nebula"))
    async_max_queue: int = Field(64, ge=1)
    tag_validation: Optional[str] = Field(None, choices=(None, "Ignore", "Warn", "Fail",
                                                         "ignore", "warn", "fail"))
    use_node_local_storage: bool = False
    parallel_write: Optional[Dict[str, Any]] = None
    keep_last_n: Optional[int] = Field(None, ge=1)
    verify_integrity: bool = False
    save_retries: int = Field(2, ge=0)
    retry_backoff_secs: float = Field(0.5, ge=0.0)
    save_on_preemption: bool = False


class NebulaConfig(ConfigModel):
    """The top-level ``nebula`` section: ``enabled`` selects the async
    (background-writer) checkpoint engine; the other fields are parsed as
    JAX parses them and read by nothing.  An unknown key raises, where JAX
    keeps it."""
    enabled: bool = False
    persistent_storage_path: Optional[str] = None
    persistent_time_interval: int = Field(100, ge=1)
    num_of_version_in_retention: int = Field(2, ge=1)
    enable_nebula_load: bool = True


class OffloadParamConfig(ConfigModel):
    """``zero_optimization.offload_param``, JAX's fields (the reference's
    DeepSpeedZeroOffloadParamConfig).  Read: ``device`` (only ``nvme``
    engages layer streaming; ``cpu`` alone changes nothing, as in JAX),
    ``nvme_path`` and ``buffer_count`` (the host buffer pool).
    ``buffer_size``, ``max_in_cpu`` and ``pin_memory`` are accepted and read
    by nothing, as in JAX (no pool buffer is copied to the GPU)."""
    device: str = Field("none", choices=("none", "cpu", "nvme"))
    nvme_path: Optional[str] = None
    buffer_count: int = Field(5, ge=1)
    buffer_size: int = Field(10**8, ge=1)
    max_in_cpu: int = Field(10**9, ge=0)
    pin_memory: bool = False


class OffloadOptimizerConfig(ConfigModel):
    """``zero_optimization.offload_optimizer``, JAX's fields (the reference's
    DeepSpeedZeroOffloadOptimizerConfig).  Read: ``device`` (``cpu``: master
    params and moments in host RAM; ``nvme``: the moments on disk under
    ``nvme_path``) and, on a CUDA engine, ``pin_memory`` (one page-locked
    buffer for the master params and one for the grads' staging).
    ``buffer_count``, ``pipeline_read``, ``pipeline_write``, ``fast_init``
    and ``ratio`` are accepted and read by nothing, as in JAX."""
    device: str = Field("none", choices=("none", "cpu", "nvme"))
    nvme_path: Optional[str] = None
    buffer_count: int = Field(4, ge=1)
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = Field(1.0, ge=0.0, le=1.0)


class ZeroConfig(ConfigModel):
    """The ``zero_optimization`` section with JAX's fields, defaults and
    bounds.  Every stage is accepted: the port trains on one device, where
    ZeRO has no data-parallel group to partition params, grads or optimizer
    state over, so each stage runs the same step.  The offload sections act
    (ZeRO-Offload, ZeRO-Infinity); the bucket, persistence, ZeRO++ and MiCS
    knobs size collectives and partitions and are accepted and unused, as
    they are on one device in JAX."""
    stage: int = Field(0, ge=0, le=3)
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = Field(int(5e8), ge=0)
    allgather_partitions: bool = True
    allgather_bucket_size: int = Field(int(5e8), ge=0)
    overlap_comm: Optional[bool] = None
    round_robin_gradients: bool = False
    offload_param: Optional[OffloadParamConfig] = None
    offload_optimizer: Optional[OffloadOptimizerConfig] = None
    sub_group_size: int = Field(int(1e9), ge=0)
    prefetch_bucket_size: int = Field(int(5e7), ge=0,
                                      deprecated_names=("stage3_prefetch_bucket_size", ))
    param_persistence_threshold: int = Field(
        int(1e5), ge=0, deprecated_names=("stage3_param_persistence_threshold", ))
    model_persistence_threshold: int = Field(
        int(1e14), ge=0, deprecated_names=("stage3_model_persistence_threshold", ))
    max_live_parameters: int = Field(int(1e9), ge=0,
                                     deprecated_names=("stage3_max_live_parameters", ))
    max_reuse_distance: int = Field(int(1e9), ge=0,
                                    deprecated_names=("stage3_max_reuse_distance", ))
    gather_16bit_weights_on_model_save: bool = Field(
        False, deprecated_names=("stage3_gather_16bit_weights_on_model_save", ))
    ignore_unused_parameters: bool = True
    zero_hpz_partition_size: int = Field(1, ge=1)
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    mics_shard_size: int = Field(-1, deprecated_names=("mics_shard_size_", ))
    mics_hierarchical_params_gather: bool = False
    elastic_checkpoint: bool = False

    def model_validate(self):
        if self.overlap_comm is None:
            # JAX's (and the reference's) default: on for stage 3
            object.__setattr__(self, "overlap_comm", self.stage == 3)


class OptimizerConfig(ConfigModel):
    type: str = "adamw"
    params: Dict[str, Any] = Field(dict)


class SchedulerConfig(ConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = Field(dict)


class SparseAttentionConfig(ConfigModel):
    """Block-sparse attention section (``deepspeed_tpu/runtime/config.py``
    SparseAttentionConfig: mode and per-mode knobs).  ``build(num_heads)``
    resolves the matching SparsityConfig from ``ops/sparse_attention``."""
    mode: str = Field("fixed", choices=("dense", "fixed", "variable", "bigbird", "bslongformer",
                                        "local"))
    block: int = Field(16, ge=8)  # a multiple of 8; see model_validate
    different_layout_per_head: bool = False
    # fixed / variable
    num_local_blocks: int = Field(4, ge=1)
    num_global_blocks: int = Field(1, ge=1)
    # None -> per-mode default: "unidirectional" for local, "bidirectional" elsewhere
    attention: Optional[str] = Field(None, choices=(None, "unidirectional", "bidirectional"))
    horizontal_global_attention: bool = False
    num_different_global_patterns: int = Field(1, ge=1)
    # variable / bigbird; None -> per-mode default (bigbird: 1, variable: 0)
    num_random_blocks: Optional[int] = Field(None, ge=0)
    local_window_blocks: Optional[List[int]] = None
    global_block_indices: Optional[List[int]] = None
    global_block_end_indices: Optional[List[int]] = None
    # bigbird / bslongformer / local
    num_sliding_window_blocks: int = Field(3, ge=1)
    # seeds the random-block placement (variable / bigbird), so that every
    # process derives the same layout from the config alone
    seed: int = Field(1234, ge=0)

    def model_validate(self):
        if self.block % 8 != 0:
            raise ValueError(f"sparse_attention.block={self.block} must be a multiple of 8, as in "
                             f"the JAX package; the kernels take any multiple of 8")

    def build(self, num_heads: int):
        from ..ops.sparse_attention import (BigBirdSparsityConfig, BSLongformerSparsityConfig,
                                            DenseSparsityConfig, FixedSparsityConfig,
                                            LocalSlidingWindowSparsityConfig,
                                            VariableSparsityConfig)
        attention = self.attention or ("unidirectional" if self.mode == "local" else
                                       "bidirectional")
        if self.mode == "dense":
            return DenseSparsityConfig(num_heads, self.block, self.different_layout_per_head)
        if self.mode == "fixed":
            return FixedSparsityConfig(
                num_heads, self.block, self.different_layout_per_head, self.num_local_blocks,
                self.num_global_blocks, attention, self.horizontal_global_attention,
                self.num_different_global_patterns)
        if self.mode == "variable":
            return VariableSparsityConfig(
                num_heads, self.block, self.different_layout_per_head,
                self.num_random_blocks or 0, self.local_window_blocks, self.global_block_indices,
                self.global_block_end_indices, attention, self.horizontal_global_attention,
                seed=self.seed)
        if self.mode == "bigbird":
            num_random = self.num_random_blocks if self.num_random_blocks is not None else 1
            return BigBirdSparsityConfig(
                num_heads, self.block, self.different_layout_per_head, num_random,
                self.num_sliding_window_blocks, self.num_global_blocks, attention, seed=self.seed)
        if self.mode == "bslongformer":
            return BSLongformerSparsityConfig(
                num_heads, self.block, self.different_layout_per_head,
                self.num_sliding_window_blocks, self.global_block_indices,
                self.global_block_end_indices, attention)
        return LocalSlidingWindowSparsityConfig(num_heads, self.block,
                                                self.num_sliding_window_blocks, attention)


class ActivationCheckpointingConfig(ConfigModel):
    """The ``activation_checkpointing`` section (JAX ``runtime/config.py:126``).
    Remat belongs to the model (``LlamaConfig.remat_policy``): the engine
    logs a non-default request and applies nothing, as the JAX engine does."""
    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: str = Field("nothing_saveable",
                        choices=("everything_saveable", "nothing_saveable", "dots_saveable",
                                 "dots_with_no_batch_dims_saveable", "checkpoint_dots",
                                 "save_anything_except_these_names", "offload_dot",
                                 "offload_residuals"))


class FaultToleranceConfig(ConfigModel):
    """The training ``fault_tolerance`` section (JAX ``runtime/config.py:399``).
    ``heartbeat`` arms the engine's per-rank liveness stamps
    (``runtime/heartbeat.py``: step, wall clock and phase in
    ``<heartbeat_dir>/hb.rank<R>.json``, at most one write per
    ``heartbeat_interval_s``, no device sync); ``DSTPU_HEARTBEAT_DIR`` arms
    them without the section.  ``collective_timeout_s`` and ``init_retries*``
    bound multi-process collectives and process-group setup, which the
    single-GPU port does not have: set away from their defaults they raise
    ``NotImplementedError`` naming ROADMAP item 11."""
    heartbeat: bool = False
    heartbeat_dir: Optional[str] = None
    heartbeat_interval_s: float = Field(1.0, ge=0.0)
    collective_timeout_s: Optional[float] = Field(None, gt=0.0)
    init_retries: int = Field(3, ge=0)
    init_retry_backoff_s: float = Field(0.5, ge=0.0)

    def model_validate(self):
        import os

        from .heartbeat import HEARTBEAT_DIR_ENV
        if self.heartbeat and not self.heartbeat_dir and not os.environ.get(HEARTBEAT_DIR_ENV):
            raise ValueError("fault_tolerance.heartbeat=true needs heartbeat_dir "
                             "(or launch under the elastic agent, which exports "
                             "DSTPU_HEARTBEAT_DIR and overrides this section)")
        for name, default in (("collective_timeout_s", None), ("init_retries", 3),
                              ("init_retry_backoff_s", 0.5)):
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"fault_tolerance.{name}={getattr(self, name)!r}: bounded collectives and "
                    f"process-group retries belong to multi-GPU training, which is not ported "
                    f"to PyTorch yet (ROADMAP item 11)")


class DataSamplingConfig(ConfigModel):
    """``data_efficiency.data_sampling``: its ``curriculum_learning`` dict
    feeds the CurriculumScheduler (the flat schedule form or
    ``curriculum_metrics``, whose ``seqlen`` metric truncates batches).  An
    unknown key raises, where JAX keeps it."""
    enabled: bool = True
    num_workers: int = 0
    curriculum_learning: Dict[str, Any] = Field(dict)


class DataRoutingConfig(ConfigModel):
    """``data_efficiency.data_routing``: random-LTD (its ``random_ltd`` dict
    feeds ``RandomLTDScheduler``)."""
    enabled: bool = False
    random_ltd: Dict[str, Any] = Field(dict)


class DataEfficiencyConfig(ConfigModel):
    """The ``data_efficiency`` section (JAX ``runtime/config.py:920-975``):
    curriculum sampling drives the dataloader ``initialize(training_data=)``
    builds; data routing scopes random-LTD around the loss function."""
    enabled: bool = False
    seed: int = Field(1234, ge=0)
    data_sampling: DataSamplingConfig = Field(DataSamplingConfig)
    data_routing: DataRoutingConfig = Field(DataRoutingConfig)

    def curriculum_dict(self) -> Optional[Dict[str, Any]]:
        """The CurriculumScheduler config when curriculum sampling is active,
        else None."""
        cl = dict(self.data_sampling.curriculum_learning or {})
        if not (self.enabled and self.data_sampling.enabled and cl.pop("enabled", False)):
            return None
        metrics = cl.pop("curriculum_metrics", None)
        if metrics:
            name = "seqlen" if "seqlen" in metrics else next(iter(metrics))
            if len(metrics) > 1:
                logging.getLogger(__name__).warning(
                    f"data_efficiency curriculum_metrics: multiple metrics configured; using "
                    f"{name!r} for difficulty (seqlen truncation)")
            return dict(metrics[name])
        return cl or None


# sections of the JAX TrainingConfig that change what a step computes and are
# not ported yet: none, every field of JAX's TrainingConfig is one here; any
# other key raises ValueError
UNPORTED_TRAINING_SECTIONS = ()


class TrainingConfig(ConfigModel):
    """The training config the port's engine reads: the batch triple,
    optimizer, scheduler, precision (bf16 by default, fp16 with loss scaling
    under ``"fp16": {"enabled": true}``, fp32 with ``"bf16": {"enabled":
    false}``), gradient clipping, seed, print cadence, the ZeRO stage and
    its ``offload_optimizer``/``offload_param`` sections, block-sparse
    attention, checkpoints (``checkpoint``, ``nebula``,
    ``checkpoint_tag_validation``, ``load_universal_checkpoint``),
    ``activation_checkpointing``,
    ``data_efficiency`` (curriculum and random-LTD) and the legacy
    ``curriculum_learning``, the watchdog (``max_consecutive_skips``), the
    ``fault_tolerance`` heartbeat, the monitor writers, telemetry and the
    ops endpoints; the serving sections, so that one dict configures the
    training and the serving engines; and every other field of JAX's
    ``TrainingConfig`` (each commented below with what the port does with
    it).  Load it with :func:`load_config`, which raises on a key it does not
    know."""
    train_batch_size: Optional[int] = Field(None, ge=1)
    train_micro_batch_size_per_gpu: Optional[int] = Field(None, ge=1)
    gradient_accumulation_steps: Optional[int] = Field(None, ge=1)
    steps_per_print: int = Field(10, ge=1)
    gradient_clipping: float = Field(0.0, ge=0.0)
    seed: int = 1234
    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    fp16: FP16Config = Field(FP16Config)
    bf16: Optional[BF16Config] = None
    zero_optimization: ZeroConfig = Field(ZeroConfig)
    sparse_attention: Optional[SparseAttentionConfig] = None
    activation_checkpointing: ActivationCheckpointingConfig = Field(ActivationCheckpointingConfig)
    data_efficiency: DataEfficiencyConfig = Field(DataEfficiencyConfig)
    # the legacy top-level curriculum section (effective_curriculum)
    curriculum_learning: Optional[Dict[str, Any]] = None
    # the train-loop watchdog: NonFiniteLossError after this many consecutive
    # bad steps (fp16 skipped steps; non-finite loss or grad norm in bf16 and
    # fp32); 0 disables
    max_consecutive_skips: int = Field(0, ge=0)
    fault_tolerance: FaultToleranceConfig = Field(FaultToleranceConfig)
    # monitor writers (TensorBoard / W&B / CSV), top level or under
    # monitor_config, per-step telemetry and the pull-based ops endpoints
    monitor_config: Optional[MonitorConfig] = None
    tensorboard: TensorBoardConfig = Field(TensorBoardConfig)
    wandb: WandbConfig = Field(WandbConfig)
    csv_monitor: CSVConfig = Field(CSVConfig)
    telemetry: TelemetryConfig = Field(TelemetryConfig)
    ops_server: OpsServerConfig = Field(OpsServerConfig)
    checkpoint: CheckpointSectionConfig = Field(CheckpointSectionConfig)
    nebula: NebulaConfig = Field(NebulaConfig)
    checkpoint_tag_validation: str = Field("Warn", choices=("Ignore", "Warn", "Fail", "ignore",
                                                            "warn", "fail"))
    load_universal_checkpoint: bool = False
    use_node_local_storage: bool = False
    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False
    # JAX acts on these, and one GPU acts the same way: a mesh that resolves
    # to one device; the serving sections, validated by the models the
    # serving engines read (one dict configures both engines); elasticity, a
    # dict read by elasticity.compute_elastic_config
    mesh: MeshConfig = Field(MeshConfig)
    serving_resilience: ServingResilienceConfig = Field(ServingResilienceConfig)
    serving_fastpath: ServingFastpathConfig = Field(ServingFastpathConfig)
    serving_spec_decode: ServingSpecDecodeConfig = Field(ServingSpecDecodeConfig)
    serving_tracing: ServingTracingConfig = Field(ServingTracingConfig)
    serving_fault_tolerance: ServingFaultToleranceConfig = Field(ServingFaultToleranceConfig)
    serving_kv_observability: KVObservabilityConfig = Field(KVObservabilityConfig)
    serving_prefix_cache: ServingPrefixCacheConfig = Field(ServingPrefixCacheConfig)
    serving_perf: ServingPerfConfig = Field(ServingPerfConfig)
    serving_fleet: ServingFleetConfig = Field(ServingFleetConfig)
    serving_qos: ServingQosConfig = Field(ServingQosConfig)
    elasticity: Optional[Dict[str, Any]] = None
    # JAX acts on these, and acting needs more than one GPU: a mesh over
    # several devices and comms_logger.enabled raise NotImplementedError
    # naming ROADMAP item 11 (MeshConfig, CommsLoggerConfig)
    comms_logger: CommsLoggerConfig = Field(CommsLoggerConfig)
    # no JAX code reads these: accepted and ignored, as in JAX; autotuning
    # stays a dict until the autotuner is ported
    prescale_gradients: bool = False
    gradient_predivide_factor: float = Field(1.0, gt=0.0)
    sparse_gradients: bool = False
    communication_data_type: Optional[str] = None
    gradient_compression: GradientCompressionConfig = Field(GradientCompressionConfig)
    flops_profiler: FlopsProfilerConfig = Field(FlopsProfilerConfig)
    dump_state: bool = False
    autotuning: Optional[Dict[str, Any]] = None

    def model_validate(self):
        if self.memory_breakdown and not self.telemetry.memory_breakdown:
            # the reference's top-level memory_breakdown key routes to the
            # see_memory_usage cadence the telemetry section controls
            object.__setattr__(self.telemetry, "memory_breakdown", True)
        if self.fp16.enabled and self.bf16 is not None and self.bf16.enabled:
            raise ValueError("fp16 and bf16 cannot both be enabled")
        if self.bf16 is None:
            # bf16 on unless fp16 is asked for, as in the JAX package
            object.__setattr__(self, "bf16", BF16Config(enabled=not self.fp16.enabled))
        if self.checkpoint.tag_validation is not None:
            object.__setattr__(self, "checkpoint_tag_validation", self.checkpoint.tag_validation)

    def resolve_batch_sizes(self, dp_world_size: int):
        """(train_batch, micro_batch, gas), solving for any missing member of
        train_batch = micro_batch * gas * dp_world_size; raises on an
        inconsistent triple."""
        tb, mb, gas = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp_world_size:
                raise ValueError(f"train_batch_size={tb} != micro_batch({mb}) * gas({gas}) * "
                                 f"dp_world({dp_world_size})")
        elif tb is not None and mb is not None:
            if tb % (mb * dp_world_size) != 0:
                raise ValueError(f"train_batch_size={tb} not divisible by micro_batch*dp="
                                 f"{mb * dp_world_size}")
            gas = tb // (mb * dp_world_size)
        elif tb is not None and gas is not None:
            if tb % (gas * dp_world_size) != 0:
                raise ValueError(f"train_batch_size={tb} not divisible by gas*dp="
                                 f"{gas * dp_world_size}")
            mb = tb // (gas * dp_world_size)
        elif mb is not None:
            gas = gas or 1
            tb = mb * gas * dp_world_size
        elif tb is not None:
            mb = tb // dp_world_size
            if mb == 0 or tb % dp_world_size != 0:
                raise ValueError(f"train_batch_size={tb} not divisible by dp_world_size="
                                 f"{dp_world_size}")
            gas = 1
        else:
            raise ValueError("One of train_batch_size or train_micro_batch_size_per_gpu must "
                             "be set")
        object.__setattr__(self, "train_batch_size", tb)
        object.__setattr__(self, "train_micro_batch_size_per_gpu", mb)
        object.__setattr__(self, "gradient_accumulation_steps", gas)
        return tb, mb, gas

    def checkpoint_engine_kind(self) -> str:
        """The checkpoint engine plug-in: the ``nebula`` section wins, else
        ``checkpoint.checkpoint_engine``."""
        if self.nebula.enabled:
            return "async"
        return self.checkpoint.checkpoint_engine

    def effective_curriculum(self) -> Optional[Dict[str, Any]]:
        """The curriculum schedule dict from the data_efficiency section or
        the legacy top-level curriculum_learning one; None when neither is
        active."""
        cur = self.data_efficiency.curriculum_dict()
        if cur is not None:
            return cur
        legacy = dict(self.curriculum_learning or {})
        if legacy.pop("enabled", False):
            return legacy
        return None

    @property
    def precision_dtype(self):
        if self.fp16.enabled:
            return torch.float16
        return torch.bfloat16 if self.bf16.enabled else torch.float32


def load_config(config: Union[str, dict, TrainingConfig, None]) -> TrainingConfig:
    """A TrainingConfig from a JSON file path, a dict or a TrainingConfig.
    A section in ``UNPORTED_TRAINING_SECTIONS`` raises ``NotImplementedError``
    naming it and any other unknown key raises ``ValueError``, so a config is
    never half-applied."""
    if config is None:
        return TrainingConfig()
    if isinstance(config, TrainingConfig):
        return config
    if isinstance(config, str):
        with open(config, "r") as fh:
            config = json.load(fh)
    if not isinstance(config, dict):
        raise TypeError(f"config must be a path, dict, or TrainingConfig; got {type(config)}")
    # the ZeRO aliases JAX's load_config drops
    config = {k: v for k, v in config.items()
              if k not in ("zero_allow_untested_optimizer", "zero_force_ds_cpu_optimizer")}
    unported = [k for k in UNPORTED_TRAINING_SECTIONS if k in config]
    if unported:
        raise NotImplementedError(f"the PyTorch port does not implement the training config "
                                  f"section(s) {unported} yet")
    return TrainingConfig(**config)
