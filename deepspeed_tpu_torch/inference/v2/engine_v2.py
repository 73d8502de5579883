"""Continuous-batching inference engine (FastGen analog).

Counterpart of ``deepspeed_tpu/inference/v2/engine_v2.py``: ``put()``
enqueues requests, each ``step()`` runs ONE ragged forward over a
SplitFuse-scheduled token batch against the paged KV pool and picks the next
token of every sequence that produced one, and ``generate()`` serves a batch
to completion through the admission queue, deadline eviction and the
progress watchdog.

The ragged batch is padded to power-of-two (sequences, chunk) buckets, as
the JAX engine pads it.  With ``serving_fastpath.enabled`` (the default) the
engine runs the JAX engine's fast path:

- each bucket's batch lives on the device (``fastpath.DeviceBatchState``)
  and a step uploads only the rows that changed, in one packed scatter;
- sampled tokens stay on the device behind ``fastpath.DeferredTokens``; the
  serve loop dispatches step N before it absorbs step N-1, and a decode row
  whose input token is still in flight is fed on the device;
- a pure-decode live set runs as one fused burst of k steps with eos
  done-masks and one host sync;
- table widths grow in steps of ``TABLE_STEP`` slots with hysteresis, and
  ``generate()`` prewarms the buckets its requests are about to hit;
- on the card every bucket forward and every burst step is replayed from a
  captured CUDA graph (``cuda_graphs.py``).

With the fast path off the engine runs the JAX reference loop: the
rebuild-and-upload step with one sync a step, pow2 table widths, and the
same decode bursts, all eager (no graphs) on the card.

Copy-on-write prefix caching (``serving_prefix_cache``, on by default as in
the JAX engine): a request whose leading full prompt blocks are live in the
pool maps them read-only and prefills only its tail; a prompt cached to its
last token gets a private copy of its final block (``_cow_copy_block``, the
one device action of the cache, written in place into the KV pool the
graphs captured).  KV-pool observability (``serving_kv_observability``, on
by default): the block census, the counterfactual prefix observatory and the
capacity forecast of ``kv_metrics.py``, refreshed from host ints every step,
and the census invariant checked after every serve pass.

Request tracing (``serving_tracing``, off by default as in the JAX engine):
one span chain per request (queue_wait -> prefill -> decode, requeue spans
around preemptions, one terminal event matching its ``RequestResult``),
TTFT/TBT/e2e/queue-wait histograms, and a Chrome trace with one track per
request and the ``kv_pool`` counter track; the flight recorder of recent
engine events is always on and rides ``health()``, ``state_snapshot()``
and the stall dump.  The tracer reads only the engine's injectable clock,
at points the host already touches, and never syncs the device.

Serving fault tolerance (``serving_fault_tolerance``, off by default as in
the JAX engine, or armed by ``ServingSupervisor``'s env exports): a durable
CRC-framed request journal (``journal.py``: every admit, the emitted tokens
at each wave boundary, every terminal) and a serve-iteration liveness
heartbeat (``runtime/heartbeat.py``), both from host ints the loop already
holds; ``serve_recovered`` re-admits journaled requests with the prefix
they already emitted (``supervisor.py`` drives it after a crash).

Observability (the JAX engine's seams): a ``telemetry=``
``TelemetryCollector`` receives the scheduler's and the engine's serving
gauges, the resilience events and, with ``serving_tracing.trace_jsonl``, one
``kind: trace`` record per request, and drives the serve-iteration
``torch.profiler`` window; ``serving_perf`` turns on the phase profiler of
the serve loop and the live roofline (``monitor/perf.py``, costed per bucket
at its build); ``ops_server`` (or a supervisor's ``DSTPU_OPS_DIR``) publishes
``/metrics``, ``/healthz`` and ``/statez`` from host snapshots refreshed by
the loop, throttled on the engine clock.  None of them syncs the device.

Multi-tenant QoS (``serving_qos``, off by default as in the JAX engine): per-
tenant token-rate and resident-KV quotas shed as retryable
``quota_exceeded`` with an exact ``retry_after_s``, weighted-fair dequeue
across the ``interactive`` / ``batch`` / ``best_effort`` classes, and
preemption steered to over-quota tenants and lower classes (``qos.py``);
``generate``/``put`` take ``tenants``/``service_classes``.  Off, the engine
builds no policy and its tokens, counters, journal and exposition are those
of the policy-free engine.

Speculative decoding (``serving_spec_decode``, off by default as in the JAX
engine): on a pure-decode fused window a drafter (prompt lookup on the host,
or a draft model over a pool of its own, ``attach_draft_model``) proposes k
tokens a sequence, one target forward over the paged pool at width k+1
scores them (a captured graph per ``(n, k, b, sample)`` verify bucket on
the card), and rejection sampling on the device emits the
accepted prefix plus one token, absorbed in one host sync (``spec_decode.py``,
``fastpath.DeferredRuns``).  An adaptive k walks a static ladder of
prewarmed verify widths and falls back to the plain burst at its floor.
Off, the engine builds no drafter, controller or stats.

The engine runs on ``device="cuda"`` unless the caller asks for the CPU; it
never falls back from one to the other.  Tensor parallelism of the JAX engine
is not ported yet.
"""

import collections
import contextlib
import functools
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ...monitor.metrics import populate_from_engine
from ...monitor.ops_server import OpsPublisher
from ...monitor.perf import CompileLedger, RooflineModel, StepPhaseProfiler
from ...monitor.tracing import RequestTracer
from ...runtime.heartbeat import (HEARTBEAT_DIR_ENV, HEARTBEAT_INTERVAL_ENV, NULL_HEARTBEAT,
                                  OPS_DIR_ENV, SERVING_FSYNC_ENV, SERVING_GENERATION_ENV,
                                  SERVING_JOURNAL_ENV, HeartbeatWriter)
from ...utils.env import env_float, env_int
from ..config import DTYPES as _DTYPES, load_inference_config
from ..engine import _sample
from .admission import (DEADLINE_EXPIRED, FAILED, OK, PREEMPT_REQUEUED_EXHAUSTED, SHED,
                        AdmissionQueue, RecoveredRequest, RequestResult, ServingStalledError)
from .blocked_allocator import KVAllocationError
from .cuda_graphs import BucketPrograms
from .fastpath import (FED_SENTINEL, PENDING_TOKEN, DeferredRuns, DeferredTokens,
                       DeviceBatchState, ServeCounters, materialize, round_up_pow2, upload)
from .journal import RequestJournal, journal_bytes
from .kv_metrics import KVObservability
from .qos import QosPolicy
from .ragged_manager import PrefixCache, RaggedStateManager
from .scheduler import SplitFuseScheduler
from .spec_decode import (AdaptiveKController, ModelDrafter, NgramDrafter, SpecDecodeStats,
                          rejection_select)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("InferenceEngineV2: device 'cuda' requested (the default) but no "
                           "CUDA device is available; pass device='cpu' to run the plain "
                           "PyTorch path on the CPU")
    return device


def _tree_to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device=device, dtype=dtype)


def _last_rows(logits, n_tokens):
    """Each row's logits at its last valid position: [N, T, V] -> [N, V]."""
    last = torch.clamp(n_tokens.long() - 1, min=0)
    return logits[torch.arange(logits.shape[0], device=logits.device), last]


class InferenceEngineV2:

    # decode-burst length while any live request carries a deadline OR the
    # admission queue is non-empty: deadlines are enforced between host round
    # trips, so this bounds eviction overshoot and admission latency
    BURST_DEADLINE_SLICE = 8
    # fast-path table widths grow in TABLE_STEP block-table slots and shrink
    # only after TABLE_SHRINK_PATIENCE consecutive steps of a full step of
    # slack, so one long sequence joining or leaving does not rebuild every
    # (n, t) bucket it touches
    TABLE_STEP = 4
    TABLE_SHRINK_PATIENCE = 16

    def __init__(self, model_module, model_config, params, config: Optional[Dict] = None,
                 num_blocks: int = 512, block_size: int = 16,
                 max_blocks_per_seq: int = 64, token_budget: int = 256,
                 max_seqs_per_step: int = 32, clock: Optional[Callable[[], float]] = None,
                 device="cuda", journal: Optional[RequestJournal] = None, telemetry=None):
        self.config = load_inference_config(config)
        self.device = resolve_device(device)
        self.model = model_module
        self.model_config = model_config
        self.dtype = _DTYPES[self.config.dtype]
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.manager = RaggedStateManager(num_blocks, block_size, max_blocks_per_seq)
        # copy-on-write prefix caching (the block copy is installed below,
        # once the KV pool exists)
        self.prefix_cfg = self.config.serving_prefix_cache
        if self.prefix_cfg.enabled:
            self.manager.prefix_cache = PrefixCache(
                block_size, cow=self.prefix_cfg.cow,
                defer_shared_prefill=self.prefix_cfg.defer_shared_prefill)
        # block-level KV-pool observability: census, prefix-sharing
        # opportunity and capacity forecast, all from host state
        self.kv_cfg = self.config.serving_kv_observability
        self.kv_obs: Optional[KVObservability] = None
        if self.kv_cfg.enabled:
            self.kv_obs = KVObservability(
                block_size, num_blocks, self.manager.trash_block,
                ewma_alpha=self.kv_cfg.ewma_alpha, pressure_steps=self.kv_cfg.pressure_steps,
                age_buckets_per_decade=self.kv_cfg.age_buckets_per_decade)
            self.manager.census = self.kv_obs.census
        # serve-step clock of the KV census: a stepwise dispatch counts 1, a
        # fused burst of k counts k (the scheduler's steps skip bursts)
        self._kv_steps = 0
        # telemetry: a monitor.TelemetryCollector; the scheduler emits its
        # gauges through it and the engine adds the serving gauges
        self.telemetry = telemetry
        # admission control + load shedding in front of the manager, deadlines
        # on an injectable clock, preemption policy shared with the scheduler
        self.resilience = self.config.serving_resilience
        self._clock = clock if clock is not None else time.monotonic
        # an injected clock makes gauge timestamps deterministic too: gauge
        # records stamp the engine clock's last read instead of wall time
        self._clock_injected = clock is not None
        # request-lifecycle tracing: span chains per uid, SLO latency
        # histograms and the always-on flight recorder, on the injectable
        # clock only, at points the host already touches (no device syncs)
        self.tracer = RequestTracer(self.config.serving_tracing, clock=self._clock,
                                    telemetry=telemetry)
        # multi-tenant QoS: per-tenant quotas + weighted-fair dequeue +
        # victim steering.  Constructed only when the section is armed —
        # self.qos is None otherwise and every downstream seam (admission,
        # scheduler, metrics) keeps its policy-free behavior
        self.qos = None
        if self.config.serving_qos.enabled:
            self.qos = QosPolicy(self.config.serving_qos, clock=self._clock)
            self.qos.kv_blocks_of = self.manager.tenant_blocks
        self.admission = AdmissionQueue(self.resilience, clock=self._clock, tracer=self.tracer,
                                        qos=self.qos)
        self._queue_wait_s = 0.0  # the last admission's queue wait (a serving gauge)
        # the scheduler's gauge stamp reads the tracer, not the engine: no
        # reference cycle keeps a dropped engine's pool and graphs alive
        self.scheduler = SplitFuseScheduler(
            token_budget, max_seqs_per_step, telemetry=telemetry, resilience=self.resilience,
            tracer=self.tracer,
            gauge_timestamp=(functools.partial(getattr, self.tracer, "last_now")
                             if self._clock_injected else None))
        self.scheduler.qos = self.qos
        # serving fault tolerance: durable request journal + serve-iteration
        # liveness heartbeat, armed from config OR the ServingSupervisor's
        # env exports (DSTPU_SERVING_JOURNAL + DSTPU_HEARTBEAT_DIR), so a
        # supervised worker needs no config changes.  The env heartbeat dir
        # counts ONLY under a serving supervisor (the journal env marks
        # that): a serving engine inside a supervised training worker must
        # not clobber the trainer's rank stamps.
        self.ft = self.config.serving_fault_tolerance
        generation = int(os.environ.get(SERVING_GENERATION_ENV, "0") or 0)
        if journal is None:
            jp = os.environ.get(SERVING_JOURNAL_ENV) or \
                (self.ft.journal_path if self.ft.enabled else None)
            if jp:
                # the supervisor exports its fsync policy beside the path
                journal = RequestJournal(
                    jp, fsync_every=env_int(SERVING_FSYNC_ENV, self.ft.fsync_every),
                    seed=self.config.seed)
        self.journal = journal
        if self.journal is not None:
            self.journal.open_generation(generation)
        self._heartbeat = NULL_HEARTBEAT
        under_supervisor = bool(os.environ.get(SERVING_JOURNAL_ENV))
        hb_dir = (os.environ.get(HEARTBEAT_DIR_ENV) if under_supervisor else None) \
            or (self.ft.heartbeat_dir if self.ft.heartbeat else None)
        if hb_dir:
            self._heartbeat = HeartbeatWriter(
                hb_dir, rank=0,
                interval_s=env_float(HEARTBEAT_INTERVAL_ENV, self.ft.heartbeat_interval_s),
                generation=generation)
        # recovery counters for health()/state_snapshot(); the supervisor
        # stamps restarts_total/degraded onto each engine it builds
        self.ft_stats = {"restarts_total": 0, "recovered_requests_total": 0,
                         "degraded": False}
        # pull-based ops plane: /metrics + /healthz + /statez over host-side
        # CACHED snapshots, refreshed by the serve loop (throttled on the
        # injectable clock); scrape handlers only read the cached strings.
        # The supervisor-exported DSTPU_OPS_DIR (honoured only under a
        # serving supervisor, like the heartbeat dir) also publishes per-rank
        # snapshot/textfile pairs for the fleet merge.
        self.ops_cfg = self.config.ops_server
        ops_dir = (os.environ.get(OPS_DIR_ENV) if under_supervisor else None) \
            or self.ops_cfg.textfile_dir
        self._ops = None
        if self.ops_cfg.enabled or ops_dir:
            self._ops = OpsPublisher(self.ops_cfg, generation=generation, ops_dir=ops_dir,
                                     rank=int(os.environ.get("RANK", "0") or 0),
                                     owner="serving engine")
        self.ops = self._ops.server if self._ops is not None else None
        self._deadline_expired_total = 0
        self._stall_streak = 0
        self.stalls_total = 0  # lifetime watchdog trips (streaks are transient)
        self.forward_steps = 0  # ragged forwards run (a burst of k counts k)
        self.tokens_run = 0     # real tokens through those forwards
        self.positions_run = 0  # padded (sequences x chunk) positions they computed
        self.chunk_widths = collections.Counter()  # padded chunk width -> forwards run at it
        self.params = _tree_to(params, self.device, self.dtype)
        self.kv = model_module.init_paged_cache(model_config, num_blocks, block_size,
                                                dtype=self.dtype, device=self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(self.config.seed)
        # serving fast path: host-link counters, the compile ledger behind
        # counters.compiles, the device-resident batch buffers, and the
        # bucket programs (CUDA graphs on the card, eager on the CPU and in
        # the reference loop)
        self.fastpath = self.config.serving_fastpath
        self.counters = ServeCounters()
        if self.prefix_cfg.enabled:
            # the cache's ONE device action; bound to the pool, not to the
            # engine, so the manager holds no reference back to the engine
            # and a dropped engine frees its pool and graphs at once
            self.manager.cow_copy = functools.partial(self._cow_copy_block, self.kv,
                                                      self.counters, self.device)
        self.ledger = CompileLedger(self.counters, tracer=self.tracer)
        # serving performance observatory: the phase profiler reads the
        # injectable clock at phase boundaries only when serving_perf is on
        # (off, it adds no clock reads); the roofline's costs are noted at
        # each fwd bucket's build, always
        self.perf_cfg = self.config.serving_perf
        self.phase_profiler = StepPhaseProfiler(self.perf_cfg, clock=self._clock,
                                                tracer=self.tracer)
        self.roofline = RooflineModel(self.perf_cfg)
        self.batch_state = DeviceBatchState(self.counters, self.device)
        # the build hook is bound to the roofline and the model, not to the
        # engine (no reference cycle)
        self.programs = BucketPrograms(
            self.ledger, self.device, graphs=self.device.type == "cuda" and self.fastpath.enabled,
            on_build=functools.partial(self._note_bucket_cost, self.roofline, self.perf_cfg,
                                       model_module, model_config, block_size, self.dtype))
        self._burst_inputs: Dict = {}  # (n, b) -> the burst step's static inputs
        self._verify_inputs: Dict = {}  # (n, k, b) -> the verify's static inputs
        # speculative decoding: drafter + adaptive-k controller + accounting
        # behind the fused draft/verify round (decode_spec), built only when
        # the section is armed: off, tokens, counters, journal and exposition
        # are those of the engine without it
        self.spec_cfg = self.config.serving_spec_decode
        self.spec_stats: Optional[SpecDecodeStats] = None
        self._spec_controller: Optional[AdaptiveKController] = None
        self._drafter = None
        if self.spec_cfg.enabled:
            self.spec_stats = SpecDecodeStats()
            self._spec_controller = AdaptiveKController(self.spec_cfg)
            if self.spec_cfg.drafter == "ngram":
                self._drafter = NgramDrafter(self.spec_cfg.ngram_max, self.spec_cfg.ngram_min)
            # drafter "model": speculation stays dormant (plain burst) until
            # the caller attaches weights with attach_draft_model()
        self._inflight: Optional[DeferredTokens] = None
        self._table_width = 0
        self._table_slack = 0
        self._health_generated_at = self._clock()
        self._tokens_run_total = 0  # forward tokens, for the tokens/s gauge
        # first ops snapshot at attach: a scrape before the first serve sees
        # real (zeroed) families instead of an empty body
        self.refresh_ops(force=True)

    # ------------------------------------------------------------------ intake
    def put(self, uids: Sequence[int], prompts: Sequence[Sequence[int]],
            ttl_s: Optional[float] = None, *, tenant: Optional[str] = None,
            service_class: Optional[str] = None) -> None:
        """Enqueue requests directly into the state manager, bypassing the
        admission queue — the step()-level API for callers running their own
        loop.  ``ttl_s`` stamps a deadline that step() enforces between
        forwards: an expired sequence is evicted (done, ``finish_reason:
        deadline_expired``, blocks reclaimed) before the next batch.

        ``tenant``/``service_class`` stamp QoS identity on the whole batch:
        the prefix cache keys on the tenant and the per-tenant gauges
        attribute the load.  put() bypasses the admission queue, so quota
        SHEDDING does not apply here — callers running their own loop own
        their own backpressure — but identity and accounting do."""
        ttl = ttl_s if ttl_s is not None else self.resilience.default_ttl_s
        tenant = str(tenant) if tenant else "default"
        if self.qos is not None:
            service_class = self.qos.service_class(service_class)
        elif service_class is None:
            service_class = "interactive"
        now = None
        if ttl is not None or self.tracer.enabled:
            # one clock read covers the whole batch: the deadline stamp, the
            # flight-recorder tick and the admit marks all share it
            now = self._clock()
            self.tracer.tick(now)
        deadline = now + ttl if ttl is not None else None
        self._reset_table_width_if_idle()
        for uid, prompt in zip(uids, prompts):
            seq = self.manager.add_sequence(int(uid), [int(t) for t in prompt],
                                            deadline=deadline, tenant=tenant,
                                            service_class=service_class)
            self._map_prefix(seq)  # shared prompt blocks already computed
            if self.qos is not None:
                self.qos.note_admit(tenant, service_class, len(prompt))
            if self.journal is not None:
                # step()-level requests journal too (max_new_tokens=0: the
                # caller's own loop owns the budget)
                self.journal.record_admit(int(uid), [int(t) for t in prompt], ttl_s=ttl,
                                          max_new_tokens=0, tenant=tenant,
                                          service_class=service_class)
            self.tracer.event("admit", uid=int(uid), direct=True)
            self.tracer.on_admit(int(uid), now, prompt_len=len(prompt),
                                 tenant=(tenant if self.qos is not None else None))
        # prefix-sharing opportunity over the post-intake live set
        self._observe_prefix({})

    def flush(self, uid: int) -> None:
        """End a put()-level request's life: retire it, reclaim its blocks
        and close its trace.  The terminal status mirrors retire()'s
        accounting: a failed sequence stays failed, an evicted one keeps its
        eviction status, anything else is flushed as completed."""
        seq = self.manager.seqs.get(uid)
        finish_reason = seq.finish_reason if seq is not None else None
        failure = self.manager.failures.get(uid)
        self.manager.retire(uid)
        if failure is not None:
            status = FAILED
        elif finish_reason in (DEADLINE_EXPIRED, PREEMPT_REQUEUED_EXHAUSTED):
            status = finish_reason
        else:
            status = OK
        if self.journal is not None and uid in self.journal.watched:
            self.journal.record_terminal(
                uid, status, finish_reason=finish_reason, reason=failure,
                n_tokens=seq.generated_tokens if seq is not None else 0)
        self.tracer.on_terminal(uid, status, finish_reason=finish_reason, reason=failure,
                                t=self.tracer.last_now)

    def _reset_table_width_if_idle(self) -> None:
        """Fresh serve (no tracked sequences): drop the sticky table width so
        a repeated scenario replays the same width trajectory, and therefore
        hits the same bucket programs, as its first run."""
        if not self.manager.seqs:
            self._table_width = 0
            self._table_slack = 0

    # ------------------------------------------------------------------ widths
    _bucket = staticmethod(round_up_pow2)

    def _stepped_width(self, blocks: int) -> int:
        """Block-table width rounded up in TABLE_STEP-slot increments, capped
        at max_blocks_per_seq; shared by the live bucketing and the prewarm."""
        return min(-(-blocks // self.TABLE_STEP) * self.TABLE_STEP, self.max_blocks_per_seq)

    def _table_width_for(self, need: int) -> int:
        """Block-table width for this step's batch.  Fast path: ``need``
        rounded up in TABLE_STEP-slot steps with sticky hysteresis (no shrink
        until TABLE_SHRINK_PATIENCE consecutive steps had a full step of
        slack).  Reference loop: the live maximum rounded up to a power of
        two.  Both capped at max_blocks_per_seq."""
        need = min(need, self.max_blocks_per_seq)
        if not self.fastpath.enabled:
            return min(self._bucket(need), self.max_blocks_per_seq)
        stepped = self._stepped_width(need)
        w = self._table_width
        if stepped > w:
            w = stepped
            self._table_slack = 0
        elif stepped <= w - self.TABLE_STEP:
            self._table_slack += 1
            if self._table_slack >= self.TABLE_SHRINK_PATIENCE:
                w = stepped
                self._table_slack = 0
        else:
            self._table_slack = 0
        self._table_width = w
        return w

    # ------------------------------------------------------------------- step
    @torch.no_grad()
    def step(self, greedy: bool = True) -> Dict[int, int]:
        """Run one SplitFuse step; returns {uid: sampled_token} for sequences
        that produced a next token (finished prefill or decoded).  On the
        fast path this is dispatch + immediate materialize; the serve loop
        uses the split halves to defer the materialize by one step."""
        if not self.fastpath.enabled:
            return self._step_reference(greedy)
        deferred = self._dispatch_step(greedy)
        if deferred is None:
            return {}
        return deferred.patch(self.manager)

    def _dispatch_step(self, greedy: bool) -> Optional[DeferredTokens]:
        """Fast-path step dispatch: scatter this step's changed rows into the
        bucket's persistent buffers, run the bucket program and the pick, and
        return a :class:`DeferredTokens` handle WITHOUT waiting on the
        tokens.  Emitting sequences get a PENDING_TOKEN placeholder that
        ``patch()`` later overwrites; a decode row whose input token is still
        in flight is fed on the device from the previous step's tokens."""
        self._expire_live()  # TTL enforcement between forwards, never mid-batch
        chunks = self.scheduler.schedule(self.manager)
        if not chunks:
            return None
        self._trace_dispatch(chunks)
        n = self._bucket(len(chunks))
        t = self._bucket(max(c.n_tokens for c in chunks))
        b = self._table_width_for(max(len(self.manager.seqs[c.uid].blocks) for c in chunks))
        key = (n, t, b)
        program = self._fwd_program(key)
        rows = []
        feeds = []
        tokens_run = 0
        for i, c in enumerate(chunks):
            seq = self.manager.seqs[c.uid]
            sl = seq.tokens[seq.seen_tokens:seq.seen_tokens + c.n_tokens]
            packed = np.zeros(3 + t + b, np.int32)
            packed[0] = i
            if c.n_tokens == 1 and sl[0] == PENDING_TOKEN:
                # the input token is the previous step's sample, still on the
                # device: feed it there instead of waiting for it
                if self._inflight is None or c.uid not in self._inflight.row_of:
                    raise RuntimeError(f"uid {c.uid}: pending token scheduled with no "
                                       f"in-flight step to feed it from")
                feeds.append((i, self._inflight.row_of[c.uid]))
                packed[1] = FED_SENTINEL
            else:
                packed[1:1 + len(sl)] = sl
            packed[1 + t] = c.n_tokens
            packed[2 + t] = seq.seen_tokens
            packed[3 + t:] = self.manager.block_table_row(seq, width=b)
            rows.append((i, packed))
            tokens_run += c.n_tokens
        self.batch_state.update(key, rows, n_active=len(chunks),
                                trash_block=self.manager.trash_block)
        if feeds:
            self.batch_state.feed(key, self._inflight.toks_dev, feeds)
        self.phase_profiler.mark("scatter_upload")
        self.counters.dispatches += 1
        row = program()
        # the pick runs on the device into a tensor of this step's own: the
        # program's output is overwritten by the bucket's next replay
        self.counters.dispatches += 1
        toks_dev = self._pick_rows(row, greedy)
        self.phase_profiler.mark("dispatch")
        self.roofline.note_dispatch(key, tokens_run)
        self._count_forward(n, t, tokens_run)
        emits = []
        row_of: Dict[int, int] = {}
        for i, c in enumerate(chunks):
            seq = self.manager.seqs[c.uid]
            seq.seen_tokens += c.n_tokens
            # prompt blocks this chunk completes become shareable: the
            # forward that writes them is already on the stream, ahead of
            # any later reader or CoW copy
            self.manager.register_prefix_blocks(seq)
            if seq.seen_tokens >= len(seq.tokens):
                # produced a next token (end of prompt, or a decode step)
                seq.tokens.append(PENDING_TOKEN)
                emits.append((c.uid, len(seq.tokens) - 1, i))
                row_of[c.uid] = i
        self.counters.step_tokens += len(emits)
        self._kv_steps += 1
        self._refresh_kv()
        self._emit_serving_gauges(tokens_run=tokens_run)
        return DeferredTokens(toks_dev=toks_dev, emits=emits, row_of=row_of,
                              counters=self.counters, tracer=self.tracer,
                              journal=self.journal)

    def _step_reference(self, greedy: bool) -> Dict[int, int]:
        """The reference step: full host-side batch rebuild, four uploads and
        a synchronous fetch per step, eager on every device.  The equivalence
        oracle (``serving_fastpath.enabled=False``) the fast path is held to."""
        self._expire_live()
        chunks = self.scheduler.schedule(self.manager)
        if not chunks:
            return {}
        self._trace_dispatch(chunks)
        n = self._bucket(len(chunks))
        t = self._bucket(max(c.n_tokens for c in chunks))
        b = self._table_width_for(max(len(self.manager.seqs[c.uid].blocks) for c in chunks))
        tokens = np.zeros((n, t), np.int32)
        n_tokens = np.zeros((n, ), np.int32)
        start_pos = np.zeros((n, ), np.int32)
        tables = np.full((n, b), self.manager.trash_block, np.int32)
        for i, c in enumerate(chunks):
            seq = self.manager.seqs[c.uid]
            sl = seq.tokens[seq.seen_tokens:seq.seen_tokens + c.n_tokens]
            tokens[i, :len(sl)] = sl
            n_tokens[i] = c.n_tokens
            start_pos[i] = seq.seen_tokens
            tables[i] = self.manager.block_table_row(seq, width=b)
        # counted as the JAX reference step counts them: forward + pick, and
        # five uploads (the four batch arrays, n_tokens again for the pick)
        self.counters.dispatches += 2
        self.counters.uploads += 5
        self.counters.upload_ints += int(tokens.size + 2 * n_tokens.size + start_pos.size
                                         + tables.size)
        dev = [torch.from_numpy(a).to(self.device) for a in (tokens, n_tokens, start_pos, tables)]
        logits, self.kv = self.model.forward_paged(self.model_config, self.params, *dev,
                                                   self.kv, block_size=self.block_size)
        self._count_forward(n, t, int(n_tokens.sum()))
        toks = materialize(self._pick_rows(_last_rows(logits, dev[1]), greedy),
                           self.counters)  # one sync: n sampled ints

        out: Dict[int, int] = {}
        for i, c in enumerate(chunks):
            seq = self.manager.seqs[c.uid]
            seq.seen_tokens += c.n_tokens
            # prompt blocks this chunk completed become shareable
            self.manager.register_prefix_blocks(seq)
            if seq.seen_tokens >= len(seq.tokens):
                tok = int(toks[i])
                seq.tokens.append(tok)
                out[c.uid] = tok
        self.counters.step_tokens += len(out)
        self.tracer.event("absorb", step=self.scheduler.steps, tokens=len(out))
        self.tracer.on_tokens_map(out)
        if self.journal is not None:
            self.journal.note_token_map(out)
        self._kv_steps += 1
        self._refresh_kv()
        self._emit_serving_gauges(tokens_run=int(n_tokens.sum()))
        return out

    def _trace_dispatch(self, chunks) -> None:
        """A scheduled batch is about to run: the ``dispatch`` event, and the
        chunk list for the span hooks, built only when tracing is on."""
        self.tracer.event("dispatch", step=self.scheduler.steps, seqs=len(chunks),
                          tokens=sum(c.n_tokens for c in chunks))
        if self.tracer.enabled:
            self.tracer.on_chunks([(c.uid, c.n_tokens) for c in chunks],
                                  step=self.scheduler.steps)

    def _pick_rows(self, rows, greedy: bool):
        """Token selection on the device from each row's last-position
        logits [N, V]: argmax, or temperature/top-k/top-p sampling from the
        engine's seeded generator.  Returns a new int32 tensor [N]."""
        if greedy:
            return torch.argmax(rows, dim=-1).to(torch.int32)
        cfg = self.config
        return _sample(rows, self._generator, temperature=cfg.temperature, top_k=cfg.top_k,
                       top_p=cfg.top_p)

    def _count_forward(self, n: int, t: int, tokens: int, steps: int = 1) -> None:
        self.forward_steps += steps
        self.tokens_run += tokens
        self.positions_run += n * t * steps
        self.chunk_widths[t] += steps

    def _refresh_kv(self) -> None:
        """Per-step census/forecast refresh: the health stamp (one clock
        read, as in the JAX engine), per-block residency and last-touched
        stamps from ``seen_tokens``, the alloc/free rates into the capacity
        forecaster, pressure edges into the flight recorder, and a
        ``kv_pool`` counter-track sample when a Chrome trace is configured.
        Pure host arithmetic over ints the engine already owns: no device
        sync, no effect on ``ServeCounters``."""
        self._health_generated_at = self._clock()
        if self.kv_obs is None:
            return
        free = self.manager.allocator.free_blocks
        self.kv_obs.refresh(self.manager.seqs, self._kv_steps, free)
        crossing = self.kv_obs.pressure_crossing()
        if crossing is not None:
            edge, ste = crossing
            self.tracer.event(
                "kv_pressure", step=self.scheduler.steps, edge=edge,
                steps_to_exhaustion=None if ste == float("inf") else round(ste, 1),
                free_blocks=free)
        if self.tracer.config.chrome_trace_path:
            # assembled only when an export will consume it:
            # fragmentation_tokens() walks the census
            census = self.kv_obs.census
            ste = self.kv_obs.forecaster.steps_to_exhaustion()
            self.tracer.counter_track("kv_pool", {
                "allocated_blocks": census.allocated_blocks,
                "free_blocks": free,
                "fragmentation_tokens": census.fragmentation_tokens(),
                **({} if ste is None else {"steps_to_exhaustion": round(ste, 1)}),
            })

    def _observe_prefix(self, extra_prompts: Dict[int, List[int]]) -> None:
        """One PrefixObservatory pass over live + admitted requests: every
        live sequence contributes its PROMPT portion, ``extra_prompts`` the
        not-yet-admitted prompts of the current intake."""
        if self.kv_obs is None:
            return
        obs = self.kv_obs.prefix
        # a live uid whose hashes are cached passes None (no slice built)
        prompts: Dict[int, Optional[List[int]]] = {
            uid: (None if obs.has(uid) else seq.tokens[:seq.prompt_len])
            for uid, seq in self.manager.seqs.items() if not seq.done}
        prompts.update(extra_prompts)
        obs.observe(prompts)

    def _map_prefix(self, seq) -> int:
        """Admit-time shared-prefix mapping with the hit landed in the flight
        recorder (the scheduler's per-chunk late-binding remap shares the
        manager seam but skips the event: per-step noise)."""
        mapped = self.manager.map_prefix(seq)
        if mapped:
            self.tracer.event("prefix_hit", uid=seq.uid, tokens=mapped, blocks=len(seq.blocks))
        return mapped

    def _forget_prefix(self, uid: int) -> None:
        """Invalidate a uid's PrefixObservatory hashes for a request that
        dies WITHOUT ever becoming a live sequence (queue expiry, stall
        drain, strict-abort drain): live sequences invalidate through the
        census's retirement listener, and a stale entry would credit the
        uid's next life with the dead prompt's hashes."""
        if self.kv_obs is not None:
            self.kv_obs.prefix.forget(uid)

    def check_kv_invariant(self) -> None:
        """Census-vs-allocator invariant: the census's owned-block set must
        exactly partition against the allocator free list, every shared
        block's owners must agree with its refcount, and every mapper of a
        shared block must hold the same tokens for it.  Raises
        ``CensusInvariantError`` naming the offending uid/block.  Run after
        every serve pass when ``serving_kv_observability.invariant_check``
        is set; public so smokes and tests can assert it at any point."""
        if self.kv_obs is not None:
            self.kv_obs.check_invariant(self.manager.allocator, self.manager.seqs)

    # ------------------------------------------------------------ observability
    def _gauge_timestamp(self) -> Optional[float]:
        """Deterministic gauge timestamp on an injected clock: the clock's
        last read.  None keeps record_gauges' wall-clock default."""
        return self.tracer.last_now if self._clock_injected else None

    def refresh_ops(self, force: bool = False) -> None:
        """Refresh the host-side ops snapshots the scrape handlers serve:
        re-populate the metrics registry from engine state (python ints and
        floats the host already owns; no device sync), re-render the
        Prometheus text, re-dump ``health()``/``state_snapshot()`` JSON, and
        republish the per-rank exchange files when a supervisor exported
        ``DSTPU_OPS_DIR``.  Called from the serve loop (throttled on the
        injectable clock to one refresh per ``ops_server.refresh_interval_s``)
        and forced at attach and serve end; a no-op with the ops plane off."""
        if self._ops is None:
            return
        self._ops.refresh(lambda reg: populate_from_engine(reg, self),
                          now=self.tracer.last_now, force=force,
                          healthz=lambda: json.dumps(self.health()),
                          statez=lambda: json.dumps(self.state_snapshot()))

    def close_ops(self) -> None:
        """Shut the ops HTTP listener down."""
        if self._ops is not None:
            self._ops.close()

    def _emit_serving_gauges(self, tokens_run: int) -> None:
        """Serving gauges on top of the scheduler's per-step ones: rates,
        resilience and fast-path counters, KV pool, prefix cache, SLO
        percentiles and (observatory on) the roofline, as a ``kind: gauges``
        record under ``Inference/Serving``."""
        if self.telemetry is None:
            return
        c = self.counters
        gauges = {"live_seqs": float(len(self.manager.live_uids())),
                  "admission_queue_depth": float(len(self.admission)),
                  "shed_total": float(self.admission.shed_total),
                  "preempted_total": float(self.scheduler.preempted_total),
                  "deadline_expired_total": float(self._deadline_expired_total),
                  "queue_wait": float(self._queue_wait_s),
                  "fastpath_host_syncs": float(c.host_syncs),
                  "fastpath_dispatches": float(c.dispatches),
                  "fastpath_compiled_programs": float(c.compiles),
                  "fastpath_upload_ints": float(c.upload_ints),
                  "fastpath_burst_fraction":
                      c.burst_tokens / max(c.burst_tokens + c.step_tokens, 1)}
        if self.kv_obs is not None:
            census, fc = self.kv_obs.census, self.kv_obs.forecaster
            ste = fc.steps_to_exhaustion()
            gauges.update({
                "kv_free_blocks": float(self.manager.allocator.free_blocks),
                "kv_utilization": self.manager.kv_utilization(),
                "kv_fragmentation_tokens": float(census.fragmentation_tokens()),
                "kv_alloc_rate": fc.alloc_rate,
                "kv_free_rate": fc.free_rate,
                **({} if ste is None else {"kv_steps_to_exhaustion": float(ste)}),
            })
        pc = self.manager.prefix_cache
        if pc is not None:
            gauges.update({
                "kv_prefix_hits": float(pc.hit_blocks_total),
                "kv_prefill_tokens_saved": float(pc.tokens_saved_total),
                "kv_prefix_realized_hit_rate": pc.realized_hit_rate(),
            })
        # SLO percentile gauges ({} while tracing is off)
        gauges.update(self.tracer.gauge_fields())
        if self.perf_cfg.enabled:
            gauges.update(self.roofline.gauges(self.phase_profiler.wall_s))
            gauges["serving_warm_recompiles"] = float(self.ledger.warm_total)
        rps = self.telemetry.rate("v2_completed_requests",
                                  float(self.manager.completed_requests))
        if rps is not None:
            gauges["requests_per_sec"] = rps
        self._tokens_run_total += tokens_run
        tps = self.telemetry.rate("v2_tokens_total", float(self._tokens_run_total))
        if tps is not None:
            gauges["tokens_per_sec"] = tps
        self.telemetry.record_gauges(gauges, step=self.scheduler.steps,
                                     prefix="Inference/Serving",
                                     timestamp=self._gauge_timestamp())

    def _phase_annotation(self, name: str):
        """A ``record_function`` range for one serve phase while a capture
        window is open; a nullcontext otherwise."""
        t = self.telemetry
        if t is not None and t.tracing:
            return t.annotation(name)
        return contextlib.nullcontext()

    def _perf_snapshot(self) -> Dict[str, Any]:
        """The perf observatory's host-side snapshot: phase attribution,
        compile ledger, roofline."""
        snap = self.phase_profiler.snapshot()  # enabled/iterations/wall_s/phases
        snap["compile_ledger"] = self.ledger.snapshot()
        snap["roofline"] = self.roofline.snapshot(self.phase_profiler.wall_s)
        return snap

    @staticmethod
    def _note_bucket_cost(roofline: RooflineModel, perf_cfg, model, model_config,
                          block_size: int, dtype, site: str, key) -> None:
        """The bucket programs' build hook: a ``"fwd"`` bucket's analytic
        (FLOPs, bytes) go to the roofline once, at its build (a graph capture
        on the card, the first eager use on the CPU), and so do a
        ``"spec_verify"`` bucket's, a forward of width k+1."""
        if not perf_cfg.capture_cost_analysis:
            return
        if site == "fwd":
            n, t, b = key
        elif site == "spec_verify":
            n, k, b, _ = key
            t = k + 1
        else:
            return
        roofline.note_cost(key, *model.paged_bucket_cost(model_config, n, t, b, block_size,
                                                         dtype))

    @staticmethod
    def _cow_copy_block(kv, counters: ServeCounters, device, src: int, dst: int) -> None:
        """Copy-on-write block copy: block ``src``'s KV into block ``dst`` in
        every leaf of the pool ``kv``, so a fully-cached prompt's one
        recomputed position writes a PRIVATE block.  The copy writes into the
        existing leaves (``index_copy_``): the bucket graphs captured the
        pool's storage.  It is enqueued on the current stream, the one the
        graphs replay on, so it runs after the forward that wrote ``src`` and
        before any replay that reads ``dst``, with no host sync.  Counted as
        the JAX engine counts its copy: one dispatch, one upload of the
        (src, dst) pair."""
        counters.dispatches += 1
        counters.uploads += 1
        counters.upload_ints += 2
        pair = upload(np.asarray([src, dst], np.int64), device)
        for leaf in kv.values():
            leaf.index_copy_(1, pair[1:], leaf.index_select(1, pair[:1]))

    # --------------------------------------------------------- bucket programs
    def _fwd_program(self, key, *, prewarmed: bool = False):
        """The ``(n, t, b)`` bucket's forward + last-row gather over its
        persistent batch buffers: a captured graph on the card's fast path,
        the eager function elsewhere."""
        slot = self.batch_state.slot(key, self.manager.trash_block)
        trash = self.manager.trash_block

        def make():
            model, cfg, params, kv, bs = (self.model, self.model_config, self.params, self.kv,
                                          self.block_size)

            def fwd():
                logits, _ = model.forward_paged(cfg, params, *slot.buffers(), kv, block_size=bs)
                return _last_rows(logits, slot.n_tokens)

            def neutralize():
                slot.n_tokens.zero_()
                slot.start_pos.zero_()
                slot.tables.fill_(trash)

            return fwd, slot.buffers(), neutralize

        return self.programs.get("fwd", key, make, prewarmed=prewarmed)

    def _burst_program(self, n: int, b: int):
        """One decode step of an ``n``-sequence burst over a ``b``-slot table,
        on static inputs of its own (tokens [n, 1], n_tokens of ones, start
        positions, tables); the burst replays it k times."""
        inputs = self._burst_inputs.get((n, b))
        if inputs is None:
            ints = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=self.device)
            inputs = (ints(n, 1), torch.ones(n, dtype=torch.int32, device=self.device),
                      ints(n), torch.full((n, b), self.manager.trash_block, dtype=torch.int32,
                                          device=self.device))
            self._burst_inputs[(n, b)] = inputs
        trash = self.manager.trash_block

        def make():
            model, cfg, params, kv, bs = (self.model, self.model_config, self.params, self.kv,
                                          self.block_size)

            def decode_step():
                logits, _ = model.forward_paged(cfg, params, *inputs, kv, block_size=bs)
                return logits[:, 0]

            def neutralize():
                inputs[1].zero_()
                inputs[2].zero_()
                inputs[3].fill_(trash)

            return decode_step, inputs, neutralize

        return self.programs.get("burst", (n, b), make), inputs

    def _verify_program(self, n: int, k: int, b: int, sample_cfg, *, prewarmed: bool = False):
        """The speculative verify of an ``n``-sequence round with ``k`` draft
        tokens over a ``b``-slot table: ONE target forward of width k+1 over
        static inputs of its own (tokens [n, k+1] = input token then the
        draft, the constant width k+1, start positions, tables).  Greedy
        (``sample_cfg`` None) it ends in the rejection sampler and returns
        the packed [n, k+2] rows; sampled it returns the logits [n, k+1, V]
        and the caller samples after the replay, from the engine's generator
        (a captured draw would repeat its numbers on every replay).  The
        bucket key is ``(n, k, b, sample_cfg)`` under the site
        ``"spec_verify"``."""
        inputs = self._verify_inputs.get((n, k, b))
        if inputs is None:
            ints = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=self.device)
            inputs = (ints(n, k + 1),
                      torch.full((n, ), k + 1, dtype=torch.int32, device=self.device), ints(n),
                      torch.full((n, b), self.manager.trash_block, dtype=torch.int32,
                                 device=self.device))
            self._verify_inputs[(n, k, b)] = inputs
        trash = self.manager.trash_block

        def make():
            model, cfg, params, kv, bs = (self.model, self.model_config, self.params, self.kv,
                                          self.block_size)

            def verify():
                logits, _ = model.forward_paged(cfg, params, *inputs, kv, block_size=bs)
                if sample_cfg is None:
                    return rejection_select(logits, inputs[0][:, 1:], None, sample_cfg=None)
                return logits

            def neutralize():
                inputs[1].zero_()
                inputs[2].zero_()
                inputs[3].fill_(trash)

            return verify, inputs, neutralize

        return (self.programs.get("spec_verify", (n, k, b, sample_cfg), make, prewarmed=prewarmed),
                inputs)

    # ------------------------------------------------------------ decode burst
    @torch.no_grad()
    def decode_burst(self, k: int, greedy: bool = True,
                     eos_token_id: Optional[int] = None) -> Optional[Dict[int, List[int]]]:
        """Run ``k`` decode steps on the device with ONE host round trip.

        Greedy and sampled (temperature/top-k/top-p from the engine config)
        decode both stay on the device, the sampled one drawing from the
        engine's generator exactly as k stepwise picks would; with
        ``eos_token_id`` a done-mask is carried and finished rows freeze, so
        the returned per-uid lists stop at (and include) the first eos.
        Applies only when every live sequence is in pure decode and the pool
        can pre-allocate k more slots per sequence; returns None otherwise
        (the caller steps instead).  Each of the k steps is one replay of the
        ``(n, b)`` burst graph on the card's fast path."""
        live, prefilling = self.scheduler.live_split(self.manager)
        if not live or prefilling:
            return None  # fuse only a pure-decode live set
        if len(live) > self.scheduler.max_seqs:
            return None
        if self._inflight is not None:
            # a deferred pick is still in flight: its placeholder is this
            # burst's input token, so patch it in first (idempotent; the serve
            # loop still absorbs the same handle afterwards)
            self._inflight.patch(self.manager)
        max_pos = getattr(self.model_config, "max_seq_len", None)
        total_new = 0
        for seq in live:
            upto = seq.seen_tokens + 1 + k
            if self.manager.over_cap(upto):
                return None
            if max_pos is not None and upto > max_pos:
                return None  # positions past the rotary table would clamp
            total_new += self.manager.blocks_needed(seq, upto)
        if not self.manager.can_allocate(total_new):
            # check BEFORE allocating anything: a partial grab would strand
            # blocks on some sequences and starve the stepwise fallback
            return None
        grown: List = []
        try:
            for seq in live:
                prior = len(seq.blocks)
                self.manager.ensure_blocks(seq, seq.seen_tokens + 1 + k)
                grown.append((seq, prior))
        except KVAllocationError:
            # a transient allocator failure mid-grab: roll every sequence back
            # to its prior table and decline; the stepwise path retries
            for seq, prior in grown:
                self.manager.rollback_blocks(seq, prior)
            return None

        n = self._bucket(len(live))
        b = self._table_width_for(max(len(s.blocks) for s in live))
        tok0 = np.zeros((n, 1), np.int32)
        start0 = np.zeros((n, ), np.int32)
        tables = np.full((n, b), self.manager.trash_block, np.int32)
        for i, seq in enumerate(live):
            tok0[i, 0] = seq.tokens[seq.seen_tokens]
            start0[i] = seq.seen_tokens
            tables[i] = self.manager.block_table_row(seq, width=b)
        # padded rows decode into the trash block
        eos = -1 if eos_token_id is None else int(eos_token_id)
        self.counters.dispatches += 1
        self.counters.uploads += 3
        self.counters.upload_ints += int(tok0.size + start0.size + tables.size)
        program, (tok, _, start, tables_dev) = self._burst_program(n, b)
        for dst, arr in ((tok, tok0), (start, start0), (tables_dev, tables)):
            dst.copy_(upload(arr, self.device))
        done = torch.zeros(n, dtype=torch.bool, device=self.device)
        packed = torch.empty((2 * k, n), dtype=torch.int32, device=self.device)
        for s in range(k):
            nxt = self._pick_rows(program(), greedy)
            # finished rows freeze: re-emit their last token (the pool keeps
            # absorbing writes into pre-allocated slots; the host truncates at
            # the first done flag)
            nxt = torch.where(done, tok[:, 0], nxt)
            done = done | (nxt == eos)
            packed[s] = nxt
            packed[k + s] = done
            tok[:, 0] = nxt
            start += 1
        self._count_forward(n, 1, k * len(live), steps=k)
        fetched = materialize(packed, self.counters)  # ONE sync per k steps
        toks, dones = fetched[:k], fetched[k:]        # [K, N] each
        out: Dict[int, List[int]] = {}
        for i, seq in enumerate(live):
            n_real = k
            if eos >= 0 and dones[:, i].any():
                n_real = int(np.argmax(dones[:, i])) + 1  # first done step, inclusive
            produced = [int(t) for t in toks[:n_real, i]]
            seq.tokens.extend(produced)
            seq.seen_tokens += n_real
            # a burst's first position can complete the FINAL prompt block
            # (a budget split at prompt_len - 1, or the CoW copy's recompute)
            self.manager.register_prefix_blocks(seq)
            self.counters.burst_tokens += n_real
            out[seq.uid] = produced
        self.scheduler.note_fused_work(k, sum(len(v) for v in out.values()))
        self.tracer.event("burst", step=self.scheduler.steps, k=k, seqs=len(live))
        self.tracer.on_burst_tokens({uid: len(toks_) for uid, toks_ in out.items()})
        if self.journal is not None:
            # a burst IS a wave boundary: the host just materialized k tokens
            # per sequence in one sync, so the journal appends one delta
            # frame here at no extra device cost
            self.journal.note_token_map(out)
            self.journal.flush()
        self._kv_steps += k
        self._refresh_kv()
        self._emit_serving_gauges(tokens_run=sum(len(v) for v in out.values()))
        return out

    # ----------------------------------------------------- speculative decode
    def attach_draft_model(self, model_module, model_config, params, *,
                           num_blocks: Optional[int] = None,
                           block_size: Optional[int] = None) -> None:
        """Arm ``drafter: "model"`` speculative decoding with a draft model
        (a module of ``models/``): it proposes greedily against a paged pool
        of its own, and its proposals feed the verify without visiting the
        host.  ``num_blocks``/``block_size`` size that pool (by default as
        the target's).  The draft model runs on the engine's one device."""
        if not self.spec_cfg.enabled:
            raise ValueError("serving_spec_decode.enabled is off: arm the section before "
                             "attaching a draft model")
        if self.spec_cfg.drafter != "model":
            raise ValueError(f"serving_spec_decode.drafter is '{self.spec_cfg.drafter}', "
                             f"not 'model'")
        self._drafter = ModelDrafter(
            model_module, model_config, params,
            num_blocks=(num_blocks if num_blocks is not None
                        else self.manager.allocator.num_blocks),
            block_size=block_size if block_size is not None else self.block_size,
            max_blocks_per_seq=self.max_blocks_per_seq, dtype=self.dtype, device=self.device,
            programs=self.programs)

    @torch.no_grad()
    def decode_spec(self, k: int, greedy: bool = True,
                    eos_token_id: Optional[int] = None) -> Optional[Dict[int, List[int]]]:
        """One speculative draft/verify round over the pure-decode live set:
        the drafter proposes ``k`` tokens a sequence, ONE target forward
        scores them all over the paged pool, and the rejection sampler emits
        the accepted prefix plus one corrected or bonus token: 1 to k+1
        tokens a sequence for one pass over the target's weights, with the
        plain decode's distribution (its tokens, greedy).

        The bookkeeping follows ``decode_burst``: an all-or-nothing block
        grab up front (rolled back on an allocator failure), ONE host sync
        for the packed runs, each sequence advanced by its accepted run with
        the draft-overshoot blocks rolled back before prefix registration,
        and journal frames of verified tokens only.  Returns None when the
        round does not apply (the caller runs the plain burst)."""
        drafter = self._drafter
        if drafter is None:
            return None
        live, prefilling = self.scheduler.live_split(self.manager)
        if not live or prefilling:
            return None  # speculate only over a pure-decode live set
        if len(live) > self.scheduler.max_seqs:
            return None
        if any(seq.deadline is not None for seq in live):
            # deadline-armed sequences take the plain path: a round emits a
            # variable-length run per loop iteration, which would move
            # eviction times against the engine without speculation
            return None
        if self._inflight is not None:
            # the drafter reads token HISTORY: a deferred pick still in
            # flight would leave PENDING_TOKEN placeholders in it
            self._inflight.patch(self.manager)
        max_pos = getattr(self.model_config, "max_seq_len", None)
        total_new = 0
        for seq in live:
            upto = seq.seen_tokens + 1 + k
            if self.manager.over_cap(upto):
                return None
            if max_pos is not None and upto > max_pos:
                return None
            total_new += self.manager.blocks_needed(seq, upto)
        if not self.manager.can_allocate(total_new):
            return None
        grown: List = []
        try:
            for seq in live:
                prior = len(seq.blocks)
                self.manager.ensure_blocks(seq, seq.seen_tokens + 1 + k)
                grown.append((seq, prior))
        except KVAllocationError:
            # a transient allocator failure mid-grab: roll every sequence
            # back so nothing is stranded, and decline
            for seq, prior in grown:
                self.manager.rollback_blocks(seq, prior)
            return None

        n = self._bucket(len(live))
        b = self._table_width_for(max(len(s.blocks) for s in live))
        tok0 = np.zeros((n, 1), np.int32)
        start0 = np.zeros((n, ), np.int32)
        tables = np.full((n, b), self.manager.trash_block, np.int32)
        for i, seq in enumerate(live):
            tok0[i, 0] = seq.tokens[seq.seen_tokens]
            start0[i] = seq.seen_tokens
            tables[i] = self.manager.block_table_row(seq, width=b)
        draft = drafter.propose_batch(live, k, n, counters=self.counters)
        if draft is None:
            # the drafter's private pool cannot cover the round: undo the
            # target-pool grab and let the plain burst run instead
            for seq, prior in grown:
                self.manager.rollback_blocks(seq, prior)
            return None
        sample_cfg = None if greedy else (self.config.temperature, self.config.top_k,
                                          self.config.top_p)
        program, (tokens, _, start, tables_dev) = self._verify_program(n, k, b, sample_cfg)
        self.counters.dispatches += 1
        if isinstance(draft, np.ndarray):
            self.counters.uploads += 4
            self.counters.upload_ints += int(tok0.size + start0.size + tables.size
                                             + draft.size)
            tokens[:, 1:].copy_(upload(draft, self.device))
        else:
            # a model drafter's proposals are already on the device
            self.counters.uploads += 3
            self.counters.upload_ints += int(tok0.size + start0.size + tables.size)
            tokens[:, 1:].copy_(draft)
        # every input is rewritten each round: a block rolled back after an
        # earlier round never stays in a table a replay reads
        for dst, arr in ((tokens[:, :1], tok0), (start, start0), (tables_dev, tables)):
            dst.copy_(upload(arr, self.device))
        packed = program()
        if sample_cfg is not None:
            packed = rejection_select(packed, tokens[:, 1:], self._generator,
                                      sample_cfg=sample_cfg)
        self._count_forward(n, k + 1, len(live) * (k + 1))
        raw = DeferredRuns(packed_dev=packed, uids=[s.uid for s in live],
                           counters=self.counters).runs()  # ONE sync for the round
        bs = self.manager.block_size
        out: Dict[int, List[int]] = {}
        accepted_total = 0
        max_run = 1
        for seq in live:
            run = raw[seq.uid]
            if eos_token_id is not None:
                for j, tok in enumerate(run):
                    if tok == int(eos_token_id):
                        run = run[:j + 1]
                        break
            accepted_total += max(0, len(run) - 1)
            seq.tokens.extend(run)
            seq.seen_tokens += len(run)
            # the verify wrote KV at every draft position; past the accepted
            # run it is stale, and the trailing blocks holding only such
            # positions go back now (census and prefix watermarks follow),
            # before the allocator could hand one to another sequence
            keep = -(-len(seq.tokens) // bs)
            if len(seq.blocks) > keep:
                self.manager.rollback_blocks(seq, keep)
            # a round's first position can complete the FINAL prompt block
            # (the burst's seam)
            self.manager.register_prefix_blocks(seq)
            self.counters.burst_tokens += len(run)
            max_run = max(max_run, len(run))
            out[seq.uid] = run
        self.counters.spec_rounds += 1
        self.counters.spec_proposed += len(live) * k
        self.counters.spec_accepted += accepted_total
        self.spec_stats.note_round(len(live) * k, accepted_total, [len(r) for r in out.values()])
        self._spec_controller.note_round(len(live) * k, accepted_total)
        # the deepest accepted run is the round's sequential-step equivalent
        self.scheduler.note_fused_work(max_run, sum(len(r) for r in out.values()))
        self.tracer.event("spec_verify", step=self.scheduler.steps, k=k, seqs=len(live),
                          accepted=accepted_total)
        self.tracer.on_burst_tokens({uid: len(r) for uid, r in out.items()})
        if self.journal is not None:
            # VERIFIED tokens only reach the journal: the accepted prefix +
            # the corrected token just materialized are the frame, so a
            # replay after a crash mid-verify regenerates the same streams
            self.journal.note_token_map(out)
            self.journal.flush()
        self._kv_steps += max_run
        self._refresh_kv()
        self._emit_serving_gauges(tokens_run=sum(len(r) for r in out.values()))
        return out

    def _fused_decode(self, window: int, *, greedy: bool,
                      eos_token_id: Optional[int]) -> Optional[Dict[int, List[int]]]:
        """One fused decode round: a speculative draft/verify when the
        section is armed and the adaptive-k controller is off its floor, the
        plain burst otherwise.  The draft length is snapped DOWN to the
        largest ladder rung within both the controller's pick and the
        remaining-budget window (so a round emits at most ``window`` tokens a
        sequence), so every verify width is a prewarmed bucket."""
        if self._drafter is not None and self._spec_controller is not None:
            nk = self._spec_controller.next_k()
            if nk > 1:
                cap = min(nk, window - 1)
                k_d = max((r for r in self._spec_controller.ladder if r <= cap), default=0)
                if k_d >= 1:
                    out = self.decode_spec(k_d, greedy=greedy, eos_token_id=eos_token_id)
                    if out is not None:
                        return out
                    self.spec_stats.fallback_rounds_total += 1
        return self.decode_burst(window, greedy=greedy, eos_token_id=eos_token_id)

    def _spec_snapshot(self) -> Dict[str, Any]:
        """``health()["spec_decode"]``: {"enabled": False} with the section
        off, else the controller's state (live k, acceptance EWMA, ladder),
        the lifetime counters and the tokens-per-verify histogram."""
        if self.spec_stats is None or self._spec_controller is None:
            return {"enabled": False}
        return {"enabled": True,
                "drafter": self.spec_cfg.drafter if self._drafter is not None else "none",
                **self._spec_controller.snapshot(),
                **self.spec_stats.snapshot()}

    # ---------------------------------------------------------------- serving
    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None, greedy: bool = True, *,
                 strict: bool = True, priorities: Optional[Sequence[int]] = None,
                 ttl_s: Optional[float] = None,
                 tenants: Optional[Sequence[str]] = None,
                 service_classes: Optional[Sequence[str]] = None
                 ) -> Union[List[List[int]], List[RequestResult]]:
        """Serve a batch to completion through the continuous-batching loop.

        Requests flow through the admission queue (bounded, priority-aware,
        load-shed under pressure), are evicted between steps once past their
        deadline (``ttl_s`` or the config default), and a progress watchdog
        bounds live-but-unschedulable loops.

        ``strict=True`` (default): returns ``List[List[int]]`` of
        prompt+generated tokens and raises on the first shed/failure/stall
        (:class:`ServingStalledError` carries a state snapshot).
        ``strict=False``: every request runs to a terminal status and the call
        returns per-request :class:`RequestResult` objects (status in {ok,
        shed, deadline_expired, preempt_requeued_exhausted, failed}).

        ``greedy=False`` samples with the engine config's temperature/top-k/
        top-p from the engine's seeded generator.

        ``tenants``/``service_classes`` (one per prompt) carry the QoS
        identity: with ``serving_qos`` on they select the quotas and the
        dequeue class; off, the tenant still seeds the prefix keying."""
        uids = list(range(len(prompts)))
        results = self._serve(uids, prompts, max_new_tokens=max_new_tokens,
                              eos_token_id=eos_token_id, greedy=greedy, strict=strict,
                              priorities=priorities, ttl_s=ttl_s,
                              tenants=tenants, service_classes=service_classes)
        if strict:
            return [results[u].tokens for u in uids]
        return [results[u] for u in uids]

    def serve_recovered(self, requests: Sequence[RecoveredRequest], *,
                        max_new_tokens: int, eos_token_id: Optional[int] = None,
                        greedy: bool = True, strict: bool = False
                        ) -> Dict[int, RequestResult]:
        """Serve a batch where some requests resume a previous engine life:
        each :class:`RecoveredRequest` carries the token prefix it already
        emitted (replayed from the durable journal) and its REMAINING TTL.
        Re-admitted sequences prefill ``prompt + prefix`` in one pass (the
        KV rebuild) and then continue decoding from where they died; the
        prefix counts against ``max_new_tokens`` so a recovered request
        never overruns its original budget.  Entries with an empty prefix
        are ordinary admissions riding the same call (the supervisor routes
        new work through here too, so one serve covers a mixed recovery)."""
        uids = [int(r.uid) for r in requests]
        prompts = [list(r.prompt) for r in requests]
        prefixes = {int(r.uid): [int(t) for t in r.prefix] for r in requests if r.prefix}
        ttls = {int(r.uid): r.ttl_s for r in requests if r.pin_ttl}
        priorities = [int(r.priority) for r in requests]
        # QoS identity rides recovery AS JOURNALED: the planner copied
        # tenant/class from the journal entry, so a crash can never launder
        # a best-effort request into interactive
        tenants = [r.tenant for r in requests]
        service_classes = [r.service_class for r in requests]
        self.ft_stats["recovered_requests_total"] += len(prefixes)
        for r in requests:
            if r.prefix:
                self.tracer.event("recovered", uid=int(r.uid), prefix=len(r.prefix))
                self._record_resilience("serving_recovered", uid=int(r.uid),
                                        prefix_tokens=len(r.prefix))
        return self._serve(uids, prompts, max_new_tokens=max_new_tokens,
                           eos_token_id=eos_token_id, greedy=greedy, strict=strict,
                           priorities=priorities, ttl_s=None, prefixes=prefixes, ttls=ttls,
                           tenants=tenants, service_classes=service_classes)

    @torch.no_grad()
    def _serve(self, uids: List[int], prompts: Sequence[Sequence[int]], *,
               max_new_tokens: int, eos_token_id: Optional[int], greedy: bool,
               strict: bool, priorities: Optional[Sequence[int]],
               ttl_s: Optional[float],
               prefixes: Optional[Dict[int, List[int]]] = None,
               ttls: Optional[Dict[int, Optional[float]]] = None,
               tenants: Optional[Sequence[str]] = None,
               service_classes: Optional[Sequence[str]] = None
               ) -> Dict[int, RequestResult]:
        my = set(uids)
        self._reset_table_width_if_idle()
        conflict = sorted(my & set(self.manager.seqs))
        if conflict:
            # fail fast BEFORE any queue/manager mutation: a collision with a
            # put()-registered sequence would otherwise let this call evict
            # foreign work
            raise ValueError(f"generate() uids {conflict} are already tracked (direct "
                             f"put() requests coexist with generate() only with "
                             f"disjoint uids); flush them first")
        for uid in uids:
            # a failure entry left over from a reused uid's previous life must
            # not poison the fresh request
            self.manager.failures.pop(uid, None)
        results: Dict[int, RequestResult] = {}
        # a recovered prefix pre-spends its share of the max_new_tokens
        # budget: the request finishes after (budget - prefix) NEW tokens
        produced = {u: len(prefixes[u]) if prefixes and u in prefixes else 0 for u in uids}
        token_cap = self.manager.max_blocks_per_seq * self.manager.block_size
        try:
            # ---- admission: shed-or-queue BEFORE any KV allocation
            for i, (uid, prompt) in enumerate(zip(uids, prompts)):
                prefix = prefixes.get(uid, []) if prefixes else []
                if ttls is not None and uid in ttls:
                    t, apply_default = ttls[uid], False  # recovery pins the TTL
                else:
                    t, apply_default = ttl_s, True
                priority = priorities[i] if priorities is not None else 0
                tenant = tenants[i] if tenants is not None else None
                service_class = service_classes[i] if service_classes is not None else None
                if self.qos is not None:
                    # normalize HERE (not just inside submit) so the journal
                    # admit record carries the class the policy resolved —
                    # replay must reconstruct identity, not re-default it
                    tenant = str(tenant) if tenant else "default"
                    service_class = self.qos.service_class(service_class)
                shed = self.admission.submit(
                    uid, [int(tok) for tok in prompt], priority=priority, ttl_s=t,
                    apply_default_ttl=apply_default,
                    kv_utilization=self.manager.kv_utilization(), token_cap=token_cap,
                    prefix=prefix or None, recovered=bool(prefix), tenant=tenant,
                    service_class=service_class)
                if shed is not None:
                    self._record_resilience("serving_shed", uid=uid, code=shed.code,
                                            retryable=shed.retryable, detail=shed.detail)
                    if self.journal is not None:
                        # direct write, not _journal_terminal: a shed request
                        # was never admitted, so it is not watched (and a
                        # recovered one re-shed here is only in a PREVIOUS
                        # generation's watched set), yet its terminal must be
                        # durable or replay re-serves it forever
                        self.journal.record_terminal(
                            uid, SHED, reason=str(shed), retryable=shed.retryable,
                            # gated on qos: a QoS-off journal keeps the
                            # policy-free record format
                            shed_code=shed.code if self.qos is not None else None)
                    if strict:
                        raise RuntimeError(f"request {uid} shed: {shed}")
                    results[uid] = RequestResult(uid=uid, status=SHED, reason=str(shed),
                                                 retryable=shed.retryable,
                                                 retry_after_s=shed.retry_after_s,
                                                 shed_code=shed.code)
                elif self.journal is not None:
                    # the effective TTL (what admission just stamped) rides
                    # the admit record, with a wall-clock stamp so recovery
                    # keeps the ORIGINAL deadline clock across processes
                    effective = t if t is not None else \
                        (self.resilience.default_ttl_s if apply_default else None)
                    self.journal.record_admit(
                        uid, [int(tok) for tok in prompt], priority=priority,
                        ttl_s=effective, max_new_tokens=max_new_tokens,
                        eos_token_id=eos_token_id, greedy=greedy, prefix_len=len(prefix),
                        tenant=tenant if tenant is not None else "default",
                        service_class=(service_class if service_class is not None
                                       else "interactive"))
            # counterfactual prefix-cache report for THIS pass: the queued
            # (non-shed) prompts joining whatever is already live
            self._observe_prefix({uid: [int(t) for t in prompt]
                                  for uid, prompt in zip(uids, prompts) if uid not in results})
            self._prewarm(max_new_tokens, greedy=greedy)
            if self.telemetry is not None:
                # re-arm the serve-loop profiler window for THIS call
                self.telemetry.serve_profile_begin()
            self._serve_loop(uids, my, results, produced, max_new_tokens=max_new_tokens,
                             eos_token_id=eos_token_id, greedy=greedy, strict=strict)
            # post-pass pool state: final refresh, then the census invariant
            self._refresh_kv()
            if self.kv_cfg.invariant_check:
                self.check_kv_invariant()
        except Exception:
            # a strict-mode raise must not leak this call's queued tickets or
            # live sequences into the next call
            self._abandon(my)
            raise
        finally:
            if self.telemetry is not None:
                # a serve capture window never leaks across generate() calls,
                # a strict raise included
                self.telemetry.serve_profile_end()
            # the Chrome-trace export (when configured), a strict raise
            # included: the partial trace is what the postmortem wants
            self.tracer.write_chrome_trace()
            if self.journal is not None:
                # buffered token deltas must not outlive the call that
                # materialized them (a strict raise included)
                self.journal.flush()
            # final ops snapshot: a post-serve scrape sees the completed
            # state, not a mid-wave cache
            self.refresh_ops(force=True)
        return results

    def _serve_loop(self, uids: List[int], my: set, results: Dict[int, RequestResult],
                    produced: Dict[int, int], *, max_new_tokens: int,
                    eos_token_id: Optional[int], greedy: bool, strict: bool) -> None:
        fp = self.fastpath
        fusion_min = max(2, fp.fusion_min_steps) if fp.enabled else 2
        # an externally wrapped step() (fault injectors, tracing shims) must
        # keep intercepting every step, so the split dispatch/materialize
        # pipeline only engages on an unwrapped engine
        can_pipeline = fp.enabled and fp.pipeline_depth > 0 and "step" not in self.__dict__
        stall_streak = 0
        last_sig = None
        prof = self.phase_profiler
        serve_iter = 0  # per-call index driving the serve profiler window

        def absorb(stepped):
            self._absorb_step(stepped, my, results, produced, max_new_tokens=max_new_tokens,
                              eos_token_id=eos_token_id, strict=strict)

        while any(u not in results for u in uids):
            self.counters.loop_iterations += 1
            if self.telemetry is not None:
                # the serve-loop torch.profiler window: [start, stop) in
                # per-call iterations, a no-op unless its knobs are set
                self.telemetry.profile_serve_boundary(serve_iter)
            serve_iter += 1
            prof.begin_iteration()
            # serve-iteration liveness stamp on host ints only (throttled in
            # the writer; the NULL writer when supervision is off)
            self._heartbeat.stamp(self.counters.loop_iterations, phase="serving")
            # ops-plane cache refresh: host-only snapshot rebuild, throttled
            # on the injectable clock; a no-op with the plane off
            self.refresh_ops()
            prof.mark("other")  # liveness/ops bookkeeping, not a serve phase
            if self._inflight is not None and (len(self.admission)
                                               or self._any_live_deadline()):
                # wave boundary: admission/deadline handling below may evict
                # or finalize sequences, so catch the host up with the device
                self.counters.flushes += 1
                self.tracer.event("flush", step=self.scheduler.steps, cause="wave")
                absorb(self._settle_inflight())
                prof.mark("flush")
            self._expire_live()
            with self._phase_annotation("admission_pump"):
                self._pump_admissions(my, results, strict)
            prof.mark("admission_pump")

            # pure-decode fast path: burst k steps on the device, sliced while
            # anything is queued or deadlined so admission latency and
            # eviction overshoot stay bounded
            k = self._fusion_window(uids, results, produced, max_new_tokens)
            fusible = False
            if k >= fusion_min:
                decoding, prefilling = self.scheduler.live_split(self.manager)
                fusible = (bool(decoding) and not prefilling
                           and len(decoding) <= self.scheduler.max_seqs)
            if fusible and self._inflight is not None:
                # the burst's bookkeeping finalizes sequences on the host:
                # absorb the in-flight step first, then re-measure the window
                self.counters.flushes += 1
                self.tracer.event("flush", step=self.scheduler.steps, cause="fuse")
                absorb(self._settle_inflight())
                prof.mark("flush")
                k = self._fusion_window(uids, results, produced, max_new_tokens)
            if fusible and k >= fusion_min:
                with self._phase_annotation("burst"):
                    burst = self._fused_decode(k, greedy=greedy, eos_token_id=eos_token_id)
                if burst:
                    for uid, toks in burst.items():
                        if uid not in my or uid in results:
                            continue
                        produced[uid] += len(toks)
                        hit_eos = (eos_token_id is not None and toks
                                   and toks[-1] == eos_token_id)
                        if hit_eos or produced[uid] >= max_new_tokens:
                            self._finish_ok(uid, results, "eos" if hit_eos else "max_new_tokens")
                    prof.mark("burst")
                    prof.end_iteration()
                    continue
                prof.mark("burst")  # a declined burst attempt still costs time

            if can_pipeline and not (len(self.admission) or self._any_live_deadline()):
                # dispatch step N, then absorb step N-1's tokens while the
                # device executes N
                if (self._inflight is not None
                        and all(produced[u] + (1 if u in self._inflight.row_of else 0)
                                >= max_new_tokens for u in uids if u not in results)):
                    # every unresolved request finishes when the in-flight
                    # step lands: absorb it instead of dispatching a
                    # guaranteed-overshoot step
                    absorb(self._settle_inflight())
                    prof.mark("absorb_patch")
                else:
                    with self._phase_annotation("dispatch"):
                        deferred = self._dispatch_step(greedy)
                    prev, self._inflight = self._inflight, deferred
                    with self._phase_annotation("absorb_patch"):
                        absorb(prev.patch(self.manager) if prev is not None else {})
                    prof.mark("absorb_patch")
            else:
                if self._inflight is not None:
                    self.counters.flushes += 1
                    self.tracer.event("flush", step=self.scheduler.steps, cause="sync")
                    absorb(self._settle_inflight())
                    prof.mark("flush")
                with self._phase_annotation("dispatch"):
                    absorb(self.step(greedy=greedy))
                prof.mark("absorb_patch")

            # ---- progress watchdog: a live-but-unschedulable engine must trip,
            # not spin.  Identical signatures for the watchdog window = stall.
            sig = self._progress_signature()
            stall_streak = stall_streak + 1 if sig == last_sig else 0
            last_sig = sig
            self._stall_streak = stall_streak
            if stall_streak >= self.resilience.stall_watchdog_steps:
                if self._inflight is not None:
                    absorb(self._settle_inflight())
                self._handle_stall(my, results, strict)
                stall_streak, last_sig = 0, None
                self._stall_streak = 0

            if self.journal is not None:
                # wave-boundary journal flush: every token this iteration
                # materialized is already host-side, so the delta frame costs
                # one buffered file append (fsync amortized per fsync_every)
                self.journal.flush()
            prof.end_iteration()  # residual (watchdog, journal) lands in "other"

        if self._inflight is not None:
            # the final absorb resolved every request with a step still in
            # flight (a coexisting put() sequence rode it): patch its
            # placeholders so no PENDING_TOKEN escapes the loop
            self._inflight.patch(self.manager)
            self._inflight = None

    def _fusion_window(self, uids: List[int], results: Dict[int, RequestResult],
                       produced: Dict[int, int], max_new_tokens: int) -> int:
        """Tokens worth fusing into one decode burst now: the smallest
        remaining budget across this call's live requests, sliced to
        BURST_DEADLINE_SLICE while anything is queued or deadlined."""
        live = [u for u in uids if u not in results]
        k = min((max_new_tokens - produced[u] for u in live), default=0)
        if len(self.admission) or self._any_live_deadline():
            k = min(k, self.BURST_DEADLINE_SLICE)
        return k

    def _absorb_step(self, stepped: Dict[int, int], my: set,
                     results: Dict[int, RequestResult], produced: Dict[int, int], *,
                     max_new_tokens: int, eos_token_id: Optional[int],
                     strict: bool) -> None:
        """Fold one step's outcomes into per-request results: sampled-token
        finishes (eos / max_new_tokens), failures, and evictions.  The
        pipelined loop feeds it the PREVIOUS step's materialized tokens."""
        for uid, tok in stepped.items():
            if uid not in my or uid in results:
                continue
            produced[uid] += 1
            hit_eos = eos_token_id is not None and tok == eos_token_id
            if produced[uid] >= max_new_tokens or hit_eos:
                self._truncate_overshoot(uid)
                self._finish_ok(uid, results, "eos" if hit_eos else "max_new_tokens")

        for uid, reason in list(self.manager.failures.items()):
            if uid in my and uid not in results:
                if strict:
                    raise RuntimeError(f"request {uid} failed: {reason}")
                self._record_resilience("serving_request_failed", uid=uid, reason=reason)
                self._journal_terminal(uid, FAILED, reason=reason)
                self.tracer.event("failed", step=self.scheduler.steps, uid=uid)
                self.tracer.on_terminal(uid, FAILED, reason=reason)
                seq = self.manager.seqs.get(uid)
                results[uid] = RequestResult(
                    uid=uid, status=FAILED, reason=reason,
                    tokens=list(seq.tokens) if seq is not None else [])
                if seq is not None:
                    self.manager.retire(uid, completed=False)
                # consume the entry: uids are reused across generate() calls
                self.manager.failures.pop(uid, None)

        # sequences finished WITHOUT emitting this step: a decode capped at
        # max_blocks_per_seq completes gracefully (length_capped), an expired
        # request was evicted by _expire_live, an exhausted preemption victim
        # ends
        for uid in list(self.manager.seqs):
            if uid not in my or uid in results:
                continue
            seq = self.manager.seqs[uid]
            if not (seq.done and seq.finish_reason):
                continue
            if seq.finish_reason == DEADLINE_EXPIRED:
                if strict:
                    raise RuntimeError(f"request {uid} deadline_expired after "
                                       f"producing {seq.generated_tokens} tokens")
                results[uid] = RequestResult(uid=uid, status=DEADLINE_EXPIRED,
                                             tokens=list(seq.tokens), retryable=True,
                                             reason="deadline expired while running",
                                             queue_wait_s=seq.queue_wait_s,
                                             preemptions=seq.preemptions)
                self._journal_terminal(uid, DEADLINE_EXPIRED, retryable=True,
                                       reason="deadline expired while running")
                self.tracer.on_terminal(uid, DEADLINE_EXPIRED,
                                        reason="deadline expired while running")
                self.manager.retire(uid, completed=False)
            elif seq.finish_reason == PREEMPT_REQUEUED_EXHAUSTED:
                self._record_resilience("serving_preempt_requeued_exhausted", uid=uid,
                                        preemptions=seq.preemptions)
                if strict:
                    raise RuntimeError(
                        f"request {uid} preempted {seq.preemptions}x and evicted "
                        f"(KV pool pressure); enlarge num_blocks or lower concurrency")
                results[uid] = RequestResult(
                    uid=uid, status=PREEMPT_REQUEUED_EXHAUSTED,
                    tokens=list(seq.tokens), retryable=True,
                    reason=f"preempted {seq.preemptions}x under KV pressure",
                    preemptions=seq.preemptions, queue_wait_s=seq.queue_wait_s)
                self._journal_terminal(
                    uid, PREEMPT_REQUEUED_EXHAUSTED, retryable=True,
                    reason=f"preempted {seq.preemptions}x under KV pressure")
                self.tracer.on_terminal(
                    uid, PREEMPT_REQUEUED_EXHAUSTED,
                    reason=f"preempted {seq.preemptions}x under KV pressure")
                self.manager.retire(uid, completed=False)
            else:  # length_capped: a graceful completion
                self._finish_ok(uid, results, seq.finish_reason)

    def _truncate_overshoot(self, uid: int) -> None:
        """A request finishing on its step-N token may already have step N+1
        in flight (pipelined dispatch): drop the in-flight placeholder so the
        finished token list is exactly the synchronous loop's.  The stray KV
        write lands in blocks this retirement frees; a later owner's prefill
        rewrites them before its lengths let them be read."""
        d = self._inflight
        if d is None or uid not in d.row_of:
            return
        seq = self.manager.seqs.get(uid)
        if seq is not None and seq.tokens and seq.tokens[-1] == PENDING_TOKEN:
            seq.tokens.pop()
            seq.seen_tokens = min(seq.seen_tokens, len(seq.tokens))
        d.drop_emit(uid)

    def _settle_inflight(self) -> Dict[int, int]:
        """Materialize and clear the in-flight step (no-op when none)."""
        d, self._inflight = self._inflight, None
        return d.patch(self.manager) if d is not None else {}

    def _any_live_deadline(self) -> bool:
        return any(s.deadline is not None and not s.done for s in self.manager.seqs.values())

    def _abandon(self, my: set) -> None:
        """Strict-mode raise cleanup: reclaim every trace of this call so the
        engine is immediately reusable (blocks freed, queue drained, stale
        failure entries consumed)."""
        if self._inflight is not None:
            try:
                # foreign (direct put()) sequences may hold placeholders from
                # the aborted step: patch them before this call's teardown
                self._inflight.patch(self.manager)
            finally:
                self._inflight = None
        for uid in list(self.manager.seqs):
            if uid in my:
                self.manager.retire(uid, completed=False)
        for uid in my:
            self.manager.failures.pop(uid, None)
        for ticket in self.admission.drain():
            self._forget_prefix(ticket.uid)  # died queued: retire never fires
        # close this call's still-open traces so the live-trace map and the
        # strict caller's postmortem both see a terminal event
        self.tracer.abort_all(my, reason="strict-mode abort")
        self._stall_streak = 0

    def _finish_ok(self, uid: int, results: Dict[int, RequestResult],
                   finish_reason: str) -> None:
        seq = self.manager.seqs[uid]
        seq.done = True
        seq.finish_reason = finish_reason
        results[uid] = RequestResult(uid=uid, status=OK, tokens=list(seq.tokens),
                                     finish_reason=finish_reason,
                                     queue_wait_s=seq.queue_wait_s,
                                     preemptions=seq.preemptions)
        self._journal_terminal(uid, OK, finish_reason=finish_reason)
        self.tracer.event("finish", step=self.scheduler.steps, uid=uid, reason=finish_reason)
        self.tracer.on_terminal(uid, OK, finish_reason=finish_reason)
        self.manager.retire(uid)  # reclaim KV blocks immediately, not at batch end

    def _expire_live(self) -> None:
        """Engine-wide deadline enforcement between forwards: any live
        sequence past its deadline is evicted in place (done, ``finish_reason:
        deadline_expired``, KV blocks reclaimed)."""
        now = self._clock()
        self.tracer.tick(now)  # donate the sweep's clock read to the recorder
        for seq in list(self.manager.seqs.values()):
            if seq.done or seq.deadline is None or now < seq.deadline:
                continue
            self.manager.evict(seq, DEADLINE_EXPIRED)
            self._deadline_expired_total += 1
            self.tracer.event("expire", step=self.scheduler.steps, uid=seq.uid,
                              produced=seq.generated_tokens)
            self._record_resilience("serving_deadline_expired", uid=seq.uid,
                                    produced=seq.generated_tokens,
                                    seen_tokens=seq.seen_tokens)
        # phase attribution: a no-op (and no clock read) unless the profiler
        # is on AND inside a serve-loop iteration
        self.phase_profiler.mark("expire")

    def _pump_admissions(self, my: set, results: Dict[int, RequestResult],
                         strict: bool) -> None:
        """Move queued tickets into the state manager while the pool has
        headroom; tickets that expired waiting become deadline_expired results
        without ever owning a block.  Tickets stay queued while the live cap
        or pool pressure leaves no headroom."""
        cfg = self.resilience
        while len(self.admission):
            live = self.manager.live_uids()
            if cfg.max_live_seqs and len(live) >= cfg.max_live_seqs:
                return
            if live and self.manager.kv_utilization() >= cfg.shed_kv_utilization:
                return  # pool pressure: hold the queue (something is live, and
                # retiring it reopens the pump)
            ticket, expired = self.admission.pop_ready()
            for t in expired:
                self.tracer.event("queue_expired", step=self.scheduler.steps, uid=t.uid)
                self._forget_prefix(t.uid)  # died queued: retire never fires
                if t.uid in my and t.uid not in results:
                    self._deadline_expired_total += 1
                    self._record_resilience("serving_deadline_expired", uid=t.uid,
                                            produced=0, queued=True)
                    if strict:
                        raise RuntimeError(f"request {t.uid} deadline_expired while queued")
                    results[t.uid] = RequestResult(
                        uid=t.uid, status=DEADLINE_EXPIRED, retryable=True,
                        reason="deadline expired in the admission queue")
                    self._journal_terminal(t.uid, DEADLINE_EXPIRED, retryable=True,
                                           reason="deadline expired in the admission queue")
                    self.tracer.on_terminal(t.uid, DEADLINE_EXPIRED, t=self.tracer.last_now,
                                            reason="deadline expired in the admission queue")
            if ticket is None:
                break
            now = self._clock()
            self.tracer.tick(now)
            wait = max(0.0, now - ticket.enqueue_t)
            self._queue_wait_s = wait
            # the queue-wait histogram feeds health() even with span tracing
            # off: the wait is already computed, pure host arithmetic
            self.tracer.observe_queue_wait(wait)
            # crash recovery: a re-admitted ticket's token history is
            # prompt + already-emitted prefix (prefilled in one pass, the KV
            # rebuild), with prompt_len pinned so the prefix keeps counting
            # as generated output, not prompt
            seq = self.manager.add_sequence(ticket.uid, ticket.prompt + ticket.prefix,
                                            priority=ticket.priority, deadline=ticket.deadline,
                                            queue_wait_s=wait, prompt_len=len(ticket.prompt),
                                            tenant=ticket.tenant,
                                            service_class=ticket.service_class)
            # admit-time prefix lookup; the scheduler re-checks per prefill
            # chunk for blocks computed later
            self._map_prefix(seq)
            self.tracer.event("admit", step=self.scheduler.steps, uid=ticket.uid,
                              **({"recovered": True} if ticket.recovered else {}))
            self.tracer.on_admit(ticket.uid, now, queue_wait_s=wait,
                                 prompt_len=ticket.total_len,
                                 tenant=(ticket.tenant if self.qos is not None else None))

    def _prewarm(self, max_new_tokens: int, greedy: bool = True) -> None:
        """Serve-time prewarm: build the forward bucket programs (capture
        their graphs, on the card) that this call's queued and live requests
        are about to hit, at most ``serving_fastpath.prewarm_buckets`` of
        them, so the first wave does not pay a capture mid-serve.  With
        speculative decoding armed, also the verify bucket of every rung of
        the adaptive-k ladder at the decode and verify table widths (as many
        again at most), so a k drift mid-serve replays a built program."""
        fp = self.fastpath
        if not fp.enabled or fp.prewarm_buckets <= 0:
            return
        depth, max_prompt = self.admission.queued_stats()
        live = self.manager.live_uids()
        for uid in live:
            max_prompt = max(max_prompt, len(self.manager.seqs[uid].tokens))
        n_total = min(depth + len(live), self.scheduler.max_seqs)
        if n_total <= 0 or max_prompt <= 0:
            return
        bs = self.manager.block_size
        w_prefill = self._stepped_width(-(-(max_prompt + 1) // bs))
        w_decode = self._stepped_width(-(-(max_prompt + 1 + max_new_tokens) // bs))
        n_b = self._bucket(n_total)
        t_pf = self._bucket(max(1, min(self.scheduler.token_budget, max_prompt)))
        candidates = [(n_b, 1, w_prefill), (n_b, 1, w_decode),
                      (n_b, t_pf, w_prefill), (n_b, t_pf, w_decode)]
        warmed = 0
        for key in candidates:
            if warmed >= fp.prewarm_buckets:
                break
            if ("fwd", key) in self.programs:
                continue
            self._fwd_program(key, prewarmed=True)
            warmed += 1
        if self._drafter is None or self._spec_controller is None:
            return
        sample_cfg = None if greedy else (self.config.temperature, self.config.top_k,
                                          self.config.top_p)
        ladder = self._spec_controller.ladder
        # deepest verify reach: prompt + the round's input token + the run
        # budget + the largest rung of draft overshoot the rollback trims
        w_verify = self._stepped_width(-(-(max_prompt + 1 + max_new_tokens + max(ladder)) // bs))
        warmed_spec = 0
        for rung in ladder:
            for w in sorted({w_decode, w_verify}):
                if warmed_spec >= fp.prewarm_buckets:
                    return
                if ("spec_verify", (n_b, rung, w, sample_cfg)) in self.programs:
                    continue
                self._verify_program(n_b, rung, w, sample_cfg, prewarmed=True)
                warmed_spec += 1

    def _handle_stall(self, my: set, results: Dict[int, RequestResult],
                      strict: bool) -> None:
        self.stalls_total += 1
        self.tracer.event("stall", step=self.scheduler.steps,
                          live_seqs=len(self.manager.seqs),
                          free_blocks=self.manager.allocator.free_blocks)
        # snapshot AFTER the stall event, so the dump's flight-recorder tail
        # ends with the trip itself
        snapshot = self.state_snapshot()
        self._record_resilience("serving_stall", live_seqs=len(snapshot["live_uids"]),
                                free_blocks=snapshot["free_blocks"],
                                queue_depth=snapshot["queue_depth"])
        steps = self.resilience.stall_watchdog_steps
        if strict:
            raise ServingStalledError(
                f"serving made no progress for {steps} consecutive steps with "
                f"{len(snapshot['live_uids'])} live sequences and "
                f"{snapshot['free_blocks']} free KV blocks — see .snapshot for the "
                f"full engine state", snapshot)
        # non-strict: fail the stuck requests (live AND still-queued), reclaim
        # their blocks, and keep serving the rest
        reason = f"stalled: no scheduling progress for {steps} steps"
        for uid in list(self.manager.seqs):
            if uid in my and uid not in results:
                seq = self.manager.seqs[uid]
                results[uid] = RequestResult(uid=uid, status=FAILED, reason=reason,
                                             tokens=list(seq.tokens), retryable=True,
                                             preemptions=seq.preemptions,
                                             queue_wait_s=seq.queue_wait_s)
                self._journal_terminal(uid, FAILED, reason=reason, retryable=True)
                self.tracer.on_terminal(uid, FAILED, reason=reason, t=self.tracer.last_now)
                self.manager.retire(uid, completed=False)
        for ticket in self.admission.drain():
            self._forget_prefix(ticket.uid)  # died queued: retire never fires
            if ticket.uid in my and ticket.uid not in results:
                results[ticket.uid] = RequestResult(uid=ticket.uid, status=FAILED,
                                                    reason=reason + " (still queued)",
                                                    retryable=True)
                self._journal_terminal(ticket.uid, FAILED, retryable=True,
                                       reason=reason + " (still queued)")
                self.tracer.on_terminal(ticket.uid, FAILED, t=self.tracer.last_now,
                                        reason=reason + " (still queued)")

    def _progress_signature(self):
        return (tuple(sorted((uid, s.seen_tokens, len(s.tokens), s.done)
                             for uid, s in self.manager.seqs.items())),
                len(self.admission), self.manager.allocator.free_blocks)

    def _record_resilience(self, event: str, **fields) -> None:
        if self.telemetry is not None:
            self.telemetry.record_resilience(event, step=self.scheduler.steps, **fields)

    def _journal_terminal(self, uid: int, status: str, *,
                          finish_reason: Optional[str] = None,
                          reason: Optional[str] = None,
                          retryable: bool = False) -> None:
        """Mirror a ``RequestResult`` construction into the durable journal
        (only for uids this journal admitted — foreign put() traffic keeps
        its own lifecycle).  Terminal records order after their buffered
        token deltas; strict mode writes + fsyncs them eagerly, throughput
        mode lands them at the next wave flush (a one-iteration window — a
        crash inside it re-serves the finished request from its journaled
        prefix)."""
        j = self.journal
        if j is None or uid not in j.watched:
            return
        seq = self.manager.seqs.get(uid)
        j.record_terminal(uid, status, finish_reason=finish_reason, reason=reason,
                          retryable=retryable,
                          n_tokens=seq.generated_tokens if seq is not None else 0)

    def state_snapshot(self) -> Dict[str, Any]:
        """Serving state for stall diagnostics: live uids, per-sequence
        progress and block-table occupancy, allocator free count, queue
        depth, the KV census with its per-block table, the prefix cache, the
        recovery counters, and the flight recorder's tail (the events that
        led here)."""
        alloc = self.manager.allocator
        return {
            "live_uids": sorted(self.manager.seqs),
            "sequences": {uid: {"seen_tokens": s.seen_tokens,
                                "pending_tokens": s.pending_tokens,
                                "blocks": list(s.blocks),
                                "done": s.done,
                                "preemptions": s.preemptions,
                                "deadline": s.deadline}
                          for uid, s in self.manager.seqs.items()},
            "free_blocks": alloc.free_blocks,
            "num_blocks": alloc.num_blocks,
            "queue_depth": len(self.admission),
            "scheduler_steps": self.scheduler.steps,
            "forward_steps": self.forward_steps,
            # the per-block census table (owner, age, residency) beside the
            # rollups health() carries: which blocks are pinned where
            "kv": self._kv_snapshot(with_table=True),
            "prefix_cache": self._prefix_cache_snapshot(),
            "fault_tolerance": self._fault_tolerance_snapshot(),
            # phase budget and compile provenance ride the stall dump
            "perf": self._perf_snapshot(),
            "flight_recorder": self.tracer.recorder.tail(),
        }

    def _kv_snapshot(self, with_table: bool = False) -> Dict[str, Any]:
        """The ``health()["kv"]`` / ``state_snapshot()["kv"]`` payload: census
        rollups, the prefix observatory's report and the capacity forecast,
        plus the census table on request."""
        if self.kv_obs is None:
            return {"enabled": False}
        snap = self.kv_obs.snapshot(self.manager.allocator.free_blocks)
        if with_table:
            snap["census_table"] = self.kv_obs.census.table()
        return snap

    def _prefix_cache_snapshot(self) -> Dict[str, Any]:
        """Realized sharing: hits, CoW copies, tokens saved, hit rate."""
        cache = self.manager.prefix_cache
        return cache.snapshot() if cache is not None else {"enabled": False}

    def _fault_tolerance_snapshot(self) -> Dict[str, Any]:
        """Supervised restarts, requests recovered with a prefix, the
        drain-only flag, the journal's bytes on disk, and whether the
        journal and the heartbeat are armed."""
        return {
            **{k: self.ft_stats[k] for k in ("restarts_total", "recovered_requests_total",
                                             "degraded")},
            "journal_bytes": journal_bytes(self.journal.path if self.journal is not None
                                           else None),
            "journaling": self.journal is not None and self.journal.enabled,
            "heartbeat": bool(getattr(self._heartbeat, "enabled", False)),
        }

    def health(self) -> Dict[str, Any]:
        """Liveness snapshot for external probes: pool state, queue depth,
        the lifetime resilience counters, KV-pool observability, the
        realized prefix cache, the fast path's host-link counters, the SLO
        latency histograms, the recovery counters, the perf observatory,
        the flight recorder's recent events, the QoS ledger and speculative
        decoding's: the keys of the JAX engine's ``health()``."""
        return {
            "generated_at": self._health_generated_at,
            "live_seqs": len(self.manager.live_uids()),
            "queue_depth": len(self.admission),
            "free_blocks": self.manager.allocator.free_blocks,
            "kv_utilization": self.manager.kv_utilization(),
            # census rollups, the observatory's counterfactual, the forecast
            "kv": self._kv_snapshot(),
            "prefix_cache": self._prefix_cache_snapshot(),
            "scheduler_steps": self.scheduler.steps,
            "completed_total": self.manager.completed_requests,
            "failed_total": self.manager.failed_requests,
            "shed_total": self.admission.shed_total,
            "preempted_total": self.scheduler.preempted_total,
            "deadline_expired_total": self._deadline_expired_total,
            "stall_streak": self._stall_streak,
            "stalls_total": self.stalls_total,
            "fastpath": self.counters.snapshot(),
            # SLO latency percentiles: the admission pump feeds queue_wait
            # even with span tracing off; ttft/tbt/e2e fill in once
            # serving_tracing.enabled is set
            "queue_wait": self.tracer.queue_wait.snapshot(),
            "latency": self.tracer.latency_snapshot(),
            "tracing_enabled": self.tracer.enabled,
            # crash durability: supervised restarts, requests recovered with
            # an emitted prefix, journal size on disk, drain-only flag
            "fault_tolerance": self._fault_tolerance_snapshot(),
            # serving performance observatory: per-phase wall attribution,
            # compile provenance, live roofline (the ledger and roofline
            # report with the phase profiler off too)
            "perf": self._perf_snapshot(),
            # the recent engine-event history (always on, bounded ring)
            "flight_recorder": self.tracer.recorder.tail(32),
            # multi-tenant QoS: per-tenant admit/shed/token counters —
            # {"enabled": False} when the policy layer is off so probes can
            # key on one shape
            "qos": (self.qos.snapshot() if self.qos is not None else {"enabled": False}),
            # speculative decoding: the adaptive-k controller, the lifetime
            # proposal/acceptance counters and the tokens-per-verify
            # histogram; {"enabled": False} with the section off
            "spec_decode": self._spec_snapshot(),
        }
