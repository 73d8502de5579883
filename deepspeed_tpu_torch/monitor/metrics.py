"""Unified metrics registry: the export half of observability.

Counterpart of ``deepspeed_tpu/monitor/metrics.py`` (its elastic agent
adapter waits for that component).  The reference DeepSpeed ships a
``monitor/`` subsystem with PUSH backends (TensorBoard/WandB/CSV); a serving
fleet needs the PULL half: a registry of named counters/gauges/histograms an
HTTP endpoint renders as Prometheus text and an aggregator merges across
ranks and worker restarts.

Three layers, all host-side (nothing here imports torch or numpy, so a
population can never read a device value):

- :class:`MetricsRegistry`: named metric families (``counter`` | ``gauge`` |
  ``histogram``) with label sets.  Adapters POPULATE it by snapshotting host
  state the sources already own (:func:`populate_from_engine` reads the v2
  engine's ``ServeCounters``/admission/scheduler/tracer ints,
  :func:`populate_from_telemetry` the training collector's cached last
  record, :func:`populate_from_supervisor` the serving supervisor's
  lifecycle counters, :func:`populate_from_router` the fleet router's).
- snapshot / restore: :meth:`MetricsRegistry.snapshot` is a JSON-safe dict
  (histograms carry their raw log-buckets, so cross-process merges stay
  EXACT) written atomically per rank by workers and read back tolerantly by
  supervisors (:mod:`.ops_server` owns the file IO).
- :class:`FleetAggregator`: merges per-rank snapshots into one fleet-level
  registry: counters and gauges keep a ``rank`` label, histograms fold into
  one fleet histogram via ``StreamingHistogram.merge``, and a worker RESTART
  (a generation bump resets the process's counters to zero) is absorbed by
  carrying the dead generation's last-seen totals, so merged counters are
  monotone across restarts.
"""

import math
import re
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .tracing import StreamingHistogram

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

LabelKey = Tuple[Tuple[str, str], ...]


def label_key(labels: Optional[Dict[str, str]]) -> LabelKey:
    """Canonical (sorted, stringified) form of a label set — the sample key."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _clone_histogram(hist: StreamingHistogram) -> StreamingHistogram:
    out = StreamingHistogram(hist.buckets_per_decade, hist.min_value)
    out.merge(hist)
    return out


class MetricFamily:
    """One named metric family: type, help text, and labeled samples.

    ``samples`` maps a canonical label tuple to either a float (counter /
    gauge) or a :class:`StreamingHistogram` copy (histogram) — a registry
    owns its histogram values (set_histogram clones), so a later mutation of
    the source never skews an already-collected snapshot.
    """

    def __init__(self, name: str, kind: str, help_text: str = ""):
        if not METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r} (want "
                             f"[a-zA-Z_:][a-zA-Z0-9_:]*)")
        if kind not in (COUNTER, GAUGE, HISTOGRAM):
            raise ValueError(f"metric {name}: unknown type {kind!r}")
        self.name = name
        self.kind = kind
        self.help = str(help_text)
        self.samples: Dict[LabelKey, Any] = {}

    def validate_labels(self, labels: Optional[Dict[str, str]]) -> LabelKey:
        key = label_key(labels)
        for lname, _ in key:
            if not LABEL_NAME_RE.match(lname):
                raise ValueError(f"metric {self.name}: invalid label name {lname!r}")
            if lname == "le":
                raise ValueError(f"metric {self.name}: label 'le' is reserved "
                                 f"for histogram buckets")
        return key


class MetricsRegistry:
    """Named counter/gauge/histogram families with labels.

    Values are SET, not incremented: the ops plane snapshots lifetime
    counters the sources already maintain (``ServeCounters.host_syncs``,
    ``admission.shed_total``, ...) instead of double-counting events through
    a second instrumentation path.  A counter set to a smaller value than it
    already holds raises — catching exactly the bug class (a source counter
    that resets without a generation bump) that silently corrupts every
    downstream ``rate()``.  Restart-induced resets are legal and handled one
    layer up (:class:`FleetAggregator` carries totals across generations).
    """

    def __init__(self, namespace: str = "dstpu", generation: int = 0):
        self.namespace = str(namespace)
        self.generation = int(generation)
        self.families: Dict[str, MetricFamily] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []

    # ------------------------------------------------------------- population
    def family(self, name: str, kind: str, help_text: str = "") -> MetricFamily:
        fam = self.families.get(name)
        if fam is None:
            fam = MetricFamily(name, kind, help_text)
            self.families[name] = fam
        elif fam.kind != kind:
            raise ValueError(f"metric {name} already registered as {fam.kind}, "
                             f"not {kind}")
        if help_text and not fam.help:
            fam.help = str(help_text)
        return fam

    def set_counter(self, name: str, value: float, *,
                    labels: Optional[Dict[str, str]] = None,
                    help_text: str = "") -> None:
        value = float(value)
        if value < 0 or not math.isfinite(value):
            raise ValueError(f"counter {name}: value must be finite and >= 0, "
                             f"got {value}")
        fam = self.family(name, COUNTER, help_text)
        key = fam.validate_labels(labels)
        prev = fam.samples.get(key, 0.0)
        if value < prev:
            raise ValueError(
                f"counter {name}{dict(key)} went backwards ({prev} -> {value}) "
                f"within one generation — a source counter reset without a "
                f"restart; wire the reset through a generation bump so the "
                f"fleet aggregator can carry the old total")
        fam.samples[key] = value

    def set_gauge(self, name: str, value: float, *,
                  labels: Optional[Dict[str, str]] = None,
                  help_text: str = "") -> None:
        fam = self.family(name, GAUGE, help_text)
        fam.samples[fam.validate_labels(labels)] = float(value)

    def set_histogram(self, name: str, hist: StreamingHistogram, *,
                      labels: Optional[Dict[str, str]] = None,
                      help_text: str = "") -> None:
        fam = self.family(name, HISTOGRAM, help_text)
        fam.samples[fam.validate_labels(labels)] = _clone_histogram(hist)

    # ------------------------------------------------------------- collection
    def register_collector(self, fn: Callable[["MetricsRegistry"], None]) -> None:
        """``fn(registry)`` re-populates some families; run by :meth:`collect`.

        Collectors run on the OWNING thread (the serve loop / agent poll
        loop), never from a scrape handler — the HTTP side serves pre-rendered
        cached text, so a scrape can never execute source-reading code."""
        self._collectors.append(fn)

    def collect(self) -> Dict[str, MetricFamily]:
        for fn in self._collectors:
            fn(self)
        return self.families

    # ------------------------------------------------------- snapshot / merge
    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe deep dump: the per-rank exchange format.  Histograms
        carry raw buckets (not quantiles) so a cross-process merge is exact —
        quantiles of the merged histogram equal quantiles over the union of
        the original samples."""
        fams: Dict[str, Any] = {}
        for name, fam in self.families.items():
            samples = []
            for key, value in fam.samples.items():
                entry: Dict[str, Any] = {"labels": dict(key)}
                if fam.kind == HISTOGRAM:
                    entry["histogram"] = {
                        "buckets_per_decade": value.buckets_per_decade,
                        "min_value": value.min_value,
                        "counts": {str(i): n for i, n in value.counts.items()},
                        "count": value.count,
                        "total": value.total,
                        "max": value.max_seen,
                    }
                else:
                    entry["value"] = value
                samples.append(entry)
            fams[name] = {"type": fam.kind, "help": fam.help, "samples": samples}
        return {"namespace": self.namespace, "generation": self.generation,
                "families": fams}

    @staticmethod
    def _histogram_from_snapshot(h: Dict[str, Any]) -> StreamingHistogram:
        hist = StreamingHistogram(int(h["buckets_per_decade"]),
                                  float(h["min_value"]))
        hist.counts = {int(i): int(n) for i, n in h.get("counts", {}).items()}
        hist.count = int(h.get("count", 0))
        hist.total = float(h.get("total", 0.0))
        hist.max_seen = h.get("max")
        return hist

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any]) -> "MetricsRegistry":
        reg = cls(namespace=snap.get("namespace", "dstpu"),
                  generation=int(snap.get("generation", 0)))
        for name, fam in snap.get("families", {}).items():
            for entry in fam.get("samples", []):
                labels = entry.get("labels") or None
                if fam["type"] == HISTOGRAM:
                    reg.set_histogram(name, cls._histogram_from_snapshot(
                        entry["histogram"]), labels=labels, help_text=fam.get("help", ""))
                elif fam["type"] == COUNTER:
                    reg.set_counter(name, float(entry["value"]), labels=labels,
                                    help_text=fam.get("help", ""))
                else:
                    reg.set_gauge(name, float(entry["value"]), labels=labels,
                                  help_text=fam.get("help", ""))
        return reg


class FleetAggregator:
    """Merge per-rank registry snapshots into one fleet registry, carrying
    counters (and histogram contents) across worker restarts.

    A supervised worker that crashes and restarts comes back with all of its
    process-lifetime counters at zero; serving its raw post-restart values
    would make every fleet counter jump backwards — poison for monitoring
    that computes rates.  The aggregator watches each rank's ``generation``
    stamp: when it advances, the dead generation's last-seen counter totals
    (and histogram buckets) fold into a per-rank CARRY, and the merged value
    becomes ``carry + current`` — monotone across any number of restarts.

    Gauges are point-in-time state and simply take the newest value per rank.
    Counters and gauges keep a ``rank`` label in the merged view; histograms
    merge rank-blind into one fleet histogram per family+label set
    (``StreamingHistogram.merge``), because fleet SLO percentiles are only
    meaningful over the union of samples.
    """

    def __init__(self):
        # rank -> generation of the newest absorbed snapshot
        self._generation: Dict[int, int] = {}
        # rank -> {(family, labelkey): last seen counter value this generation}
        self._last_counters: Dict[int, Dict[Tuple[str, LabelKey], float]] = {}
        # rank -> {(family, labelkey): carried total from dead generations}
        self._carry_counters: Dict[int, Dict[Tuple[str, LabelKey], float]] = {}
        # same split for histograms (carried = merged dead-generation buckets)
        self._last_hists: Dict[int, Dict[Tuple[str, LabelKey], StreamingHistogram]] = {}
        self._carry_hists: Dict[int, Dict[Tuple[str, LabelKey], StreamingHistogram]] = {}
        # rank -> {(family, labelkey): value} newest gauges
        self._gauges: Dict[int, Dict[Tuple[str, LabelKey], float]] = {}
        # family metadata (help/type) seen newest-wins
        self._meta: Dict[str, Tuple[str, str]] = {}
        self.absorbed_total = 0

    def _roll_generation(self, rank: int) -> None:
        carry = self._carry_counters.setdefault(rank, {})
        for key, value in self._last_counters.get(rank, {}).items():
            carry[key] = carry.get(key, 0.0) + value
        hcarry = self._carry_hists.setdefault(rank, {})
        for key, hist in self._last_hists.get(rank, {}).items():
            held = hcarry.get(key)
            if held is None:
                hcarry[key] = hist
            elif (held.buckets_per_decade == hist.buckets_per_decade
                  and held.min_value == hist.min_value):
                held.merge(hist)
            else:  # a restart changed the bucket shape: the old samples can't
                hcarry[key] = hist  # merge exactly — keep the newest shape
        self._last_counters[rank] = {}
        self._last_hists[rank] = {}

    def absorb(self, rank: int, snapshot: Dict[str, Any]) -> None:
        """Fold one rank's registry snapshot in (newest wins per rank)."""
        rank = int(rank)
        generation = int(snapshot.get("generation", 0))
        prev = self._generation.get(rank)
        if prev is not None and generation > prev:
            self._roll_generation(rank)
        if prev is None or generation >= prev:
            self._generation[rank] = generation
        elif generation < prev:
            return  # a stale straggler snapshot must not roll anything back
        reg = MetricsRegistry.from_snapshot(snapshot)
        self.absorbed_total += 1
        counters = self._last_counters.setdefault(rank, {})
        hists = self._last_hists.setdefault(rank, {})
        gauges = self._gauges.setdefault(rank, {})
        for name, fam in reg.families.items():
            self._meta[name] = (fam.kind, fam.help)
            for key, value in fam.samples.items():
                if fam.kind == COUNTER:
                    counters[(name, key)] = float(value)
                elif fam.kind == HISTOGRAM:
                    hists[(name, key)] = value
                else:
                    gauges[(name, key)] = float(value)

    def ranks(self) -> List[int]:
        return sorted(self._generation)

    def registry(self, namespace: str = "dstpu") -> MetricsRegistry:
        """The merged fleet view as a fresh registry (render-ready)."""
        reg = MetricsRegistry(namespace=namespace)
        for rank in self.ranks():
            rl = {"rank": str(rank)}
            totals: Dict[Tuple[str, LabelKey], float] = dict(
                self._carry_counters.get(rank, {}))
            for key, value in self._last_counters.get(rank, {}).items():
                totals[key] = totals.get(key, 0.0) + value
            for (name, key), value in sorted(totals.items()):
                kind, help_text = self._meta.get(name, (COUNTER, ""))
                reg.set_counter(name, value, labels={**dict(key), **rl},
                                help_text=help_text)
            for (name, key), value in sorted(self._gauges.get(rank, {}).items()):
                _, help_text = self._meta.get(name, (GAUGE, ""))
                reg.set_gauge(name, value, labels={**dict(key), **rl},
                              help_text=help_text)
        # histograms: rank-blind fleet merge (the StreamingHistogram.merge
        # production call-site fleet aggregation was designed for).  On a
        # bucket-shape conflict, LIVE data wins: a current-generation
        # histogram whose shape differs from the carried one (a restart
        # changed the histogram config) replaces it — same newest-wins
        # resolution as _roll_generation, so a reconfigured worker's fresh
        # SLO samples never silently vanish behind dead-generation buckets
        merged: Dict[Tuple[str, LabelKey], StreamingHistogram] = {}
        for source, live in ((self._carry_hists, False), (self._last_hists, True)):
            for rank in sorted(source):
                for key, hist in sorted(source[rank].items()):
                    held = merged.get(key)
                    if held is None:
                        merged[key] = _clone_histogram(hist)
                    elif (held.buckets_per_decade == hist.buckets_per_decade
                          and held.min_value == hist.min_value):
                        held.merge(hist)
                    elif live:
                        merged[key] = _clone_histogram(hist)
        for (name, key), hist in sorted(merged.items()):
            _, help_text = self._meta.get(name, (HISTOGRAM, ""))
            reg.set_histogram(name, hist, labels=dict(key) or None,
                              help_text=help_text)
        return reg


# ==========================================================================
# Adapters: snapshot the state the sources already maintain into a registry.
# All reads are host-native python ints/floats the sources own: populating a
# registry can never read a device value (the same contract as
# runtime/heartbeat.py; this module imports neither torch nor numpy).
# ==========================================================================

def populate_from_engine(reg: MetricsRegistry, engine) -> None:
    """v2 serving engine → registry: ServeCounters, admission/scheduler/
    manager counters and gauges, fault-tolerance section, and the tracer's
    SLO histograms (TTFT/TBT/e2e/queue-wait)."""
    c = engine.counters
    counter_help = {
        "host_syncs": "device->host materializations in the serve loop",
        "dispatches": "device program launches (forward/pick/burst/scatter)",
        "uploads": "host->device transfers issued",
        "upload_ints": "int32 elements moved host->device",
        "compiles": "distinct compiled programs (bucket shapes)",
        "loop_iterations": "serve-loop iterations observed",
        "step_tokens": "tokens emitted via stepwise decode",
        "burst_tokens": "tokens emitted via fused decode bursts",
        "flushes": "pipeline flushes forced by wave boundaries",
    }
    for field, help_text in counter_help.items():
        reg.set_counter(f"{reg.namespace}_fastpath_{field}_total",
                        getattr(c, field), help_text=help_text)
    reg.set_counter(f"{reg.namespace}_serving_shed_total",
                    engine.admission.shed_total,
                    help_text="requests load-shed at the admission door")
    # structured backpressure: per-code shed counters plus the
    # door's own latest retry_after_s estimate — a fleet router (or client)
    # backs off for the hinted interval instead of guessing
    for code, count in sorted(engine.admission.shed_by_code.items()):
        reg.set_counter(f"{reg.namespace}_serving_shed_reason_total", count,
                        labels={"code": code},
                        help_text="requests shed, by structured reason code "
                                  "(sums to serving_shed_total)")
    for code, hint in sorted(engine.admission.last_retry_after.items()):
        reg.set_gauge(f"{reg.namespace}_serving_shed_retry_after_seconds",
                      hint, labels={"code": code},
                      help_text="latest retry_after_s backpressure hint "
                                "attached to a shed of this code")
    reg.set_counter(f"{reg.namespace}_serving_preempted_total",
                    engine.scheduler.preempted_total,
                    help_text="KV-pressure preemptions (incl. exhausted evictions)")
    reg.set_counter(f"{reg.namespace}_serving_deadline_expired_total",
                    engine._deadline_expired_total,
                    help_text="requests evicted past their TTL deadline")
    reg.set_counter(f"{reg.namespace}_serving_completed_total",
                    engine.manager.completed_requests,
                    help_text="requests retired complete")
    reg.set_counter(f"{reg.namespace}_serving_failed_total",
                    engine.manager.failed_requests,
                    help_text="requests retired failed")
    reg.set_counter(f"{reg.namespace}_serving_stalls_total",
                    engine.stalls_total,
                    help_text="progress-watchdog trips (lifetime)")
    reg.set_counter(f"{reg.namespace}_scheduler_steps_total",
                    engine.scheduler.steps,
                    help_text="SplitFuse scheduler steps run")
    reg.set_gauge(f"{reg.namespace}_serving_live_seqs",
                  len(engine.manager.live_uids()),
                  help_text="live (unfinished) sequences in the state manager")
    reg.set_gauge(f"{reg.namespace}_serving_queue_depth",
                  len(engine.admission),
                  help_text="tickets waiting in the admission queue")
    # ---- KV-pool families, unified under ONE serving_kv_* namespace
    # (canonical names only, as in the JAX package)
    ns_kv = f"{reg.namespace}_serving_kv"
    reg.set_gauge(f"{ns_kv}_free_blocks",
                  engine.manager.allocator.free_blocks,
                  help_text="free blocks in the paged KV pool")
    reg.set_gauge(f"{ns_kv}_utilization",
                  engine.manager.kv_utilization(),
                  help_text="paged KV pool utilization [0, 1]")
    # ---- realized copy-on-write prefix caching: the tree's
    # lifetime counters next to the observatory's counterfactual families
    # below — agreement between the two is the cache working as predicted
    prefix_cache = getattr(engine.manager, "prefix_cache", None)
    if prefix_cache is not None:
        reg.set_counter(f"{ns_kv}_prefix_hits_total",
                        prefix_cache.hit_blocks_total,
                        help_text="prompt blocks served from the prefix tree "
                                  "(read-only shared mappings + CoW copies)")
        reg.set_counter(f"{ns_kv}_prefill_tokens_saved_total",
                        prefix_cache.tokens_saved_total,
                        help_text="prefill tokens skipped by mapping shared "
                                  "prefix blocks (REALIZED; the counterfactual "
                                  "twin is serving_kv_prefix_tokens_saved_total)")
        reg.set_gauge(f"{ns_kv}_prefix_realized_hit_rate",
                      prefix_cache.realized_hit_rate(),
                      help_text="shared-or-copied blocks over all full prompt "
                                "blocks (lifetime) — read next to the "
                                "counterfactual serving_kv_prefix_hit_rate")
        reg.set_counter(f"{ns_kv}_prefix_cow_copies_total",
                        prefix_cache.cow_copies_total,
                        help_text="copy-on-write block copies (prompts cached "
                                  "to their last token)")
        reg.set_counter(f"{ns_kv}_prefix_deferrals_total",
                        prefix_cache.deferrals_total,
                        help_text="prefill chunks deferred one step onto a "
                                  "block another scheduled request was "
                                  "computing")
        reg.set_gauge(f"{ns_kv}_prefix_tree_entries",
                      len(prefix_cache.entries),
                      help_text="shareable fully-computed prompt blocks "
                                "currently in the prefix tree")
    # block-level observability: census, counterfactual prefix-
    # cache opportunity, capacity forecast — all host ints the engine's
    # kv_obs already assembled (absent => kv observability disabled)
    kv_obs = getattr(engine, "kv_obs", None)
    if kv_obs is not None:
        census, fc, prefix = kv_obs.census, kv_obs.forecaster, kv_obs.prefix
        reg.set_gauge(f"{ns_kv}_allocated_blocks", census.allocated_blocks,
                      help_text="census-owned blocks in the paged KV pool")
        reg.set_gauge(f"{ns_kv}_shared_blocks", census.shared_blocks(),
                      help_text="blocks currently mapped by more than one "
                                "sequence (copy-on-write prefix sharing)")
        reg.set_gauge(f"{ns_kv}_fragmentation_tokens",
                      census.fragmentation_tokens(),
                      help_text="allocated-but-unfilled token slots "
                                "(block-granularity + prefill/burst headroom)")
        reg.set_counter(f"{ns_kv}_blocks_allocated_total",
                        census.blocks_allocated_total,
                        help_text="KV blocks allocated (lifetime)")
        reg.set_counter(f"{ns_kv}_blocks_freed_total",
                        census.blocks_freed_total,
                        help_text="KV blocks freed (lifetime)")
        reg.set_histogram(f"{ns_kv}_block_age_steps", census.age_histogram(),
                          help_text="serve steps since each live block was "
                                    "allocated (a fused burst of k counts k)")
        reg.set_histogram(f"{ns_kv}_block_idle_steps", census.idle_histogram(),
                          help_text="serve steps since each live block was "
                                    "last written (cold-block signal)")
        reg.set_histogram(f"{ns_kv}_blocks_per_request",
                          census.blocks_per_request,
                          help_text="peak blocks held per retired request")
        reg.set_gauge(f"{ns_kv}_prefix_duplicate_blocks",
                      prefix.last_report["duplicate_blocks"],
                      help_text="duplicate prompt token-blocks across "
                                "live+admitted requests (last serve pass)")
        reg.set_gauge(f"{ns_kv}_prefix_hit_rate",
                      prefix.last_report["hit_rate"],
                      help_text="counterfactual prefix-cache hit-rate "
                                "(last serve pass)")
        reg.set_counter(f"{ns_kv}_prefix_tokens_saved_total",
                        prefix.prefill_tokens_saved_total,
                        help_text="prefill tokens a block-granular prefix "
                                  "cache would have saved (lifetime)")
        reg.set_counter(f"{ns_kv}_prefix_passes_total", prefix.passes_total,
                        help_text="PrefixObservatory passes run")
        reg.set_gauge(f"{ns_kv}_alloc_rate_blocks_per_step", fc.alloc_rate,
                      help_text="EWMA block allocation rate per serve step")
        reg.set_gauge(f"{ns_kv}_free_rate_blocks_per_step", fc.free_rate,
                      help_text="EWMA block free rate per serve step")
        ste = fc.steps_to_exhaustion()
        if ste is not None:
            # absent while the pool is not trending toward exhaustion — an
            # inf gauge would render fine on /metrics but poison the per-rank
            # JSON exchange files (json.dumps emits the non-RFC token
            # Infinity); absence is the idiomatic "no prediction"
            reg.set_gauge(f"{ns_kv}_steps_to_exhaustion", ste,
                          help_text="forecast serve steps until the KV pool "
                                    "exhausts at current net consumption "
                                    "(absent while not trending toward "
                                    "exhaustion) — read next to "
                                    "serving_shed_total/preempted_total")
        else:
            # the ops registry persists across refreshes: a gauge set while
            # the pool was trending must not linger once the prediction
            # clears, so the family is dropped, not left stale
            reg.families.pop(f"{ns_kv}_steps_to_exhaustion", None)
        reg.set_gauge(f"{ns_kv}_under_pressure",
                      1.0 if kv_obs.under_pressure else 0.0,
                      help_text="1 while steps-to-exhaustion is below the "
                                "configured pressure threshold")
        reg.set_counter(f"{ns_kv}_invariant_checks_total",
                        kv_obs.invariant_checks_total,
                        help_text="census-vs-allocator partition checks run")
    # scheduler per-step gauges: queue depth / token occupancy / ...
    for key, value in engine.scheduler.last_gauges.items():
        if key == "preempted_total":
            continue  # already exported as a counter above
        if key == "kv_block_utilization":
            # canonical spelling under the serving_kv_* namespace
            reg.set_gauge(f"{ns_kv}_block_utilization", value,
                          help_text="paged KV pool utilization at the last "
                                    "scheduled step")
            continue
        reg.set_gauge(f"{reg.namespace}_scheduler_{key}", value,
                      help_text="SplitFuse scheduler per-step gauge")
    # fault tolerance: restart/recovery counters + journal state
    ft = engine._fault_tolerance_snapshot()
    reg.set_counter(f"{reg.namespace}_serving_restarts_total",
                    ft["restarts_total"],
                    help_text="supervised engine restarts")
    reg.set_counter(f"{reg.namespace}_serving_recovered_requests_total",
                    ft["recovered_requests_total"],
                    help_text="requests re-admitted with a journaled prefix")
    reg.set_gauge(f"{reg.namespace}_serving_degraded",
                  1.0 if ft["degraded"] else 0.0,
                  help_text="1 when the supervisor degraded to drain-only mode")
    reg.set_gauge(f"{reg.namespace}_serving_journal_bytes", ft["journal_bytes"],
                  help_text="durable request-journal size on disk")
    # SLO latency histograms: the tracer's streaming histograms.
    # queue_wait fills even with span tracing off; ttft/tbt/e2e fill once
    # serving_tracing.enabled is set — empty histograms still render
    # (count 0), so dashboards see the family exists.
    hist_help = {
        "ttft": "time to first token (submit -> first host-visible token)",
        "tbt": "time between tokens (burst of k -> k samples of gap/k)",
        "e2e": "end-to-end request latency (completed requests)",
        "queue_wait": "admission-queue wait",
    }
    for name, hist in engine.tracer.histograms().items():
        reg.set_histogram(f"{reg.namespace}_request_{name}_seconds", hist,
                          help_text=hist_help[name])
    # serving performance observatory: per-phase wall-time
    # histograms, compile provenance counters, warm-recompile counters, and
    # the live roofline gauges — all host-side values the engine's perf
    # instruments already hold (the ledger/roofline sections export even with
    # the phase profiler off; phase + roofline-rate families need it on)
    profiler = getattr(engine, "phase_profiler", None)
    if profiler is not None:
        for phase, hist in profiler.histograms().items():
            reg.set_histogram(f"{reg.namespace}_serving_phase_seconds", hist,
                              labels={"phase": phase},
                              help_text="serve-iteration wall time attributed "
                                        "per phase (spans sum to the full "
                                        "iteration wall)")
        if profiler.enabled:
            reg.set_counter(f"{reg.namespace}_serving_phase_iterations_total",
                            profiler.iterations,
                            help_text="serve iterations the phase profiler "
                                      "attributed")
    ledger = getattr(engine, "ledger", None)
    if ledger is not None:
        for site, classes in sorted(ledger.by_site.items()):
            for cls, count in sorted(classes.items()):
                reg.set_counter(f"{reg.namespace}_serving_compiles_total",
                                count, labels={"site": site, "class": cls},
                                help_text="bucket-program builds (CUDA-graph "
                                          "captures on the card) attributed "
                                          "by site and class (prewarmed/cold/"
                                          "warm) — sums to "
                                          "fastpath_compiles_total")
            # a zero per seen site keeps the recompile family present and
            # alert-able before the first (hopefully never) warm recompile
            reg.set_counter(f"{reg.namespace}_serving_recompiles_total",
                            ledger.warm_by_site.get(site, 0),
                            labels={"site": site},
                            help_text="warm recompiles: a bucket key rebuilt "
                                      "after being seen at its site")
    roofline = getattr(engine, "roofline", None)
    if roofline is not None and profiler is not None and profiler.enabled:
        for name, value in roofline.gauges(profiler.wall_s).items():
            reg.set_gauge(f"{reg.namespace}_{name}", value,
                          help_text={
                              "serving_hbm_bytes_per_token":
                                  "device-memory bytes per served token "
                                  "(the analytic least bytes of the "
                                  "dispatched buckets)",
                              "serving_roofline_fraction":
                                  "the least bytes' bandwidth over the "
                                  "device-memory spec (a fraction of a "
                                  "lower bound)",
                              "serving_model_flops_utilization":
                                  "achieved FLOPs over peak (0 until "
                                  "serving_perf.peak_flops_per_chip is set)",
                          }[name])
        reg.set_counter(f"{reg.namespace}_serving_uncosted_dispatches_total",
                        roofline.uncosted_dispatches,
                        help_text="dispatches of buckets with no noted "
                                  "cost (roofline blind spots)")
    # multi-tenant QoS: per-tenant admission, token, shed and
    # resident-KV families plus per-tenant SLO histograms — present only
    # when the policy layer is armed (serving_qos.enabled), so a QoS-off
    # scrape stays byte-identical to the pre-QoS exposition
    qos = getattr(engine, "qos", None)
    if qos is not None:
        for (tenant, cls), count in sorted(qos.admitted_by_tenant.items()):
            reg.set_counter(f"{reg.namespace}_serving_tenant_admitted_total",
                            count, labels={"tenant": tenant, "class": cls},
                            help_text="requests admitted, by tenant and "
                                      "service class")
        for tenant, count in sorted(qos.tokens_by_tenant.items()):
            reg.set_counter(f"{reg.namespace}_serving_tenant_tokens_total",
                            count, labels={"tenant": tenant},
                            help_text="prompt tokens charged against the "
                                      "tenant's rate quota at admission")
        for (tenant, code), count in sorted(qos.shed_by_tenant.items()):
            reg.set_counter(f"{reg.namespace}_serving_tenant_shed_total",
                            count, labels={"tenant": tenant, "code": code},
                            help_text="requests shed at the QoS door, by "
                                      "tenant and structured reason code")
        for tenant, hint in sorted(qos.last_retry_after_by_tenant.items()):
            reg.set_gauge(
                f"{reg.namespace}_serving_tenant_retry_after_seconds",
                hint, labels={"tenant": tenant},
                help_text="latest quota-derived retry hint per tenant "
                          "(time until the token bucket refills)")
        for tenant, blocks in sorted(engine.manager.tenant_block_usage().items()):
            reg.set_gauge(f"{reg.namespace}_serving_tenant_kv_blocks",
                          blocks, labels={"tenant": tenant},
                          help_text="KV blocks resident per tenant (live "
                                    "sequences only)")
        tenant_hist_help = {
            "ttft": "per-tenant time to first token",
            "e2e": "per-tenant end-to-end request latency",
        }
        for (tenant, name), hist in sorted(engine.tracer.tenant_histograms()
                                           .items()):
            reg.set_histogram(
                f"{reg.namespace}_serving_tenant_{name}_seconds", hist,
                labels={"tenant": tenant},
                help_text=tenant_hist_help[name])
    # speculative decoding: proposal/acceptance counters, live
    # acceptance gauge, and the tokens-per-verify histogram — present only
    # when the section is armed (serving_spec_decode.enabled), so a spec-off
    # scrape stays byte-identical to the pre-spec exposition
    spec = getattr(engine, "spec_stats", None)
    if spec is not None:
        reg.set_counter(f"{reg.namespace}_serving_spec_proposed_total",
                        spec.proposed_total,
                        help_text="draft tokens proposed to the verifier")
        reg.set_counter(f"{reg.namespace}_serving_spec_accepted_total",
                        spec.accepted_total,
                        help_text="draft tokens accepted by rejection "
                                  "sampling (bonus/corrected tokens excluded)")
        reg.set_counter(f"{reg.namespace}_serving_spec_rounds_total",
                        spec.rounds_total,
                        help_text="draft/verify rounds dispatched")
        reg.set_counter(f"{reg.namespace}_serving_spec_fallback_rounds_total",
                        spec.fallback_rounds_total,
                        help_text="rounds that declined to speculate and fell "
                                  "back to the plain fused burst")
        reg.set_gauge(f"{reg.namespace}_serving_spec_acceptance",
                      spec.acceptance_rate(),
                      help_text="lifetime draft-token acceptance rate [0, 1] "
                                "— the adaptive-k controller steers its EWMA "
                                "twin of this")
        # the per-round run lengths live as exact small-int counts on the
        # engine; rendered as a mergeable streaming histogram like every
        # other latency/size family (direct bucket fill — same idiom as
        # MetricsRegistry._histogram_from_snapshot)
        hist = StreamingHistogram()
        for length, n in sorted(spec.tokens_per_verify.items()):
            idx = hist._index(float(length))
            hist.counts[idx] = hist.counts.get(idx, 0) + int(n)
            hist.count += int(n)
            hist.total += float(length) * int(n)
            if hist.max_seen is None or float(length) > hist.max_seen:
                hist.max_seen = float(length)
        reg.set_histogram(f"{reg.namespace}_serving_spec_tokens_per_verify",
                          hist,
                          help_text="tokens emitted per verify round per "
                                    "sequence (accepted prefix + 1)")


def populate_from_telemetry(reg: MetricsRegistry, collector) -> None:
    """Training TelemetryCollector → registry: the cached last train-step
    record (loss/step-time/throughput/MFU), cached gauge records per prefix,
    and the lifetime resilience-event counters — all host-side values the
    collector already assembled for its JSONL/monitor fan-out."""
    record = collector.last_train_record
    if record:
        # absolute training position as GAUGES, matching the engine
        # adapter's spelling: the record's step is the restored global step,
        # which survives checkpoint resumes — counter semantics (and the
        # fleet carry that comes with them) belong to per-process work, which
        # only the engine knows (runtime/engine.py _populate_ops_registry)
        reg.set_gauge(f"{reg.namespace}_train_global_step",
                      record.get("step", 0),
                      help_text="absolute training step (checkpoint position)")
        reg.set_gauge(f"{reg.namespace}_train_global_samples",
                      record.get("samples", 0),
                      help_text="absolute samples consumed (checkpoint position)")
        gauge_fields = {
            "loss": "last training loss",
            "grad_norm": "last gradient norm",
            "lr": "last learning rate",
            "step_time_ms": "last step wall-time (ms)",
            "samples_per_sec": "training throughput (samples/s)",
            "tokens_per_sec": "training throughput (tokens/s)",
            "tflops_per_sec": "achieved TFLOP/s",
            "mfu": "model FLOPs utilization [0, 1]",
        }
        for field, help_text in gauge_fields.items():
            value = record.get(field)
            if value is not None:
                reg.set_gauge(f"{reg.namespace}_train_{field}", value,
                              help_text=help_text)
        hbm = record.get("hbm") or {}
        for field, value in hbm.items():
            if value is not None:
                reg.set_gauge(f"{reg.namespace}_hbm_{field}", value,
                              help_text="device memory stats (bytes)")
    for prefix, gauges in collector.last_gauges.items():
        slug = re.sub(r"[^a-zA-Z0-9_]", "_", prefix.lower())
        for key, value in gauges.items():
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                reg.set_gauge(f"{reg.namespace}_{slug}_{key}", value,
                              help_text=f"gauge from the {prefix} stream")
    for event, count in sorted(collector.resilience_counts.items()):
        reg.set_counter(f"{reg.namespace}_resilience_events_total", count,
                        labels={"event": event},
                        help_text="resilience events (save retries, fallbacks, "
                                  "watchdog trips, shed/preempt/restart)")


def populate_from_supervisor(reg: MetricsRegistry, supervisor) -> None:
    """ServingSupervisor lifecycle → registry (the process-level view the
    per-engine adapter can't see: restart budget, degradation, generations)."""
    reg.set_counter(f"{reg.namespace}_supervisor_restarts_total",
                    supervisor.restarts_total,
                    help_text="worker restarts performed by the supervisor")
    reg.set_counter(f"{reg.namespace}_supervisor_generations_total",
                    supervisor.generations,
                    help_text="worker generations spawned")
    reg.set_counter(f"{reg.namespace}_supervisor_recovered_requests_total",
                    supervisor.recovered_requests_total,
                    help_text="requests recovered across restarts")
    reg.set_gauge(f"{reg.namespace}_supervisor_degraded",
                  1.0 if supervisor.degraded else 0.0,
                  help_text="1 when the restart budget degraded to drain-only")


def populate_from_router(reg: MetricsRegistry, router) -> None:
    """FleetRouter → registry: the fleet-level view no single replica can
    see — routing distribution, prefix-affinity effectiveness, shed
    re-routes and backoff, failover migrations, and the zero-lost-requests
    invariant — merged into the same registry the FleetAggregator already
    filled with replica-carried counters."""
    ns = reg.namespace
    for index, count in enumerate(router.routed_total):
        reg.set_counter(f"{ns}_router_routed_total", count,
                        labels={"replica": str(index)},
                        help_text="requests routed, by destination replica")
    reg.set_counter(f"{ns}_router_affinity_routed_total",
                    router.affinity_routed_total,
                    help_text="requests routed to their prefix-affinity home")
    reg.set_counter(f"{ns}_router_affinity_overridden_total",
                    router.affinity_overridden_total,
                    help_text="requests whose affinity home was unhealthy or "
                              "overloaded (fell back to least-loaded)")
    reg.set_counter(f"{ns}_router_reroutes_total", router.reroutes_total,
                    help_text="retryable sheds re-routed to another replica")
    reg.set_counter(f"{ns}_router_backoff_seconds_total",
                    router.backoff_seconds_total,
                    help_text="cumulative shed-backoff wait")
    reg.set_counter(f"{ns}_router_migrations_total", router.migrations_total,
                    help_text="replicas drained after restart-budget "
                              "exhaustion (journaled work migrated)")
    reg.set_counter(f"{ns}_router_migrated_requests_total",
                    router.migrated_requests_total,
                    help_text="in-flight journal entries transplanted to a "
                              "healthy replica")
    reg.set_counter(f"{ns}_router_adopted_from_journal_total",
                    router.adopted_from_journal_total,
                    help_text="terminals adopted from a drained replica's "
                              "journal during migration")
    reg.set_counter(f"{ns}_router_lost_total", router.lost_total,
                    help_text="requests finalized failed with NO replica "
                              "available — staying at zero is the fleet's "
                              "durability invariant")
    reg.set_gauge(f"{ns}_router_replicas", len(router.replicas),
                  help_text="fleet size")
    reg.set_gauge(f"{ns}_router_healthy_replicas",
                  len(router.healthy_indices()),
                  help_text="replicas currently routable and health-fresh")
    for replica in router.replicas:
        reg.set_gauge(f"{ns}_router_replica_drained",
                      1.0 if replica.drained else 0.0,
                      labels={"replica": str(replica.index)},
                      help_text="1 once the replica's restart budget "
                                "exhausted and its work migrated away")
    # per-tenant fleet counters: placement distribution and
    # tenant-global quota sheds (the sheds the router refuses to re-route —
    # families absent until a tenant-labeled workload arrives)
    for tenant, count in sorted(router.routed_by_tenant.items()):
        reg.set_counter(f"{ns}_router_tenant_routed_total", count,
                        labels={"tenant": tenant},
                        help_text="requests routed, by tenant")
    for tenant, count in sorted(router.quota_sheds_by_tenant.items()):
        reg.set_counter(f"{ns}_router_tenant_quota_sheds_total", count,
                        labels={"tenant": tenant},
                        help_text="quota_exceeded sheds surfaced to the "
                                  "caller (tenant-global — never re-routed "
                                  "to a sibling replica)")


def populate_from_agent(reg: MetricsRegistry, agent,
                        heartbeats: Optional[Dict[int, Dict[str, Any]]] = None,
                        alive_ranks: Optional[Iterable[int]] = None,
                        now: Optional[float] = None) -> None:
    """Elastic agent liveness → registry: restart/world state plus per-rank
    heartbeat ages and steps from the last liveness sweep: the rank-liveness
    gauges a fleet router admits on."""
    # function-local: this module stays import-light, and the age math is
    # the liveness helper's own
    from ..runtime.heartbeat import heartbeat_age
    reg.set_counter(f"{reg.namespace}_elastic_restarts_total",
                    agent.restart_count,
                    help_text="worker-group restarts (rescales included)")
    reg.set_gauge(f"{reg.namespace}_elastic_max_restarts", agent.max_restarts,
                  help_text="restart budget")
    heartbeats = heartbeats if heartbeats is not None else agent._last_heartbeats
    alive = set(alive_ranks) if alive_ranks is not None else None
    for rank, record in sorted(heartbeats.items()):
        labels = {"rank": str(rank)}
        reg.set_gauge(f"{reg.namespace}_rank_step",
                      record.get("step", 0), labels=labels,
                      help_text="last stamped training step per rank")
        if now is not None:
            reg.set_gauge(f"{reg.namespace}_rank_heartbeat_age_seconds",
                          heartbeat_age(record, now), labels=labels,
                          help_text="seconds since the rank's last heartbeat stamp")
        if alive is not None:
            reg.set_gauge(f"{reg.namespace}_rank_alive",
                          1.0 if rank in alive else 0.0, labels=labels,
                          help_text="1 while the rank's process is running")
