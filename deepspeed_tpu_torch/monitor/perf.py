"""Serving performance observatory.

Counterpart of ``deepspeed_tpu/monitor/perf.py``, with its names and
semantics.  Three instruments that attribute where a serve iteration's wall
time went, where every bucket-program build came from, and how close the
forward runs to the device-memory roofline:

- :class:`StepPhaseProfiler`: mark-based per-iteration phase attribution for
  the serve loop.  The engine calls ``begin_iteration()`` at the top of each
  loop pass and ``mark(phase)`` after each phase's work; the profiler charges
  the time since the previous mark to that phase and sends whatever is left
  at ``end_iteration()`` to ``other``, so per-iteration phase spans sum to
  the iteration wall time *exactly* (fake-clock tests assert equality, not
  tolerance).  Per-phase :class:`~.tracing.StreamingHistogram` s give
  deterministic quantiles.
- :class:`CompileLedger`: the single source of ``ServeCounters.compiles``.
  In the port a "compile" is the build of one bucket program: a CUDA-graph
  capture on the card, or the first eager use of a bucket key on the CPU.
  Every build is recorded as ``(site, key)`` (sites ``fwd``, ``burst``,
  ``spec_verify``, ``draft``) with a class (``prewarmed`` / ``cold`` /
  ``warm``, a key built again after it was seen: a recompile) and bumps the
  counter exactly once.
- :class:`RooflineModel`: per-bucket FLOPs and device-memory bytes noted
  once at the bucket's build (the engine hands in plain floats from the
  model's analytic cost, ``models.llama.paged_bucket_cost``, for fwd and
  verify buckets), accumulated per stepwise dispatch into live ``hbm_bytes_per_token`` / ``roofline_fraction`` /
  ``model_flops_utilization`` gauges.

Zero-device-sync contract: nothing here imports torch or numpy, and every
timestamp is a host float handed in by the engine's injectable clock.  The
profiler reads that clock ONLY while ``enabled``: with the observatory off
it adds no clock reads, so fake-clock call counts (and therefore tokens and
``ServeCounters``) are byte-identical with the observatory on or off.
"""

import collections
from typing import Any, Callable, Dict, Optional, Tuple

from .tracing import StreamingHistogram

# serve-loop phases, in rough per-iteration order; ``other`` absorbs the
# residual (heartbeat stamp, ops refresh, watchdog, journal flush) so the
# per-iteration spans always sum to the full iteration wall time
PHASES = ("admission_pump", "scatter_upload", "dispatch", "absorb_patch",
          "burst", "flush", "expire", "other")

# compile classes a ledger record can carry
CLASS_PREWARMED = "prewarmed"  # built ahead of traffic by _prewarm
CLASS_COLD = "cold"            # first build of this (site, key) under traffic
CLASS_WARM = "warm"            # rebuilt after already being seen: a recompile


class StepPhaseProfiler:
    """Mark-based phase attribution for the serve loop.

    ``begin_iteration()`` opens an iteration; ``mark(phase)`` charges the time
    since the previous mark (or the iteration start) to ``phase``;
    ``end_iteration()`` charges the residual to ``other``, folds the
    per-iteration spans into per-phase histograms and lifetime totals, and
    optionally emits an every-N-iterations phase-budget line to the flight
    recorder.  Marks outside an open iteration are ignored (the engine's
    public ``step()``/``decode_burst()`` run outside the serve loop too).
    """

    def __init__(self, config=None, *, clock: Optional[Callable[[], float]] = None,
                 tracer=None):
        cfg = config
        self.enabled = bool(getattr(cfg, "enabled", False))
        self.budget_every = int(getattr(cfg, "phase_budget_every", 50))
        bpd = int(getattr(cfg, "histogram_buckets_per_decade", 6))
        min_s = float(getattr(cfg, "histogram_min_s", 1e-7))
        self._clock = clock if clock is not None else (lambda: 0.0)
        self._tracer = tracer
        self.hists: Dict[str, StreamingHistogram] = {
            p: StreamingHistogram(buckets_per_decade=bpd, min_value=min_s)
            for p in PHASES}
        self.totals: Dict[str, float] = {p: 0.0 for p in PHASES}
        self.iterations = 0
        self.wall_s = 0.0
        self._active = False
        self._t_iter0 = 0.0
        self._t_mark = 0.0
        self._spans: Dict[str, float] = {}
        # window accumulator for the flight-recorder phase-budget line
        self._win_spans: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._win_iters = 0

    def begin_iteration(self) -> None:
        if not self.enabled:
            return
        now = self._clock()
        self._active = True
        self._t_iter0 = now
        self._t_mark = now
        self._spans = {}

    def mark(self, phase: str) -> None:
        """Charge time since the previous mark to ``phase``."""
        if not self.enabled or not self._active:
            return
        now = self._clock()
        span = now - self._t_mark
        self._t_mark = now
        self._spans[phase] = self._spans.get(phase, 0.0) + span

    def end_iteration(self) -> None:
        if not self.enabled or not self._active:
            return
        now = self._clock()
        self._spans["other"] = self._spans.get("other", 0.0) + (now - self._t_mark)
        self._active = False
        wall = now - self._t_iter0
        self.iterations += 1
        self.wall_s += wall
        self._win_iters += 1
        start = self._t_iter0
        for phase, span in self._spans.items():
            self.hists[phase].add(span)
            self.totals[phase] += span
            self._win_spans[phase] += span
            if self._tracer is not None:
                self._tracer.phase_span(phase, start, span,
                                        track=PHASES.index(phase))
            start += span
        if self._win_iters >= self.budget_every:
            self._emit_budget()

    def _emit_budget(self) -> None:
        """Flight-recorder line: where the last window's wall time went."""
        if self._tracer is not None:
            total = sum(self._win_spans.values()) or 1.0
            fields = {p: round(self._win_spans[p], 6) for p in PHASES
                      if self._win_spans[p] > 0.0}
            top = max(self._win_spans, key=lambda p: self._win_spans[p])
            self._tracer.event("phase_budget", iters=self._win_iters,
                               wall_s=round(total, 6), top=top, **fields)
        self._win_spans = {p: 0.0 for p in PHASES}
        self._win_iters = 0

    def histograms(self) -> Dict[str, StreamingHistogram]:
        """Per-phase histograms that have seen at least one sample."""
        return {p: h for p, h in self.hists.items() if h.count}

    def snapshot(self) -> Dict[str, Any]:
        phases = {p: dict(self.hists[p].snapshot(),
                          total_s=round(self.totals[p], 9))
                  for p in PHASES if self.hists[p].count}
        return {"enabled": self.enabled, "iterations": self.iterations,
                "wall_s": round(self.wall_s, 9), "phases": phases}

    def reset(self) -> None:
        for h in self.hists.values():
            h.reset()
        self.totals = {p: 0.0 for p in PHASES}
        self.iterations = 0
        self.wall_s = 0.0
        self._active = False
        self._win_spans = {p: 0.0 for p in PHASES}
        self._win_iters = 0


class CompileLedger:
    """Attributed record of every bucket program the serving engine builds.

    Always on (it adds no clock reads and no device work): each build seam
    calls :meth:`record` instead of bumping ``ServeCounters.compiles``
    directly, and the ledger bumps the counter exactly once per record.
    Every unit carries a site name, a bucket key, a class and the build's
    host wall time (``compile_wall_s``, and per class ``wall_by_class``).  A
    ``warm`` record (a key rebuilt after it was already seen at its site)
    lands in the flight recorder and the per-site warm counters behind
    ``serving_recompiles_total{site=...}``.
    """

    def __init__(self, counters=None, *, tracer=None):
        self._counters = counters
        self._tracer = tracer
        self._seen: Dict[Tuple[str, str], int] = {}
        self.by_site: Dict[str, Dict[str, int]] = {}
        self.warm_by_site: Dict[str, int] = {}
        self.wall_by_class: Dict[str, float] = {}
        self.compile_wall_s = 0.0
        self.total = 0
        self.events: collections.deque = collections.deque(maxlen=256)

    @staticmethod
    def _key_str(key: Any) -> str:
        return key if isinstance(key, str) else repr(key)

    def record(self, site: str, key: Any, *, wall_s: float = 0.0,
               prewarmed: bool = False) -> str:
        """Record one compile at ``site`` for bucket ``key``; returns class."""
        k = (site, self._key_str(key))
        seen = self._seen.get(k, 0)
        self._seen[k] = seen + 1
        if seen:
            cls = CLASS_WARM
            self.warm_by_site[site] = self.warm_by_site.get(site, 0) + 1
            if self._tracer is not None:
                self._tracer.event("warm_recompile", site=site, key=k[1],
                                   builds=seen + 1)
        else:
            cls = CLASS_PREWARMED if prewarmed else CLASS_COLD
        per_site = self.by_site.setdefault(site, {})
        per_site[cls] = per_site.get(cls, 0) + 1
        self.wall_by_class[cls] = self.wall_by_class.get(cls, 0.0) + float(wall_s)
        self.compile_wall_s += float(wall_s)
        self.total += 1
        self.events.append({"site": site, "key": k[1], "class": cls,
                            "wall_s": round(float(wall_s), 6)})
        if self._counters is not None:
            self._counters.compiles += 1
        return cls

    @property
    def warm_total(self) -> int:
        return sum(self.warm_by_site.values())

    def count(self, cls: str) -> int:
        """Builds of class ``cls`` over every site."""
        return sum(per_site.get(cls, 0) for per_site in self.by_site.values())

    def snapshot(self) -> Dict[str, Any]:
        return {"total": self.total,
                "warm_total": self.warm_total,
                "compile_wall_s": round(self.compile_wall_s, 6),
                "by_site": {s: dict(c) for s, c in sorted(self.by_site.items())},
                "recent": list(self.events)[-8:]}


class RooflineModel:
    """Live tokens-per-byte roofline for the serve loop.

    The engine notes each bucket's (FLOPs, bytes) once, at the bucket's
    build (:meth:`note_cost`), and charges them per dispatch
    (:meth:`note_dispatch`); :meth:`gauges` divides the accumulated bytes and
    FLOPs by the profiler's measured wall time against the configured memory
    bandwidth (``hbm_gbps_spec``) and peak FLOPs.  Dispatches of buckets that
    were never costed are counted in ``uncosted_dispatches``, so a low
    roofline fraction is distinguishable from missing cost coverage.
    """

    def __init__(self, config=None):
        cfg = config
        self.hbm_gbps_spec = float(getattr(cfg, "hbm_gbps_spec", 3350.0))
        self.peak_flops = getattr(cfg, "peak_flops_per_chip", None)
        self._costs: Dict[str, Tuple[float, float]] = {}  # key -> (flops, bytes)
        self.flops = 0.0
        self.bytes = 0.0
        self.tokens = 0
        self.dispatches = 0
        self.uncosted_dispatches = 0

    def reset(self) -> None:
        """Zero the dispatch accumulators (timed-pass isolation, e.g. bench's
        warm-then-measure discipline).  The per-bucket cost table survives:
        costs are a property of the compiled bucket, not of any one pass."""
        self.flops = 0.0
        self.bytes = 0.0
        self.tokens = 0
        self.dispatches = 0
        self.uncosted_dispatches = 0

    def note_cost(self, key: Any, flops: float, bytes_accessed: float) -> None:
        self._costs[CompileLedger._key_str(key)] = (float(flops),
                                                    float(bytes_accessed))

    def note_dispatch(self, key: Any, tokens: int) -> None:
        self.dispatches += 1
        self.tokens += int(tokens)
        cost = self._costs.get(CompileLedger._key_str(key))
        if cost is None:
            self.uncosted_dispatches += 1
            return
        self.flops += cost[0]
        self.bytes += cost[1]

    def gauges(self, wall_s: float) -> Dict[str, float]:
        """Finite gauge values; zeros until there is data to divide."""
        out = {"serving_hbm_bytes_per_token":
               (self.bytes / self.tokens) if self.tokens else 0.0,
               "serving_roofline_fraction": 0.0,
               "serving_model_flops_utilization": 0.0}
        if wall_s > 0.0:
            out["serving_roofline_fraction"] = (
                self.bytes / wall_s) / (self.hbm_gbps_spec * 1e9)
            if self.peak_flops:
                out["serving_model_flops_utilization"] = (
                    self.flops / wall_s) / float(self.peak_flops)
        return out

    def snapshot(self, wall_s: float = 0.0) -> Dict[str, Any]:
        return {"costed_buckets": len(self._costs),
                "dispatches": self.dispatches,
                "uncosted_dispatches": self.uncosted_dispatches,
                "tokens": self.tokens,
                "flops": self.flops,
                "hbm_bytes": self.bytes,
                "gauges": {k: round(v, 9)
                           for k, v in self.gauges(wall_s).items()}}
