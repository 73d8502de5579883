"""Request-lifecycle tracing for the v2 serving engine.

Counterpart of ``deepspeed_tpu/monitor/tracing.py``, with its names and
semantics.  Where did *this request's* time go?  The module holds the three
observability primitives the serving engine composes:

- :class:`RequestTracer`: per-uid span chains across the request lifecycle
  (``queue_wait`` -> ``prefill`` -> ``decode``, with ``requeue`` spans
  around preemptions and one terminal event that matches the request's
  ``RequestResult`` status), plus the SLO latency histograms every
  continuous-batching system reports: TTFT (time to first token), TBT (time
  between tokens), e2e latency and queue wait, each a mergeable log-bucket
  streaming histogram with p50/p95/p99 snapshots.  Completed traces export
  as ``kind: trace`` records through an attached telemetry collector's
  ``record_trace`` and, optionally, as a Chrome-trace-event JSON file
  loadable in Perfetto / ``chrome://tracing``.
- :class:`StreamingHistogram`: the log-bucket histogram itself (also the
  base of the KV-pool census's block-age, idle and blocks-per-request
  distributions in ``inference/v2/kv_metrics.py``): O(1) add, bounded
  memory, exact merge between same-shaped histograms, deterministic
  quantiles (bucket representatives, so fake-clock tests assert exact
  values).
- :class:`FlightRecorder`: an always-on bounded ring of recent engine
  events (dispatch/absorb/flush/burst/preempt/shed/admit/expire/stall)
  whose tail is dumped into ``ServingStalledError`` snapshots and
  ``health()``: the history that led up to a wedge, which a point-in-time
  snapshot lacks.

Timing discipline: the tracer consumes the ENGINE's injectable clock and
reads it only at points the host already touches (admission intake, the
per-iteration deadline sweep, token materialization): tracing adds host
arithmetic and at most a few clock reads per step when enabled, and **no**
device syncs, so the serving fast path's counters are unchanged with
tracing on.  When disabled, every span/histogram hook is a cheap
early-return and no extra clock reads happen at all; the flight recorder
stays on (it stamps events with the engine's last already-read clock value
via :meth:`RequestTracer.tick`).

All host-side; nothing here touches a device.
"""

import collections
import dataclasses
import json
import math
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

# span names (the per-request lifecycle chain)
SPAN_QUEUE_WAIT = "queue_wait"
SPAN_PREFILL = "prefill"
SPAN_DECODE = "decode"
SPAN_REQUEUE = "requeue"

# statuses a trace can terminate with mirror admission.REQUEST_STATUSES
# (spelled out here so monitor/ never imports inference/)
TERMINAL_OK = "ok"
TERMINAL_SHED = "shed"


class StreamingHistogram:
    """Mergeable log-bucket streaming histogram with deterministic quantiles.

    Values land in logarithmic buckets: bucket ``i`` covers
    ``[min_value * 10^(i/bpd), min_value * 10^((i+1)/bpd))`` with
    ``bpd = buckets_per_decade``; values below ``min_value`` (including the
    exact-0.0 queue waits FakeClock tests produce) land in a dedicated
    underflow bucket whose representative is 0.0.  Quantiles return the
    geometric midpoint of the answering bucket — a deterministic function of
    the inputs, so fake-clock tests can assert exact percentile values, at a
    bounded relative error of ``10^(1/bpd) - 1`` (~47% per bucket at the
    default 6/decade — tight enough for SLO work where the decade matters).

    Two histograms with the same shape merge by adding counts, which is what
    makes per-worker histograms aggregatable into a fleet view.
    """

    def __init__(self, buckets_per_decade: int = 6, min_value: float = 1e-5):
        if buckets_per_decade < 1:
            raise ValueError(f"buckets_per_decade must be >= 1, got {buckets_per_decade}")
        if min_value <= 0.0:
            raise ValueError(f"min_value must be > 0, got {min_value}")
        self.buckets_per_decade = int(buckets_per_decade)
        self.min_value = float(min_value)
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.max_seen: Optional[float] = None

    def _index(self, value: float) -> int:
        if value < self.min_value:
            return -1  # underflow bucket (includes 0.0 exactly)
        # the epsilon keeps exact bucket edges in the bucket they open
        return int(math.floor(math.log10(value / self.min_value)
                              * self.buckets_per_decade + 1e-9))

    def representative(self, index: int) -> float:
        """Deterministic stand-in value for a bucket (geometric midpoint)."""
        if index < 0:
            return 0.0
        return self.min_value * 10.0 ** ((index + 0.5) / self.buckets_per_decade)

    def add(self, value: float) -> None:
        value = float(value)
        idx = self._index(value)
        self.counts[idx] = self.counts.get(idx, 0) + 1
        self.count += 1
        self.total += value
        if self.max_seen is None or value > self.max_seen:
            self.max_seen = value

    def merge(self, other: "StreamingHistogram") -> None:
        """Fold ``other`` in; shapes (bpd, min_value) must match exactly."""
        if (other.buckets_per_decade != self.buckets_per_decade
                or other.min_value != self.min_value):
            raise ValueError(
                f"histogram shape mismatch: {self.buckets_per_decade}/decade from "
                f"{self.min_value} vs {other.buckets_per_decade}/decade from "
                f"{other.min_value} — merge requires identical bucket edges")
        for idx, n in other.counts.items():
            self.counts[idx] = self.counts.get(idx, 0) + n
        self.count += other.count
        self.total += other.total
        if other.max_seen is not None and (self.max_seen is None
                                           or other.max_seen > self.max_seen):
            self.max_seen = other.max_seen

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` in [0, 1]; None while empty."""
        # one GIL-atomic copy: health()/scrape threads read these histograms
        # while the serve thread add()s, and iterating the live bucket dict
        # with interleaved bytecode would crash on a concurrent insert (the
        # copied view may lag by an in-flight add; quantiles tolerate that)
        counts = dict(self.counts)
        count = sum(counts.values())
        if not count:
            return None
        rank = max(1, math.ceil(q * count))
        cum = 0
        for idx in sorted(counts):
            cum += counts[idx]
            if cum >= rank:
                return self.representative(idx)
        return self.representative(max(counts))  # q > 1 degrades to max bucket

    def percentiles(self) -> Optional[Dict[str, float]]:
        """{p50, p95, p99} or None while empty."""
        if not self.count:
            return None
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"count": self.count,
                               "mean": (self.total / self.count) if self.count else None,
                               "max": self.max_seen}
        out.update(self.percentiles() or {"p50": None, "p95": None, "p99": None})
        return out

    def reset(self) -> None:
        self.counts.clear()
        self.count = 0
        self.total = 0.0
        self.max_seen = None


class FlightRecorder:
    """Always-on bounded ring of recent engine events.

    Appends are O(1) dict-into-deque; the ring holds the last ``capacity``
    events so a stall/postmortem dump shows the sequence that LED to the
    wedge, not just the wedged state.  Events are stamped with whatever clock
    value the engine last read anyway (see :meth:`RequestTracer.tick`), so an
    always-on recorder costs zero extra clock reads.

    The serve loop records dispatch/absorb/flush/burst/preempt/shed/
    submit/admit/expire/finish/failed/stall, the KV observability layer
    ``kv_pressure`` edges, the prefix cache ``prefix_hit`` and the compile
    ledger ``warm_recompile``.  The serving fault-tolerance layer lands its
    lifecycle here too: ``replay`` (a journal read back), ``restart`` (a
    supervised engine rebuild), ``recovered`` (a request re-admitted with
    its emitted prefix) and ``finalized`` (a terminal the recovery planner
    wrote without re-serving), so a crash postmortem reads as one ring.
    ``ServingSupervisor`` keeps its own instance for the process-level view
    (generation_spawned/worker_failed/hang_detected/degraded/run_complete).
    """

    def __init__(self, capacity: int = 256):
        self._ring: collections.deque = collections.deque(maxlen=max(int(capacity), 1))
        self.events_total = 0

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, event: str, *, t: float = 0.0, step: int = 0, **fields) -> None:
        self.events_total += 1
        entry = {"seq": self.events_total, "t": round(float(t), 6),
                 "step": int(step), "event": event}
        if fields:
            entry.update(fields)
        self._ring.append(entry)

    def tail(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """The most recent ``n`` events (all buffered events when None)."""
        events = list(self._ring)
        return events if n is None else events[-int(n):]


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: Optional[float] = None
    meta: Optional[Dict[str, Any]] = None

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, "start": round(self.start, 6),
                               "end": None if self.end is None else round(self.end, 6)}
        if self.meta:
            out["meta"] = self.meta
        return out


@dataclasses.dataclass
class RequestTrace:
    """One request's lifecycle: spans + point events + derived marks."""
    uid: int
    submit_t: Optional[float] = None
    admit_t: Optional[float] = None
    first_sched_t: Optional[float] = None
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    end_t: Optional[float] = None
    tokens: int = 0
    preemptions: int = 0
    queue_wait_s: float = 0.0
    status: Optional[str] = None
    finish_reason: Optional[str] = None
    reason: Optional[str] = None
    spans: List[Span] = dataclasses.field(default_factory=list)
    events: List[Tuple[str, float, Dict[str, Any]]] = dataclasses.field(default_factory=list)

    def open_span(self, name: str, start: float, **meta) -> Span:
        span = Span(name=name, start=start, meta=meta or None)
        self.spans.append(span)
        return span

    def close_span(self, name: str, end: float) -> Optional[Span]:
        """Close the most recent open span named ``name`` (None if none open)."""
        for span in reversed(self.spans):
            if span.name == name and span.end is None:
                span.end = end
                return span
        return None

    def open_span_names(self) -> List[str]:
        return [s.name for s in self.spans if s.end is None]

    def record(self) -> Dict[str, Any]:
        """The JSONL-exportable per-request trace record (``kind: trace``)."""
        r6 = lambda v: None if v is None else round(v, 6)
        e2e = (self.end_t - self.submit_t
               if self.end_t is not None and self.submit_t is not None else None)
        ttft = (self.first_token_t - self.submit_t
                if self.first_token_t is not None and self.submit_t is not None else None)
        return {
            "uid": self.uid,
            "status": self.status,
            "finish_reason": self.finish_reason,
            "reason": self.reason,
            "submit_t": r6(self.submit_t),
            "admit_t": r6(self.admit_t),
            "first_token_t": r6(self.first_token_t),
            "end_t": r6(self.end_t),
            "queue_wait_s": r6(self.queue_wait_s),
            "ttft_s": r6(ttft),
            "e2e_s": r6(e2e),
            "tokens": self.tokens,
            "preemptions": self.preemptions,
            "spans": [s.as_dict() for s in self.spans],
            "events": [[name, r6(t), fields] for name, t, fields in self.events],
        }


class RequestTracer:
    """Per-request span recorder + SLO histograms + flight recorder.

    The engine owns exactly one tracer and threads it through admission,
    the scheduler and the fast path.  Hook methods come in two families:

    - always-on, zero-clock-read: :meth:`event` (flight recorder, stamped
      with the last :meth:`tick`'ed time) and :meth:`observe_queue_wait`
      (the wait is a float the admission pump already computed);
    - gated on ``enabled``: the span hooks (``on_submit``/``on_admit``/
      ``on_chunks``/``on_tokens``/``on_preempt``/``on_terminal``), which may
      read the injected clock — host-side only, never a device sync.

    ``clock`` is the engine's injectable clock (fault tests drive a fake);
    the tracer NEVER reads any other time source, so traces and percentile
    assertions are deterministic under a FakeClock.
    """

    HISTOGRAMS = ("ttft", "tbt", "e2e", "queue_wait")

    def __init__(self, config=None, *, clock: Optional[Callable[[], float]] = None,
                 telemetry=None):
        from ..runtime.config import ServingTracingConfig
        self.config = config if config is not None else ServingTracingConfig()
        self.enabled = bool(self.config.enabled)
        self.clock = clock if clock is not None else time.monotonic
        self.telemetry = telemetry
        self.recorder = FlightRecorder(self.config.flight_recorder_events)
        self.last_now = 0.0
        hist = lambda: StreamingHistogram(self.config.histogram_buckets_per_decade,
                                          self.config.histogram_min_s)
        self.ttft = hist()
        self.tbt = hist()
        self.e2e = hist()
        self.queue_wait = hist()
        self._live: Dict[int, RequestTrace] = {}
        self.completed_total = 0
        # chrome-trace events accumulate only when an export path is set;
        # bounded so a long-lived server can't grow the buffer unboundedly
        self._chrome: collections.deque = collections.deque(maxlen=100_000)
        # per-tenant SLO histograms: filled only for requests whose intake
        # hook carried a tenant id (the QoS layer supplies it), keyed
        # (tenant, ttft|e2e) — the serving_tenant_* exposition reads these;
        # single-tenant/no-QoS runs never populate the map
        self._hist = hist
        self._tenant_of: Dict[int, str] = {}
        self.tenant_hists: Dict[Tuple[str, str], StreamingHistogram] = {}

    # ------------------------------------------------------------ time plumbing
    def tick(self, now: float) -> None:
        """Donate a clock value the engine already read (the per-iteration
        deadline sweep) — keeps the always-on flight recorder stamped without
        any tracer-initiated clock reads."""
        self.last_now = now

    def now(self) -> float:
        """Read the injected clock (enabled paths only)."""
        t = self.clock()
        self.last_now = t
        return t

    # ------------------------------------------------------- always-on hooks
    def event(self, name: str, *, step: int = 0, **fields) -> None:
        """Flight-recorder append (always on; stamped with the last ticked
        time, never a fresh clock read)."""
        self.recorder.record(name, t=self.last_now, step=step, **fields)

    def observe_queue_wait(self, wait_s: float) -> None:
        """Queue-wait histogram sample (always on: the pump already computed
        the wait, this is pure host arithmetic)."""
        self.queue_wait.add(max(0.0, float(wait_s)))

    # ------------------------------------------------------------ span hooks
    def trace(self, uid: int) -> Optional[RequestTrace]:
        return self._live.get(uid)

    def _ensure(self, uid: int) -> RequestTrace:
        tr = self._live.get(uid)
        if tr is None:
            tr = RequestTrace(uid=int(uid))
            self._live[uid] = tr
        return tr

    def _note_tenant(self, uid: int, tenant: Optional[str]) -> None:
        if tenant:
            self._tenant_of[int(uid)] = str(tenant)

    def _tenant_hist(self, tenant: str, name: str) -> StreamingHistogram:
        key = (tenant, name)
        h = self.tenant_hists.get(key)
        if h is None:
            h = self.tenant_hists[key] = self._hist()
        return h

    def on_submit(self, uid: int, t: float, *, prompt_len: int = 0,
                  priority: int = 0, tenant: Optional[str] = None) -> None:
        """Request entered the admission queue (t = the ticket's enqueue_t —
        a clock value the queue already read)."""
        if not self.enabled:
            return
        self._note_tenant(uid, tenant)
        tr = self._ensure(uid)
        tr.submit_t = t
        tr.open_span(SPAN_QUEUE_WAIT, t, prompt_len=int(prompt_len),
                     priority=int(priority))

    def on_shed(self, uid: int, code: str, *, retryable: bool = False,
                detail: str = "") -> None:
        """Terminal at the admission door: the request never owned a trace
        worth of spans — emit a single-event terminal record."""
        if not self.enabled:
            return
        tr = self._live.pop(uid, None) or RequestTrace(uid=int(uid))
        t = self.last_now
        if tr.submit_t is None:
            tr.submit_t = t
        fields: Dict[str, Any] = {"code": code, "retryable": bool(retryable)}
        if detail:
            fields["detail"] = detail
        tr.events.append(("shed", t, fields))
        tr.status = TERMINAL_SHED
        tr.reason = code
        tr.end_t = t
        self._tenant_of.pop(uid, None)
        self._finalize(tr)

    def on_admit(self, uid: int, t: Optional[float] = None, *,
                 queue_wait_s: float = 0.0, prompt_len: int = 0,
                 tenant: Optional[str] = None) -> None:
        """Request left the queue and entered the state manager (or was
        ``put()`` directly, queue_wait 0)."""
        if not self.enabled:
            return
        self._note_tenant(uid, tenant)
        if t is None:
            t = self.now()
        tr = self._ensure(uid)
        tr.admit_t = t
        tr.queue_wait_s = max(0.0, float(queue_wait_s))
        if tr.submit_t is None:
            # direct put(): arrival == admission
            tr.submit_t = t - tr.queue_wait_s
        tr.close_span(SPAN_QUEUE_WAIT, t)
        tr.events.append(("admit", t, {"queue_wait_s": round(tr.queue_wait_s, 6)}))

    def on_chunks(self, chunks: Iterable[Tuple[int, int]], *, step: int = 0) -> None:
        """A scheduled batch was dispatched: ``chunks`` is [(uid, n_tokens)].
        Opens each request's prefill span on its first appearance and closes
        any requeue span a preempted request was waiting in."""
        if not self.enabled:
            return
        t = self.now()
        for uid, n_tokens in chunks:
            tr = self._live.get(uid)
            if tr is None:
                continue
            if tr.close_span(SPAN_REQUEUE, t) is not None:
                tr.events.append(("resumed", t, {"step": int(step)}))
                # the victim re-prefills its rolled-back positions
                tr.open_span(SPAN_PREFILL, t, resumed=True)
            elif tr.first_sched_t is None:
                tr.first_sched_t = t
                tr.open_span(SPAN_PREFILL, t, first_chunk_tokens=int(n_tokens))

    def on_tokens(self, uid: int, n: int, t: float) -> None:
        """``n`` sampled tokens for ``uid`` became host-visible at ``t`` (a
        materialize boundary).  The first observation closes the prefill span,
        opens the decode span and lands the TTFT sample; later observations
        contribute TBT samples — a burst of k tokens fetched in one sync
        contributes k samples of (t - prev)/k, matching the bench convention
        (per-token latency inside a fused burst is not host-observable)."""
        if not self.enabled or n <= 0:
            return
        tr = self._live.get(uid)
        if tr is None:
            return
        if tr.first_token_t is None:
            tr.first_token_t = t
            tr.close_span(SPAN_PREFILL, t)
            tr.open_span(SPAN_DECODE, t)
            base = tr.submit_t if tr.submit_t is not None else t
            self.ttft.add(max(0.0, t - base))
            tenant = self._tenant_of.get(uid)
            if tenant is not None:
                self._tenant_hist(tenant, "ttft").add(max(0.0, t - base))
            n_gap = n - 1
        else:
            n_gap = n
        if n_gap > 0 and tr.last_token_t is not None:
            gap = max(0.0, t - tr.last_token_t) / n_gap
            for _ in range(n_gap):
                self.tbt.add(gap)
        tr.last_token_t = t
        tr.tokens += n

    def on_tokens_map(self, out: Dict[int, int]) -> None:
        """Step-shaped emission: {uid: token} — one token per uid, all
        host-visible at one shared clock read."""
        if not self.enabled or not out:
            return
        t = self.now()
        for uid in out:
            self.on_tokens(uid, 1, t)

    def on_burst_tokens(self, counts: Dict[int, int]) -> None:
        """Burst-shaped emission: {uid: n_tokens} materialized in ONE sync."""
        if not self.enabled or not counts:
            return
        t = self.now()
        for uid, n in counts.items():
            self.on_tokens(uid, int(n), t)

    def on_preempt(self, uid: int, *, freed_blocks: int = 0,
                   rolled_back_to: int = 0, preemptions: int = 0) -> None:
        """KV-pressure preemption: point event + an open requeue span that the
        victim's next scheduled chunk closes."""
        if not self.enabled:
            return
        tr = self._live.get(uid)
        if tr is None:
            return
        t = self.last_now  # the scheduler runs between engine clock reads
        tr.preemptions = max(tr.preemptions + 1, int(preemptions))
        tr.events.append(("preempt", t, {"freed_blocks": int(freed_blocks),
                                         "rolled_back_to": int(rolled_back_to)}))
        tr.close_span(SPAN_PREFILL, t)
        # the requeue span stays open until the victim's next scheduled chunk
        # (on_chunks closes it and reopens prefill for the recomputed positions)
        tr.open_span(SPAN_REQUEUE, t, rolled_back_to=int(rolled_back_to))

    def on_terminal(self, uid: int, status: str, *, finish_reason: Optional[str] = None,
                    reason: Optional[str] = None, t: Optional[float] = None) -> None:
        """Close the trace with its terminal status (matches the request's
        ``RequestResult.status``), land the e2e sample for completed requests,
        and export the trace record."""
        if not self.enabled:
            return
        tr = self._live.pop(uid, None)
        if tr is None:
            return  # already terminal (idempotent across flush()/retire paths)
        if t is None:
            t = self.now()
        for name in tr.open_span_names():
            tr.close_span(name, t)
        tr.end_t = t
        tr.status = status
        tr.finish_reason = finish_reason
        tr.reason = reason
        tr.events.append((status, t, {"finish_reason": finish_reason}
                          if finish_reason else {}))
        if status == TERMINAL_OK and tr.submit_t is not None:
            self.e2e.add(max(0.0, t - tr.submit_t))
            tenant = self._tenant_of.get(uid)
            if tenant is not None:
                self._tenant_hist(tenant, "e2e").add(max(0.0, t - tr.submit_t))
        self._tenant_of.pop(uid, None)
        self._finalize(tr)

    def abort_all(self, uids: Iterable[int], *, reason: str = "aborted") -> None:
        """Strict-mode teardown: close every still-open trace of this call so
        the live-trace map can't leak across generate() calls."""
        if not self.enabled:
            return
        for uid in list(uids):
            if uid in self._live:
                self.on_terminal(uid, "failed", reason=reason, t=self.last_now)

    # ---------------------------------------------------------------- export
    def _finalize(self, tr: RequestTrace) -> None:
        self.completed_total += 1
        record = tr.record()
        if self.telemetry is not None and self.config.trace_jsonl:
            self.telemetry.record_trace(record)
        if self.config.chrome_trace_path:
            self._chrome.extend(self._chrome_events(tr))

    @staticmethod
    def _chrome_events(tr: RequestTrace) -> List[Dict[str, Any]]:
        """Chrome-trace-event (Perfetto-loadable) shapes: one track per uid,
        complete ("X") events per span, instant ("i") events per point."""
        us = lambda t: int(round(t * 1e6))
        events: List[Dict[str, Any]] = []
        for span in tr.spans:
            if span.end is None:
                continue
            ev = {"name": span.name, "ph": "X", "pid": 0, "tid": tr.uid,
                  "ts": us(span.start), "dur": max(0, us(span.end) - us(span.start)),
                  "cat": "request"}
            if span.meta:
                ev["args"] = span.meta
            events.append(ev)
        for name, t, fields in tr.events:
            events.append({"name": name, "ph": "i", "pid": 0, "tid": tr.uid,
                           "ts": us(t), "s": "t", "cat": "request",
                           **({"args": fields} if fields else {})})
        return events

    def counter_track(self, name: str, values: Dict[str, float]) -> None:
        """Append a Chrome-trace COUNTER sample (``ph: "C"`` — rendered as a
        stacked counter track in Perfetto/chrome://tracing) stamped with the
        last ticked engine time.  Used by the KV-pool observability layer for
        free-blocks / fragmentation / steps-to-exhaustion tracks alongside
        the per-request span rows.  A no-op unless a chrome export path is
        configured, so the always-on path costs one attribute check."""
        if not self.config.chrome_trace_path or not values:
            return
        # counter events key on (pid, name); tid rides along so every buffered
        # event carries the same field set as the span/instant shapes
        self._chrome.append({"name": name, "ph": "C", "pid": 0, "tid": 0,
                             "ts": int(round(self.last_now * 1e6)),
                             "args": {k: float(v) for k, v in values.items()}})

    def phase_span(self, name: str, start_s: float, dur_s: float,
                   track: int = 0) -> None:
        """Append a Chrome-trace COMPLETE span (``ph: "X"``) for one serve-loop
        phase (the JAX package's StepPhaseProfiler tracks).  Phase
        rows live under their own pid so Perfetto groups them separately from
        the per-request lifecycle rows; ``track`` (the phase's index) keeps
        each phase on a stable tid/row.  A no-op unless a chrome export path
        is configured — the serve loop pays one attribute check."""
        if not self.config.chrome_trace_path:
            return
        self._chrome.append({"name": name, "ph": "X", "pid": 1, "tid": int(track),
                             "ts": int(round(start_s * 1e6)),
                             "dur": int(round(dur_s * 1e6)), "cat": "phase"})

    def write_chrome_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Write buffered chrome events as a trace-event JSON file (load in
        Perfetto or chrome://tracing); returns the path, or None when neither
        an explicit path nor ``config.chrome_trace_path`` is set."""
        path = path or self.config.chrome_trace_path
        if not path or not self._chrome:
            return None
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as fh:
            json.dump({"traceEvents": list(self._chrome),
                       "displayTimeUnit": "ms"}, fh)
        return path

    # ------------------------------------------------------------- snapshots
    def histograms(self) -> Dict[str, StreamingHistogram]:
        return {name: getattr(self, name) for name in self.HISTOGRAMS}

    def percentiles(self) -> Dict[str, Optional[Dict[str, float]]]:
        """{ttft|tbt|e2e|queue_wait: {p50, p95, p99} | None-when-empty}."""
        return {name: h.percentiles() for name, h in self.histograms().items()}

    def latency_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """health()-shaped: full snapshots (count/mean/max/p50/p95/p99)."""
        return {name: h.snapshot() for name, h in self.histograms().items()}

    def gauge_fields(self) -> Dict[str, float]:
        """Flat float gauges for the telemetry stream (only non-empty
        histograms contribute; {} when tracing is disabled)."""
        if not self.enabled:
            return {}
        out: Dict[str, float] = {}
        for name, h in self.histograms().items():
            pct = h.percentiles()
            if pct is None:
                continue
            for p, v in pct.items():
                out[f"{name}_{p}_s"] = float(v)
        return out

    def reset_histograms(self) -> None:
        """Drop accumulated samples (bench: isolate the timed pass from the
        warm/compile pass).  Live traces and the flight recorder are kept."""
        for h in self.histograms().values():
            h.reset()

    def live_uids(self) -> List[int]:
        return sorted(self._live)

    def tenant_histograms(self) -> Dict[Tuple[str, str], StreamingHistogram]:
        """{(tenant, ttft|e2e): histogram} — the per-tenant SLO view the
        serving_tenant_* Prometheus families export (empty without QoS)."""
        return dict(self.tenant_hists)
