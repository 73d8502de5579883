"""Unified telemetry subsystem.

Counterpart of ``deepspeed_tpu/monitor/telemetry.py``.  One collector joins
the observability islands the reference spreads over ``wall_clock_breakdown``
timers, ``see_memory_usage``, the FLOPs profiler and the monitor writers: per
train step it assembles ONE structured record (loss, grad-norm, lr, step
wall-time, samples/sec, tokens/sec, model-FLOPs-utilization, device-memory
high-water mark) and fans it out to

- ``MonitorMaster`` (TensorBoard / W&B / CSV writers, rank 0 only), and
- a rank-0 JSONL sink (``TelemetryConfig.jsonl_path``), one JSON object per
  line.

It also owns the config-driven ``torch.profiler`` capture windows
(``profile_step_start``/``profile_step_stop`` for train steps,
``profile_serve_iteration_start``/``_stop`` for serve-loop iterations): a
window runs ``torch.profiler.profile`` over the CPU and, where there is one,
the CUDA device, and on stop writes a Chrome trace (``export_chrome_trace``)
into ``profile_dir``.  ``step_annotation``/``annotation`` hand out
``torch.profiler.record_function`` ranges (``train_step#<n>``, and the
annotation's name) so steps, batch-prep and serve phases show up as named
ranges in that trace.

MFU: ``flops_per_step`` is set ONCE by the engine (the port counts the first
step under ``torch.utils.flop_counter.FlopCounterMode``), divided by the
measured step time and the per-device peak FLOPs times the device count.
The peak comes from ``TelemetryConfig.peak_flops_per_chip`` or, failing
that, from the CUDA device's name (:data:`PEAK_FLOPS_BY_DEVICE`); an unknown
device or the CPU gives ``mfu: null``.
"""

import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils.memory import device_memory_stats
from .monitor import process_rank

logger = logging.getLogger(__name__)

Event = Tuple[str, float, int]

# NVIDIA's published dense bf16 tensor-core peaks (FLOP/s) by a substring of
# torch.cuda.get_device_name(), most specific first
PEAK_FLOPS_BY_DEVICE = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),   # H100 SXM ("NVIDIA H100 80GB HBM3")
    ("h200", 989e12),
    ("a100", 312e12),
)

_FLOPS_UNSET = object()  # distinguishes "not yet counted" from "counting failed"


def detect_peak_flops_per_chip() -> Optional[float]:
    """The CUDA device's dense bf16 peak from its name; None on the CPU or
    an unnamed device."""
    import torch
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0).lower()
    for needle, peak in PEAK_FLOPS_BY_DEVICE:
        if needle in name:
            return peak
    return None


class TelemetryCollector:
    """Assembles per-step records and fans them out (monitor + JSONL).

    Disabled collectors (``config.enabled`` false and no ``jsonl_path``) keep
    every method a cheap no-op, so call sites never branch.
    """

    def __init__(self, config=None, monitor=None, batch_size: int = 1,
                 n_chips: Optional[int] = None):
        from ..runtime.config import TelemetryConfig
        self.config = config if config is not None else TelemetryConfig()
        self.monitor = monitor
        self.batch_size = max(int(batch_size), 1)
        self.enabled = bool(self.config.enabled)
        self._is_rank0 = process_rank() == 0
        if n_chips:
            self.n_chips = int(n_chips)
        else:
            import torch
            import torch.distributed as dist
            self.n_chips = (dist.get_world_size() if dist.is_available() and dist.is_initialized()
                            else max(torch.cuda.device_count(), 1))
        self.peak_flops_per_chip = (self.config.peak_flops_per_chip
                                    if self.config.peak_flops_per_chip is not None
                                    else detect_peak_flops_per_chip())
        self._flops_per_step: Any = _FLOPS_UNSET
        self._jsonl_fh = None
        self._unflushed = 0
        self._profiler = None
        self._profile_done = False  # the step capture window fires at most once
        self._serve_profile_done = False
        self.traces_written: List[str] = []
        self.records_written = 0
        # requests/sec rate tracking for serving gauges (name -> (t, count))
        self._rates: Dict[str, Tuple[float, float]] = {}
        # host-side caches for the pull-based ops plane (monitor/metrics.py
        # populate_from_telemetry): the newest train-step record, the newest
        # gauges per prefix, and lifetime resilience-event counts; reading
        # them re-reads values this collector already assembled, so an ops
        # refresh can never read a device value
        self.last_train_record: Optional[Dict[str, Any]] = None
        self.last_gauges: Dict[str, Dict[str, Any]] = {}
        self.resilience_counts: Dict[str, int] = {}

    # ------------------------------------------------------------- flops / mfu
    def wants_flops(self) -> bool:
        """True while the one-time train-step FLOP count is still pending."""
        return self.enabled and self._flops_per_step is _FLOPS_UNSET

    def set_flops_per_step(self, flops: Optional[float]) -> None:
        self._flops_per_step = float(flops) if flops else None

    @property
    def flops_per_step(self) -> Optional[float]:
        return None if self._flops_per_step is _FLOPS_UNSET else self._flops_per_step

    def _mfu(self, step_time_s: Optional[float]) -> Optional[float]:
        flops = self.flops_per_step
        if not flops or not step_time_s or not self.peak_flops_per_chip:
            return None
        return flops / step_time_s / (self.peak_flops_per_chip * self.n_chips)

    # ----------------------------------------------------------------- records
    def record_train_step(self, *, step: int, samples: int, loss: Optional[float] = None,
                          grad_norm: Optional[float] = None, lr: Optional[float] = None,
                          step_time_s: Optional[float] = None, tokens: Optional[int] = None,
                          extra: Optional[Dict[str, Any]] = None) -> Optional[Dict[str, Any]]:
        """One structured record per optimizer step; returns the record (None
        when disabled).  ``tokens`` is the global token count this step; a
        batch without a sequence dim counts one token per sample."""
        if not self.enabled:
            return None
        tokens = int(tokens) if tokens else self.batch_size
        step_time_ms = step_time_s * 1e3 if step_time_s else None
        samples_per_sec = self.batch_size / step_time_s if step_time_s else None
        tokens_per_sec = tokens / step_time_s if step_time_s else None
        flops = self.flops_per_step
        record: Dict[str, Any] = {
            "kind": "train_step",
            "step": int(step),
            "samples": int(samples),
            "loss": loss,
            "grad_norm": grad_norm,
            "lr": lr,
            "step_time_ms": step_time_ms,
            "samples_per_sec": samples_per_sec,
            "tokens_per_sec": tokens_per_sec,
            "flops_per_step": flops,
            "tflops_per_sec": (flops / step_time_s / 1e12 if flops and step_time_s else None),
            "mfu": self._mfu(step_time_s),
            "hbm": device_memory_stats(),
            "timestamp": time.time(),
        }
        if extra:
            record.update(extra)
        self.last_train_record = record
        self._write_jsonl(record)
        return record

    def record_gauges(self, gauges: Dict[str, Any], step: int,
                      prefix: str = "Inference",
                      timestamp: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Point-in-time gauges (scheduler/serving state) -> monitor events
        and a ``kind: gauges`` JSONL record.  ``timestamp`` lets a caller on
        an injectable clock stamp the record deterministically; None keeps
        wall time."""
        if not self.enabled:
            return None
        self.record_events([(f"{prefix}/{k}", float(v), int(step))
                            for k, v in gauges.items() if v is not None])
        record = {"kind": "gauges", "prefix": prefix, "step": int(step),
                  "timestamp": time.time() if timestamp is None else float(timestamp),
                  **gauges}
        # cache the GAUGES only: the ops adapter exports every numeric cached
        # key as a metric family, and step/timestamp must not become one
        self.last_gauges[prefix] = dict(gauges)
        self._write_jsonl(record)
        return record

    def record_resilience(self, event: str, *, step: int = 0, samples: int = 0,
                          **fields) -> Optional[Dict[str, Any]]:
        """Fault-path happenings (sheds, preemptions, deadline expiries,
        stalls, restarts) -> a ``kind: resilience`` JSONL record plus monitor
        events for the numeric fields."""
        if not self.enabled:
            return None
        record = {"kind": "resilience", "event": event, "step": int(step),
                  "timestamp": time.time(), **fields}
        self.resilience_counts[event] = self.resilience_counts.get(event, 0) + 1
        self._write_jsonl(record)
        self.record_events([(f"Resilience/{event}/{k}", float(v), int(samples))
                            for k, v in fields.items()
                            if isinstance(v, (int, float)) and not isinstance(v, bool)])
        return record

    def record_trace(self, trace: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """One completed request-lifecycle trace (``monitor/tracing.py``
        ``RequestTracer``) -> a ``kind: trace`` JSONL record: uid, terminal
        status, span chain, SLO marks."""
        if not self.enabled:
            return None
        record = {"kind": "trace", "timestamp": time.time(), **trace}
        self._write_jsonl(record)
        return record

    def record_events(self, events: List[Event]) -> None:
        """Fan events out to MonitorMaster (rank 0; no JSONL)."""
        if not self.enabled or not events:
            return
        if self.monitor is not None and self._is_rank0:
            self.monitor.write_events(list(events))

    def rate(self, name: str, count: float) -> Optional[float]:
        """Per-second rate of a monotonically increasing counter between
        successive calls (None on the first observation of ``name``)."""
        now = time.perf_counter()
        prev = self._rates.get(name)
        self._rates[name] = (now, count)
        if prev is None or now <= prev[0]:
            return None
        return (count - prev[1]) / (now - prev[0])

    # ------------------------------------------------------------- JSONL sink
    def _write_jsonl(self, record: Dict[str, Any]) -> None:
        path = self.config.jsonl_path
        if path is None or not self._is_rank0:
            return
        if self._jsonl_fh is None:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._jsonl_fh = open(path, "a")
        self._jsonl_fh.write(json.dumps(record) + "\n")
        self.records_written += 1
        # flush every jsonl_flush_every records (1: after each one); close()
        # flushes whatever is buffered
        self._unflushed += 1
        if self._unflushed >= self.config.jsonl_flush_every:
            self._jsonl_fh.flush()
            self._unflushed = 0

    def flush_jsonl(self) -> None:
        """Force out any buffered JSONL records (close() does this too)."""
        if self._jsonl_fh is not None:
            self._jsonl_fh.flush()
        self._unflushed = 0

    # ------------------------------------------------- torch.profiler windows
    @property
    def tracing(self) -> bool:
        return self._profiler is not None

    def profile_step_boundary(self, step: int) -> None:
        """Drive the step capture window; call at the top of each train step
        with the CURRENT global step.  The window is [start, stop): the trace
        starts entering any step inside it (>= start) and stops entering
        ``profile_step_stop`` (or at close()); one window per run."""
        if not self.enabled:
            return
        start, stop = self.config.profile_step_start, self.config.profile_step_stop
        if self.tracing and stop >= 0 and step >= stop:
            self.stop_trace()
            self._profile_done = True
        if (not self.tracing and not self._profile_done and start >= 0
                and step >= start and (stop < 0 or step < stop)):
            self.start_trace()

    def serve_profile_begin(self) -> None:
        """Arm the serve-iteration capture window for one ``generate()``
        call: every generate() can capture its own [start, stop) window."""
        self._serve_profile_done = False

    def profile_serve_boundary(self, iteration: int) -> None:
        """Drive the serve-loop capture window; call at the top of each serve
        iteration with the per-generate iteration index.  Same [start, stop)
        semantics as :meth:`profile_step_boundary`, keyed on
        ``profile_serve_iteration_start/stop`` and re-armed per generate()."""
        if not self.enabled:
            return
        start = self.config.profile_serve_iteration_start
        stop = self.config.profile_serve_iteration_stop
        if self.tracing and stop >= 0 and iteration >= stop:
            self.stop_trace()
            self._serve_profile_done = True
        if (not self.tracing and not self._serve_profile_done and start >= 0
                and iteration >= start and (stop < 0 or iteration < stop)):
            self.start_trace()

    def serve_profile_end(self) -> None:
        """Close a serve window still open when generate() returns: one
        window per generate(), never a trace leaking across calls."""
        if (self.enabled and self.tracing
                and self.config.profile_serve_iteration_start >= 0):
            self.stop_trace()
            self._serve_profile_done = True

    def start_trace(self) -> bool:
        """Start a ``torch.profiler`` window.  A profiler that fails to start
        (another one active, no profiling support) is logged and skipped:
        the profiler must never kill training or serving."""
        if self.tracing:
            return False
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        try:
            prof.start()
        except Exception as e:
            logger.warning(f"telemetry: torch.profiler start failed: {e}")
            return False
        self._profiler = prof
        logger.info(f"telemetry: torch.profiler trace started -> {self.config.profile_dir}")
        return True

    def stop_trace(self) -> Optional[str]:
        """Stop the window and write its Chrome trace into ``profile_dir``;
        returns the file's path (None when no window was open or the export
        failed, which is logged)."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return None
        path = os.path.join(self.config.profile_dir,
                            f"trace_{os.getpid()}_{len(self.traces_written)}.json")
        try:
            prof.stop()
            os.makedirs(self.config.profile_dir, exist_ok=True)
            prof.export_chrome_trace(path)
        except Exception as e:
            logger.warning(f"telemetry: torch.profiler stop/export failed: {e}")
            return None
        self.traces_written.append(path)
        logger.info(f"telemetry: torch.profiler trace written to {path}")
        return path

    def step_annotation(self, step: int):
        """``record_function("train_step#<step>")`` for the train step."""
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(f"train_step#{int(step)}")

    def annotation(self, name: str):
        """A named ``record_function`` range (batch-prep, serve phases, ...)."""
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    # ---------------------------------------------------------------- teardown
    def close(self) -> None:
        self.stop_trace()
        if self._jsonl_fh is not None:
            self._jsonl_fh.close()  # close() flushes any buffered records
            self._jsonl_fh = None
        self._unflushed = 0

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the profiler or logging may be gone
            pass
