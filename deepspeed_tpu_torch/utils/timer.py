"""Wall-clock and throughput timers (JAX ``deepspeed_tpu/utils/timer.py``).

``sync=True`` waits for the device's queued work before the clock is read:
``torch.cuda.synchronize`` on a CUDA device, nothing on the CPU, where
every op has finished when it returns.  JAX's timers drain XLA's dispatch
queue instead.
"""

import time
from typing import Dict, List, Optional

from .logging import log_dist


def _device_sync(device=None):
    import torch
    device = torch.device("cuda" if device is None and torch.cuda.is_available()
                          else device or "cpu")
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Timer:

    def __init__(self, name, device=None):
        self.name = name
        self.device = device
        self.started = False
        self.start_time = 0.0
        self.elapsed_ms = 0.0
        self.count = 0

    def start(self, sync=False):
        if sync:
            _device_sync(self.device)
        self.start_time = time.perf_counter()
        self.started = True

    def stop(self, sync=False):
        if not self.started:
            return
        if sync:
            _device_sync(self.device)
        self.elapsed_ms += (time.perf_counter() - self.start_time) * 1000.0
        self.count += 1
        self.started = False

    def elapsed(self, reset=True):
        value = self.elapsed_ms
        if reset:
            self.elapsed_ms = 0.0
            self.count = 0
        return value

    def mean(self):
        return self.elapsed_ms / max(self.count, 1)


class SynchronizedWallClockTimer:
    """Named timers; ``device`` is the one a synchronized read waits for
    (default: the current CUDA device where there is one, else none)."""

    def __init__(self, device=None):
        self.device = device
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, self.device)
        return self.timers[name]

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True):
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) / max(normalizer, 1e-9)
                parts.append(f"{name}: {ms:.2f}")
        if parts:
            log_dist("time (ms) | " + " | ".join(parts), ranks=[0])


class NoopTimer:

    class _N:

        def start(self, *a, **k):
            pass

        def stop(self, *a, **k):
            pass

        def elapsed(self, *a, **k):
            return 0.0

    def __call__(self, name):
        return self._N()

    def log(self, *a, **k):
        pass


class ThroughputTimer:
    """Samples a second over the steps after the first ``start_step``."""

    def __init__(self, batch_size: int, start_step: int = 2, device=None):
        self.batch_size = max(batch_size, 1)
        self.start_step = start_step
        self.device = device
        self.step_count = 0
        self.total_elapsed = 0.0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> Optional[float]:
        if self._t0 is None:
            return None
        _device_sync(self.device)
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.step_count += 1
        if self.step_count > self.start_step:  # the first steps carry the warm-up
            self.total_elapsed += dt
        return dt

    def avg_samples_per_sec(self) -> float:
        counted = self.step_count - self.start_step
        if counted <= 0 or self.total_elapsed == 0:
            return 0.0
        return counted * self.batch_size / self.total_elapsed
