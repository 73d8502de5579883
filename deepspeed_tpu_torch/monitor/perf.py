"""Compile ledger of the v2 serving engine.

Counterpart of the ``CompileLedger`` of ``deepspeed_tpu/monitor/perf.py``:
the single source of ``ServeCounters.compiles``.  In the port a "compile" is
the build of one bucket program: a CUDA-graph capture on the card, or the
first eager use of a bucket key on the CPU.  Every build is recorded as
``(site, key)`` with a class:

- ``prewarmed``: built ahead of traffic by the engine's intake prewarm;
- ``cold``: the first build of this (site, key) under traffic;
- ``warm``: a key built again after it was already seen, a recompile.

A ``warm`` build lands in the engine's flight recorder as a
``warm_recompile`` event, as in the JAX ledger.  The phase profiler and
roofline model of the JAX module are not ported yet.  Nothing here reads a
clock or touches a device: wall times come in from the caller.
"""

from typing import Any, Dict, Tuple

CLASS_PREWARMED = "prewarmed"  # built ahead of traffic by _prewarm
CLASS_COLD = "cold"            # first build of this (site, key) under traffic
CLASS_WARM = "warm"            # rebuilt after already being seen: a recompile


class CompileLedger:
    """Attributed record of every bucket program the serving engine builds;
    each :meth:`record` bumps ``counters.compiles`` exactly once."""

    def __init__(self, counters=None, *, tracer=None):
        self._counters = counters
        self._tracer = tracer
        self._seen: Dict[Tuple[str, str], int] = {}
        self.by_site: Dict[str, Dict[str, int]] = {}
        self.warm_by_site: Dict[str, int] = {}
        self.wall_by_class: Dict[str, float] = {}
        self.total = 0

    @staticmethod
    def _key_str(key: Any) -> str:
        return key if isinstance(key, str) else repr(key)

    def record(self, site: str, key: Any, *, wall_s: float = 0.0,
               prewarmed: bool = False) -> str:
        """Record one build at ``site`` for bucket ``key``; returns its class."""
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
        self.total += 1
        if self._counters is not None:
            self._counters.compiles += 1
        return cls

    @property
    def warm_total(self) -> int:
        return sum(self.warm_by_site.values())

    def count(self, cls: str) -> int:
        """Builds of class ``cls`` over every site."""
        return sum(per_site.get(cls, 0) for per_site in self.by_site.values())
