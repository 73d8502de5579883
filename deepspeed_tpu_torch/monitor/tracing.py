"""Streaming histograms for serving observability.

Counterpart of ``deepspeed_tpu/monitor/tracing.py``; the port carries only
:class:`StreamingHistogram`, the log-bucket histogram the KV-pool census
(``inference/v2/kv_metrics.py``) builds its block-age, idle and
blocks-per-request distributions on.  The request tracer, its SLO latency
histograms and the flight recorder of the JAX module come with the port of
request tracing (ROADMAP Queue 1, item 4).

All host-side; nothing here touches a device.
"""

import math
from typing import Any, Dict, Optional


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
