"""Prometheus text-format (0.0.4) exposition for the metrics registry.

Counterpart of ``deepspeed_tpu/monitor/exposition.py``, the same renderer,
parser and histogram mapping.

Renders a :class:`~.metrics.MetricsRegistry` as the plain-text format every
Prometheus-compatible scraper speaks::

    # HELP dstpu_serving_shed_total requests load-shed at the admission door
    # TYPE dstpu_serving_shed_total counter
    dstpu_serving_shed_total 3
    # HELP dstpu_request_ttft_seconds time to first token
    # TYPE dstpu_request_ttft_seconds histogram
    dstpu_request_ttft_seconds_bucket{le="1e-05"} 0
    dstpu_request_ttft_seconds_bucket{le="2.1544346900318823e-05"} 2
    dstpu_request_ttft_seconds_bucket{le="+Inf"} 7
    dstpu_request_ttft_seconds_sum 0.004
    dstpu_request_ttft_seconds_count 7

Histogram conversion is EXACT, not approximated: the log-bucket
:class:`~.tracing.StreamingHistogram` keeps one count per occupied bucket,
and every bucket's upper edge becomes a cumulative ``le`` boundary (the
underflow bucket's edge is ``min_value``), with ``_sum``/``_count`` taken
from the histogram's own running total/count.  :func:`histogram_from_samples`
reverses the mapping (``le`` edge -> bucket index), so a histogram
round-trips through exposition with IDENTICAL quantiles — the property the
unit tests pin, and the reason a fleet endpoint can be scraped instead of
queried in-process without losing SLO accuracy.

Also here: :func:`parse_exposition`, a strict mini parser used by the tests
and the ops-smoke lane to validate that everything we render (HELP/TYPE
lines, label escaping, histogram cumulativity, ``+Inf`` == ``_count``) is
well-formed — the in-tree scraper contract.

All host-side string/arithmetic work; nothing here imports torch or numpy.
"""

import math
import re
from typing import Any, Dict, List, Optional, Tuple

from .metrics import (COUNTER, GAUGE, HISTOGRAM, METRIC_NAME_RE, MetricFamily,
                      MetricsRegistry)
from .tracing import StreamingHistogram

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>\S+)"
    r"(?:\s+(?P<ts>-?\d+))?$")
_LABEL_RE = re.compile(
    r'\s*(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\.)*)"\s*(?:,|$)')


def escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _unescape(value: str) -> str:
    out, i = [], 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def format_value(value: float) -> str:
    """Prometheus-parseable value: integral floats render as ints (counters
    stay pretty), everything else as ``repr`` (which round-trips exactly)."""
    value = float(value)
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if math.isnan(value):
        return "NaN"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


def _labels_text(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(str(v))}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


# ------------------------------------------------------------ histogram maps
def cumulative_buckets(hist: StreamingHistogram) -> List[Tuple[float, int]]:
    """``[(le_upper_edge, cumulative_count)]`` over occupied buckets, in
    ascending edge order.  Bucket ``i`` of the log histogram covers
    ``[min * 10^(i/bpd), min * 10^((i+1)/bpd))``; its Prometheus boundary is
    the exclusive upper edge (the count of values <= edge equals the count
    of values < edge for these half-open buckets up to measure-zero ties,
    and the histogram itself assigns exact edges to the upper bucket, so
    the cumulative counts are exact)."""
    out: List[Tuple[float, int]] = []
    cum = 0
    for idx in sorted(hist.counts):
        cum += hist.counts[idx]
        out.append((bucket_upper_edge(hist, idx), cum))
    return out


def bucket_upper_edge(hist: StreamingHistogram, index: int) -> float:
    """Exclusive upper edge of log-bucket ``index`` (underflow's edge is
    exactly ``min_value``: the formula holds for index -1 too)."""
    return hist.min_value * 10.0 ** ((index + 1) / hist.buckets_per_decade)


def bucket_index_of_edge(le: float, buckets_per_decade: int,
                         min_value: float) -> int:
    """Inverse of :func:`bucket_upper_edge` (round-trip reconstruction)."""
    return round(math.log10(le / min_value) * buckets_per_decade) - 1


def histogram_from_samples(samples: List[Tuple[Dict[str, str], float]], *,
                           buckets_per_decade: int,
                           min_value: float) -> StreamingHistogram:
    """Rebuild a :class:`StreamingHistogram` from parsed exposition samples
    of one histogram family (the ``_bucket``/``_sum``/``_count`` triplet as
    ``(labels, value)`` pairs, ``le`` in labels).  Quantiles of the result
    are IDENTICAL to the source histogram's — the round-trip contract.
    ``max_seen`` is not carried by the text format and stays None."""
    hist = StreamingHistogram(buckets_per_decade, min_value)
    edges: List[Tuple[float, int]] = []
    for labels, value in samples:
        le = labels.get("le")
        if le is None:
            continue
        if le == "+Inf":
            hist.count = int(value)
            continue
        edges.append((float(le), int(value)))
    edges.sort()
    prev = 0
    for le, cum in edges:
        n = cum - prev
        prev = cum
        if n:
            hist.counts[bucket_index_of_edge(le, buckets_per_decade,
                                             min_value)] = n
    if hist.count < prev:
        hist.count = prev
    return hist


# ------------------------------------------------------------------- render
def render_family(fam: MetricFamily) -> List[str]:
    lines = [f"# HELP {fam.name} {escape_help(fam.help)}",
             f"# TYPE {fam.name} {fam.kind}"]
    for key in sorted(fam.samples):
        labels = dict(key)
        value = fam.samples[key]
        if fam.kind == HISTOGRAM:
            for le, cum in cumulative_buckets(value):
                lines.append(f"{fam.name}_bucket"
                             f"{_labels_text({**labels, 'le': repr(le)})} {cum}")
            lines.append(f"{fam.name}_bucket"
                         f"{_labels_text({**labels, 'le': '+Inf'})} {value.count}")
            lines.append(f"{fam.name}_sum{_labels_text(labels)} "
                         f"{format_value(value.total)}")
            lines.append(f"{fam.name}_count{_labels_text(labels)} {value.count}")
        else:
            lines.append(f"{fam.name}{_labels_text(labels)} "
                         f"{format_value(value)}")
    return lines


def render(registry: MetricsRegistry, *, collect: bool = True) -> str:
    """The full /metrics payload.  ``collect=False`` skips the registered
    collector callbacks and renders the registry as-is — the ops server's
    cache-refresh path collects explicitly on the owning thread."""
    families = registry.collect() if collect else registry.families
    lines: List[str] = []
    for name in sorted(families):
        lines.extend(render_family(families[name]))
    return "\n".join(lines) + ("\n" if lines else "")


# -------------------------------------------------------------------- parse
class ExpositionError(ValueError):
    """A rendered payload violated the text-format contract (the mini
    parser is strict on purpose: it is the in-tree stand-in for every
    external scraper)."""


def _base_name(sample_name: str, histogram_families: set) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix) and \
                sample_name[:-len(suffix)] in histogram_families:
            return sample_name[:-len(suffix)]
    return sample_name


def parse_exposition(text: str) -> Dict[str, Dict[str, Any]]:
    """Strict parse of a 0.0.4 payload.

    Returns ``{family: {"type", "help", "samples": [(name, labels, value)]}}``
    and raises :class:`ExpositionError` on: malformed HELP/TYPE/sample lines,
    a sample with no preceding TYPE for its family, bad label syntax or a
    histogram sample without ``le``, non-monotone cumulative buckets, or a
    ``+Inf`` bucket disagreeing with ``_count``."""
    families: Dict[str, Dict[str, Any]] = {}
    histogram_families: set = set()
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            name = parts[0]
            if not METRIC_NAME_RE.match(name):
                raise ExpositionError(f"line {lineno}: bad metric name in HELP: {name!r}")
            fam = families.setdefault(name, {"type": None, "help": "", "samples": []})
            fam["help"] = _unescape(parts[1]) if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split()
            if len(parts) != 2 or parts[1] not in (COUNTER, GAUGE, HISTOGRAM,
                                                   "summary", "untyped"):
                raise ExpositionError(f"line {lineno}: bad TYPE line: {raw!r}")
            name, kind = parts
            fam = families.setdefault(name, {"type": None, "help": "", "samples": []})
            if fam["samples"]:
                raise ExpositionError(f"line {lineno}: TYPE for {name} after its samples")
            fam["type"] = kind
            if kind == HISTOGRAM:
                histogram_families.add(name)
            continue
        if line.startswith("#"):
            continue  # comment
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ExpositionError(f"line {lineno}: unparseable sample: {raw!r}")
        sample_name = m.group("name")
        labels: Dict[str, str] = {}
        labels_text = m.group("labels")
        if labels_text is not None:
            pos = 0
            while pos < len(labels_text):
                lm = _LABEL_RE.match(labels_text, pos)
                if not lm:
                    raise ExpositionError(
                        f"line {lineno}: bad label syntax at {labels_text[pos:]!r}")
                labels[lm.group("name")] = _unescape(lm.group("value"))
                pos = lm.end()
        value_text = m.group("value")
        try:
            value = float("inf") if value_text == "+Inf" else \
                float("-inf") if value_text == "-Inf" else float(value_text)
        except ValueError:
            raise ExpositionError(f"line {lineno}: bad value {value_text!r}")
        base = _base_name(sample_name, histogram_families)
        fam = families.get(base)
        if fam is None or fam["type"] is None:
            raise ExpositionError(
                f"line {lineno}: sample {sample_name} has no preceding # TYPE")
        if fam["type"] == HISTOGRAM and sample_name == f"{base}_bucket" \
                and "le" not in labels:
            raise ExpositionError(f"line {lineno}: histogram bucket without le label")
        fam["samples"].append((sample_name, labels, value))
    _validate_histograms(families, histogram_families)
    return families


def _series_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, v) for k, v in labels.items() if k != "le"))


def _validate_histograms(families: Dict[str, Dict[str, Any]],
                         histogram_families: set) -> None:
    for name in histogram_families:
        fam = families[name]
        buckets: Dict[Tuple, List[Tuple[float, float]]] = {}
        counts: Dict[Tuple, float] = {}
        for sample_name, labels, value in fam["samples"]:
            key = _series_key(labels)
            if sample_name == f"{name}_bucket":
                le = labels["le"]
                edge = float("inf") if le == "+Inf" else float(le)
                buckets.setdefault(key, []).append((edge, value))
            elif sample_name == f"{name}_count":
                counts[key] = value
        for key, series in buckets.items():
            series.sort()
            last = -1.0
            for edge, cum in series:
                if cum < last:
                    raise ExpositionError(
                        f"{name}{dict(key)}: cumulative bucket counts decrease "
                        f"at le={edge}")
                last = cum
            if not series or not math.isinf(series[-1][0]):
                raise ExpositionError(f"{name}{dict(key)}: missing +Inf bucket")
            inf_count = series[-1][1]
            if key in counts and counts[key] != inf_count:
                raise ExpositionError(
                    f"{name}{dict(key)}: +Inf bucket ({inf_count}) != _count "
                    f"({counts[key]})")


def parsed_histogram(families: Dict[str, Dict[str, Any]], name: str, *,
                     buckets_per_decade: int, min_value: float,
                     labels: Optional[Dict[str, str]] = None
                     ) -> StreamingHistogram:
    """Convenience for tests/smokes: reconstruct one (family, label-set)
    histogram straight from :func:`parse_exposition` output."""
    fam = families[name]
    want = _series_key(labels or {})
    samples = [(lab, value) for sample_name, lab, value in fam["samples"]
               if sample_name == f"{name}_bucket" and _series_key(lab) == want]
    hist = histogram_from_samples(samples, buckets_per_decade=buckets_per_decade,
                                  min_value=min_value)
    for sample_name, lab, value in fam["samples"]:
        if _series_key(lab) != want:
            continue
        if sample_name == f"{name}_sum":
            hist.total = value
        elif sample_name == f"{name}_count":
            hist.count = int(value)
    return hist
