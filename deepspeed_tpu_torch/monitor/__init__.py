"""Monitoring: the monitor writers, the unified telemetry collector, the
serving perf observatory and request tracing, and the pull-based ops plane
(metrics registry, Prometheus exposition, HTTP endpoints)."""
from .exposition import parse_exposition, render
from .metrics import FleetAggregator, MetricsRegistry
from .monitor import Monitor, MonitorMaster
from .ops_server import OpsCache, OpsServer, scrape
from .telemetry import TelemetryCollector, detect_peak_flops_per_chip
from .tracing import FlightRecorder, RequestTracer, StreamingHistogram
