"""Pull-based ops endpoints: /metrics, /healthz, /statez.

Counterpart of ``deepspeed_tpu/monitor/ops_server.py``, with its names,
endpoints and per-rank file protocol.

A stdlib ``ThreadingHTTPServer`` (ephemeral port by default) that serves the
operator-facing face of everything the engines measure:

- ``/metrics``  — Prometheus text format 0.0.4 (:mod:`.exposition`)
- ``/healthz``  — the owning component's ``health()`` snapshot as JSON
- ``/statez``   — ``state_snapshot()`` (+ flight-recorder tail) as JSON

**Scrape-safety contract.**  Handlers serve ONLY the
pre-rendered byte strings in :class:`OpsCache`; they never call into the
engine, registry, or any collector.  The owning thread (the serve loop, the
train step, the agent/supervisor poll loop) refreshes the cache at points it
already touches the host state — so a scrape is a memory read, can never
read a device value, and can never race a mutating step.  This module
imports neither torch nor numpy.

**Multi-process aggregation.**  Ranks that don't own the endpoint (training
ranks > 0, supervised serving workers) write their registry snapshot — plus
a scrape-ready ``.prom`` textfile for node-exporter-style collection — to a
shared directory via :func:`write_rank_files` (atomic tmp + ``os.replace``,
the heartbeat write protocol).  The elastic agent / ``ServingSupervisor``
read them back with :func:`read_rank_snapshots` (torn/foreign files read as
absent, never as an exception) and merge them through
:class:`~.metrics.FleetAggregator` into one fleet-level endpoint that stays
monotone across worker restarts.
"""

import json
import logging
import os
import re
import socket
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from ..utils.env import warning_once
from .exposition import CONTENT_TYPE, render
from .metrics import MetricsRegistry

# rank exchange files: ops.rank<R>.json (registry snapshot, the exact-merge
# format) + ops.rank<R>.prom (rendered text, for external textfile collectors)
_SNAPSHOT_PREFIX = "ops.rank"
_SNAPSHOT_RE = re.compile(r"^ops\.rank(\d+)\.json$")

JSON_CONTENT_TYPE = "application/json; charset=utf-8"

logger = logging.getLogger(__name__)


class OpsCache:
    """The host-side cached snapshots a scrape reads.

    Plain attribute assignment of complete strings — atomic under the GIL,
    so the HTTP threads always see a consistent payload without locking the
    serve loop."""

    def __init__(self):
        self.metrics_text = ""
        self.healthz = "{}"
        self.statez = "{}"
        self.refreshes = 0

    def update(self, *, metrics_text: Optional[str] = None,
               healthz: Optional[str] = None,
               statez: Optional[str] = None) -> None:
        if metrics_text is not None:
            self.metrics_text = metrics_text
        if healthz is not None:
            self.healthz = healthz
        if statez is not None:
            self.statez = statez
      
        self.refreshes += 1


class _OpsHandler(BaseHTTPRequestHandler):
    server_version = "dstpu-ops/1"

    def _send(self, body: str, content_type: str, code: int = 200) -> None:
        payload = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):  # noqa: N802 (http.server API)
        cache: OpsCache = self.server.ops_cache  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            self._send(cache.metrics_text, CONTENT_TYPE)
        elif path == "/healthz":
            self._send(cache.healthz, JSON_CONTENT_TYPE)
        elif path == "/statez":
            self._send(cache.statez, JSON_CONTENT_TYPE)
        elif path == "/":
            self._send('{"endpoints": ["/metrics", "/healthz", "/statez"]}',
                       JSON_CONTENT_TYPE)
        else:
            self._send('{"error": "not found"}', JSON_CONTENT_TYPE, code=404)

    def log_message(self, format, *args):  # scrapes must not spam stderr
        pass


class OpsServer:
    """Threaded HTTP server over an :class:`OpsCache`.

    ``port=0`` (the default) binds an ephemeral port — read ``.port`` after
    construction; ``close()`` shuts the listener down and joins the thread.
    Construction failures (port in use) raise; callers that prefer degraded
    observability over a dead process use :func:`try_start_ops_server`."""

    def __init__(self, cache: Optional[OpsCache] = None, *,
                 host: str = "127.0.0.1", port: int = 0):
        self.cache = cache if cache is not None else OpsCache()
        self._httpd = ThreadingHTTPServer((host, int(port)), _OpsHandler)
        self._httpd.daemon_threads = True
        self._httpd.ops_cache = self.cache  # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="dstpu-ops-server", daemon=True)
        self._thread.start()
        self.closed = False

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        # ``shutdown()`` blocks until serve_forever acknowledges — which
        # NEVER happens during interpreter finalization (daemon threads are
        # frozen before remaining __del__s run), so a process exiting with a
        # live listener would hang forever on this wait.  At finalization
        # (or with the thread already gone) just close the socket; the
        # daemon thread dies with the process.
        if not sys.is_finalizing() and self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
        self._httpd.server_close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the socket/thread machinery may be gone
            pass


def try_start_ops_server(cache: OpsCache, *, host: str = "127.0.0.1",
                         port: int = 0, owner: str = "ops") -> Optional[OpsServer]:
    """Start a server, degrading to None (with one warning) on bind failure —
    a busy port must degrade observability, never kill training/serving."""
    try:
        server = OpsServer(cache, host=host, port=port)
    except OSError as exc:
        warning_once(f"{owner}: ops server failed to bind {host}:{port} "
                     f"({exc}); /metrics+/healthz disabled for this process")
        return None
    logger.info(f"{owner}: ops endpoints at http://{server.host}:{server.port} "
                f"(/metrics /healthz /statez)")
    return server


class OpsPublisher:
    """One process's ops-plane state, shared by the training and serving
    engines: the registry, the scrape cache, the (optional) HTTP listener,
    and the per-rank exchange files — plus the refresh policy (throttle and
    counter-reset handling) so the two engines cannot drift apart.

    ``refresh`` takes CALLABLES for the payloads so a throttled call costs
    two float compares, not a render.  A ``ValueError`` out of ``populate``
    (a source counter that legally rewound — e.g. a checkpoint rollback
    restoring an older ``global_steps``) is exposed as a standard Prometheus
    COUNTER RESET: fresh registry, SAME generation, so scrapers apply their
    normal reset handling.  A generation bump would instead fold the
    pre-rollback totals into the fleet carry and double-count every counter
    that did NOT rewind (the carry is exact only for real restarts, where
    process counters restart from zero)."""

    def __init__(self, cfg, *, generation: int = 0, ops_dir: Optional[str] = None,
                 rank: int = 0, owner: str = "ops"):
        self.cfg = cfg
        self.registry = MetricsRegistry(namespace=cfg.namespace,
                                        generation=int(generation))
        self.cache = OpsCache()
        self.ops_dir = ops_dir
        self.rank = int(rank)
        self.server = (try_start_ops_server(self.cache, host=cfg.host,
                                            port=cfg.port, owner=owner)
                       if cfg.enabled else None)
        self._last_refresh = -float("inf")

    def refresh(self, populate, *, now: float, force: bool = False,
                healthz=None, statez=None) -> bool:
        """Rebuild the cached snapshots (True when a refresh ran).  ``now``
        is the OWNER's clock (the serving engine donates its injectable
        clock's last read; training uses monotonic wall time) so throttling
        stays deterministic under fake clocks."""
        if not force and now - self._last_refresh < self.cfg.refresh_interval_s:
            return False
        self._last_refresh = now
        try:
            populate(self.registry)
        except ValueError:
            # counter reset (see class docstring): same generation, fresh
            # counts — never let a metrics invariant kill the owning loop
            self.registry = MetricsRegistry(namespace=self.cfg.namespace,
                                            generation=self.registry.generation)
            populate(self.registry)
        text = render(self.registry, collect=False)
        self.cache.update(metrics_text=text,
                          healthz=healthz() if healthz is not None else None,
                          statez=statez() if statez is not None else None)
        if self.ops_dir:
            write_rank_files(self.ops_dir, self.rank, self.registry,
                             metrics_text=text)
        return True

    def close(self) -> None:
        if self.server is not None:
            self.server.close()


def scrape(url: str, timeout: float = 2.0) -> str:
    """Tiny in-tree scraper (tests + smokes; avoids urllib's global state):
    one GET, returns the decoded body, raises on a non-200."""
    from urllib.parse import urlparse
    parsed = urlparse(url)
    with socket.create_connection((parsed.hostname, parsed.port),
                                  timeout=timeout) as sock:
        path = parsed.path or "/"
        sock.sendall(f"GET {path} HTTP/1.1\r\nHost: {parsed.hostname}\r\n"
                     f"Connection: close\r\n\r\n".encode())
        chunks = []
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            chunks.append(chunk)
    raw = b"".join(chunks).decode("utf-8", errors="replace")
    head, _, body = raw.partition("\r\n\r\n")
    status_line = head.splitlines()[0] if head else ""
    parts = status_line.split()
    code = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else 0
    if code != 200:
        raise RuntimeError(f"scrape {url}: HTTP {code or status_line!r}")
    return body


# ==========================================================================
# Per-rank exchange files (training ranks > 0, supervised serving workers)
# ==========================================================================

def _atomic_write(path: str, payload: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(payload)
    os.replace(tmp, path)


def snapshot_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"{_SNAPSHOT_PREFIX}{int(rank)}.json")


def textfile_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"{_SNAPSHOT_PREFIX}{int(rank)}.prom")


def write_rank_files(directory: str, rank: int,
                     registry: MetricsRegistry, *,
                     metrics_text: Optional[str] = None) -> bool:
    """Atomically publish this rank's registry: the JSON snapshot (the
    exact-merge format the aggregators read) and the rendered ``.prom``
    textfile.  A broken directory degrades to False with one warning —
    observability export must never fail the work it observes."""
    try:
        os.makedirs(directory, exist_ok=True)
        _atomic_write(snapshot_path(directory, rank),
                      json.dumps(registry.snapshot()))
        _atomic_write(textfile_path(directory, rank),
                      metrics_text if metrics_text is not None
                      else render(registry, collect=False))
    except OSError as exc:
        warning_once(f"ops: cannot write rank {rank} metrics files under "
                     f"{directory!r} ({exc}); per-rank export disabled")
        return False
    return True


def read_rank_snapshots(directory: str) -> Dict[int, Dict[str, Any]]:
    """All parseable per-rank snapshots under ``directory``.  Missing dir,
    torn writes, foreign files and valid-JSON-but-wrong-shape content all
    read as absent (the heartbeat reader's tolerance contract) — the
    aggregator keeps whatever it merged last.  A malformed file must degrade
    one rank's freshness, never crash the supervisor poll loop that every
    worker's lifecycle hangs off."""
    out: Dict[int, Dict[str, Any]] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        m = _SNAPSHOT_RE.match(name)
        if not m:
            continue
        try:
            with open(os.path.join(directory, name)) as fh:
                snap = json.load(fh)
        except (OSError, ValueError):
            continue  # torn write: absent this poll, not fatal
        if not isinstance(snap, dict) or not isinstance(snap.get("families"), dict):
            continue  # foreign/version-skewed writer: shape-invalid, absent
        out[int(m.group(1))] = snap
    return out
