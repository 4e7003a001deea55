"""Shared observability HTTP surface: /metrics, /healthz, /debug/traces.

One routing function serves both front doors — the admission webhook
(runtime/webhook.py mounts it inside its existing handler, so the
kube-apiserver-facing port also answers scrapes) and a standalone
:class:`ObservabilityServer` for processes with no webhook listener
(the background scanner). Endpoints:

``/metrics``
    Prometheus text 0.0.4 exposition from the metrics registry —
    including the ``kyverno_stage_duration_seconds`` bucket histograms
    the trace recorder feeds, so per-stage p50/p99 are scrapeable.
``/healthz``
    JSON liveness snapshot: ``ok``/``degraded`` status (the SLO
    watchdog's verdict), trace-recorder counters, the kill-switch lane
    matrix, stream-plane state (open streams, inflight batch fill,
    continuous flag), and the SLO burn-rate snapshot.
``/debug/traces``
    Flight-recorder dump (JSON). Query params: ``n`` (max traces,
    default 32), ``slowest=1`` (the K-slowest set instead of the
    newest), ``format=chrome`` (Chrome ``trace_event`` JSON for
    chrome://tracing / Perfetto instead of the plain schema).
``/debug/policies``
    Per-policy attribution snapshot: labelled top-K (policy, rule)
    pairs with verdict breakdowns, the exact-total overflow tail, and
    per-tenant rollups. ``n`` caps the pair rows.
``/debug/profile``
    On-demand device profiling: paramless GET = capture status plus a
    device-memory snapshot; ``?seconds=N`` starts a bounded
    torch.profiler window capture (409 while one is running).
``/debug/dryrun``
    Policy-rollout dry-run. Waits for the port's ``workload.dryrun``; it
    answers as the JAX package's does with ``KTPU_DRYRUN=0`` and no scan
    source: GET 200 ``{"enabled": false, "scan_source": false, ...}``,
    POST 403.
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from . import metrics as metrics_mod
from . import tracing

_started_at = time.time()

# version stamp on the /debug/* JSON payloads — replay-manifest diffing
# keys on it instead of sniffing the layout
DEBUG_SCHEMA_VERSION = 1

# the route whose module the port does not have yet (workload.dryrun):
# fixed answers, as the JAX route gives with its module off
DRYRUN_SCHEMA_VERSION = 1
DRYRUN_DISABLED = "dry-run service disabled (workload.dryrun is not ported)"


def _stream_enabled() -> bool:
    """Continuous-batching lane flag, without importing batch at module
    load (obs_http must stay importable from anything)."""
    try:
        from .batch import stream_enabled

        return stream_enabled()
    except Exception:
        return False


def handle_obs_get(path: str, registry=None):
    """Route one GET. Returns ``(status, body_bytes, content_type)`` or
    ``None`` when ``path`` is not an observability endpoint (the caller
    falls through to its own routes / 404)."""
    parsed = urlparse(path)
    # normalize: collapse duplicate slashes ("//healthz" is a classic
    # reverse-proxy artifact) and drop trailing ones before matching.
    # Work from the raw request target, not parsed.path — urlparse
    # reads a leading "//" as an authority and empties the path.
    raw = path.split("?", 1)[0].split("#", 1)[0]
    route = re.sub(r"/{2,}", "/", raw).rstrip("/") or "/"
    if route == "/metrics":
        # settle the recorder's deferred histogram feed before exposing
        tracing.recorder().feed_metrics()
        reg = registry if registry is not None else metrics_mod.registry()
        return 200, reg.expose().encode(), "text/plain; version=0.0.4"
    if route == "/healthz":
        rec = tracing.recorder()
        rec.feed_metrics()
        reg = registry if registry is not None else metrics_mod.registry()
        from . import sloactions
        from .slo import watchdog

        slo = watchdog().snapshot()
        # degradation controller: a scrape doubles as a tick so the
        # state machine (and the state-seconds counter) advances even
        # on an idle replica; report() carries the action ladder, the
        # explicit shed set, and the replica scale hint
        try:
            ctl = sloactions.controller()
            ctl.maybe_tick()
            slo_actions = ctl.report()
        except Exception:
            slo_actions = {"enabled": False, "state": "unknown"}
        body = json.dumps({
            "status": "degraded" if slo.get("degraded") else "ok",
            "uptime_s": round(time.time() - _started_at, 3),
            "tracing_enabled": tracing.trace_enabled(),
            "traces": dict(rec.stats),
            "lanes": tracing.killswitch_lanes(),
            # stream-plane fill state, next to the lane matrix
            "streams": {
                "open_streams": int(reg.gauge_value(
                    "kyverno_stream_open_streams") or 0),
                "inflight_batch_fill": reg.gauge_value(
                    "kyverno_stream_inflight_batch_fill") or 0.0,
                "continuous": _stream_enabled(),
            },
            "slo": slo,
            "slo_actions": slo_actions,
            # scan-plane mesh geometry: selected axes, device
            # inventory, per-shard rule distribution
            "mesh": metrics_mod.mesh_geometry_snapshot(),
            # fleet plane: ``{"enabled": false}`` in the port
            "fleet": metrics_mod.fleet_snapshot(),
        }).encode()
        return 200, body, "application/json"
    if route == "/debug/policies":
        q = parse_qs(parsed.query)
        try:
            limit = max(0, int(q.get("n", ["0"])[0]))
        except ValueError:
            limit = 0
        payload = metrics_mod.attribution_snapshot(limit=limit)
        payload["schema_version"] = DEBUG_SCHEMA_VERSION
        payload["attrib_enabled"] = tracing.attrib_enabled()
        reg = registry if registry is not None else metrics_mod.registry()
        payload.update(metrics_mod.lint_findings_snapshot(reg))
        return 200, json.dumps(payload).encode(), "application/json"
    if route == "/debug/profile":
        from . import profiling

        q = parse_qs(parsed.query)
        svc = profiling.capture_service()
        seconds_arg = q.get("seconds", [None])[0]
        if seconds_arg is None:
            payload = {"status": "idle", **svc.status(),
                       "device_memory": profiling.device_memory_snapshot()}
            return 200, json.dumps(payload).encode(), "application/json"
        try:
            seconds = float(seconds_arg)
        except ValueError:
            return (400, json.dumps({"error": "seconds must be a "
                                     "number"}).encode(),
                    "application/json")
        out = svc.start(seconds)
        status = 409 if out.get("status") == "busy" else 200
        return status, json.dumps(out).encode(), "application/json"
    if route == "/debug/traces":
        q = parse_qs(parsed.query)

        def _qint(name: str, default: int) -> int:
            try:
                return max(0, int(q[name][0]))
            except (KeyError, IndexError, ValueError):
                return default

        n = _qint("n", 32)
        slowest = q.get("slowest", ["0"])[0] not in ("0", "", "false")
        rec = tracing.recorder()
        if q.get("format", [""])[0] == "chrome":
            payload = rec.chrome_trace(n, slowest=slowest)
        else:
            payload = {"schema_version": DEBUG_SCHEMA_VERSION,
                       "enabled": tracing.trace_enabled(),
                       "slowest": slowest,
                       "stats": dict(rec.stats),
                       "traces": rec.export(n, slowest=slowest)}
        return 200, json.dumps(payload).encode(), "application/json"
    if route == "/debug/dryrun":
        payload = {"schema_version": DRYRUN_SCHEMA_VERSION,
                   "enabled": False, "scan_source": False,
                   "usage": 'POST {"policy": <ClusterPolicy doc>, '
                            '"sample_limit": 5}'}
        return 200, json.dumps(payload).encode(), "application/json"
    return None


def handle_obs_post(path: str, body: bytes, registry=None):
    """Route one POST. Same contract as :func:`handle_obs_get` —
    ``None`` means "not an observability endpoint". Currently one
    route: ``/debug/dryrun`` evaluates a candidate policy's blast
    radius against the registered scan source without touching live
    decisions; in the port it answers 403, as the JAX route does while
    KTPU_DRYRUN=0."""
    raw = path.split("?", 1)[0].split("#", 1)[0]
    route = re.sub(r"/{2,}", "/", raw).rstrip("/") or "/"
    if route != "/debug/dryrun":
        return None
    return (403, json.dumps({"error": DRYRUN_DISABLED}).encode(),
            "application/json")


class ObservabilityServer:
    """Standalone /metrics /healthz /debug/traces listener for
    processes that don't run the webhook server (background scanner,
    bench drivers). Port 0 picks a free port; read it back from
    ``server_port`` after :meth:`start`."""

    def __init__(self, registry=None, host: str = "127.0.0.1",
                 port: int = 9464):
        self.registry = registry
        self.host = host
        self.port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def server_port(self) -> int | None:
        return self._httpd.server_address[1] if self._httpd else None

    def start(self) -> ThreadingHTTPServer:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _reply(self, out):
                if out is None:
                    out = (404, b"not found", "text/plain")
                status, body, ctype = out
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._reply(handle_obs_get(self.path, outer.registry))

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                self._reply(handle_obs_post(self.path, body,
                                            outer.registry))

        class Httpd(ThreadingHTTPServer):
            daemon_threads = True

        self._httpd = Httpd((self.host, self.port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="ktpu-obs-http")
        self._thread.start()
        return self._httpd

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
