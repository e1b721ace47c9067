"""HTTP exposition of a MetricRegistry (``launch/serve.py --metrics-port``).

GET /metrics       Prometheus-style text (``MetricRegistry.to_text``,
                   including derived p50/p95/p99 ``quantile=...`` lines)
GET /metrics.json  the raw ``snapshot()`` dict as JSON
GET /healthz       SLO health (docs/quality.md): 200 while the ``health``
                   source reports ok/warn, 503 during a critical alert;
                   body is the source's JSON (status + per-rule states)
GET /statusz       JSON deployment status: uptime plus whatever the
                   ``status`` source reports (artifact version, checksum,
                   alert states, ...); always 200

``health``/``status`` are zero-arg callables returning JSON-able dicts —
wire ``health=monitor.health`` from an :class:`~repro_torch.obs.quality.
SLOMonitor` and a ``status`` closure over the serving index/artifact. With
no ``health`` source, /healthz reports ``{"status": "ok"}`` (a server with
no SLOs is trivially healthy, not broken).

Copy of ``repro/obs/exposition.py`` (the standard library only): the same
paths, bodies and status codes.

Runs a ThreadingHTTPServer on a daemon thread; ``start_metrics_server``
returns the server so callers can ``shutdown()`` it. Port 0 binds an
ephemeral port (tests read ``server.server_address``).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs.registry import MetricRegistry

__all__ = ["start_metrics_server"]


def _make_handler(registry: MetricRegistry, health=None, status=None):
    t0 = time.monotonic()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?")[0]
            code = 200
            if path == "/metrics":
                body = registry.to_text().encode()
                ctype = "text/plain; version=0.0.4"
            elif path == "/metrics.json":
                body = json.dumps(registry.snapshot()).encode()
                ctype = "application/json"
            elif path == "/healthz":
                payload = health() if health is not None else {"status": "ok"}
                code = 503 if payload.get("status") == "critical" else 200
                body = json.dumps(payload).encode()
                ctype = "application/json"
            elif path == "/statusz":
                payload = {"uptime_s": round(time.monotonic() - t0, 3)}
                if status is not None:
                    payload.update(status())
                if health is not None:
                    payload["health"] = health()
                body = json.dumps(payload).encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):    # scrapes must not spam stderr
            pass

    return Handler


def start_metrics_server(registry: MetricRegistry, port: int,
                         host: str = "0.0.0.0", *, health=None,
                         status=None) -> ThreadingHTTPServer:
    """Serve ``registry`` on ``host:port`` from a daemon thread. Returns the
    running server; call ``server.shutdown()`` to stop scraping. ``health``
    and ``status`` (optional zero-arg dict sources) enable /healthz and
    enrich /statusz — see the module docstring for the contract."""
    server = ThreadingHTTPServer((host, port),
                                 _make_handler(registry, health, status))
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="obs-metrics-exposition")
    thread.start()
    return server
