"""Exposition transports for the metrics registry.

Two ways out of process, matching the two ways the repro runs:

- ``start_http_server(registry)`` — a daemon-thread HTTP server serving
  Prometheus text on ``/metrics`` for long-running services
  (``run_controld --serve --metrics-port N``). Stdlib only.
- ``TimeSeriesWriter`` — an append-only JSONL emitter for finite runs
  (``run_simnet.py --metrics-interval K``): one flat
  ``registry.sample()`` row per emission, stamped with whatever the
  caller knows (virtual time, window index, wall clock).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .registry import MetricsRegistry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_INDEX = b"""<html><head><title>repro telemetry</title></head>
<body><h1>repro telemetry</h1><p><a href="/metrics">/metrics</a></p></body></html>
"""


def start_http_server(registry: MetricsRegistry, host: str = "127.0.0.1", port: int = 0):
    """Serve ``registry.render()`` on ``/metrics`` in a daemon thread.

    Returns ``(server, bound_port)``; pass ``port=0`` to let the OS pick
    (tests and --metrics-port 0 rely on this). Call ``server.shutdown()``
    to stop, or just let the daemon thread die with the process.
    """

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - stdlib API name
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                body = registry.render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
            elif path == "/":
                body = _INDEX
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
            else:
                body = b"not found\n"
                self.send_response(404)
                self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass  # scrapes must not spam the service's stdout

    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, name="metrics-http", daemon=True)
    thread.start()
    return server, server.server_address[1]


class TimeSeriesWriter:
    """Append ``registry.sample()`` rows to a JSONL file.

    Each ``write(**stamp)`` emits one line ``{**stamp, "metrics": {...}}``
    and flushes, so a killed run keeps every window it completed.
    """

    def __init__(self, path: str, registry: MetricsRegistry):
        self.path = path
        self.registry = registry
        self._fh = open(path, "a", encoding="utf-8")

    def write(self, **stamp) -> None:
        row = dict(stamp)
        row["metrics"] = self.registry.sample()
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None
