"""The /health HTTP endpoint.

Reference semantics (reference cmd/ct-fetch/ct-fetch.go:567-608):
503 before the first per-log update arrives; 500 when any log's last
update is older than 2 × pollingDelayMean ("stalled"); 200 otherwise,
with a JSON body of per-log ages.

A copy of ``ct_mapreduce_tpu.ingest.health``: the port imports nothing of the JAX package.
One difference: given the verify lane's ``verifier``, every body carries
its ``verify`` section (knobs, outcome totals, Q-table occupancy). The
JAX package's ct-fetch puts that section on the metrics server's
``/healthz`` body instead (``metricsPort``), which the port does not
serve yet (ROADMAP item 14); the section moves there with it.
"""

from __future__ import annotations

import json
import threading
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class HealthServer:
    def __init__(self, engine, polling_delay_mean_s: float, addr: str = ":8080",
                 verifier=None):
        self.engine = engine
        self.verifier = verifier
        self.stall_after_s = 2.0 * polling_delay_mean_s
        host, _, port = addr.rpartition(":")
        self.host = host or "0.0.0.0"
        self.port = int(port)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def status(self) -> tuple[int, dict]:
        code, body = self._status()
        if self.verifier is not None:
            body["verify"] = self.verifier.health()
        return code, body

    def _status(self) -> tuple[int, dict]:
        updates = self.engine.last_updates()
        if not updates:
            return 503, {"status": "no updates yet"}
        now = datetime.now(timezone.utc)
        ages = {
            url: (now - ts).total_seconds() for url, ts in updates.items()
        }
        stalled = {u: a for u, a in ages.items() if a > self.stall_after_s}
        if stalled:
            return 500, {"status": "stalled", "ages_s": ages, "stalled": list(stalled)}
        return 200, {"status": "ok", "ages_s": ages}

    def start(self) -> None:
        health = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802  (http.server API)
                if self.path.rstrip("/") not in ("", "/health"):
                    self.send_error(404)
                    return
                code, body = health.status()
                payload = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args):  # silence per-request stderr spam
                pass

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]  # resolve port 0
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="health", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
