"""Client for the query plane (``serve/server.py``) — the transport
behind the ``ct-query`` binary and ``ct-getcert``'s ``queryPort``
routing. Stdlib-only (urllib), no streaming: requests are small JSON
documents by design (the batching happens server-side).

Round 23 cross-process correlation: every request mints a
W3C-traceparent-style header (telemetry/trace.py) and wraps itself in
a ``query.client`` span carrying the same trace_id — the server side
extracts the header and tags its serve spans with it, so
``traceview --merge`` shows one request crossing both processes.

A copy of ``ct_mapreduce_tpu.serve.client`` on the port's
``telemetry``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Optional

from ct_mapreduce_tpu_torch.telemetry import trace


class QueryError(RuntimeError):
    """Non-2xx answer from the query plane (status + decoded body)."""

    def __init__(self, status: int, body: dict):
        self.status = status
        self.body = body
        super().__init__(f"query plane returned {status}: "
                         f"{body.get('error', body)}")


class QueryClient:
    """Thin HTTP client: ``addr`` is ``host:port``, ``:port`` (=
    localhost), or a full ``http://...`` base URL."""

    def __init__(self, addr: str, timeout_s: float = 10.0) -> None:
        if addr.startswith(("http://", "https://")):
            base = addr
        else:
            if addr.startswith(":"):
                addr = "127.0.0.1" + addr
            base = f"http://{addr}"
        self.base_url = base.rstrip("/")
        self.timeout_s = timeout_s

    def _request(self, path: str, payload: Optional[dict] = None) -> dict:
        url = self.base_url + path
        data = None
        header, trace_id, span_id = trace.mint_traceparent()
        headers = {trace.TRACEPARENT_HEADER: header}
        if payload is not None:
            data = json.dumps(payload).encode()
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(url, data=data, headers=headers)
        with trace.trace_context(trace_id, span_id), \
                trace.span("query.client", "serve", path=path):
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as resp:
                    return json.loads(resp.read().decode())
            except urllib.error.HTTPError as err:
                try:
                    body = json.loads(err.read().decode())
                except (ValueError, OSError):
                    body = {"error": str(err)}
                raise QueryError(err.code, body) from None

    def query(self, queries: list[dict],
              timeout_ms: Optional[int] = None) -> dict:
        """Bulk membership: ``queries`` is a list of
        ``{"issuer", "expDate", "serial"}`` dicts; returns the server's
        response (``results`` + ``epoch`` + ``staleness_s``)."""
        payload: dict = {"queries": queries}
        if timeout_ms is not None:
            payload["timeoutMs"] = timeout_ms
        return self._request("/query", payload)

    def query_one(self, issuer: str, exp_date: str, serial_hex: str,
                  timeout_ms: Optional[int] = None) -> dict:
        payload: dict = {"issuer": issuer, "expDate": exp_date,
                         "serial": serial_hex}
        if timeout_ms is not None:
            payload["timeoutMs"] = timeout_ms
        return self._request("/query", payload)

    def issuer(self, issuer_id: str) -> dict:
        from urllib.parse import quote

        return self._request(f"/issuer/{quote(issuer_id, safe='')}")

    def healthz(self) -> dict:
        return self._request("/healthz")

    def getcert(self, log_url: str, index: int) -> str:
        """PEM of one log entry via the serving-plane proxy."""
        from urllib.parse import urlencode

        qs = urlencode({"log": log_url, "index": int(index)})
        return self._request(f"/getcert?{qs}")["pem"]
