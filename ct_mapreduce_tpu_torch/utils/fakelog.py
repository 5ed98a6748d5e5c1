"""A CT log in memory, served through an injectable transport or over a
loopback HTTP socket.

:class:`FakeLog` answers ``get-sth``, ``get-entries`` and
``get-entry-and-proof`` exactly as the JAX package's test log
(``tests/fakelog.py``) does, byte for byte, on the port's RFC 6962 leaf
codec (:mod:`ct_mapreduce_tpu_torch.ingest.leaf`): the same JSON pages,
the same page cap (``max_batch``), the same injected 429 / 5xx answers.
``transport(url)`` plugs into ``CTLogClient(transport=...)``;
:class:`LogServer` serves the same answers from ``http.server`` on
``127.0.0.1`` so the client's real urllib transport is exercised:

    log = FakeLog()
    log.add_cert(leaf_der, issuer_der)
    with LogServer(log) as srv:
        client = CTLogClient(srv.url)   # http://127.0.0.1:<port>/fake
"""

from __future__ import annotations

import base64
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ct_mapreduce_tpu_torch.ingest import leaf as leaflib


class FakeLog:
    def __init__(self, url: str = "https://ct.example.com/fake"):
        self.url = url
        # {"leaf_input": b64, "extra_data": b64}; add entries through the
        # add_* methods, which also keep each entry's JSON text.
        self.entries: list[dict] = []
        self._entry_json: list[str] = []
        self.max_batch = 1000
        self.rate_limit_hits = 0  # serve this many 429s before succeeding
        self.server_error_hits = 0  # serve this many 5xx before succeeding
        self.server_error_status = 503
        self.retry_after: Optional[str] = None
        self.requests: list[str] = []

    def add_cert(self, cert_der: bytes, issuer_der: bytes,
                 timestamp_ms: int = 0) -> None:
        li = leaflib.encode_leaf_input(cert_der, timestamp_ms)
        ed = leaflib.encode_extra_data([issuer_der])
        self.add_raw(base64.b64encode(li).decode(),
                     base64.b64encode(ed).decode())

    def add_precert(self, precert_der: bytes, issuer_der: bytes,
                    timestamp_ms: int = 0) -> None:
        li = leaflib.encode_leaf_input(
            b"\x00" * 10,  # TBS stand-in; the store path uses extra_data
            timestamp_ms,
            entry_type=leaflib.PRECERT_ENTRY,
        )
        ed = leaflib.encode_extra_data(
            [issuer_der],
            entry_type=leaflib.PRECERT_ENTRY,
            pre_certificate=precert_der,
        )
        self.add_raw(base64.b64encode(li).decode(),
                     base64.b64encode(ed).decode())

    def add_raw(self, leaf_input: str, extra_data: str) -> None:
        """One entry as a log serves it: base64 ``leaf_input`` and
        ``extra_data``."""
        entry = {"leaf_input": leaf_input, "extra_data": extra_data}
        self.entries.append(entry)
        self._entry_json.append(json.dumps(entry))

    def add_garbage(self) -> None:
        self.add_raw(base64.b64encode(b"\xff\xff").decode(), "")

    # -- transport -------------------------------------------------------
    def transport(self, url: str) -> tuple[int, dict, bytes]:
        self.requests.append(url)
        if self.rate_limit_hits > 0:
            self.rate_limit_hits -= 1
            headers = {}
            if self.retry_after is not None:
                headers["Retry-After"] = self.retry_after
            return 429, headers, b"slow down"
        if self.server_error_hits > 0:
            self.server_error_hits -= 1
            headers = {}
            if self.retry_after is not None:
                headers["Retry-After"] = self.retry_after
            return self.server_error_status, headers, b"upstream sad"
        parsed = urlparse(url)
        if parsed.path.endswith("/ct/v1/get-sth"):
            return 200, {}, json.dumps(
                {"tree_size": len(self.entries), "timestamp": 1700000000000}
            ).encode()
        if parsed.path.endswith("/ct/v1/get-entries"):
            q = parse_qs(parsed.query)
            start = int(q["start"][0])
            end = min(int(q["end"][0]), start + self.max_batch - 1,
                      len(self.entries) - 1)
            if start >= len(self.entries):
                return 400, {}, b"range beyond tree size"
            # json.dumps({"entries": page}) from the entries' own JSON,
            # byte for byte: a page of a large log costs a join.
            page = ", ".join(self._entry_json[start : end + 1])
            return 200, {}, ('{"entries": [' + page + "]}").encode()
        if re.search(r"/ct/v1/get-entry-and-proof$", parsed.path):
            q = parse_qs(parsed.query)
            e = self.entries[int(q["leaf_index"][0])]
            return 200, {}, json.dumps(
                {"leaf_input": e["leaf_input"], "extra_data": e["extra_data"],
                 "audit_path": []}
            ).encode()
        return 404, {}, b"not found"


class LogServer:
    """``log``'s transport served by ``http.server`` on 127.0.0.1 (an
    ephemeral port unless ``port`` is given), one thread a request.
    ``url`` is the log's URL on the socket, with the path of
    ``log.url``. Use as a context manager, or ``start()``/``stop()``."""

    def __init__(self, log: FakeLog, port: int = 0):
        self.log = log
        self._lock = threading.Lock()  # the log's counters are not atomic
        owner = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802  (http.server API)
                with owner._lock:
                    status, headers, body = owner.log.transport(
                        "http://127.0.0.1" + self.path)
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # no per-request stderr lines
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}{urlparse(log.url).path}"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "LogServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="fakelog-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join()

    def __enter__(self) -> "LogServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
