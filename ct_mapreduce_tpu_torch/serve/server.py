"""The query plane's HTTP surface: a batched membership oracle as a
stdlib JSON API (``queryPort`` directive); a port of
``ct_mapreduce_tpu.serve.server`` for one device.

Endpoints:

- ``POST /query`` — one or many membership questions. Body is either a
  single query object or ``{"queries": [...]}``; each query is
  ``{"issuer": <issuerID>, "expDate": <expDate id>, "serial": <hex>}``
  (issuerID = base64url(SHA-256(SPKI)), expDate in the report formats
  ``2031-06-15`` / ``2031-06-15-14``, serial as hex content bytes).
  Optional ``"timeoutMs"`` is the request deadline. The response
  carries per-query ``known`` flags plus the answering view's
  ``epoch`` and ``staleness_s``. Overload is an explicit
  ``429 overloaded``; a missed deadline is ``504 deadline_exceeded``.
- ``GET /issuer/<issuerID>`` — per-issuer metadata (running unknown
  total, CRL/DN set sizes) from the same pinned view.
- ``GET /healthz`` — queue depth vs cap, snapshot age/epoch, shed
  total; 503 when the SLO hook reports a breach.
- ``GET /getcert?log=<url>&index=<n>`` — serving-plane proxy for the
  ``ct-getcert`` flow: the server fetches one entry and returns its
  PEM, so edge clients need no direct log access.

:class:`MembershipOracle` is independent of HTTP and composes the
three serving primitives, hottest first:
:class:`~ct_mapreduce_tpu_torch.serve.cache.HotSerialCache`,
:class:`~ct_mapreduce_tpu_torch.serve.batcher.MicroBatcher` and
:class:`~ct_mapreduce_tpu_torch.serve.snapshot.ReplicaPool` (device
copies of the table on the aggregator's device, host fallback).
``serveReplicas`` / ``serveDevice`` / ``serveCacheSize`` directives
(and their ``CTMR_SERVE_*`` env equivalents) tune the tier.

Not ported yet: the filter-first tier and the ``/filter*`` distribution
routes, which need the distribution plane (ROADMAP item 15; filter
emission itself is ported, :mod:`..filter`). ``filter_first`` (or
``CTMR_SERVE_FILTER_FIRST``) raises a ``ValueError`` naming it, and the
routes answer 501.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ct_mapreduce_tpu_torch.config import profile as platprofile
from ct_mapreduce_tpu_torch.core.types import ExpDate
from ct_mapreduce_tpu_torch.serve.batcher import (
    DeadlineExceeded,
    MicroBatcher,
    Overloaded,
)
from ct_mapreduce_tpu_torch.serve.cache import HotSerialCache
from ct_mapreduce_tpu_torch.serve.snapshot import ReplicaPool
from ct_mapreduce_tpu_torch.telemetry import trace
from ct_mapreduce_tpu_torch.telemetry.metrics import incr_counter

_log = logging.getLogger(__name__)

_FILTER_UNPORTED = ("the filter-first tier and the /filter routes are not "
                    "ported yet (ROADMAP.md queue 1 item 15)")


_SERVE_KNOBS = (
    platprofile.Knob("serveReplicas", "CTMR_SERVE_REPLICAS", 2,
                     parse=int, is_set=platprofile.pos_int,
                     post=lambda v: int(v)),
    platprofile.Knob("serveDevice", "CTMR_SERVE_DEVICE", True,
                     parse=platprofile.parse_bool_lenient,
                     env_is_set=platprofile.any_set, post=bool),
    platprofile.Knob("serveCacheSize", "CTMR_SERVE_CACHE_SIZE", 4096,
                     parse=int, is_set=platprofile.nonzero_int,
                     post=lambda v: max(0, int(v))),
)


def resolve_serve(replicas: int = 0, device: Optional[bool] = None,
                  cache_size: int = 0) -> tuple[int, bool, int]:
    """Resolve the serving-tier knobs through the shared
    platformProfile ladder (config/profile.py): explicit value (config
    directive / kwarg) > ``CTMR_SERVE_REPLICAS`` /
    ``CTMR_SERVE_DEVICE`` / ``CTMR_SERVE_CACHE_SIZE`` env > profile
    ``knobs.serve`` > defaults (2 replicas; device serving with
    automatic host fallback; 4096-entry hot-serial cache).
    ``cache_size < 0`` disables the cache; unparseable env values are
    ignored, matching the config layer's tolerance."""
    r = platprofile.resolve_section("serve", _SERVE_KNOBS, {
        "serveReplicas": int(replicas or 0),
        "serveDevice": device,
        "serveCacheSize": int(cache_size or 0),
    })
    return (r["serveReplicas"], r["serveDevice"], r["serveCacheSize"])


def resolve_filter_first(flag=None) -> bool:
    """Serve-plane filter-first tier: explicit value > the
    ``CTMR_SERVE_FILTER_FIRST`` env > off."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("CTMR_SERVE_FILTER_FIRST", "").strip().lower() \
        in ("1", "t", "true")


class MembershipOracle:
    """Batched "is serial S known for (issuer, expDate)?" over a live
    aggregator: a hot-serial result cache in front of dynamic batching
    in front of a round-robin pool of epoch-pinned device replicas
    (host-NumPy fallback when a CPU view cannot pin, or the card is out
    of memory at pin time). The JAX module's
    filter-first tier (``filter_first``) is not ported: asking for it
    raises a ``ValueError`` naming ROADMAP item 15."""

    def __init__(
        self,
        agg,
        max_batch: int = 4096,
        max_delay_s: float = 0.002,
        max_queue_lanes: int = 1 << 16,
        max_staleness_s: float = 1.0,
        device: Optional[bool] = None,
        replicas: int = 0,
        cache_size: int = 0,
        filter_first: Optional[bool] = None,
    ) -> None:
        if resolve_filter_first(filter_first):
            raise ValueError(_FILTER_UNPORTED)
        self._agg = agg
        replicas, device, cache_size = resolve_serve(
            replicas, device, cache_size)
        self.snapshots = ReplicaPool(
            agg, n_replicas=replicas, max_staleness_s=max_staleness_s,
            device=device)
        self.cache = (HotSerialCache(cache_size)
                      if cache_size > 0 else None)
        self.batcher = MicroBatcher(
            self._run_batch, max_batch=max_batch, max_delay_s=max_delay_s,
            max_queue_lanes=max_queue_lanes)

    def _run_batch(self, items: list) -> list:
        view = self.snapshots.view()
        with trace.span(
                "serve.lookup", cat="serve", lanes=len(items),
                epoch=view.epoch, device=int(view._device),
                replica=(-1 if view.replica_ix is None
                         else int(view.replica_ix))):
            known = view.lookup(items)
        age = view.age_s()
        return [(bool(k), view.epoch, age) for k in known]

    def query_raw(self, items: list,
                  timeout_s: Optional[float] = None) -> list:
        """items: [(issuer_idx, exp_hour, serial_bytes)] →
        [(known, epoch, staleness_s)]. Cache hits answer immediately
        (valid while their epoch >= the pool's floor, as if the
        round-robin had picked the stalest replica); the rest batch
        through the oracle, each sub-batch answered by ONE pinned
        view."""
        n = len(items)
        out: list = [None] * n
        if self.cache is None:
            miss = list(range(n))
        else:
            floor = self.snapshots.floor_epoch()
            now = time.time()
            miss = []
            for i, it in enumerate(items):
                e = self.cache.get(it, floor)
                if e is None:
                    miss.append(i)
                else:
                    out[i] = (e.known, e.epoch,
                              max(0.0, now - e.created_wall))
            if n - len(miss):
                incr_counter("serve", "cache_hit",
                             value=float(n - len(miss)))
            if not miss:
                return out
            incr_counter("serve", "cache_miss", value=float(len(miss)))
        res = self.batcher.submit([items[i] for i in miss],
                                  timeout_s=timeout_s)
        done = time.time()
        for i, r in zip(miss, res):
            out[i] = r
            if self.cache is not None:
                self.cache.put(items[i], known=r[0], epoch=r[1],
                               created_wall=done - r[2])
        return out

    def resolve_issuer(self, issuer_id: str) -> int:
        idx = self._agg.registry.index_of_issuer_id(issuer_id)
        return -1 if idx is None else idx

    def issuer_meta(self, issuer_id: str) -> Optional[dict]:
        view = self.snapshots.view()
        meta = view.issuer_meta(issuer_id)
        if meta is not None:
            meta["epoch"] = view.epoch
            meta["staleness_s"] = round(view.age_s(), 6)
        return meta

    def stats(self) -> dict:
        body = {
            "queue_lanes": self.batcher.queue_lanes(),
            "queue_cap": self.batcher.max_queue_lanes,
            "max_batch": self.batcher.max_batch,
            "max_delay_s": self.batcher.max_delay_s,
        }
        body.update(self.snapshots.stats())
        if self.cache is not None:
            body.update(self.cache.stats())
        body["filter_first"] = False
        return body

    def close(self) -> None:
        self.batcher.close()


def _parse_query(q: dict, oracle: MembershipOracle):
    """One JSON query object → (issuer_idx, exp_hour, serial_bytes).

    Unknown issuers map to idx -1: the lookup treats them as
    device-ineligible and the host-set probe can't match either, so
    the answer is an honest ``known: false`` (the table has, by
    definition, never counted a serial for an issuer the registry has
    never seen)."""
    issuer = q.get("issuer")
    exp = q.get("expDate")
    serial_hex = q.get("serial")
    if not isinstance(issuer, str) or not isinstance(exp, str) \
            or not isinstance(serial_hex, str):
        raise ValueError("query needs string issuer, expDate, serial")
    try:
        serial = bytes.fromhex(serial_hex)
    except ValueError as err:
        raise ValueError(f"serial is not hex: {err}") from None
    try:
        eh = ExpDate.parse(exp).unix_hour()
    except ValueError as err:
        raise ValueError(f"bad expDate {exp!r}: {err}") from None
    return (oracle.resolve_issuer(issuer), eh, serial)


class QueryServer:
    """Background HTTP server for the query plane (``queryPort``).

    ``ThreadingHTTPServer`` on a daemon thread; port 0 binds an
    ephemeral port (tests), ``stop()`` shuts down cleanly. ``transport``
    overrides the CT-log HTTP transport for the ``/getcert`` proxy
    (tests route it at an in-process fake log)."""

    def __init__(self, agg, port: int, host: str = "0.0.0.0",
                 max_batch: int = 4096, max_delay_s: float = 0.002,
                 max_queue_lanes: int = 1 << 16,
                 max_staleness_s: float = 1.0,
                 device: Optional[bool] = None, replicas: int = 0,
                 cache_size: int = 0, transport=None,
                 filter_first: Optional[bool] = None) -> None:
        self.host = host
        self.port = int(port)
        self.oracle = MembershipOracle(
            agg, max_batch=max_batch, max_delay_s=max_delay_s,
            max_queue_lanes=max_queue_lanes,
            max_staleness_s=max_staleness_s, device=device,
            replicas=replicas, cache_size=cache_size,
            filter_first=filter_first)
        self._transport = transport
        # Optional SLO probe: a callable returning the
        # current breach-reason list; non-empty flips /healthz to 503.
        self.slo_check = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- request handling ------------------------------------------------
    def handle_query(self, body: dict) -> tuple[int, dict]:
        queries = body.get("queries")
        single = queries is None
        if single:
            queries = [body]
        if not isinstance(queries, list) or not queries:
            return 400, {"error": "queries must be a non-empty list"}
        try:
            items = [_parse_query(q, self.oracle) for q in queries]
        except (ValueError, AttributeError, TypeError) as err:
            return 400, {"error": str(err)}
        timeout_ms = body.get("timeoutMs")
        timeout_s = float(timeout_ms) / 1e3 if timeout_ms else None
        try:
            results = self.oracle.query_raw(items, timeout_s=timeout_s)
        except Overloaded as err:
            return 429, {"error": "overloaded", "detail": str(err)}
        except DeadlineExceeded as err:
            return 504, {"error": "deadline_exceeded", "detail": str(err)}
        # A result row comes from one pinned view, but rows can span
        # views (cache hits at older epochs; oversized bulks split into
        # sub-batches) — report the OLDEST epoch consulted and the
        # LARGEST staleness, so the surfaced bound errs conservative.
        epoch = min(r[1] for r in results)
        staleness = max(r[2] for r in results)
        out = {
            "results": [{"known": known} for known, _, _ in results],
            "epoch": epoch,
            "staleness_s": round(staleness, 6),
        }
        if single:
            out["known"] = out["results"][0]["known"]
        return 200, out

    def handle_issuer(self, issuer_id: str) -> tuple[int, dict]:
        meta = self.oracle.issuer_meta(issuer_id)
        if meta is None:
            return 404, {"error": "unknown issuer", "issuer": issuer_id}
        return 200, meta

    def handle_filter(self, rest: str, req_headers=None):
        """The filter distribution routes (``/filter``,
        ``/filter/manifest``, ``/filter/container/<kind>``,
        ``/filter/delta/<from>/<to>``, ``/filter/<issuer>/<expDate>``)
        answer 501 until the distribution plane (item 15) is ported."""
        return 501, {"error": _FILTER_UNPORTED}

    def handle_healthz(self) -> tuple[int, dict]:
        from ct_mapreduce_tpu_torch.telemetry.metrics import get_sink

        counters = get_sink().snapshot().get("counters", {})
        # SLO hook: ct-fetch attaches its rule evaluation;
        # any breach renders the same JSON body under HTTP 503 so load
        # balancers act on the code while operators read the reasons.
        degraded: list = []
        if self.slo_check is not None:
            try:
                degraded = list(self.slo_check())
            except Exception as err:  # the probe must answer, not 500
                degraded = [f"slo check failed: "
                            f"{type(err).__name__}: {err}"]
        body = {
            "healthy": not degraded,
            **self.oracle.stats(),
            "shed_total": counters.get("serve.shed", 0.0),
            "batches_total": counters.get("serve.batches", 0.0),
            "cache_hit_total": counters.get("serve.cache_hit", 0.0),
            "cache_miss_total": counters.get("serve.cache_miss", 0.0),
            "device_fallback_total": counters.get(
                "serve.device_fallback", 0.0),
        }
        if degraded:
            body["degraded"] = degraded
        return (503 if degraded else 200), body

    def handle_getcert(self, params: dict) -> tuple[int, dict]:
        log_url = params.get("log")
        index = params.get("index")
        if not log_url or index is None:
            return 400, {"error": "log and index are required"}
        try:
            index = int(index)
        except ValueError:
            return 400, {"error": f"index is not an integer: {index!r}"}
        from ct_mapreduce_tpu_torch.core.der import der_to_pem
        from ct_mapreduce_tpu_torch.ingest.ctclient import CTLogClient
        from ct_mapreduce_tpu_torch.ingest.leaf import (
            LeafDecodeError,
            decode_json_entry,
        )

        try:
            client = CTLogClient(log_url, transport=self._transport)
            entries = client.get_raw_entries(index, index)
        except Exception as err:
            return 502, {"error": f"log fetch failed: {err}"}
        pems = []
        for raw in entries:
            try:
                entry = decode_json_entry(
                    raw.index,
                    {"leaf_input": raw.leaf_input,
                     "extra_data": raw.extra_data},
                )
            except LeafDecodeError as err:
                return 502, {"error": f"undecodable entry: {err}"}
            pem = der_to_pem(entry.cert_der)
            pems.append(pem.decode() if isinstance(pem, bytes) else pem)
        if not pems:
            return 404, {"error": f"no entry at index {index}"}
        return 200, {"log": log_url, "index": index, "pem": "".join(pems)}

    # -- server lifecycle ------------------------------------------------
    def start(self) -> "QueryServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _trace_ctx(self):
                """Cross-process correlation: adopt the
                client's traceparent header so every span this request
                produces on this thread carries its trace_id."""
                ids = trace.parse_traceparent(
                    self.headers.get(trace.TRACEPARENT_HEADER, "") or "")
                if ids is None:
                    return trace.trace_context(None)
                return trace.trace_context(*ids)

            def _respond(self, code: int, body, headers=None) -> None:
                if isinstance(body, (bytes, bytearray)):
                    payload, ctype = bytes(body), "application/octet-stream"
                else:
                    payload, ctype = json.dumps(body).encode(), \
                        "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                for name, value in sorted((headers or {}).items()):
                    self.send_header(name, value)
                self.end_headers()
                # Stream in 1 MB slices, so a large body is never
                # buffered twice and a slow client never pins one
                # giant write.
                view = memoryview(payload)
                for off in range(0, len(view), 1 << 20):
                    self.wfile.write(view[off: off + (1 << 20)])
                if code >= 400:
                    incr_counter("serve", "http_errors")

            def do_POST(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path != "/query":
                    self._respond(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except (ValueError, json.JSONDecodeError) as err:
                    self._respond(400, {"error": f"bad request: {err}"})
                    return
                try:
                    with self._trace_ctx():
                        self._respond(*server.handle_query(body))
                except Exception as err:  # the server must answer
                    _log.error("query batch failed: %s: %s",
                               type(err).__name__, err)
                    self._respond(
                        500, {"error": f"{type(err).__name__}: {err}"})

            def do_GET(self):  # noqa: N802
                raw_path, _, qs = self.path.partition("?")
                path = raw_path.rstrip("/") or "/"
                with self._trace_ctx():
                    self._dispatch_get(path, qs)

            def _dispatch_get(self, path: str, qs: str) -> None:
                try:
                    if path == "/healthz":
                        self._respond(*server.handle_healthz())
                    elif path.startswith("/issuer/"):
                        from urllib.parse import unquote

                        self._respond(*server.handle_issuer(
                            unquote(path[len("/issuer/"):])))
                    elif path == "/filter" or path.startswith("/filter/"):
                        from urllib.parse import unquote

                        self._respond(*server.handle_filter(
                            unquote(path[len("/filter"):]).lstrip("/"),
                            req_headers=self.headers))
                    elif path == "/getcert":
                        from urllib.parse import parse_qsl

                        self._respond(
                            *server.handle_getcert(dict(parse_qsl(qs))))
                    else:
                        self._respond(404, {"error": "not found"})
                except Exception as err:
                    self._respond(
                        500, {"error": f"{type(err).__name__}: {err}"})

            def log_message(self, *args):  # no per-request stderr spam
                pass

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]  # resolve port 0
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="query-serve",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        self.oracle.close()
