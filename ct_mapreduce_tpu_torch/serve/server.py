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
- ``GET /filter``, ``/filter/manifest``, ``/filter/container/<kind>``,
  ``/filter/delta/<from>/<to>`` and ``/filter/<issuer>/<expDate>`` —
  the filter distribution routes (:meth:`QueryServer.handle_filter`),
  served from the :class:`..distrib.FilterDistributor` the filter-first
  tier publishes into.

:class:`MembershipOracle` is independent of HTTP and composes the
three serving primitives, hottest first:
:class:`~ct_mapreduce_tpu_torch.serve.cache.HotSerialCache`,
:class:`~ct_mapreduce_tpu_torch.serve.batcher.MicroBatcher` and
:class:`~ct_mapreduce_tpu_torch.serve.snapshot.ReplicaPool` (device
copies of the table on the aggregator's device, host fallback).
``serveReplicas`` / ``serveDevice`` / ``serveCacheSize`` directives
(and their ``CTMR_SERVE_*`` env equivalents) tune the tier. With
``filter_first`` (or ``CTMR_SERVE_FILTER_FIRST``) a :class:`FilterTier`
sits between the cache and the batcher: a filter cascade built from the
aggregator's capture on its device (K1 and K5 on the card) answers
negatives without a table view and forwards positives.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

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


class FilterTier:
    """An epoch-tagged filter-cascade snapshot in front of the table
    tier: compiled from the aggregator's filter capture, it answers
    NEGATIVE lookups without touching a table view (exact for every
    serial the build-time state knew) and forwards positives to the
    table-confirm tier, which kills the cascade's false positives.
    Serials first seen AFTER the build answer through the same
    epoch/staleness surface the replica pool reports: the tier's epoch
    is the pool's floor epoch at build time."""

    def __init__(self, artifact, issuer_ids: list[str], epoch: int,
                 device=None):
        self.artifact = artifact
        # Registry snapshot: run-local issuer index → issuerID, as of
        # the build. Queries for indices past this snapshot (issuers
        # first seen after the build) must FORWARD to the table, not
        # answer negative from a filter that predates them.
        self.issuer_ids = issuer_ids
        self.epoch = int(epoch)
        self.device = device
        self.created_wall = time.time()

    @classmethod
    def build(cls, agg, fp_rate: float, epoch: int,
              cache=None) -> "FilterTier":
        """Compile the tier on the aggregator's device (K1 and K5 on the
        card). ``cache`` (a :class:`..filter.GroupBuildCache`) arms the
        CTMRFL02 dirty-group path: across refresh ticks only churned
        groups rebuild (the oracle owns one cache for its lifetime)."""
        from ct_mapreduce_tpu_torch.filter import build_from_aggregator

        art = build_from_aggregator(agg, fp_rate=fp_rate, cache=cache)
        ids = [agg.registry.issuer_at(i).id()
               for i in range(len(agg.registry))]
        return cls(art, ids, epoch, device=getattr(agg, "device", None))

    def age_s(self) -> float:
        return max(0.0, time.time() - self.created_wall)

    def negatives(self, items: list) -> np.ndarray:
        """bool[n]: lanes the cascade answers *excluded* — definitely
        unknown as of the build. False means forward to the table
        (cascade-positive, or outside the build's registry snapshot)."""
        n = len(items)
        out = np.zeros((n,), bool)
        by_group: dict = {}
        for i, (idx, eh, _sb) in enumerate(items):
            if 0 <= int(idx) < len(self.issuer_ids):
                key = (self.issuer_ids[int(idx)], int(eh))
                by_group.setdefault(key, []).append(i)
            # idx == -1 (registry never saw the issuer): the TABLE is
            # the authority on honest-false; forward.
        with trace.span("serve.filter", cat="serve", lanes=n):
            for (iss, eh), lanes in by_group.items():
                g = self.artifact.group_for(iss, eh)
                if g is None:
                    # No serials for this (issuer, expDate) at build
                    # time: exact-negative for the build corpus.
                    out[lanes] = True
                    continue
                hit = self.artifact.query_group(
                    g, [items[i][2] for i in lanes], device=self.device)
                out[np.asarray(lanes)[~hit]] = True
        return out


class MembershipOracle:
    """Batched "is serial S known for (issuer, expDate)?" over a live
    aggregator: a hot-serial result cache in front of dynamic batching
    in front of a round-robin pool of epoch-pinned device replicas
    (host-NumPy fallback when a CPU view cannot pin, or the card is out
    of memory at pin time). With ``filter_first``, a filter-cascade
    tier sits between the cache and the batcher: cascade-negative lanes
    answer without a table view, cascade-positive lanes fall through for
    table confirmation."""

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
        filter_fp_rate: float = 0.0,
        distrib_history: int = 0,
        max_delta_chain: int = 0,
    ) -> None:
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
        # Filter-first tier: built on the first refresh (construction
        # must not fail when the aggregator has no capture yet — the
        # tier stays cold and every lane takes the table path).
        from ct_mapreduce_tpu_torch.filter import (
            DEFAULT_FP_RATE,
            GroupBuildCache,
        )

        self.filter_first = resolve_filter_first(filter_first)
        self.filter_fp_rate = float(filter_fp_rate) or DEFAULT_FP_RATE
        self.filter_tier: Optional[FilterTier] = None
        # Epoch-persistent build cache (CTMRFL02): refresh ticks reuse
        # clean groups' cascades verbatim, so the steady-state refresh
        # costs O(churn). Harmless for fl01 (an fl01 build ignores it).
        self.filter_build_cache = GroupBuildCache()
        # Distribution store: published epochs, delta links,
        # containers, pre-compressed variants — what the /filter*
        # routes serve. Armed alongside the filter tier.
        self.distributor = None
        if self.filter_first:
            from ct_mapreduce_tpu_torch.distrib import (
                FilterDistributor,
                resolve_distrib,
            )

            history, max_chain = resolve_distrib(
                distrib_history, max_delta_chain)
            self.distributor = FilterDistributor(
                history=history, max_chain=max_chain)
        if self.filter_first and getattr(
                agg, "filter_capture", None) is not None:
            try:
                self.refresh_filter()
            except Exception as err:
                # Serve must come up; refresh_filter can retry. The
                # tier stays cold (stats() says so) and every lane
                # takes the table path.
                _log.warning("filter tier not armed: %s: %s",
                             type(err).__name__, err)

    def refresh_filter(self, fp_rate: float = 0.0) -> FilterTier:
        """(Re)build the filter tier from the live aggregator's
        capture, tagged with the replica pool's current floor epoch.
        The rebuilt artifact also publishes into the distribution
        store (source ``local`` — a fleet-fed merged artifact outranks
        it). Raises ``ValueError`` when the aggregator has no
        capture.

        Unlike the JAX package's, a refresh never reuses the epoch it
        published last: when no query has moved the replica pool past
        that epoch since (a quiet plane), the pool captures fresh views
        first, so the rebuilt artifact publishes under a new epoch
        instead of being dropped as stale by the store."""
        if self.distributor is not None:
            latest = self.distributor.latest()
            if latest is not None \
                    and latest.epoch >= self.snapshots.floor_epoch():
                for _ in range(self.snapshots.n_replicas):
                    self.snapshots.refresh()
        tier = FilterTier.build(
            self._agg, float(fp_rate) or self.filter_fp_rate,
            self.snapshots.floor_epoch(),
            cache=self.filter_build_cache)
        self.filter_tier = tier
        if self.distributor is not None:
            self.distributor.publish(
                tier.epoch, tier.artifact.to_bytes(), source="local")
        incr_counter("serve", "filter_refresh")
        return tier

    def publish_artifact(self, epoch: int, blob: bytes,
                         source: str = "fleet") -> bool:
        """Publish externally built artifact bytes (a fleet's merged
        filter) into this worker's distribution store. Byte-identical
        input on every worker ⇒ identical ETags/deltas/containers."""
        if self.distributor is None:
            return False
        return self.distributor.publish(epoch, blob, source=source)

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
        round-robin had picked the stalest replica); cache misses
        consult the filter tier when armed (cascade-negative lanes
        answer at the tier's epoch, no table view touched); the rest
        batch through the oracle, each sub-batch answered by ONE pinned
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
        tier = self.filter_tier if self.filter_first else None
        if tier is not None and miss:
            neg = tier.negatives([items[i] for i in miss])
            age = tier.age_s()
            fwd = []
            for j, i in enumerate(miss):
                if neg[j]:
                    out[i] = (False, tier.epoch, age)
                else:
                    fwd.append(i)
            if len(miss) - len(fwd):
                incr_counter("serve", "filter_negative",
                             value=float(len(miss) - len(fwd)))
            if fwd:
                incr_counter("serve", "filter_forward",
                             value=float(len(fwd)))
            miss = fwd
        if not miss:
            return out
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
        body["filter_first"] = bool(self.filter_first)
        if self.filter_tier is not None:
            body["filter_epoch"] = self.filter_tier.epoch
            body["filter_staleness_s"] = round(self.filter_tier.age_s(), 6)
            body["filter_serials"] = self.filter_tier.artifact.n_serials
            body["filter_format"] = self.filter_tier.artifact.fmt
            body["filter_groups_reused"] = self.filter_build_cache.hits
        if self.distributor is not None:
            body.update(self.distributor.stats())
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
                 filter_first: Optional[bool] = None,
                 filter_fp_rate: float = 0.0,
                 distrib_history: int = 0,
                 max_delta_chain: int = 0) -> None:
        self.host = host
        self.port = int(port)
        self.oracle = MembershipOracle(
            agg, max_batch=max_batch, max_delay_s=max_delay_s,
            max_queue_lanes=max_queue_lanes,
            max_staleness_s=max_staleness_s, device=device,
            replicas=replicas, cache_size=cache_size,
            filter_first=filter_first, filter_fp_rate=filter_fp_rate,
            distrib_history=distrib_history,
            max_delta_chain=max_delta_chain)
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

    # Cache policies per distribution resource: "latest"-shaped
    # resources move every epoch, epoch-pinned resources never change.
    _CC_LATEST = "public, max-age=60, must-revalidate"
    _CC_IMMUTABLE = "public, max-age=31536000, immutable"

    def _blob_response(self, blob: bytes, etag: str, req_headers,
                       cache_control: str, cache_key=None,
                       created_wall: Optional[float] = None,
                       epoch: Optional[int] = None):
        """One distribution payload: strong-ETag conditional GET
        (If-None-Match ⇒ 304 with zero body bytes), Accept-Encoding
        negotiation against the pre-compressed cache, and per-artifact
        cache headers."""
        from email.utils import formatdate

        headers = {"ETag": etag, "Cache-Control": cache_control,
                   "Vary": "Accept-Encoding"}
        if created_wall is not None:
            headers["Last-Modified"] = formatdate(created_wall,
                                                  usegmt=True)
        if epoch is not None:
            headers["X-Filter-Epoch"] = str(epoch)
        inm = (req_headers.get("If-None-Match", "")
               if req_headers else "")
        if inm and (inm.strip() == "*"
                    or etag in [t.strip() for t in inm.split(",")]):
            incr_counter("distrib", "http_304")
            return 304, b"", headers
        distributor = self.oracle.distributor
        if req_headers is not None and distributor is not None:
            from ct_mapreduce_tpu_torch.distrib import negotiate_encoding

            enc = negotiate_encoding(
                req_headers.get("Accept-Encoding", ""))
            if enc:
                payload = distributor.encoded(cache_key, blob, enc)
                headers["Content-Encoding"] = enc
                incr_counter("distrib", "bytes_sent",
                             value=float(len(payload)))
                return 200, payload, headers
        incr_counter("distrib", "bytes_sent", value=float(len(blob)))
        return 200, blob, headers

    def handle_filter(self, rest: str, req_headers=None):
        """The distribution surface:

        - ``GET /filter`` — the latest full artifact;
        - ``GET /filter/manifest`` — the chain manifest JSON (latest
          epoch + hash, delta links with per-link SHA-256, anchors);
        - ``GET /filter/container/<kind>`` — the latest artifact in an
          upstream container encoding (``mlbf`` | ``clubcard``);
        - ``GET /filter/delta/<from>/<to>`` — the concatenated delta
          links replaying epoch *from* to *to* (404 ⇒ no contiguous
          chain: full-pull);
        - ``GET /filter/<issuer>/<expDate>`` — a standalone
          single-group artifact slice.

        Every binary answer carries a strong ETag (SHA-256 of the
        deterministic bytes), honors ``If-None-Match`` with 304,
        negotiates gzip/zstd via ``Accept-Encoding``, and sets
        per-artifact ``Cache-Control``/``Last-Modified``. 404 when the
        tier is cold or the resource is unknown."""
        from ct_mapreduce_tpu_torch.distrib import publish as _pub

        tier = self.oracle.filter_tier
        distributor = self.oracle.distributor
        latest = distributor.latest() if distributor is not None else None
        if tier is None and latest is None:
            return 404, {"error": "filter tier not armed "
                                  "(emitFilter / refresh_filter)"}
        parts = [p for p in rest.split("/") if p] if rest else []
        if not parts:
            incr_counter("distrib", "http_full")
            if latest is not None:
                return self._blob_response(
                    latest.blob, latest.etag, req_headers,
                    self._CC_LATEST, cache_key=("full", latest.epoch),
                    created_wall=latest.created_wall,
                    epoch=latest.epoch)
            blob = tier.artifact.to_bytes()
            return self._blob_response(blob, _pub.etag_of(blob),
                                       req_headers, self._CC_LATEST,
                                       epoch=tier.epoch)
        if parts[0] == "manifest":
            if distributor is None:
                return 404, {"error": "distribution store not armed"}
            incr_counter("distrib", "http_manifest")
            return 200, distributor.manifest()
        if parts[0] == "container":
            if latest is None:
                return 404, {"error": "no published artifact"}
            if len(parts) != 2 or parts[1] not in latest.containers:
                return 404, {"error": "unknown container kind",
                             "kinds": sorted(latest.containers)}
            incr_counter("distrib", "http_container")
            return self._blob_response(
                latest.containers[parts[1]],
                latest.container_etags[parts[1]], req_headers,
                self._CC_LATEST,
                cache_key=("container", latest.epoch, parts[1]),
                created_wall=latest.created_wall, epoch=latest.epoch)
        if parts[0] == "delta":
            if distributor is None:
                return 404, {"error": "distribution store not armed"}
            if len(parts) != 3:
                return 400, {"error": "use /filter/delta/<from>/<to>"}
            try:
                from_e, to_e = int(parts[1]), int(parts[2])
            except ValueError:
                return 400, {"error": "delta epochs must be integers"}
            bundle = distributor.delta_bundle(from_e, to_e)
            if bundle is None:
                return 404, {"error": "no delta chain",
                             "fromEpoch": from_e, "toEpoch": to_e,
                             "hint": "full-pull /filter"}
            incr_counter("distrib", "http_delta")
            return self._blob_response(
                bundle, _pub.etag_of(bundle), req_headers,
                self._CC_IMMUTABLE, cache_key=("delta", from_e, to_e),
                epoch=to_e)
        if len(parts) != 2:
            return 400, {"error": "use /filter/<issuer>/<expDate>"}
        if tier is not None:
            art = tier.artifact
        else:
            from ct_mapreduce_tpu_torch.filter import FilterArtifact

            art = FilterArtifact.from_bytes(latest.blob)
        blob = art.group_bytes(parts[0], parts[1])
        if blob is None:
            return 404, {"error": "no filter group",
                         "issuer": parts[0], "expDate": parts[1]}
        return self._blob_response(blob, _pub.etag_of(blob),
                                   req_headers, self._CC_LATEST)

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
