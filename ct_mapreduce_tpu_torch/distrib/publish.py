"""The filter-distribution store behind the serve plane's CDN tier (a
port of ``ct_mapreduce_tpu.distrib.publish``):
published epochs, their container encodings, the delta chain, and
pre-compressed wire variants — everything ``GET /filter*`` serves.

One :class:`FilterDistributor` per worker holds a bounded history of
published full artifacts. Each ``publish(epoch, blob)``:

- computes the ``CTMRDL01`` delta link from the previous epoch
  (:mod:`ct_mapreduce_tpu_torch.distrib.delta`) unless the chain since the
  last anchor already has ``max_chain`` links — then the new epoch is
  an **anchor** (clients older than it must full-pull; bounded replay
  work per client by construction);
- encodes the upstream containers
  (:mod:`ct_mapreduce_tpu_torch.distrib.container`);
- records strong ETags (the SHA-256 of the exact bytes — free, the
  artifacts are deterministic) and the publish wall time for
  ``Last-Modified``.

Because artifact bytes are byte-identical on every worker of a fleet
(docs/FILTER_FORMAT.md's determinism contract), feeding each worker's
distributor the leader's merged artifact yields identical ETags,
identical deltas, and identical container bytes fleet-wide: any
replica is authoritative, and a CDN in front can collapse them.

Compression variants (gzip from the stdlib; zstd when the optional
``zstandard`` module is importable — never a hard dependency) are
built once per (artifact, encoding) and cached; ``gzip`` bytes are
deterministic too (``mtime=0``).

Publishes are ranked by source: ``"fleet"`` (the leader's merged
artifact, fanned out on epoch ticks) outranks ``"local"`` (a worker's
own build), so a follower that both emits locally and receives the
merged artifact serves the fleet bytes.
"""

from __future__ import annotations

import gzip
import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ct_mapreduce_tpu_torch.distrib import container as containers
from ct_mapreduce_tpu_torch.distrib import delta as deltas
from ct_mapreduce_tpu_torch.telemetry.metrics import (
    add_sample,
    incr_counter,
    set_gauge,
)

try:  # optional: the container image may not ship zstandard
    import zstandard as _zstd
except ImportError:  # pragma: no cover - environment-dependent
    _zstd = None

DEFAULT_HISTORY = 8

_SOURCE_RANK = {"local": 0, "fleet": 1}


def zstd_available() -> bool:
    return _zstd is not None


def compress(blob: bytes, encoding: str) -> bytes:
    if encoding == "gzip":
        # mtime=0 keeps the compressed bytes deterministic, so even the
        # encoded variants are byte-identical (and cacheable) fleet-wide.
        return gzip.compress(blob, compresslevel=6, mtime=0)
    if encoding == "zstd":
        if _zstd is None:
            raise ValueError("zstandard module not available")
        return _zstd.ZstdCompressor(level=10).compress(blob)
    raise ValueError(f"unknown encoding {encoding!r}")


def available_encodings() -> tuple[str, ...]:
    return ("zstd", "gzip") if zstd_available() else ("gzip",)


def etag_of(blob: bytes) -> str:
    """Strong ETag: quoted SHA-256 of the exact payload bytes."""
    return '"' + hashlib.sha256(blob).hexdigest() + '"'


@dataclass
class PublishedEpoch:
    epoch: int
    blob: bytes
    sha256: str
    etag: str
    created_wall: float
    containers: dict = field(default_factory=dict)  # kind -> bytes
    container_etags: dict = field(default_factory=dict)


class FilterDistributor:
    """Bounded epoch store + delta chain + compression cache. All
    methods are thread-safe (HTTP handler threads read while the
    checkpoint path publishes)."""

    def __init__(self, history: int = DEFAULT_HISTORY,
                 max_chain: int = deltas.DEFAULT_MAX_CHAIN,
                 container_kinds=containers.CONTAINER_KINDS):
        self.history = max(2, int(history))
        self.max_chain = max(1, int(max_chain))
        self.container_kinds = tuple(container_kinds)
        self._lock = threading.Lock()
        self._epochs: dict[int, PublishedEpoch] = {}
        self._links: dict[int, tuple[deltas.ChainLink, bytes]] = {}
        # from_epoch -> (link, blob)
        self._anchors: list[int] = []
        self._encoded: dict[tuple, bytes] = {}
        self._source_rank = -1

    # -- publishing ------------------------------------------------------
    def publish(self, epoch: int, blob: bytes,
                source: str = "local") -> bool:
        """Publish one epoch's full artifact bytes. Returns False for
        stale epochs (<= latest) or a source outranked by what already
        feeds this distributor."""
        epoch = int(epoch)
        rank = _SOURCE_RANK.get(source, 0)
        with self._lock:
            if rank < self._source_rank:
                incr_counter("distrib", "publish_ignored")
                return False
            if rank > self._source_rank and self._epochs:
                # Source upgrade (a fleet leader's merged artifact
                # taking over from this worker's own builds): the two
                # sources number epochs independently, so the store
                # restarts clean in the new epoch space.
                self._epochs.clear()
                self._links.clear()
                self._anchors = []
                self._encoded.clear()
            latest = max(self._epochs) if self._epochs else None
            if latest is not None and epoch <= latest:
                incr_counter("distrib", "publish_ignored")
                return False
            if latest is not None and self._epochs[latest].sha256 \
                    == hashlib.sha256(blob).hexdigest():
                # Content-unchanged republish (the fleet tick fans the
                # same merged artifact out every epoch): a no-op, so
                # store epochs advance only when bytes change — warm
                # clients keep revalidating 304 against the same ETag
                # and the delta chain never accumulates empty links
                # (which would burn maxDeltaChain and force pointless
                # full-snapshot anchors).
                incr_counter("distrib", "publish_ignored")
                return False
            self._source_rank = rank
            art = None
            cont, cont_etags = {}, {}
            for kind in self.container_kinds:
                if art is None:
                    from ct_mapreduce_tpu_torch.filter import FilterArtifact

                    art = FilterArtifact.from_bytes(blob)
                cb = containers.encode_container(art, kind)
                cont[kind] = cb
                cont_etags[kind] = etag_of(cb)
            pe = PublishedEpoch(
                epoch=epoch, blob=blob,
                sha256=hashlib.sha256(blob).hexdigest(),
                etag=etag_of(blob), created_wall=time.time(),
                containers=cont, container_etags=cont_etags)
            if latest is not None:
                links_since_anchor = self._links_since_anchor()
                if (links_since_anchor >= self.max_chain
                        or self._epochs[latest].blob[:8] != blob[:8]):
                    # Mandatory full-snapshot anchor: chain budget
                    # exhausted, or the artifact format changed under
                    # us (an fl01→fl02 rollover can never delta — the
                    # codec refuses mixed ends); older clients
                    # full-pull from here.
                    self._anchors.append(epoch)
                    incr_counter("distrib", "anchor")
                else:
                    prev = self._epochs[latest]
                    dblob = deltas.compute_delta(
                        prev.blob, blob, latest, epoch)
                    link = deltas.ChainLink(
                        from_epoch=latest, to_epoch=epoch,
                        sha256=hashlib.sha256(dblob).hexdigest(),
                        base_sha256=prev.sha256,
                        target_sha256=pe.sha256, n_bytes=len(dblob))
                    self._links[latest] = (link, dblob)
                    add_sample("distrib", "delta_bytes",
                               value=float(len(dblob)))
            else:
                # The very first publish is an anchor by definition.
                self._anchors.append(epoch)
            self._epochs[epoch] = pe
            self._evict_locked()
            set_gauge("distrib", "epochs_held",
                      value=float(len(self._epochs)))
            set_gauge("distrib", "chain_links",
                      value=float(len(self._links)))
            set_gauge("distrib", "artifact_bytes",
                      value=float(len(blob)))
        incr_counter("distrib", "publish")
        return True

    def _links_since_anchor(self) -> int:
        anchor = max(self._anchors) if self._anchors else -1
        return sum(1 for f in self._links if f >= anchor)

    def _evict_locked(self) -> None:
        while len(self._epochs) > self.history:
            oldest = min(self._epochs)
            del self._epochs[oldest]
            self._links.pop(oldest, None)
            self._anchors = [a for a in self._anchors
                             if a in self._epochs or a > oldest]
            for key in [k for k in self._encoded
                        if k[0] in ("full", "container")
                        and k[1] == oldest
                        or k[0] == "delta" and k[1] == oldest]:
                del self._encoded[key]

    # -- reads -----------------------------------------------------------
    def latest(self) -> Optional[PublishedEpoch]:
        with self._lock:
            if not self._epochs:
                return None
            return self._epochs[max(self._epochs)]

    def get(self, epoch: int) -> Optional[PublishedEpoch]:
        with self._lock:
            return self._epochs.get(int(epoch))

    def delta_bundle(self, from_epoch: int,
                     to_epoch: int) -> Optional[bytes]:
        """The concatenated (self-delimiting) link blobs from → to, or
        None when no contiguous chain exists (evicted epoch, anchor in
        the span, or unknown epochs) — the client then full-pulls."""
        with self._lock:
            manifest = self._manifest_locked()
            path = manifest.link_path(int(from_epoch), int(to_epoch))
            if path is None:
                return None
            return b"".join(self._links[li.from_epoch][1] for li in path)

    def _manifest_locked(self) -> deltas.ChainManifest:
        latest = max(self._epochs) if self._epochs else -1
        pe = self._epochs.get(latest)
        # The chain's delta format follows the published artifact
        # format (CTMRFL02 epochs link as CTMRDL02); an empty store
        # reports the legacy default.
        fmt = deltas.MAGIC.decode()
        if pe is not None and pe.blob[:8] == b"CTMRFL02":
            fmt = deltas.MAGIC_DL02.decode()
        return deltas.ChainManifest(
            latest_epoch=latest,
            latest_sha256=pe.sha256 if pe else "",
            latest_bytes=len(pe.blob) if pe else 0,
            anchors=sorted(self._anchors),
            links=[li for _, (li, _) in sorted(self._links.items())],
            fmt=fmt)

    def manifest(self) -> dict:
        """The chain-manifest JSON body (``GET /filter/manifest``),
        plus the epochs/containers/encodings this worker can serve."""
        with self._lock:
            body = self._manifest_locked().to_json()
            body["containers"] = sorted(self.container_kinds)
            body["encodings"] = list(available_encodings())
            body["epochsHeld"] = sorted(self._epochs)
            body["maxDeltaChain"] = self.max_chain
            return body

    # -- wire encodings --------------------------------------------------
    def encoded(self, cache_key: Optional[tuple], blob: bytes,
                encoding: Optional[str]) -> bytes:
        """``blob`` compressed as ``encoding`` (None = identity), built
        once and cached under ``cache_key + (encoding,)``. A None
        cache_key compresses WITHOUT caching (ad-hoc payloads like
        per-group slices — unbounded key spaces must not grow the
        cache; epoch-keyed entries are pruned with their epoch)."""
        if not encoding:
            return blob
        if cache_key is None:
            return compress(blob, encoding)
        key = tuple(cache_key) + (encoding,)
        with self._lock:
            hit = self._encoded.get(key)
            if hit is not None:
                return hit
        enc = compress(blob, encoding)
        with self._lock:
            self._encoded.setdefault(key, enc)
        return enc

    def stats(self) -> dict:
        with self._lock:
            latest = max(self._epochs) if self._epochs else None
            return {
                "distrib_epochs": sorted(self._epochs),
                "distrib_latest_epoch": latest,
                "distrib_links": len(self._links),
                "distrib_anchors": sorted(self._anchors),
                "distrib_encodings": list(available_encodings()),
            }


def negotiate_encoding(accept_encoding: str) -> Optional[str]:
    """Pick the response Content-Encoding from an Accept-Encoding
    header: zstd when the build has it and the client accepts it, else
    gzip, else identity (None). Tokens with ``q=0`` are treated as
    refused; anything unparseable falls back to identity."""
    accepted = {}
    for part in (accept_encoding or "").split(","):
        token, _, params = part.strip().partition(";")
        token = token.strip().lower()
        if not token:
            continue
        q = 1.0
        params = params.strip()
        if params.startswith("q="):
            try:
                q = float(params[2:])
            except ValueError:
                q = 1.0
        accepted[token] = q
    for enc in available_encodings():
        if accepted.get(enc, accepted.get("*", 0.0)) > 0.0:
            return enc
    return None
