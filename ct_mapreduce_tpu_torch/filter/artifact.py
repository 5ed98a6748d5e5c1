"""The on-disk revocation-filter artifact (port of
``ct_mapreduce_tpu.filter.artifact``): versioned, deterministic, one
filter cascade per ``(issuer, expDate)`` known-serial set, in the same
bytes as the JAX package's.

This is the second product of the reduce state (ROADMAP item 5(b)):
where ``storage-statistics`` prints the per-(issuer, expDate) serial
*counts*, the filter artifact compiles the serial *sets* — captured by
the aggregator's filter capture (:meth:`TorchAggregator.
enable_filter_capture`) — into compact crlite-style cascades a
downstream revocation pipeline can ship. Byte layout is specified in
docs/FILTER_FORMAT.md; the invariants that matter here:

- **Canonical keys.** Element keys are the pipeline's own fingerprint
  message (``expHour ‖ issuerOrdinal ‖ serialLen ‖ serial``, SHA-256,
  low 128 bits) with the issuer's run-local registry index replaced by
  its ORDINAL in the artifact's sorted issuerID list. Run-local
  indices differ between a fleet's workers and a serial run; sorted
  identities do not — this is what makes a merged fleet artifact
  byte-identical to the serial run's (tools/fleet.py --verify).
  Conforming serials (≤ MAX_SERIAL_BYTES) hash through the fingerprint
  kernel K1 (:func:`ops.sha256.sha256_fingerprint64` on ``device``,
  CUDA unless named; its plain version on the CPU) for large batches,
  the :func:`core.packing.fingerprints_np` host mirror otherwise;
  oversized serials take a host hashlib lane with a disjoint message
  encoding.
- **Determinism.** Groups sort by (issuerID, expHour), serials sort
  bytewise, layer sizing is a fixed formula, headers are
  sorted-key/compact JSON, and no wall-clock enters the bytes: the
  same aggregation state always serializes to the same artifact.
- **Exactness.** In the ``CTMRFL01`` format each group's cascade is
  built with *every other group's keys* as its excluded universe, so
  any serial known to the aggregation state answers its (issuer,
  expDate) membership exactly; serials outside the state see ≈ the
  target FP rate and are killed by the serve plane's table-confirm
  tier.
- **Per-group universes (CTMRFL02, the default).** Each group's
  cascade builds against its OWN observed universe only: keys hash
  under ordinal 0 (no cross-group issuer numbering) and the excluded
  set is empty, so the cascade is a single Bloom layer at the target
  FP rate. One group's churn can never move another group's bytes —
  the property the delta plane (CTMRDL02) and the dirty-group
  incremental build path (filter/cache.py) are built on. The trade:
  a query against the WRONG group (a serial the state knows only
  under a different (issuer, expDate)) now false-positives at ≈ the
  target rate instead of answering exactly; the serve tier's
  table-confirm kills those exactly as it kills ordinary FPs.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
import time
from dataclasses import dataclass

import numpy as np

from ct_mapreduce_tpu_torch.core import packing
from ct_mapreduce_tpu_torch.core.types import ExpDate
from ct_mapreduce_tpu_torch.filter.cascade import (
    DEVICE_BUILD_MIN,
    BloomLayer,
    FilterCascade,
    device_enabled,
)
from ct_mapreduce_tpu_torch.telemetry import trace
from ct_mapreduce_tpu_torch.telemetry.metrics import (
    incr_counter,
    measure,
    set_gauge,
)

MAGIC = b"CTMRFL01"
MAGIC_FL02 = b"CTMRFL02"
VERSION = 1
DEFAULT_FP_RATE = 0.01

# Format names (the `filterFormat` directive / CTMR_FILTER_FORMAT
# values). fl02 — per-group universes — is the default; fl01 is the
# compatibility path for consumers pinned to the global-universe
# format (round-15/19 golden artifacts).
FORMAT_FL01 = "fl01"
FORMAT_FL02 = "fl02"
_FORMAT_MAGIC = {FORMAT_FL01: MAGIC, FORMAT_FL02: MAGIC_FL02}
_MAGIC_FORMAT = {MAGIC: FORMAT_FL01, MAGIC_FL02: FORMAT_FL02}


def normalize_format(fmt: str) -> str:
    """One canonical spelling per format; loud on unknown values."""
    f = str(fmt).strip().lower()
    if f in ("fl01", "ctmrfl01"):
        return FORMAT_FL01
    if f in ("fl02", "ctmrfl02"):
        return FORMAT_FL02
    raise ValueError(f"unknown filter format {fmt!r} "
                     f"(expected fl01 or fl02)")


def default_format() -> str:
    """The build-time artifact format: ``CTMR_FILTER_FORMAT`` env
    (``fl01`` | ``fl02``) when set and parseable, else fl02."""
    v = os.environ.get("CTMR_FILTER_FORMAT", "").strip()
    if v:
        try:
            return normalize_format(v)
        except ValueError:
            pass  # unparseable env ignored (config-layer tolerance)
    return FORMAT_FL02


def resolve_format(fmt) -> str:
    """None/empty → the default format; otherwise normalized."""
    if fmt is None or fmt == "":
        return default_format()
    return normalize_format(fmt)


# Dispatch statistics of the most recent fused build (None after a
# per-group build) — a tool/test observability hook, not API.
LAST_BUILD_STATS = None


def canonical_keys(ordinals: np.ndarray, exp_hours: np.ndarray,
                   serials: list[bytes],
                   use_device: bool | None = None,
                   chunk: int = 0, device=None) -> np.ndarray:
    """uint32[n, 4] canonical filter keys for (ordinal, expHour,
    serial) triples. Conforming serials hash through the fingerprint
    kernel K1 on ``device`` when the batch is large, the vectorized
    host mirror otherwise; oversized serials — host-lane-only identities —
    hash through a disjoint single-purpose encoding that no conforming
    message can collide with (marker byte 0xFF > MAX_SERIAL_BYTES in
    the length position).

    Chunked driver: the per-serial message matrix is built
    ``chunk`` rows at a time (default ``stream.DEFAULT_STREAM_CHUNK``),
    so only the [n, 4] key array is corpus-sized. Chunk boundaries
    change no bytes."""
    from ct_mapreduce_tpu_torch.filter import stream

    n = len(serials)
    out = np.zeros((n, 4), np.uint32)
    if n == 0:
        return out
    chunk = int(chunk) or stream.DEFAULT_STREAM_CHUNK
    ordinals = np.asarray(ordinals, np.int64)
    exp_hours = np.asarray(exp_hours, np.int64)
    lens = np.fromiter((len(s) for s in serials), np.int64, n)
    fit = lens <= packing.MAX_SERIAL_BYTES
    sel = np.nonzero(fit)[0]
    for start in range(0, int(sel.size), chunk):
        part = sel[start: start + chunk]
        block = [serials[p] for p in part]
        blens, mat = stream.pack_serials(block)
        dev = use_device
        if dev is None:
            dev = device_enabled() and part.size >= DEVICE_BUILD_MIN
        with trace.span("filter.stream_chunk", cat="filter",
                        lanes=int(part.size), device=int(bool(dev))):
            if dev:
                fps = stream._fingerprints_device(
                    ordinals[part], exp_hours[part], mat, blens, device)
            else:
                fps = packing.fingerprints_np(
                    ordinals[part], exp_hours[part], mat, blens)
        out[part] = fps
    for p in np.nonzero(~fit)[0]:
        out[p] = stream.oversized_key(
            int(ordinals[p]), int(exp_hours[p]), serials[p])
    return out


@dataclass
class FilterGroup:
    issuer: str  # issuerID (base64url(SHA-256(SPKI)))
    exp_id: str  # expDate report id, e.g. "2031-06-15-14"
    exp_hour: int
    ordinal: int  # issuer ordinal the keys were hashed under
    n: int  # included serials
    cascade: FilterCascade


class FilterArtifact:
    """Parsed (or freshly built) artifact: group directory + cascades.

    ``fmt`` is the serialization format (``fl01`` | ``fl02``): it
    picks the magic ``to_bytes`` writes and round-trips through
    ``from_bytes``, so re-serializers (delta replay, group slices)
    preserve the source format."""

    def __init__(self, fp_rate: float, groups: list[FilterGroup],
                 fmt: str = FORMAT_FL01):
        self.fp_rate = float(fp_rate)
        self.fmt = normalize_format(fmt)
        self.groups = {(g.issuer, g.exp_id): g for g in groups}
        self._by_hour = {(g.issuer, g.exp_hour): g for g in groups}

    @property
    def n_serials(self) -> int:
        return sum(g.n for g in self.groups.values())

    def max_layers(self) -> int:
        return max((len(g.cascade.layers) for g in self.groups.values()),
                   default=0)

    def total_bits(self) -> int:
        return sum(g.cascade.total_bits() for g in self.groups.values())

    def bits_per_entry(self) -> float:
        return self.total_bits() / max(1, self.n_serials)

    # -- queries ---------------------------------------------------------
    def group_for(self, issuer: str, exp) -> FilterGroup | None:
        """Group lookup; ``exp`` is an expDate id string or epoch
        hour. String ids resolve through ExpDate.parse so day- and
        hour-form spellings of the same bucket both land."""
        if isinstance(exp, str):
            g = self.groups.get((issuer, exp))
            if g is not None:
                return g
            try:
                exp = ExpDate.parse(exp).unix_hour()
            except ValueError:
                return None
        return self._by_hour.get((issuer, int(exp)))

    def query(self, issuer: str, exp, serial: bytes) -> bool:
        """Is ``serial`` a known serial of (issuer, expDate)? Exact
        for every serial the source aggregation state knew; unknown
        serials see ≈ the target FP rate (confirm against the table
        before trusting a positive)."""
        g = self.group_for(issuer, exp)
        if g is None:
            return False
        keys = canonical_keys(
            np.array([g.ordinal]), np.array([g.exp_hour]), [serial])
        return bool(g.cascade.contains(keys)[0])

    def query_group(self, g: FilterGroup, serials: list[bytes],
                    device=None) -> np.ndarray:
        keys = canonical_keys(
            np.full((len(serials),), g.ordinal),
            np.full((len(serials),), g.exp_hour), serials, device=device)
        return g.cascade.contains(keys)

    # -- serialization ---------------------------------------------------
    def to_bytes(self) -> bytes:
        payload = bytearray()
        entries = []
        for (_, _), g in sorted(self.groups.items()):
            layers = []
            for layer in g.cascade.layers:
                raw = layer.words.astype("<u4").tobytes()
                layers.append({"k": layer.k, "m": layer.m,
                               "off": len(payload), "words": len(raw)})
                payload += raw
            entries.append({
                "expDate": g.exp_id, "expHour": g.exp_hour,
                "issuer": g.issuer, "layers": layers, "n": g.n,
                "ordinal": g.ordinal,
            })
        header = json.dumps(
            {"fpRate": self.fp_rate, "groups": entries,
             "nSerials": self.n_serials, "version": VERSION},
            sort_keys=True, separators=(",", ":")).encode()
        return (_FORMAT_MAGIC[self.fmt] + struct.pack("<I", len(header))
                + header + bytes(payload))

    @classmethod
    def from_bytes(cls, blob: bytes) -> "FilterArtifact":
        fmt = _MAGIC_FORMAT.get(blob[:8])
        if fmt is None:
            raise ValueError("not a ct-mapreduce filter artifact "
                             f"(magic {blob[:8]!r})")
        (hlen,) = struct.unpack("<I", blob[8:12])
        header = json.loads(blob[12:12 + hlen].decode())
        if header.get("version") != VERSION:
            raise ValueError(
                f"unsupported filter artifact version "
                f"{header.get('version')!r} (this build reads {VERSION})")
        payload = blob[12 + hlen:]
        groups = []
        for e in header["groups"]:
            layers = []
            for lyr in e["layers"]:
                raw = payload[lyr["off"]: lyr["off"] + lyr["words"]]
                words = np.frombuffer(raw, dtype="<u4").astype(np.uint32)
                layers.append(BloomLayer(m=lyr["m"], k=lyr["k"],
                                         words=words))
            groups.append(FilterGroup(
                issuer=e["issuer"], exp_id=e["expDate"],
                exp_hour=int(e["expHour"]), ordinal=int(e["ordinal"]),
                n=int(e["n"]),
                cascade=FilterCascade(fp_rate=header["fpRate"],
                                      n_included=int(e["n"]),
                                      layers=layers)))
        return cls(fp_rate=header["fpRate"], groups=groups, fmt=fmt)

    def group_bytes(self, issuer: str, exp) -> bytes | None:
        """A standalone single-group artifact (same format) for the
        serve plane's per-(issuer, expDate) download route. The group
        keeps its full-artifact ordinal; a CTMRFL01 cascade was built
        against the GLOBAL excluded universe and a CTMRFL02 one
        against its own, so in both formats the slice answers exactly
        what the full artifact answers."""
        g = self.group_for(issuer, exp)
        if g is None:
            return None
        return FilterArtifact(self.fp_rate, [g], fmt=self.fmt).to_bytes()


def fused_enabled() -> bool:
    """Filter builds use the fused multi-group layer dispatcher by
    default; ``CTMR_FILTER_FUSED=0`` forces the per-group path
    (byte-identical — the parity escape hatch)."""
    v = os.environ.get("CTMR_FILTER_FUSED", "").strip().lower()
    if v in ("0", "f", "false"):
        return False
    return True


def build_artifact(serial_sets: dict, fp_rate: float = DEFAULT_FP_RATE,
                   use_device: bool | None = None,
                   fused: bool | None = None,
                   stream_chunk: int = 0,
                   fused_lanes: int = 0,
                   fmt: str | None = None,
                   cache=None,
                   tokens: dict | None = None,
                   device=None) -> FilterArtifact:
    """Compile ``{(issuerID, expHour): iterable of serial bytes}`` into
    a deterministic artifact: each group's cascade includes its own
    serials and (fl01 only) excludes every other group's keys.
    ``tokens`` optionally maps the same keys to per-group content
    tokens for the incremental ``cache`` (filter/cache.py). ``device``
    (CUDA unless named) runs the device lanes: K1 for the keys, K5 for
    the scatters."""
    from ct_mapreduce_tpu_torch.filter import stream

    sources = []
    for iss, eh in sorted(serial_sets):
        src = stream.ListGroupSource(iss, eh, serial_sets[(iss, eh)])
        if tokens is not None:
            src.content_token = tokens.get((iss, eh))
        sources.append(src)
    return build_artifact_from_sources(
        sources, fp_rate=fp_rate, use_device=use_device, fused=fused,
        stream_chunk=stream_chunk, fused_lanes=fused_lanes, fmt=fmt,
        cache=cache, device=device)


def build_artifact_from_sources(
        sources: list, fp_rate: float = DEFAULT_FP_RATE,
        use_device: bool | None = None,
        fused: bool | None = None,
        stream_chunk: int = 0,
        fused_lanes: int = 0,
        fmt: str | None = None,
        cache=None,
        device=None) -> FilterArtifact:
    """The build driver over :class:`stream.GroupSource`
    providers (packed chunks — the 10⁸-scale entry point; the dict
    wrapper above feeds it :class:`stream.ListGroupSource`).

    Serial data streams through the fingerprint kernel in fixed-size
    blocks, only the ``[N, 4]`` key arena is corpus-resident, and the
    cascades build through the fused multi-group layer dispatcher (one
    scatter per layer-round batch, not per (group, layer) —
    ``fused=False`` / ``CTMR_FILTER_FUSED=0`` for the byte-identical
    per-group reference path). Streamed, fused, in-memory, and
    fleet-merged builds of the same logical state produce identical
    bytes in either format.

    ``fmt`` picks the artifact format (``fl01`` global universes /
    ``fl02`` per-group universes; None → :func:`default_format`).
    ``cache`` (a :class:`filter.cache.GroupBuildCache`, fl02 only)
    arms the dirty-group incremental path: sources whose
    ``content_token`` matches the cache reuse the prior build's
    group VERBATIM — no key generation, no scatter — and only dirty
    groups rebuild, so the epoch tick costs O(churn)."""
    from ct_mapreduce_tpu_torch.filter import fused as fused_mod
    from ct_mapreduce_tpu_torch.filter import stream

    fmt = resolve_format(fmt)
    if fused is None:
        fused = fused_enabled()
    stream_chunk = int(stream_chunk) or stream.DEFAULT_STREAM_CHUNK
    t0 = time.perf_counter()
    peak_rss = stream._rss_bytes()
    with measure("filter", "build_s"), \
            trace.span("filter.build", cat="filter",
                       groups=len(sources)):
        sources = sorted(sources, key=lambda s: (s.issuer, s.exp_hour))
        issuers = sorted({s.issuer for s in sources})
        if fmt == FORMAT_FL01:
            ordinal = {iss: i for i, iss in enumerate(issuers)}
        else:
            # CTMRFL02: every group hashes under ordinal 0. A new
            # issuer appearing must not renumber — and thereby re-key —
            # every other issuer's groups; the issuerID in the
            # fingerprint's group identity lives in the (issuer,
            # expHour) directory key, not the hashed message.
            ordinal = {iss: 0 for iss in issuers}
        reused: dict = {}
        build_srcs = []
        for src in sources:
            if src.n == 0:
                continue
            hit = None
            if cache is not None and fmt == FORMAT_FL02:
                hit = cache.get(src.issuer, src.exp_hour,
                                getattr(src, "content_token", None),
                                fp_rate)
            if hit is not None:
                reused[(src.issuer, src.exp_hour)] = hit
            else:
                build_srcs.append(src)
        group_keys = []
        meta = []
        for src in build_srcs:
            keys = stream.collect_keys(
                src, ordinal[src.issuer], stream_chunk,
                use_device=use_device, device=device)
            group_keys.append(keys)
            meta.append(src)
            peak_rss = max(peak_rss, stream._rss_bytes())
        global LAST_BUILD_STATS
        if fmt == FORMAT_FL02:
            if fused:
                cascades, stats = fused_mod.build_cascades_grouped(
                    group_keys, fp_rate, use_device=use_device,
                    max_lanes=fused_lanes, consume=True, device=device)
                set_gauge("filter", "fused_groups_per_dispatch",
                          value=stats.mean_groups_per_dispatch())
                peak_rss = max(peak_rss, stats.peak_rss)
                LAST_BUILD_STATS = stats
            else:
                no_exc = np.zeros((0, 4), np.uint32)
                cascades = [FilterCascade.build(k, no_exc, fp_rate,
                                                use_device=use_device,
                                                device=device)
                            for k in group_keys]
                LAST_BUILD_STATS = None
        elif fused:
            cascades, stats = fused_mod.build_cascades_fused(
                group_keys, fp_rate, use_device=use_device,
                max_lanes=fused_lanes, consume=True, device=device)
            set_gauge("filter", "fused_groups_per_dispatch",
                      value=stats.mean_groups_per_dispatch())
            peak_rss = max(peak_rss, stats.peak_rss)
            LAST_BUILD_STATS = stats
        else:
            cascades = _build_cascades_per_group(
                group_keys, fp_rate, use_device, device)
            LAST_BUILD_STATS = None
        del group_keys
        groups = []
        for src, cascade in zip(meta, cascades):
            g = FilterGroup(
                issuer=src.issuer,
                exp_id=ExpDate.from_unix_hour(src.exp_hour).id(),
                exp_hour=src.exp_hour, ordinal=ordinal[src.issuer],
                n=src.n, cascade=cascade)
            groups.append(g)
            if cache is not None and fmt == FORMAT_FL02:
                cache.put(src.issuer, src.exp_hour,
                          getattr(src, "content_token", None),
                          fp_rate, g)
        for key in sorted(reused):
            groups.append(reused[key])
        if fmt == FORMAT_FL02:
            set_gauge("filter", "dirty_groups", value=float(len(meta)))
            set_gauge("filter", "groups_reused",
                      value=float(len(reused)))
            if cache is not None:
                cache.prune({(g.issuer, g.exp_hour) for g in groups})
        art = FilterArtifact(fp_rate=fp_rate, groups=groups, fmt=fmt)
        peak_rss = max(peak_rss, stream._rss_bytes())
    build_s = time.perf_counter() - t0
    set_gauge("filter", "serials", value=float(art.n_serials))
    set_gauge("filter", "groups", value=float(len(art.groups)))
    set_gauge("filter", "layers", value=float(art.max_layers()))
    set_gauge("filter", "bits_per_entry", value=art.bits_per_entry())
    set_gauge("filter", "build_rate",
              value=art.n_serials / max(build_s, 1e-9))
    set_gauge("filter", "build_rss_bytes", value=float(peak_rss))
    return art


def _build_cascades_per_group(group_keys: list, fp_rate: float,
                              use_device, device=None) -> list:
    """The reference path: one cascade at a time, each
    group's excluded universe the concatenation of every other
    group's keys. Kept as the byte-identity oracle for the fused
    dispatcher (CTMR_FILTER_FUSED=0 and the parity tests)."""
    if not group_keys:
        return []
    all_keys = np.concatenate(group_keys)
    bounds = np.cumsum([0] + [k.shape[0] for k in group_keys])
    cascades = []
    for i in range(len(group_keys)):
        mask = np.zeros((all_keys.shape[0],), bool)
        mask[bounds[i]: bounds[i + 1]] = True
        cascades.append(FilterCascade.build(
            all_keys[mask], all_keys[~mask], fp_rate,
            use_device=use_device, device=device))
    return cascades


def capture_by_identity(capture: dict, registry) -> dict:
    """Aggregator filter capture ({(issuer_idx, expHour): serial set})
    → identity-keyed serial sets ({(issuerID, expHour): set}). Indices
    past the registry (impossible in a consistent state) fail loudly —
    an artifact must never silently drop a group."""
    out: dict = {}
    # Sorted so the identity-keyed dict's insertion order is a function
    # of content, not capture fold order (ctmrlint: determinism).
    for (idx, eh), serials in sorted(capture.items()):
        if not serials:
            continue
        iss = registry.issuer_at(int(idx)).id()
        out.setdefault((iss, int(eh)), set()).update(serials)
    return out


def capture_tokens(capture: dict, hashes: dict | None,
                   registry) -> dict:
    """Identity-keyed per-group content tokens ({(issuerID, expHour):
    (n, xor-hash)}) for the incremental build cache. Exact
    incrementally-maintained hashes from the capture layer are used
    when available; otherwise the token recomputes from the serial
    set (sha256 per serial — far cheaper than the rebuild a missing
    token would force). A group fed by more than one registry index
    recomputes from its merged set: XOR-combining per-index hashes
    would cancel serials present under both indices."""
    from ct_mapreduce_tpu_torch.filter.cache import content_token

    merged: dict = {}
    contrib: dict = {}
    for (idx, eh), serials in sorted(capture.items()):
        if not serials:
            continue
        iss = registry.issuer_at(int(idx)).id()
        key = (iss, int(eh))
        merged.setdefault(key, set()).update(serials)
        contrib.setdefault(key, []).append((int(idx), int(eh)))
    out = {}
    for key in sorted(merged):
        srcs = contrib[key]
        if hashes is not None and len(srcs) == 1 and srcs[0] in hashes:
            out[key] = (len(merged[key]), hashes[srcs[0]])
        else:
            out[key] = content_token(merged[key])
    return out


def build_from_aggregator(agg, fp_rate: float = DEFAULT_FP_RATE,
                          use_device: bool | None = None,
                          fmt: str | None = None,
                          cache=None, device=None,
                          stream_chunk: int = 0,
                          fused_lanes: int = 0) -> FilterArtifact:
    """Artifact from a live aggregator's filter capture. With a
    ``cache`` (fl02), per-group content tokens come from the capture
    layer's incrementally-maintained hashes where exact, so clean
    groups reuse the prior epoch's blocks verbatim. The build runs on
    ``device``, the aggregator's own unless named."""
    if getattr(agg, "filter_capture", None) is None:
        raise ValueError(
            "aggregator has no filter capture; enable emitFilter (or "
            "call enable_filter_capture) before ingesting")
    # Snapshot under the fold lock: a live serve-plane refresh may run
    # while ingest folds mutate the capture dict/sets concurrently.
    import contextlib

    lock = getattr(agg, "_fold_lock", None)
    with (lock if lock is not None else contextlib.nullcontext()):
        capture = {key: set(serials)
                   for key, serials in sorted(agg.filter_capture.items())}
        hashes = (agg.capture_content_hashes()
                  if hasattr(agg, "capture_content_hashes") else None)
    tokens = (capture_tokens(capture, hashes, agg.registry)
              if cache is not None else None)
    if device is None:
        device = getattr(agg, "device", None)
    return build_artifact(
        capture_by_identity(capture, agg.registry),
        fp_rate=fp_rate, use_device=use_device, fmt=fmt, cache=cache,
        tokens=tokens, device=device, stream_chunk=stream_chunk,
        fused_lanes=fused_lanes)


def build_from_merged(merged, fp_rate: float = DEFAULT_FP_RATE,
                      allow_partial: bool = False,
                      use_device: bool | None = None,
                      fmt: str | None = None,
                      cache=None, device=None) -> FilterArtifact:
    """Artifact from a fleet's merged checkpoints
    (:class:`ct_mapreduce_tpu_torch.agg.merge.MergedAggregate`), built
    on ``device`` (CUDA unless named). Every folded
    checkpoint must carry a filter capture (a worker that ran with
    emitFilter off contributes device-lane serials only as hashes —
    unrecoverable), unless ``allow_partial`` explicitly accepts an
    artifact over the capturing subset. Cache tokens always recompute
    from the merged union sets — per-worker hashes must never
    XOR-combine (shared serials would cancel)."""
    missing = getattr(merged, "capture_missing", [])
    if missing and not allow_partial:
        raise ValueError(
            "merged checkpoints without a filter capture (run workers "
            f"with emitFilter=true): {missing}")
    tokens = (capture_tokens(merged.filter_serials, None,
                             merged.registry)
              if cache is not None else None)
    return build_artifact(
        capture_by_identity(merged.filter_serials, merged.registry),
        fp_rate=fp_rate, use_device=use_device, fmt=fmt, cache=cache,
        tokens=tokens, device=device)


def write_artifact(path: str, blob: bytes) -> None:
    """Atomic artifact write (temp + rename — the same durability
    contract as the aggregate checkpoint: a crash mid-write must not
    corrupt the previous good artifact)."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp_path = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".tmp.", dir=directory)
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp_path, path)
    except BaseException:
        import contextlib

        with contextlib.suppress(OSError):
            os.unlink(tmp_path)
        raise
    incr_counter("filter", "emit")


def read_artifact(path: str) -> FilterArtifact:
    with open(path, "rb") as fh:
        return FilterArtifact.from_bytes(fh.read())
