"""Upstream-style container encodings of the filter artifact: the
``mlbf`` and ``clubcard`` shapes crlite consumers already speak,
emitted alongside ``CTMRFL01`` from the same capture (a port of
``ct_mapreduce_tpu.distrib.container``; byte layouts in the JAX
package's docs/FILTER_FORMAT.md).

- **mlbf** (``CTMRMB01``) — the rust-cascade shape: a flat binary
  stream of per-group multi-level Bloom-filter records (hash-algorithm
  tag, then per-layer ``m``/``k``/bitmap), no JSON anywhere. The
  closest relative of Mozilla's ``filter`` file in a crlite channel
  update.
- **clubcard** (``CTMRCC01``) — the partitioned shape: per group an
  *approximate* section (the layer-0 Bloom bitmap) and an *exact*
  section (the deeper exception layers), each independently offset so
  a consumer can map the approximate part and lazily fault the exact
  part — the access pattern clubcard-style consumers optimize for.

Both containers carry exactly the information of the source artifact:
``decode_container`` reconstructs a :class:`FilterArtifact` whose
every membership answer is identical to the source's (pinned by
tests/test_distrib.py). Encodings are deterministic — groups iterate
sorted, no wall-clock — so a container's bytes (and therefore its
ETag) are byte-identical on every worker of a fleet.

A container sourced from a ``CTMRFL02`` artifact writes the rev-2
magics (``CTMRMB02`` / ``CTMRCC02``): the record layout is unchanged,
but the per-group cascades were built against per-group universes, so
a consumer must know which native format a decoded artifact
re-serializes to (and which FP semantics apply to unobserved groups —
docs/FILTER_FORMAT.md). ``decode_container`` restores the matching
``fmt`` on the artifact it returns.
"""

from __future__ import annotations

import struct

import numpy as np

from ct_mapreduce_tpu_torch.filter.artifact import (
    FORMAT_FL01,
    FORMAT_FL02,
    FilterArtifact,
    FilterGroup,
)
from ct_mapreduce_tpu_torch.filter.cascade import BloomLayer, FilterCascade
from ct_mapreduce_tpu_torch.telemetry.metrics import measure

MLBF_MAGIC = b"CTMRMB01"
MLBF_MAGIC2 = b"CTMRMB02"
CLUBCARD_MAGIC = b"CTMRCC01"
CLUBCARD_MAGIC2 = b"CTMRCC02"

# Source artifact format → container magic (and back). Layouts are
# identical across revs; the magic records the provenance format.
_MLBF_MAGIC_BY_FMT = {FORMAT_FL01: MLBF_MAGIC, FORMAT_FL02: MLBF_MAGIC2}
_CLUB_MAGIC_BY_FMT = {FORMAT_FL01: CLUBCARD_MAGIC,
                      FORMAT_FL02: CLUBCARD_MAGIC2}
_FMT_BY_MAGIC = {MLBF_MAGIC: FORMAT_FL01, MLBF_MAGIC2: FORMAT_FL02,
                 CLUBCARD_MAGIC: FORMAT_FL01,
                 CLUBCARD_MAGIC2: FORMAT_FL02}
# Hash-algorithm tag: 1 = the pipeline's Kirsch-Mitzenmacher double
# hash over SHA-256 fingerprint words (docs/FILTER_FORMAT.md). The
# only algorithm this build writes; readers must reject others.
HASH_ALG_KM_SHA256 = 1

CONTAINER_KINDS = ("clubcard", "mlbf")


class ContainerError(ValueError):
    """Unparseable container: wrong magic, hash tag, or truncation."""


def _pack_str(s: str) -> bytes:
    raw = s.encode()
    if len(raw) > 0xFFFF:
        raise ContainerError(f"string too long for container: {len(raw)}")
    return struct.pack("<H", len(raw)) + raw


class _Reader:
    def __init__(self, blob: bytes, pos: int = 0):
        self.blob = blob
        self.pos = pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.blob):
            raise ContainerError(
                f"truncated container at byte {self.pos} (+{n})")
        out = self.blob[self.pos: self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.take(8))[0]

    def string(self) -> str:
        return self.take(self.u16()).decode()


# -- mlbf -----------------------------------------------------------------


def encode_mlbf(art: FilterArtifact) -> bytes:
    """``CTMRMB01``: magic ‖ u8 hashAlg ‖ f64 fpRate ‖ u32 nGroups ‖
    group records (sorted by (issuer, expDate)); per group: issuer ‖
    expDate (u16-length-prefixed UTF-8) ‖ i32 expHour ‖ u32 ordinal ‖
    u32 n ‖ u8 nLayers ‖ per layer u32 m ‖ u8 k ‖ u32 nWords ‖
    little-endian uint32 bitmap words."""
    with measure("distrib", "container_build_s"):
        out = bytearray(_MLBF_MAGIC_BY_FMT[art.fmt])
        out += struct.pack("<Bd", HASH_ALG_KM_SHA256, art.fp_rate)
        out += struct.pack("<I", len(art.groups))
        for (_, _), g in sorted(art.groups.items()):
            out += _pack_str(g.issuer)
            out += _pack_str(g.exp_id)
            out += struct.pack("<iII", g.exp_hour, g.ordinal, g.n)
            out += struct.pack("<B", len(g.cascade.layers))
            for layer in g.cascade.layers:
                raw = layer.words.astype("<u4").tobytes()
                out += struct.pack("<IBI", layer.m, layer.k,
                                   len(raw) // 4)
                out += raw
    return bytes(out)


def decode_mlbf(blob: bytes) -> FilterArtifact:
    if blob[:8] not in (MLBF_MAGIC, MLBF_MAGIC2):
        raise ContainerError(f"not an mlbf container ({blob[:8]!r})")
    r = _Reader(blob, 8)
    alg = r.u8()
    if alg != HASH_ALG_KM_SHA256:
        raise ContainerError(f"unknown mlbf hash algorithm {alg}")
    fp_rate = r.f64()
    groups = []
    for _ in range(r.u32()):
        issuer = r.string()
        exp_id = r.string()
        exp_hour = r.i32()
        ordinal = r.u32()
        n = r.u32()
        layers = []
        for _ in range(r.u8()):
            m = r.u32()
            k = r.u8()
            nwords = r.u32()
            words = np.frombuffer(r.take(4 * nwords),
                                  dtype="<u4").astype(np.uint32)
            layers.append(BloomLayer(m=m, k=k, words=words))
        groups.append(FilterGroup(
            issuer=issuer, exp_id=exp_id, exp_hour=exp_hour,
            ordinal=ordinal, n=n,
            cascade=FilterCascade(fp_rate=fp_rate, n_included=n,
                                  layers=layers)))
    return FilterArtifact(fp_rate=fp_rate, groups=groups,
                          fmt=_FMT_BY_MAGIC[blob[:8]])


# -- clubcard -------------------------------------------------------------


def encode_clubcard(art: FilterArtifact) -> bytes:
    """``CTMRCC01``: magic ‖ u8 hashAlg ‖ f64 fpRate ‖ u32 nGroups ‖
    directory ‖ approximate section ‖ exact section. The directory
    lists, per sorted group, its identity plus (offset, length) of its
    layer-0 bitmap in the approximate section and of its packed
    exception layers in the exact section — so a consumer can resolve
    the common case (layer-0 miss ⇒ not revoked) touching only the
    approximate bytes."""
    with measure("distrib", "container_build_s"):
        approx = bytearray()
        exact = bytearray()
        dir_out = bytearray()
        ordered = sorted(art.groups.items())
        for (_, _), g in ordered:
            layers = g.cascade.layers
            if layers:
                l0 = layers[0]
                a_off = len(approx)
                a_raw = l0.words.astype("<u4").tobytes()
                approx += a_raw
                l0_meta = struct.pack("<IBI", l0.m, l0.k,
                                      len(a_raw) // 4)
            else:
                a_off = len(approx)
                l0_meta = struct.pack("<IBI", 0, 0, 0)
            e_off = len(exact)
            exact += struct.pack("<B", max(0, len(layers) - 1))
            for layer in layers[1:]:
                raw = layer.words.astype("<u4").tobytes()
                exact += struct.pack("<IBI", layer.m, layer.k,
                                     len(raw) // 4)
                exact += raw
            dir_out += _pack_str(g.issuer)
            dir_out += _pack_str(g.exp_id)
            dir_out += struct.pack("<iII", g.exp_hour, g.ordinal, g.n)
            dir_out += l0_meta
            dir_out += struct.pack("<II", a_off, e_off)
        out = bytearray(_CLUB_MAGIC_BY_FMT[art.fmt])
        out += struct.pack("<Bd", HASH_ALG_KM_SHA256, art.fp_rate)
        out += struct.pack("<III", len(ordered), len(dir_out),
                           len(approx))
        out += dir_out + approx + exact
    return bytes(out)


def decode_clubcard(blob: bytes) -> FilterArtifact:
    if blob[:8] not in (CLUBCARD_MAGIC, CLUBCARD_MAGIC2):
        raise ContainerError(f"not a clubcard container ({blob[:8]!r})")
    r = _Reader(blob, 8)
    alg = r.u8()
    if alg != HASH_ALG_KM_SHA256:
        raise ContainerError(f"unknown clubcard hash algorithm {alg}")
    fp_rate = r.f64()
    n_groups = r.u32()
    dir_len = r.u32()
    approx_len = r.u32()
    dir_end = r.pos + dir_len
    approx_base = dir_end
    exact_base = approx_base + approx_len
    groups = []
    for _ in range(n_groups):
        issuer = r.string()
        exp_id = r.string()
        exp_hour = r.i32()
        ordinal = r.u32()
        n = r.u32()
        l0_m = r.u32()
        l0_k = r.u8()
        l0_words = r.u32()
        a_off = r.u32()
        e_off = r.u32()
        layers = []
        if l0_words:
            raw = blob[approx_base + a_off:
                       approx_base + a_off + 4 * l0_words]
            if len(raw) != 4 * l0_words:
                raise ContainerError("truncated approximate section")
            layers.append(BloomLayer(
                m=l0_m, k=l0_k,
                words=np.frombuffer(raw, dtype="<u4").astype(np.uint32)))
        er = _Reader(blob, exact_base + e_off)
        for _ in range(er.u8()):
            m = er.u32()
            k = er.u8()
            nwords = er.u32()
            words = np.frombuffer(er.take(4 * nwords),
                                  dtype="<u4").astype(np.uint32)
            layers.append(BloomLayer(m=m, k=k, words=words))
        groups.append(FilterGroup(
            issuer=issuer, exp_id=exp_id, exp_hour=exp_hour,
            ordinal=ordinal, n=n,
            cascade=FilterCascade(fp_rate=fp_rate, n_included=n,
                                  layers=layers)))
    if r.pos != dir_end:
        raise ContainerError(
            f"clubcard directory desync ({r.pos} != {dir_end})")
    return FilterArtifact(fp_rate=fp_rate, groups=groups,
                          fmt=_FMT_BY_MAGIC[blob[:8]])


# -- dispatch -------------------------------------------------------------


def encode_container(art: FilterArtifact, kind: str) -> bytes:
    if kind == "mlbf":
        return encode_mlbf(art)
    if kind == "clubcard":
        return encode_clubcard(art)
    raise ContainerError(f"unknown container kind {kind!r} "
                         f"(expected one of {CONTAINER_KINDS})")


def decode_container(blob: bytes) -> FilterArtifact:
    if blob[:8] in (MLBF_MAGIC, MLBF_MAGIC2):
        return decode_mlbf(blob)
    if blob[:8] in (CLUBCARD_MAGIC, CLUBCARD_MAGIC2):
        return decode_clubcard(blob)
    raise ContainerError(f"unknown container magic {blob[:8]!r}")
