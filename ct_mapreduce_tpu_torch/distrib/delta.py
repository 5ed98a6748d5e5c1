"""Epoch deltas between filter artifacts: the ``CTMRDL01`` stash/diff
format (a port of ``ct_mapreduce_tpu.distrib.delta``: "a client pulls
KBs, not the full cascade").

A delta is computed between two consecutive epochs' deterministic
artifact bytes (docs/FILTER_FORMAT.md) and captures exactly what
changed at the group level. Two wire magics, one codec: ``CTMRDL01``
links take ``CTMRFL01`` artifacts to ``CTMRFL01`` artifacts, and
``CTMRDL02`` links do the same for ``CTMRFL02`` — the record formats
are identical; the magic pins which artifact format the replay
re-serializes under (mixed-format deltas are a loud
:class:`DeltaError`, never a guess). The practical difference is
upstream of the codec: per-group-universe ``CTMRFL02`` artifacts
confine churn to the touched groups, so untouched groups diff equal
and ship ZERO bytes — no sparse-XOR salvage of globally-reshaped
layers needed.

- **removed** — (issuer, expDate) groups present in the base but not
  the target;
- **added** — groups new in the target, shipped whole (layer records
  identical to the full format's, bitmaps in the delta payload);
- **patched** — groups present in both with different content: the new
  group directory entry plus per-layer diffs. A layer whose bitmap
  size ``m`` is unchanged ships as a sparse XOR record (changed word
  indices + XOR values); a layer whose geometry changed (cascade depth
  or ``m`` moved with the group's serial count) ships whole.

:func:`apply_delta` replays a delta onto the base artifact and
re-serializes through :meth:`FilterArtifact.to_bytes` — the SAME
canonical writer the full build uses — so a replayed chain is
byte-identical to the full build by construction, and both ends are
pinned by mandatory SHA-256 checks (``baseSha256``/``targetSha256``
in the header; a corrupted or misordered link can never produce a
silently wrong filter).

Chains are described by a :class:`ChainManifest`: one link per
consecutive epoch pair with the link blob's own SHA-256, plus the
anchor epochs where a full snapshot is mandatory (``max_chain`` bounds
how many links a client may ever need to replay). The manifest is the
integrity root a client validates a downloaded chain against.

Everything here is deterministic — identical inputs always serialize
to identical delta bytes (ctmrlint's determinism rule covers this
module; no wall-clock, no unsorted iteration).
"""

from __future__ import annotations

import hashlib
import json
import struct
from dataclasses import dataclass, field

import numpy as np

from ct_mapreduce_tpu_torch.filter.artifact import (
    FORMAT_FL01,
    FORMAT_FL02,
    FilterArtifact,
    FilterGroup,
)
from ct_mapreduce_tpu_torch.filter.cascade import BloomLayer, FilterCascade
from ct_mapreduce_tpu_torch.telemetry.metrics import incr_counter, measure

MAGIC = b"CTMRDL01"
MAGIC_DL02 = b"CTMRDL02"
VERSION = 1

# Artifact format ↔ delta wire magic. The delta magic is a pure
# function of the artifact format at both ends (compute_delta refuses
# mixed ends), so a reader knows the replay's serialization format
# from the first 8 bytes.
_DELTA_MAGIC = {FORMAT_FL01: MAGIC, FORMAT_FL02: MAGIC_DL02}
_MAGIC_DELTA_FMT = {MAGIC: FORMAT_FL01, MAGIC_DL02: FORMAT_FL02}

# Default bound on consecutive delta links before a mandatory
# full-snapshot anchor (the `maxDeltaChain` directive).
DEFAULT_MAX_CHAIN = 4


class DeltaError(ValueError):
    """A delta that cannot be (safely) applied: wrong magic/version,
    base mismatch, or a target-hash check failure."""


def artifact_sha256(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


def _group_entry(g: FilterGroup, payload: bytearray) -> dict:
    """One full group record (layers appended to ``payload``) — the
    same shape as the full format's directory entries."""
    layers = []
    for layer in g.cascade.layers:
        raw = layer.words.astype("<u4").tobytes()
        layers.append({"k": layer.k, "m": layer.m,
                       "off": len(payload), "words": len(raw)})
        payload += raw
    return {
        "expDate": g.exp_id, "expHour": g.exp_hour, "issuer": g.issuer,
        "layers": layers, "n": g.n, "ordinal": g.ordinal,
    }


def _layer_diff(old: BloomLayer | None, new: BloomLayer,
                payload: bytearray) -> dict:
    """Per-layer diff record. Same-geometry layers ship sparse XOR
    words; anything else ships the whole new bitmap."""
    if old is not None and old.m == new.m and old.k == new.k:
        x = old.words.astype(np.uint32) ^ new.words.astype(np.uint32)
        idx = np.nonzero(x)[0].astype(np.uint32)
        # Sparse only pays while the index+value pairs undercut the
        # full bitmap (8 B/changed word vs 4 B/word full).
        if idx.size * 8 < new.words.size * 4:
            off = len(payload)
            payload += idx.astype("<u4").tobytes()
            payload += x[idx].astype("<u4").tobytes()
            return {"mode": "xor", "m": new.m, "k": new.k,
                    "off": off, "count": int(idx.size)}
    raw = new.words.astype("<u4").tobytes()
    off = len(payload)
    payload += raw
    return {"mode": "full", "m": new.m, "k": new.k,
            "off": off, "words": len(raw)}


def compute_delta(base: bytes, target: bytes,
                  from_epoch: int, to_epoch: int) -> bytes:
    """``CTMRDL01`` bytes taking the base epoch's full artifact to the
    target epoch's. Pure function of its inputs (the determinism
    contract of every artifact writer in this tree)."""
    with measure("distrib", "delta_build_s"):
        base_art = FilterArtifact.from_bytes(base)
        target_art = FilterArtifact.from_bytes(target)
        if base_art.fmt != target_art.fmt:
            raise DeltaError(
                f"delta endpoints in different artifact formats "
                f"({base_art.fmt} -> {target_art.fmt}): re-anchor with "
                f"a full snapshot instead of a delta")
        payload = bytearray()
        removed = sorted(set(base_art.groups) - set(target_art.groups))
        added, patched = [], []
        for key in sorted(target_art.groups):
            new_g = target_art.groups[key]
            old_g = base_art.groups.get(key)
            if old_g is None:
                added.append(_group_entry(new_g, payload))
                continue
            if _groups_equal(old_g, new_g):
                continue
            layers = []
            for i, layer in enumerate(new_g.cascade.layers):
                old_layer = (old_g.cascade.layers[i]
                             if i < len(old_g.cascade.layers) else None)
                layers.append(_layer_diff(old_layer, layer, payload))
            patched.append({
                "expDate": new_g.exp_id, "expHour": new_g.exp_hour,
                "issuer": new_g.issuer, "layers": layers,
                "n": new_g.n, "ordinal": new_g.ordinal,
            })
        header = json.dumps({
            "added": added,
            "baseSha256": artifact_sha256(base),
            "fpRate": target_art.fp_rate,
            "fromEpoch": int(from_epoch),
            "patched": patched,
            "payloadBytes": len(payload),
            "removed": [list(k) for k in removed],
            "targetSha256": artifact_sha256(target),
            "toEpoch": int(to_epoch),
            "version": VERSION,
        }, sort_keys=True, separators=(",", ":")).encode()
        incr_counter("distrib", "delta_groups_shipped",
                     value=float(len(added) + len(patched)))
    return (_DELTA_MAGIC[target_art.fmt] + struct.pack("<I", len(header))
            + header + bytes(payload))


def _groups_equal(a: FilterGroup, b: FilterGroup) -> bool:
    if (a.exp_hour, a.ordinal, a.n) != (b.exp_hour, b.ordinal, b.n):
        return False
    if len(a.cascade.layers) != len(b.cascade.layers):
        return False
    for la, lb in zip(a.cascade.layers, b.cascade.layers):
        if (la.m, la.k) != (lb.m, lb.k) or not np.array_equal(
                la.words, lb.words):
            return False
    return True


def delta_format(blob: bytes) -> str:
    """The artifact format (``fl01`` | ``fl02``) a delta blob's replay
    re-serializes under, from its wire magic."""
    fmt = _MAGIC_DELTA_FMT.get(blob[:8])
    if fmt is None:
        raise DeltaError(
            f"not a ct-mapreduce filter delta (magic {blob[:8]!r})")
    return fmt


def parse_delta(blob: bytes) -> tuple[dict, bytes]:
    """(header, payload) of one delta blob (either magic); loud on
    wrong magic or an unknown version (readers must never guess)."""
    delta_format(blob)
    (hlen,) = struct.unpack("<I", blob[8:12])
    header = json.loads(blob[12:12 + hlen].decode())
    if header.get("version") != VERSION:
        raise DeltaError(f"unsupported delta version "
                         f"{header.get('version')!r} (this build reads "
                         f"{VERSION})")
    payload = blob[12 + hlen:]
    if len(payload) != header["payloadBytes"]:
        raise DeltaError(
            f"truncated delta payload: {len(payload)} of "
            f"{header['payloadBytes']} bytes")
    return header, payload


def split_bundle(blob: bytes) -> list[bytes]:
    """Split a concatenation of self-delimiting delta blobs (the
    ``/filter/delta/<from>/<to>`` wire shape) back into links."""
    out = []
    pos = 0
    while pos < len(blob):
        if blob[pos:pos + 8] not in _MAGIC_DELTA_FMT:
            raise DeltaError(f"bundle desync at byte {pos}")
        (hlen,) = struct.unpack("<I", blob[pos + 8:pos + 12])
        header = json.loads(blob[pos + 12:pos + 12 + hlen].decode())
        end = pos + 12 + hlen + int(header["payloadBytes"])
        if end > len(blob):
            raise DeltaError("truncated bundle")
        out.append(blob[pos:end])
        pos = end
    return out


def _layers_from_entry(entry: dict, payload: bytes) -> list[BloomLayer]:
    layers = []
    for lyr in entry["layers"]:
        raw = payload[lyr["off"]: lyr["off"] + lyr["words"]]
        layers.append(BloomLayer(
            m=lyr["m"], k=lyr["k"],
            words=np.frombuffer(raw, dtype="<u4").astype(np.uint32)))
    return layers


def apply_delta(base: bytes, delta: bytes) -> bytes:
    """Replay one delta onto the base artifact's bytes. The result is
    re-serialized through the canonical full-format writer and checked
    against the header's ``targetSha256`` — the output is either
    byte-identical to the full build or a loud :class:`DeltaError`."""
    header, payload = parse_delta(delta)
    fmt = delta_format(delta)
    if artifact_sha256(base) != header["baseSha256"]:
        raise DeltaError(
            f"delta base mismatch: have {artifact_sha256(base)[:16]}…, "
            f"delta expects {header['baseSha256'][:16]}… (epoch "
            f"{header['fromEpoch']})")
    art = FilterArtifact.from_bytes(base)
    if art.fmt != fmt:
        raise DeltaError(
            f"delta format mismatch: base artifact is {art.fmt}, link "
            f"replays {fmt}")
    groups = {(g.issuer, g.exp_id): g
              for _, g in sorted(art.groups.items())}
    for key in header["removed"]:
        groups.pop(tuple(key), None)
    for entry in header["added"]:
        g = FilterGroup(
            issuer=entry["issuer"], exp_id=entry["expDate"],
            exp_hour=int(entry["expHour"]), ordinal=int(entry["ordinal"]),
            n=int(entry["n"]),
            cascade=FilterCascade(
                fp_rate=header["fpRate"], n_included=int(entry["n"]),
                layers=_layers_from_entry(entry, payload)))
        groups[(g.issuer, g.exp_id)] = g
    for entry in header["patched"]:
        key = (entry["issuer"], entry["expDate"])
        old_g = groups.get(key)
        if old_g is None:
            raise DeltaError(f"patched group {key} absent from base")
        layers = []
        for i, lyr in enumerate(entry["layers"]):
            if lyr["mode"] == "full":
                raw = payload[lyr["off"]: lyr["off"] + lyr["words"]]
                words = np.frombuffer(raw, dtype="<u4").astype(np.uint32)
            elif lyr["mode"] == "xor":
                count = int(lyr["count"])
                idx_raw = payload[lyr["off"]: lyr["off"] + 4 * count]
                xor_raw = payload[lyr["off"] + 4 * count:
                                  lyr["off"] + 8 * count]
                idx = np.frombuffer(idx_raw, dtype="<u4").astype(np.int64)
                xor = np.frombuffer(xor_raw, dtype="<u4")
                if i >= len(old_g.cascade.layers):
                    raise DeltaError(
                        f"xor layer {i} of {key} has no base layer")
                words = old_g.cascade.layers[i].words.astype(np.uint32)
                words = words.copy()
                words[idx] ^= xor.astype(np.uint32)
            else:
                raise DeltaError(f"unknown layer mode {lyr['mode']!r}")
            layers.append(BloomLayer(m=lyr["m"], k=lyr["k"], words=words))
        groups[key] = FilterGroup(
            issuer=entry["issuer"], exp_id=entry["expDate"],
            exp_hour=int(entry["expHour"]), ordinal=int(entry["ordinal"]),
            n=int(entry["n"]),
            cascade=FilterCascade(
                fp_rate=header["fpRate"], n_included=int(entry["n"]),
                layers=layers))
    out = FilterArtifact(
        fp_rate=header["fpRate"],
        groups=[groups[k] for k in sorted(groups)], fmt=fmt).to_bytes()
    got = artifact_sha256(out)
    if got != header["targetSha256"]:
        raise DeltaError(
            f"delta replay hash mismatch: built {got[:16]}…, header "
            f"says {header['targetSha256'][:16]}… (corrupt link?)")
    return out


def apply_chain(base: bytes, deltas: list[bytes]) -> bytes:
    """Replay a chain of consecutive deltas (each link's base check
    enforces the order; each link's target check enforces content)."""
    cur = base
    for d in deltas:
        cur = apply_delta(cur, d)
    return cur


# -- chain manifest -------------------------------------------------------


@dataclass
class ChainLink:
    from_epoch: int
    to_epoch: int
    sha256: str  # of the delta blob itself
    base_sha256: str  # of the from-epoch full artifact
    target_sha256: str  # of the to-epoch full artifact
    n_bytes: int

    def to_json(self) -> dict:
        return {"baseSha256": self.base_sha256, "bytes": self.n_bytes,
                "fromEpoch": self.from_epoch, "sha256": self.sha256,
                "targetSha256": self.target_sha256,
                "toEpoch": self.to_epoch}

    @classmethod
    def from_json(cls, d: dict) -> "ChainLink":
        return cls(from_epoch=int(d["fromEpoch"]),
                   to_epoch=int(d["toEpoch"]), sha256=d["sha256"],
                   base_sha256=d["baseSha256"],
                   target_sha256=d["targetSha256"],
                   n_bytes=int(d["bytes"]))


@dataclass
class ChainManifest:
    """The client-facing integrity root of the delta plane: every
    published link with its own SHA-256, the anchor epochs (full
    snapshots a chain may never cross), and the latest epoch's full
    artifact hash. A client at epoch E validates: (1) a contiguous
    link path E → latest exists, (2) each downloaded link hashes to
    its manifest entry, (3) the replayed bytes hash to
    ``latest_sha256``."""

    latest_epoch: int = -1
    latest_sha256: str = ""
    latest_bytes: int = 0
    anchors: list[int] = field(default_factory=list)
    links: list[ChainLink] = field(default_factory=list)
    # The chain's delta wire format ("CTMRDL01" | "CTMRDL02") — every
    # link in one manifest shares it (compute_delta refuses mixed
    # ends, so a format rev always re-anchors).
    fmt: str = "CTMRDL01"

    def to_json(self) -> dict:
        return {
            "anchors": sorted(self.anchors),
            "format": self.fmt,
            "latestBytes": self.latest_bytes,
            "latestEpoch": self.latest_epoch,
            "latestSha256": self.latest_sha256,
            "links": [li.to_json() for li in
                      sorted(self.links,
                             key=lambda li: (li.from_epoch, li.to_epoch))],
            "version": VERSION,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ChainManifest":
        return cls(latest_epoch=int(d["latestEpoch"]),
                   latest_sha256=d["latestSha256"],
                   latest_bytes=int(d["latestBytes"]),
                   anchors=[int(a) for a in d["anchors"]],
                   links=[ChainLink.from_json(li) for li in d["links"]],
                   fmt=d.get("format", MAGIC.decode()))

    def link_path(self, from_epoch: int,
                  to_epoch: int) -> list[ChainLink] | None:
        """The contiguous link sequence from → to, or None when the
        path is broken (epoch evicted, or an anchor sits strictly
        inside the span — anchored clients must full-pull)."""
        if from_epoch >= to_epoch:
            return None
        by_from = {li.from_epoch: li for li in self.links}
        path = []
        cur = from_epoch
        while cur < to_epoch:
            li = by_from.get(cur)
            if li is None:
                return None
            if li.from_epoch != from_epoch and li.from_epoch in self.anchors:
                return None  # chains never cross an anchor
            path.append(li)
            cur = li.to_epoch
        return path if cur == to_epoch else None

    def validate_chain(self, from_epoch: int, to_epoch: int,
                       deltas: list[bytes]) -> list[ChainLink]:
        """Check downloaded link blobs against the manifest before any
        replay: path contiguity and per-link SHA-256. Returns the
        matching links; raises :class:`DeltaError` on any mismatch
        (truncated, corrupted, or reordered downloads die here)."""
        path = self.link_path(from_epoch, to_epoch)
        if path is None:
            raise DeltaError(
                f"no delta path {from_epoch} -> {to_epoch} in manifest")
        if len(deltas) != len(path):
            raise DeltaError(
                f"chain length mismatch: {len(deltas)} blobs for "
                f"{len(path)} manifest links")
        for li, blob in zip(path, deltas):
            got = hashlib.sha256(blob).hexdigest()
            if got != li.sha256:
                raise DeltaError(
                    f"link {li.from_epoch}->{li.to_epoch} hash mismatch: "
                    f"downloaded {got[:16]}…, manifest {li.sha256[:16]}…")
        return path
