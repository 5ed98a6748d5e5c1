"""CTMRCK02 — incremental epoch checkpoints for the aggregation state
(a copy of ``ct_mapreduce_tpu.agg.ckpt``: the same magic, formats, env
names and write order, so checkpoints move between the two packages).

- The full ``.npz`` snapshot (``ck01``, agg/aggregator.py::_write_npz)
  is the **base** format and the restore oracle.
- Each epoch tick appends one self-delimiting **delta segment**
  (``<path>.ckseg-<seq>``) carrying only that tick's churn: the
  device-table rows the fold paths saw insert, host-lane serial
  additions, and the registry/issuer-total/verify-counter diffs.
- A JSON **manifest** (``<path>.ckmanifest.json``) names the live
  chain. Every segment is hash-chained: ``token_0`` is the SHA-256 of
  the base file's bytes and ``token_i = sha256(token_{i-1} +
  payloadSha_i)``, so a segment never replays onto the wrong base or
  out of order.
- Chains are bounded: after ``ckptMaxChain`` segments the next save is
  a mandatory **anchor** (a fresh base; the chain is dropped).

Crash ordering (tmp + fsync + rename for every file, segment before
manifest, base before manifest): a SIGKILL at any point leaves either
the previous durable tick or the new one. A base whose hash does not
match the manifest's ``baseSha256`` is NEWER than the manifest (a
compaction died between the base rename and the manifest rename) and
is complete by construction, so the loader uses it alone.

The aggregator owns the dirty log and the replay; this module owns
bytes, hashing, chain validation and the resolution of what to replay.
Everything here is a pure function of its inputs.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import struct
import tempfile
import zlib
from typing import Any, NamedTuple, Optional

from ct_mapreduce_tpu_torch.config.profile import (
    Knob,
    pos_int,
    resolve_section,
)

MAGIC = b"CTMRCK02"
FORMAT = "CTMRCK02"
MODE_FULL = "ck01"          # compatibility path: every save is a base
MODE_INCREMENTAL = "ck02"   # base + delta segments (the default)
DEFAULT_MAX_CHAIN = 8
DEFAULT_SEGMENT_BUDGET_MB = 256

# One dirty row: issuer index, expiry hour, serial byte length —
# followed by the serial bytes (the capture spill ring's framing).
REC = struct.Struct("<iqI")
_LEN = struct.Struct("<I")


class CkptError(ValueError):
    """A segment/manifest/chain that cannot be trusted."""


# -- knobs ----------------------------------------------------------------


def _parse_mode(raw: str) -> str:
    return raw.strip().lower()


def _valid_mode(v: Any) -> bool:
    return v in (MODE_FULL, MODE_INCREMENTAL)


_CKPT_KNOBS = (
    Knob(name="checkpointMode", env="CTMR_CHECKPOINT_MODE",
         default=MODE_INCREMENTAL, parse=_parse_mode, is_set=_valid_mode),
    Knob(name="ckptMaxChain", env="CTMR_CKPT_MAX_CHAIN",
         default=DEFAULT_MAX_CHAIN, parse=int, is_set=pos_int),
    Knob(name="ckptSegmentBudgetMB", env="CTMR_CKPT_SEGMENT_BUDGET_MB",
         default=DEFAULT_SEGMENT_BUDGET_MB, parse=int, is_set=pos_int),
)


class CkptKnobs(NamedTuple):
    mode: str
    max_chain: int
    segment_budget_mb: int


def resolve_ckpt(mode: str = "", max_chain: int = 0,
                 segment_budget_mb: int = 0) -> CkptKnobs:
    """The checkpoint plane's knob ladder (explicit > CTMR_* env >
    platformProfile > default). ``mode`` empty / ints <= 0 mean
    "unset" at the explicit layer."""
    r = resolve_section("ckpt", _CKPT_KNOBS, {
        "checkpointMode": _parse_mode(mode) if mode else None,
        "ckptMaxChain": max_chain,
        "ckptSegmentBudgetMB": segment_budget_mb,
    })
    return CkptKnobs(r["checkpointMode"], r["ckptMaxChain"],
                     r["ckptSegmentBudgetMB"])


# -- fault injection (kill-resume tests) ----------------------------------

KILL_ENV = "CTMR_CKPT_KILL"
# Named write points, in write order. "base-*" fire on full/anchor
# saves (compaction included), "seg-*"/"manifest-*" on segment ticks;
# manifest-pre-rename also fires for the fresh manifest a compaction
# writes after its base.
KILL_POINTS = ("seg-pre-rename", "seg-post-rename",
               "base-post-rename", "manifest-pre-rename")

_kill_hits: dict = {}


def kill_point(point: str) -> None:
    """SIGKILL this process when CTMR_CKPT_KILL names this write
    point — the kill-resume tests' way of dying at exactly the
    ordering boundaries the crash proofs argue about. The value is
    either a bare point name (die on the first hit) or "name:N" (die
    on the Nth hit — e.g. "base-post-rename:2" survives the initial
    base save and dies inside the first compaction's anchor write)."""
    spec = os.environ.get(KILL_ENV, "")
    if not spec:
        return
    name, _, nth = spec.partition(":")
    if name != point:
        return
    _kill_hits[name] = _kill_hits.get(name, 0) + 1
    if _kill_hits[name] >= (int(nth) if nth else 1):
        os.kill(os.getpid(), signal.SIGKILL)


# -- paths / hashing ------------------------------------------------------


def manifest_path(path: str) -> str:
    return path + ".ckmanifest.json"


def segment_path(path: str, seq: int) -> str:
    return f"{path}.ckseg-{seq:08d}"


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def chain_token(prev_token: str, payload_sha: str) -> str:
    """token_i from token_{i-1}: binding every segment to its exact
    predecessor (CTMRDL01's baseSha/targetSha discipline)."""
    return hashlib.sha256(
        (prev_token + payload_sha).encode("ascii")).hexdigest()


def _dumps(obj: Any) -> bytes:
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


# -- segment codec --------------------------------------------------------


def encode_segment(seq: int, prev_token: str,
                   dev_rows: list, host_rows: list,
                   blob: dict) -> tuple[bytes, dict]:
    """One delta segment: MAGIC + u32 header length + sorted-key JSON
    header + payload. Payload = dev_rows then host_rows as REC-framed
    (issuer_idx, exp_hour, serial) records, then a zlib-compressed
    sorted-key JSON blob with the non-row diffs. Self-delimiting: the
    header carries every section's byte length."""
    body = bytearray()
    for idx, eh, sb in dev_rows:
        body += REC.pack(int(idx), int(eh), len(sb))
        body += sb
    rows_bytes = len(body)
    for idx, eh, sb in host_rows:
        body += REC.pack(int(idx), int(eh), len(sb))
        body += sb
    host_bytes = len(body) - rows_bytes
    zblob = zlib.compress(_dumps(blob), 6)
    body += zblob
    payload = bytes(body)
    payload_sha = hashlib.sha256(payload).hexdigest()
    header = {
        "format": FORMAT,
        "version": 1,
        "seq": int(seq),
        "devRows": len(dev_rows),
        "devRowBytes": rows_bytes,
        "hostRows": len(host_rows),
        "hostRowBytes": host_bytes,
        "blobBytes": len(zblob),
        "baseSha256": prev_token,
        "payloadSha256": payload_sha,
        "targetSha256": chain_token(prev_token, payload_sha),
    }
    hdr = _dumps(header)
    return MAGIC + _LEN.pack(len(hdr)) + hdr + payload, header


def _parse_records(buf: bytes, n: int) -> list:
    rows = []
    off = 0
    for _ in range(n):
        if off + REC.size > len(buf):
            raise CkptError("segment truncated inside a dirty row")
        idx, eh, slen = REC.unpack_from(buf, off)
        off += REC.size
        if off + slen > len(buf):
            raise CkptError("segment truncated inside serial bytes")
        rows.append((idx, eh, buf[off:off + slen]))
        off += slen
    if off != len(buf):
        raise CkptError("trailing bytes after dirty rows")
    return rows


def decode_segment(data: bytes) -> tuple[dict, list, list, dict]:
    """Validate + decode one segment's bytes →
    (header, dev_rows, host_rows, blob)."""
    if data[:len(MAGIC)] != MAGIC:
        raise CkptError("bad segment magic")
    off = len(MAGIC)
    if len(data) < off + _LEN.size:
        raise CkptError("segment truncated before header")
    (hlen,) = _LEN.unpack_from(data, off)
    off += _LEN.size
    if len(data) < off + hlen:
        raise CkptError("segment truncated inside header")
    try:
        header = json.loads(data[off:off + hlen].decode("utf-8"))
    except ValueError as err:
        raise CkptError(f"unparseable segment header: {err}") from err
    off += hlen
    payload = data[off:]
    want = (header.get("devRowBytes", -1) + header.get("hostRowBytes", -1)
            + header.get("blobBytes", -1))
    if header.get("format") != FORMAT or want != len(payload):
        raise CkptError("segment header does not match payload size")
    payload_sha = hashlib.sha256(payload).hexdigest()
    if payload_sha != header.get("payloadSha256"):
        raise CkptError("segment payload hash mismatch")
    if header.get("targetSha256") != chain_token(
            header.get("baseSha256", ""), payload_sha):
        raise CkptError("segment target token mismatch")
    db = header["devRowBytes"]
    hb = header["hostRowBytes"]
    dev_rows = _parse_records(payload[:db], header["devRows"])
    host_rows = _parse_records(payload[db:db + hb], header["hostRows"])
    try:
        blob = json.loads(zlib.decompress(
            payload[db + hb:]).decode("utf-8"))
    except (ValueError, zlib.error) as err:
        raise CkptError(f"unparseable segment blob: {err}") from err
    return header, dev_rows, host_rows, blob


# -- manifest / atomic writes ---------------------------------------------


def _atomic_write(target: str, data: bytes, pre_rename: str = "",
                  post_rename: str = "") -> None:
    d = os.path.dirname(os.path.abspath(target))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(target),
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        if pre_rename:
            kill_point(pre_rename)
        os.replace(tmp, target)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if post_rename:
        kill_point(post_rename)


def write_segment(path: str, seq: int, data: bytes) -> str:
    sp = segment_path(path, seq)
    _atomic_write(sp, data, pre_rename="seg-pre-rename",
                  post_rename="seg-post-rename")
    return sp


def write_manifest(path: str, manifest: dict) -> None:
    _atomic_write(manifest_path(path), _dumps(manifest) + b"\n",
                  pre_rename="manifest-pre-rename")


def read_manifest(path: str) -> Optional[dict]:
    mp = manifest_path(path)
    if not os.path.exists(mp):
        return None
    try:
        with open(mp, "rb") as fh:
            man = json.loads(fh.read().decode("utf-8"))
    except (OSError, ValueError) as err:
        # Manifests are written atomically: an unreadable one is real
        # damage, not a torn write.
        raise CkptError(f"unreadable checkpoint manifest {mp}: {err}")
    if not isinstance(man, dict) or man.get("format") != FORMAT:
        raise CkptError(f"bad checkpoint manifest format in {mp}")
    return man


def cleanup_segments(path: str, keep_seqs=()) -> None:
    """Best-effort removal of segment files not in ``keep_seqs`` (after
    a compaction dropped the chain). Failures are ignored — orphan
    segments are inert: never loaded unless a manifest names them, and
    overwritten via tmp+rename if their seq is ever reused."""
    import glob as _glob

    keep = {segment_path(path, s) for s in keep_seqs}
    for sp in sorted(_glob.glob(path + ".ckseg-*")):
        if sp not in keep:
            try:
                os.unlink(sp)
            except OSError:
                pass


# -- chain resolution -----------------------------------------------------


class ChainState(NamedTuple):
    base_sha: str        # sha256 of the base file actually on disk
    tip_token: str       # token of the newest durable tick
    segments: list       # [(header, dev_rows, host_rows, blob), ...]


def resolve_chain(path: str) -> ChainState:
    """What must be replayed on top of the base at ``path``.

    - No manifest → plain ck01 snapshot: base alone, tip == base sha.
    - Manifest whose baseSha256 != the base file's actual hash → the
      base is NEWER (a compaction's base landed but its manifest did
      not); the fresh base IS the tick's complete state, so it loads
      alone and the stale chain is ignored.
    - Otherwise every listed segment must exist, decode, and
      hash-chain from the base: the manifest is only ever renamed into
      place AFTER its newest segment, so a broken listed chain is
      damage, not a crash artifact → CkptError.
    """
    base_sha = file_sha256(path)
    man = read_manifest(path)
    if man is None or man.get("baseSha256") != base_sha:
        return ChainState(base_sha, base_sha, [])
    segments = []
    prev = base_sha
    chain = man.get("chain", [])
    if not isinstance(chain, list):
        raise CkptError("manifest chain is not a list")
    for link in chain:
        sp = segment_path(path, int(link["seq"]))
        try:
            with open(sp, "rb") as fh:
                data = fh.read()
        except OSError as err:
            raise CkptError(
                f"manifest names missing segment {sp}: {err}")
        header, dev_rows, host_rows, blob = decode_segment(data)
        if header["baseSha256"] != prev:
            raise CkptError(
                f"segment {sp} chains from {header['baseSha256'][:12]} "
                f"but the durable tip is {prev[:12]}")
        if header["targetSha256"] != link.get("targetSha256"):
            raise CkptError(f"segment {sp} target differs from manifest")
        prev = header["targetSha256"]
        segments.append((header, dev_rows, host_rows, blob))
    return ChainState(base_sha, prev, segments)
