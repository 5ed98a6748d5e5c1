"""Host-side batch packing and the fingerprint/meta schemas.

A copy of ``ct_mapreduce_tpu.core.packing``: the port keeps its own
copy rather than importing the JAX package.

The device pipeline consumes fixed-shape batches; this module is the
single source of truth for their layout, shared by the device ops, the
host reference lane, and the tests:

- **Entry batch**: zero-padded DER bytes ``uint8[B, L]`` + per-lane
  true length, issuer index, and validity mask. ``L`` is chosen from
  power-of-two-ish buckets so XLA compiles a handful of shapes total
  (the streaming analog of the reference's fixed 1000-entry download
  batches, reference cmd/ct-fetch/ct-fetch.go:417).
- **Fingerprint message** (dedup key): ``expHour(4B BE) ‖
  issuerIdx(4B BE) ‖ serialLen(1B) ‖ serial(≤46B)`` hashed with
  SHA-256, low 128 bits kept. Equality of this message ⇔ equality of
  the reference's Redis member ``(serials::<exp>::<issuer>, serial)``
  triple (reference storage/knowncertificates.go:28-55), given
  the run's issuer registry.
- **Meta word**: ``issuerIdx(14b) | expHourOffset(18b)`` stored next
  to each table key so drains can rebuild exact per-(issuer, expDate)
  serial counts.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

MAX_SERIAL_BYTES = 46  # fits a single SHA-256 block with the prefix
FP_MSG_BYTES = 9 + MAX_SERIAL_BYTES  # ≤ 55 ⇒ single block after padding

META_ISSUER_BITS = 14
META_HOUR_BITS = 18
MAX_ISSUERS = 1 << META_ISSUER_BITS
META_HOUR_SPAN = 1 << META_HOUR_BITS  # ~29.9 years of hour buckets

# Default epoch-hour base for the meta word: 2015-08-02T16:00Z. Any cert
# expiring within ~30 years of that is representable; others take the
# host lane.
DEFAULT_BASE_HOUR = 400_000

LENGTH_BUCKETS = (512, 768, 1024, 1536, 2048, 3072, 4096, 6144, 8192)


def length_bucket(n: int) -> int:
    for b in LENGTH_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"certificate of {n} bytes exceeds the largest bucket")


@dataclass
class PackedBatch:
    """A fixed-shape device batch (all NumPy; device_put by the caller)."""

    data: np.ndarray  # uint8[B, L]
    length: np.ndarray  # int32[B]
    issuer_idx: np.ndarray  # int32[B]
    valid: np.ndarray  # bool[B]

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]


def pack_entries(
    entries: list[tuple[bytes, int]],
    batch_size: int | None = None,
    pad_len: int | None = None,
) -> PackedBatch:
    """Pack (der, issuer_idx) pairs into a device batch.

    Lanes beyond ``len(entries)`` are padding (valid=False). Entries
    longer than ``pad_len`` (when forced) raise — callers should route
    such certs to the host lane before packing.
    """
    n = len(entries)
    b = batch_size or n
    if n > b:
        raise ValueError(f"{n} entries > batch size {b}")
    maxlen = max((len(d) for d, _ in entries), default=1)
    l = pad_len or length_bucket(maxlen)
    if maxlen > l:
        raise ValueError(f"entry of {maxlen} bytes > pad length {l}")
    data = np.zeros((b, l), dtype=np.uint8)
    length = np.zeros((b,), dtype=np.int32)
    issuer_idx = np.zeros((b,), dtype=np.int32)
    valid = np.zeros((b,), dtype=bool)
    for i, (der, idx) in enumerate(entries):
        data[i, : len(der)] = np.frombuffer(der, dtype=np.uint8)
        length[i] = len(der)
        issuer_idx[i] = idx
        valid[i] = True
    return PackedBatch(data, length, issuer_idx, valid)


def unpack_meta(meta: int, base_hour: int = DEFAULT_BASE_HOUR) -> tuple[int, int]:
    """meta word → (issuer_idx, exp_hour)."""
    return meta >> META_HOUR_BITS, (meta & (META_HOUR_SPAN - 1)) + base_hour


def fingerprint_message(issuer_idx: int, exp_hour: int, serial: bytes) -> bytes:
    if len(serial) > MAX_SERIAL_BYTES:
        raise ValueError(f"serial of {len(serial)} bytes needs the host lane")
    return (
        int(exp_hour).to_bytes(4, "big", signed=True)
        + int(issuer_idx).to_bytes(4, "big")
        + bytes([len(serial)])
        + serial
    )


def fingerprint_host(issuer_idx: int, exp_hour: int, serial: bytes) -> tuple[int, ...]:
    """Host reference of the device fingerprint: 4 uint32 words.

    Must match :func:`ct_mapreduce_tpu_torch.ops.pipeline.fingerprints`
    exactly — the kernel-parity tests enforce it.
    """
    digest = hashlib.sha256(fingerprint_message(issuer_idx, exp_hour, serial)).digest()
    return tuple(
        int.from_bytes(digest[16 + 4 * i : 20 + 4 * i], "big") for i in range(4)
    )


# FIPS 180-4 SHA-256 constants for the vectorized host fingerprint
# below (duplicated from ops/sha256.py rather than imported: core/
# stays torch-free, and the constants are spec values, not code).
_SHA_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
        0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
        0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
        0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
        0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
        0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
        0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
        0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
        0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
        0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
        0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

_SHA_H0 = np.array(
    [
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    ],
    dtype=np.uint32,
)


def fingerprints_np(
    issuer_idx: np.ndarray,
    exp_hour: np.ndarray,
    serials: np.ndarray,
    serial_len: np.ndarray,
) -> np.ndarray:
    """Vectorized host mirror of the device fingerprint pipeline
    (:func:`ct_mapreduce_tpu_torch.ops.pipeline.fingerprints`):
    ``uint32[n, 4]`` dedup-key words from the sidecar's compact
    per-lane fields, no device round trip. Bytes of ``serials`` past
    ``serial_len`` must
    already be zero (the sidecar serial window guarantees it), exactly
    as the device path assumes.
    """
    n = int(len(issuer_idx))
    if n == 0:
        return np.zeros((0, 4), np.uint32)
    eh = np.asarray(exp_hour).astype(np.uint32)
    ii = np.asarray(issuer_idx).astype(np.uint32)
    slen = np.asarray(serial_len).astype(np.int64)
    msg = np.zeros((n, 64), np.uint8)
    for j, v in enumerate((eh >> 24, eh >> 16, eh >> 8, eh,
                           ii >> 24, ii >> 16, ii >> 8, ii)):
        msg[:, j] = (v & 0xFF).astype(np.uint8)
    msg[:, 8] = (slen & 0xFF).astype(np.uint8)
    msg[:, 9:9 + MAX_SERIAL_BYTES] = np.asarray(serials, np.uint8)
    msg_len = 9 + slen  # ≤ 55: single block after FIPS padding
    msg = np.where(np.arange(64)[None, :] == msg_len[:, None],
                   np.uint8(0x80), msg)
    bits = (msg_len * 8).astype(np.uint32)
    msg[:, 62] = ((bits >> 8) & 0xFF).astype(np.uint8)
    msg[:, 63] = (bits & 0xFF).astype(np.uint8)
    w4 = msg.reshape(n, 16, 4).astype(np.uint32)
    block = ((w4[:, :, 0] << 24) | (w4[:, :, 1] << 16)
             | (w4[:, :, 2] << 8) | w4[:, :, 3])

    def rotr(x: np.ndarray, r: int) -> np.ndarray:
        return ((x >> np.uint32(r)) | (x << np.uint32(32 - r))).astype(
            np.uint32)

    # Message schedule + 64 compression rounds, all wrapping uint32.
    w = np.zeros((64, n), np.uint32)
    w[:16] = block.T
    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (
            w[t - 15] >> np.uint32(3))
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (
            w[t - 2] >> np.uint32(10))
        w[t] = w[t - 16] + s0 + w[t - 7] + s1
    a, b, c, d, e, f, g, h = (
        np.full((n,), _SHA_H0[i], np.uint32) for i in range(8))
    for t in range(64):
        s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + _SHA_K[t] + w[t]
        s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + t2
    digest = np.stack([a, b, c, d, e, f, g, h], axis=1) + _SHA_H0[None, :]
    return digest[:, 4:]  # low 128 bits, like sha256_fingerprint64
