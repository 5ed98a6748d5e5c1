"""Embedded-SCT wire format: extraction, digest convention, fixtures (a
copy of ``ct_mapreduce_tpu.verify.sct``).

An embedded SCT lives in certificate extension OID
1.3.6.1.4.1.11129.2.4.2 as an OCTET STRING holding a TLS-encoded
``SignedCertificateTimestampList`` (RFC 6962 §3.3): per SCT —
version(1) ‖ log_id(32) ‖ timestamp(8, ms) ‖ extensions(2+n) ‖
hash_alg(1) ‖ sig_alg(1) ‖ sig_len(2) ‖ signature. For ECDSA the
signature bytes are a DER ``ECDSA-Sig-Value`` (SEQUENCE of two
INTEGERs).

**Signed-payload convention (RFC 6962 §3.2).** An embedded
SCT signs the *reconstructed precert TBS*: the TBSCertificate with the
SCT-list extension (and any poison extension,
1.3.6.1.4.1.11129.2.4.3) removed and every enclosing DER length
re-encoded minimally, wrapped as a ``precert_entry``:

    version(0x00) ‖ sig_type(0x00) ‖ timestamp(8 BE) ‖
    entry_type(0x0001) ‖ issuer_key_hash(32) ‖
    len3(tbs') ‖ tbs' ‖ ext_len(2 BE) ‖ ext_bytes

where ``tbs'`` = :func:`reconstruct_precert_tbs` and
``issuer_key_hash`` = SHA-256 of the issuing certificate's SPKI DER
(:func:`issuer_key_hash_of`; all-zero when the lane carries no issuer
chain — such lanes can never verify against a real log key, matching
RFC semantics). The digest is independent of the signature bytes
(they live inside the removed extension), which is what lets
:func:`attach_sct` sign-then-patch; real embedded SCTs from production
logs verify against production log keys.

``extract_scts_np`` is the pure-python mirror of the native
``ctmr_extract_scts_v2`` pass (ctmr_native.cpp) — bit-identical
outputs, pinned by tests/test_torch_verify.py — and the fallback when
the native library is unavailable (the PR-1 degradation contract).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from ct_mapreduce_tpu_torch.verify import host

# OID 1.3.6.1.4.1.11129.2.4.2 content bytes.
SCT_OID = bytes.fromhex("2b06010401d679020402")
# OID 1.3.6.1.4.1.11129.2.4.3 — the precert poison extension
# (RFC 6962 §3.1); stripped alongside the SCT list during TBS
# reconstruction so a precert and its final cert sign identically.
POISON_OID = bytes.fromhex("2b06010401d679020403")

# issuer_key_hash for lanes with no issuer chain.
ZERO_IKH = bytes(32)

# Lane status codes (keep in sync with ctmr_native.cpp).
SCT_NONE = 0  # no (parseable) SCT extension on the lane
SCT_OK = 1  # P-256-shaped SCT: digest/r/s/log_id ready for the device
SCT_FALLBACK = 2  # SCT present but not device-decidable (non-ECDSA
# algorithm bytes, oversized integers, malformed TLS/DER innards):
# replay through the pure-python host verifier

HASH_SHA256 = 4
SIG_ECDSA = 3
SIG_RSA = 1


def _tlv(der: bytes, off: int, end: int):
    """One DER TLV header at ``off``: (tag, content_off, content_len)
    or None when malformed/truncated. Matches the native scanner's
    acceptance exactly (definite lengths up to 4 bytes)."""
    if off + 2 > end:
        return None
    tag = der[off]
    first = der[off + 1]
    off += 2
    if first < 0x80:
        length = first
    else:
        nb = first & 0x7F
        if nb == 0 or nb > 4 or off + nb > end:
            return None
        length = int.from_bytes(der[off : off + nb], "big")
        off += nb
    if off + length > end:
        return None
    return tag, off, length


def find_sct_extension(der: bytes):
    """Locate the SCT extension: returns ``(tlv_off, tlv_end, val_off,
    val_end)`` of the extension TLV and its extnValue OCTET STRING
    content, or None. Plain TLV walk (version, serial, sigalg, issuer,
    validity, subject, SPKI, optional [1]/[2], then [3] extensions)."""
    n = len(der)
    t = _tlv(der, 0, n)
    if t is None or t[0] != 0x30:
        return None
    _, cert_off, cert_len = t
    t = _tlv(der, cert_off, cert_off + cert_len)
    if t is None or t[0] != 0x30:
        return None
    _, tbs_off, tbs_len = t
    end = tbs_off + tbs_len
    off = tbs_off
    t = _tlv(der, off, end)
    if t is None:
        return None
    if t[0] == 0xA0:  # explicit [0] version
        off = t[1] + t[2]
    for _ in range(6):  # serial, sigalg, issuer, validity, subject, SPKI
        t = _tlv(der, off, end)
        if t is None:
            return None
        off = t[1] + t[2]
    while off < end:
        t = _tlv(der, off, end)
        if t is None:
            return None
        tag, c_off, c_len = t
        if tag == 0xA3:
            break
        off = c_off + c_len  # [1]/[2] issuer/subjectUniqueID
    else:
        return None
    t = _tlv(der, c_off, c_off + c_len)
    if t is None or t[0] != 0x30:
        return None
    _, seq_off, seq_len = t
    off, end = seq_off, seq_off + seq_len
    while off < end:
        ext = _tlv(der, off, end)
        if ext is None or ext[0] != 0x30:
            return None
        _, e_off, e_len = ext
        ext_end = e_off + e_len
        oid = _tlv(der, e_off, ext_end)
        if oid is None or oid[0] != 0x06:
            return None
        is_sct = der[oid[1] : oid[1] + oid[2]] == SCT_OID
        p = oid[1] + oid[2]
        t2 = _tlv(der, p, ext_end)
        if t2 is not None and t2[0] == 0x01:  # critical BOOLEAN
            p = t2[1] + t2[2]
            t2 = _tlv(der, p, ext_end)
        if t2 is None or t2[0] != 0x04:
            return None
        if is_sct:
            return off, ext_end, t2[1], t2[1] + t2[2]
        off = ext_end
    return None


def find_spki(der: bytes):
    """Locate the subjectPublicKeyInfo TLV: (tlv_off, tlv_end) of the
    full SPKI SEQUENCE (header included), or None. Same acceptance as
    :func:`find_sct_extension`'s walk — SPKI is the sixth field after
    the optional [0] version."""
    n = len(der)
    t = _tlv(der, 0, n)
    if t is None or t[0] != 0x30:
        return None
    t = _tlv(der, t[1], t[1] + t[2])
    if t is None or t[0] != 0x30:
        return None
    _, tbs_off, tbs_len = t
    end = tbs_off + tbs_len
    off = tbs_off
    t = _tlv(der, off, end)
    if t is None:
        return None
    if t[0] == 0xA0:  # explicit [0] version
        off = t[1] + t[2]
    for _ in range(5):  # serial, sigalg, issuer, validity, subject
        t = _tlv(der, off, end)
        if t is None:
            return None
        off = t[1] + t[2]
    t = _tlv(der, off, end)
    if t is None or t[0] != 0x30:
        return None
    return off, t[1] + t[2]


def issuer_key_hash_of(issuer_der: bytes) -> bytes:
    """RFC 6962 issuer_key_hash: SHA-256 over the issuing cert's SPKI
    DER (header included). All-zero when the issuer doesn't parse —
    the lane then carries a hash no real log signed, so it fails
    verification instead of silently passing."""
    win = find_spki(issuer_der)
    if win is None:
        return ZERO_IKH
    return hashlib.sha256(issuer_der[win[0]:win[1]]).digest()


def reconstruct_precert_tbs(der: bytes):
    """RFC 6962 §3.2 TBS reconstruction: the certificate's
    TBSCertificate with every SCT-list and poison extension removed
    and the enclosing lengths ([3] → extensions SEQUENCE → TBS)
    re-encoded minimally. When stripping empties the extensions list,
    the [3] element is omitted entirely. Returns the re-encoded TBS
    bytes (header included), or None when the certificate doesn't
    parse to the extractor's acceptance.

    The native scanner (ctmr_native.cpp ``sctext::digest_lane``)
    streams exactly these bytes into SHA-256 without materializing the
    buffer."""
    n = len(der)
    t = _tlv(der, 0, n)
    if t is None or t[0] != 0x30:
        return None
    t = _tlv(der, t[1], t[1] + t[2])
    if t is None or t[0] != 0x30:
        return None
    _, tbs_off, tbs_len = t
    tbs_end = tbs_off + tbs_len
    off = tbs_off
    t = _tlv(der, off, tbs_end)
    if t is None:
        return None
    if t[0] == 0xA0:
        off = t[1] + t[2]
    for _ in range(6):  # serial, sigalg, issuer, validity, subj, SPKI
        t = _tlv(der, off, tbs_end)
        if t is None:
            return None
        off = t[1] + t[2]
    # Trailing elements: [1]/[2] unique IDs pass through; [3] is the
    # extensions element to rebuild.
    a3_off = None
    while off < tbs_end:
        t = _tlv(der, off, tbs_end)
        if t is None:
            return None
        if t[0] == 0xA3:
            a3_off = off
            a3_end = t[1] + t[2]
            seq = _tlv(der, t[1], a3_end)
            if seq is None or seq[0] != 0x30:
                return None
            seq_off, seq_len = seq[1], seq[2]
            break
        off = t[1] + t[2]
    if a3_off is None:
        # No extensions: the reconstruction is the TBS content as-is
        # (re-wrapped so a non-minimal original length normalizes).
        return _wrap_tlv(0x30, der[tbs_off:tbs_end])
    kept = bytearray()
    p, p_end = seq_off, seq_off + seq_len
    while p < p_end:
        ext = _tlv(der, p, p_end)
        if ext is None or ext[0] != 0x30:
            return None
        ext_end = ext[1] + ext[2]
        oid = _tlv(der, ext[1], ext_end)
        if oid is None or oid[0] != 0x06:
            return None
        o = der[oid[1]:oid[1] + oid[2]]
        if o != SCT_OID and o != POISON_OID:
            kept += der[p:ext_end]
        p = ext_end
    new_exts = b""
    if kept:
        new_exts = _wrap_tlv(0xA3, _wrap_tlv(0x30, bytes(kept)))
    content = der[tbs_off:a3_off] + new_exts + der[a3_end:tbs_end]
    return _wrap_tlv(0x30, content)


@dataclass
class ParsedSct:
    """First SCT of a lane's list, as far as the wire parse got."""

    log_id: bytes
    timestamp_ms: int
    extensions: bytes
    hash_alg: int
    sig_alg: int
    signature: bytes
    version: int


def parse_sct_list(blob: bytes):
    """First SCT of a serialized SCT list, or None when malformed."""
    if len(blob) < 2:
        return None
    total = int.from_bytes(blob[0:2], "big")
    if total + 2 > len(blob) or total < 2:
        return None
    n0 = int.from_bytes(blob[2:4], "big")
    p = 4
    if p + n0 > len(blob) or n0 < 47:  # 1+32+8+2+1+1+2 header minimum
        return None
    end = p + n0
    version = blob[p]
    log_id = blob[p + 1 : p + 33]
    ts = int.from_bytes(blob[p + 33 : p + 41], "big")
    ext_len = int.from_bytes(blob[p + 41 : p + 43], "big")
    q = p + 43
    if q + ext_len + 4 > end:
        return None
    ext = blob[q : q + ext_len]
    q += ext_len
    hash_alg, sig_alg = blob[q], blob[q + 1]
    sig_len = int.from_bytes(blob[q + 2 : q + 4], "big")
    q += 4
    if q + sig_len != end:
        return None
    return ParsedSct(
        log_id=log_id, timestamp_ms=ts, extensions=ext,
        hash_alg=hash_alg, sig_alg=sig_alg, signature=blob[q:end],
        version=version,
    )


def parse_ecdsa_sig(sig: bytes, max_bytes: int = 32):
    """DER ECDSA-Sig-Value → (r, s) ints with both values <
    2^(8·max_bytes), or None. Accepts non-minimal INTEGER paddings up
    to one leading zero byte past max_bytes (the fixed-width fixture
    encoding); anything wider routes to the host fallback."""
    n = len(sig)
    t = _tlv(sig, 0, n)
    if t is None or t[0] != 0x30 or t[1] + t[2] != n:
        return None
    off, end = t[1], t[1] + t[2]
    vals = []
    for _ in range(2):
        t = _tlv(sig, off, end)
        if t is None or t[0] != 0x02 or t[2] < 1:
            return None
        content = sig[t[1] : t[1] + t[2]]
        stripped = content.lstrip(b"\x00") or b"\x00"
        if len(stripped) > max_bytes:
            return None
        vals.append(int.from_bytes(stripped, "big"))
        off = t[1] + t[2]
    if off != end:
        return None
    return vals[0], vals[1]


def sct_digest(der: bytes, tlv_off: int, tlv_end: int,
               timestamp_ms: int, extensions: bytes = b"",
               issuer_key_hash: bytes = ZERO_IKH):
    """The RFC 6962 §3.2 SHA-256 signing digest for one lane's
    embedded SCT (precert_entry over the reconstructed TBS), or None
    when the certificate doesn't reconstruct. ``tlv_off``/``tlv_end``
    are accepted for signature continuity with the older byte-splice
    convention (the reconstruction re-finds and strips every SCT/
    poison extension itself)."""
    del tlv_off, tlv_end
    tbs = reconstruct_precert_tbs(der)
    if tbs is None:
        return None
    payload = (
        b"\x00\x00"
        + timestamp_ms.to_bytes(8, "big")
        + b"\x00\x01"
        + issuer_key_hash
        + len(tbs).to_bytes(3, "big")
        + tbs
        + len(extensions).to_bytes(2, "big")
        + extensions
    )
    return hashlib.sha256(payload).digest()


@dataclass
class SctBatch:
    """Per-lane SCT extraction output for a packed row batch — the
    verification analog of :class:`~ct_mapreduce_tpu_torch.native.leafpack.
    Sidecar`. All arrays length n."""

    ok: np.ndarray  # uint8[n] — SCT_NONE / SCT_OK / SCT_FALLBACK
    digest: np.ndarray  # uint8[n, 32] — convention digest (ok != 0)
    log_id: np.ndarray  # uint8[n, 32]
    timestamp_ms: np.ndarray  # int64[n]
    r: np.ndarray  # uint8[n, 32] big-endian (ok == SCT_OK)
    s: np.ndarray  # uint8[n, 32]
    hash_alg: np.ndarray  # uint8[n]
    sig_alg: np.ndarray  # uint8[n]

    @classmethod
    def empty(cls, n: int) -> "SctBatch":
        return cls(
            ok=np.zeros((n,), np.uint8),
            digest=np.zeros((n, 32), np.uint8),
            log_id=np.zeros((n, 32), np.uint8),
            timestamp_ms=np.zeros((n,), np.int64),
            r=np.zeros((n, 32), np.uint8),
            s=np.zeros((n, 32), np.uint8),
            hash_alg=np.zeros((n,), np.uint8),
            sig_alg=np.zeros((n,), np.uint8),
        )


def extract_sct_lane(der: bytes, issuer_key_hash: bytes = ZERO_IKH):
    """One lane: (status, ParsedSct | None, digest | None, r, s).

    The native scanner implements exactly this classification; keep
    the two in lockstep (parity pinned by the extraction fuzz)."""
    win = find_sct_extension(der)
    if win is None:
        return SCT_NONE, None, None, 0, 0
    tlv_off, tlv_end, v_off, v_end = win
    sct = parse_sct_list(der[v_off:v_end])
    if sct is None:
        return SCT_NONE, None, None, 0, 0
    digest = sct_digest(der, tlv_off, tlv_end, sct.timestamp_ms,
                        sct.extensions, issuer_key_hash)
    if digest is None:  # pragma: no cover - find succeeded, so walk does
        return SCT_NONE, None, None, 0, 0
    if (sct.version != 0 or sct.hash_alg != HASH_SHA256
            or sct.sig_alg != SIG_ECDSA):
        return SCT_FALLBACK, sct, digest, 0, 0
    rs = parse_ecdsa_sig(sct.signature, 32)
    if rs is None:
        return SCT_FALLBACK, sct, digest, 0, 0
    return SCT_OK, sct, digest, rs[0], rs[1]


def extract_scts_np(data: np.ndarray, length: np.ndarray,
                    issuer_key_hash=None) -> SctBatch:
    """Python extraction over packed rows uint8[n, pad] + int32[n]
    lengths — the no-native fallback (and the native pass's parity
    reference). ``issuer_key_hash``: uint8[n, 32] per-lane issuer key
    hashes (None → all-zero: no issuer chain)."""
    n = int(data.shape[0])
    out = SctBatch.empty(n)
    for i in range(n):
        ln = int(length[i])
        if ln <= 0:
            continue
        der = data[i, :ln].tobytes()
        ikh = (ZERO_IKH if issuer_key_hash is None
               else bytes(issuer_key_hash[i]))
        status, sct, digest, r, s = extract_sct_lane(der, ikh)
        out.ok[i] = status
        if sct is None:
            continue
        out.digest[i] = np.frombuffer(digest, np.uint8)
        out.log_id[i] = np.frombuffer(sct.log_id, np.uint8)
        out.timestamp_ms[i] = sct.timestamp_ms
        out.hash_alg[i] = sct.hash_alg
        out.sig_alg[i] = sct.sig_alg
        if status == SCT_OK:
            out.r[i] = np.frombuffer(r.to_bytes(32, "big"), np.uint8)
            out.s[i] = np.frombuffer(s.to_bytes(32, "big"), np.uint8)
    return out


# -- fixture signers + DER surgery --------------------------------------

# Deterministic 1023-bit RSA fixture key (test-only; generated once,
# seeded miller-rabin — no host can "regenerate" it wrong).
RSA_FIXTURE_N = int(
    "663b77f7b119250800268282b0a06532bf8a474366749630f66def6cb969f15b"
    "049e0e1ea899adbed610df45822154d8e9994b844ea259a87b7a0dcf1f3d78e3"
    "2bc898d63d6f52726894d6c2cae7f1c7223bd0eac13d66b6c8c7a39961d1978b"
    "d5504aaa60275d378e265fa82f466357f4ffdddde8c9929a53958ad88f0b3e6b",
    16,
)
RSA_FIXTURE_E = 65537
RSA_FIXTURE_D = int(
    "1b2fad537d1106bbfdee3fbea961be07a4d00ceb6b8f8d712fd7445851664efc"
    "b9599ebfa06e5db9e60b4e94996a6bb9d34524c3e6755e0a63ebad486b3259b7"
    "18dff82e62c7f9385643845f8594a7269f9e32cc517592b6a82f3315b8f4dd03"
    "3587c3ecfff7a4ea32683c9ca456425765c17c450c3a581f7dd87ff0be701c81",
    16,
)


def _fixed_ecdsa_der(r: int, s: int, width: int) -> bytes:
    """Fixed-length ECDSA-Sig-Value: both INTEGERs padded to
    ``width + 1`` content bytes (leading 0x00) so the signature length
    — and with it the SCT extension length, and with *it* the signed
    splice — is known before signing."""
    def part(v: int) -> bytes:
        body = b"\x00" + v.to_bytes(width, "big")
        return bytes([0x02, len(body)]) + body

    body = part(r) + part(s)
    return bytes([0x30, len(body)]) + body


class EcSctSigner:
    """Deterministic fixture log key on a named curve. P-256 keys are
    device-decidable; anything else routes to the host fallback."""

    def __init__(self, seed: str, curve: host.Curve = host.P256):
        self.seed = seed
        self.curve = curve
        self.d = host.derive_scalar(seed, curve)
        self.q = host._point_mul(curve, self.d, (curve.gx, curve.gy))
        w = curve.byte_len
        self.log_id = hashlib.sha256(
            b"ctmr-log-v1:" + curve.name.encode() + b":"
            + self.q[0].to_bytes(w, "big") + self.q[1].to_bytes(w, "big")
        ).digest()
        self.hash_alg = HASH_SHA256
        self.sig_alg = SIG_ECDSA
        self.sig_len = 2 + 2 * (2 + curve.byte_len + 1)

    def sign(self, digest: bytes) -> bytes:
        k = host.derive_nonce(self.seed, digest, self.curve)
        r, s = host.sign_ecdsa(self.curve, digest, self.d, k)
        return _fixed_ecdsa_der(r, s, self.curve.byte_len)

    def key_entry(self) -> dict:
        return {
            "log_id": self.log_id.hex(),
            "alg": self.curve.name,
            "x": hex(self.q[0]),
            "y": hex(self.q[1]),
        }


class RsaSctSigner:
    """RSA PKCS#1-v1.5 fixture log key — always a host-fallback lane."""

    def __init__(self, n: int = RSA_FIXTURE_N, e: int = RSA_FIXTURE_E,
                 d: int = RSA_FIXTURE_D):
        self.n, self.e, self.d = n, e, d
        k = (n.bit_length() + 7) // 8
        self.log_id = hashlib.sha256(
            b"ctmr-log-v1:rsa:" + n.to_bytes(k, "big")
            + e.to_bytes(4, "big")
        ).digest()
        self.hash_alg = HASH_SHA256
        self.sig_alg = SIG_RSA
        self.sig_len = k

    def sign(self, digest: bytes) -> bytes:
        return host.sign_rsa_pkcs1_sha256(digest, self.n, self.d)

    def key_entry(self) -> dict:
        return {
            "log_id": self.log_id.hex(),
            "alg": "rsa",
            "n": hex(self.n),
            "e": hex(self.e),
        }


def _wrap_tlv(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        return bytes([tag, n]) + content
    if n < 0x100:
        return bytes([tag, 0x81, n]) + content
    if n < 0x10000:
        return bytes([tag, 0x82, n >> 8, n & 0xFF]) + content
    return bytes([tag, 0x83, n >> 16, (n >> 8) & 0xFF, n & 0xFF]) + content


def build_sct_list(log_id: bytes, timestamp_ms: int, hash_alg: int,
                   sig_alg: int, signature: bytes,
                   extensions: bytes = b"") -> bytes:
    """Serialize a one-SCT SignedCertificateTimestampList."""
    sct = (
        b"\x00" + log_id + timestamp_ms.to_bytes(8, "big")
        + len(extensions).to_bytes(2, "big") + extensions
        + bytes([hash_alg, sig_alg])
        + len(signature).to_bytes(2, "big") + signature
    )
    body = len(sct).to_bytes(2, "big") + sct
    return len(body).to_bytes(2, "big") + body


def attach_sct(der: bytes, signer, timestamp_ms: int,
               extensions: bytes = b"",
               corrupt_signature: bool = False,
               issuer_key_hash: bytes = ZERO_IKH,
               issuer_der: bytes = b"") -> bytes:
    """Embed a signed SCT into an existing certificate by DER surgery.

    The SCT extension is appended as the LAST extension (creating the
    [3] list if absent), with a zeroed fixed-length signature; the
    RFC 6962 digest is computed over the reconstructed TBS (which
    excludes the whole extension, hence the signature), the signer
    signs it, and the signature bytes are patched in place.
    ``corrupt_signature`` flips a bit post-signing (failing fixture).
    The signed issuer_key_hash comes from ``issuer_der`` (the issuing
    cert, hashed via :func:`issuer_key_hash_of`) or raw
    ``issuer_key_hash``; default all-zero matches lanes ingested
    without an issuer chain.
    """
    if issuer_der:
        issuer_key_hash = issuer_key_hash_of(issuer_der)
    n = len(der)
    t = _tlv(der, 0, n)
    if t is None or t[0] != 0x30:
        raise ValueError("not a certificate SEQUENCE")
    _, cert_off, cert_len = t
    tbs = _tlv(der, cert_off, cert_off + cert_len)
    if tbs is None or tbs[0] != 0x30:
        raise ValueError("no TBSCertificate")
    tbs_off, tbs_len = tbs[1], tbs[2]
    tbs_end = tbs_off + tbs_len
    rest = der[tbs_end:]  # signatureAlgorithm + signatureValue TLVs
    tbs_content = der[tbs_off:tbs_end]

    placeholder = bytes(signer.sig_len)
    ext_value = build_sct_list(
        signer.log_id, timestamp_ms, signer.hash_alg, signer.sig_alg,
        placeholder, extensions,
    )
    sct_ext = _wrap_tlv(
        0x30, _wrap_tlv(0x06, SCT_OID) + _wrap_tlv(0x04, ext_value)
    )

    # Split the TBS content at the [3] extensions element (if any).
    off = tbs_off
    t2 = _tlv(der, off, tbs_end)
    if t2 is not None and t2[0] == 0xA0:
        off = t2[1] + t2[2]
    for _ in range(6):
        t2 = _tlv(der, off, tbs_end)
        if t2 is None:
            raise ValueError("truncated TBSCertificate")
        off = t2[1] + t2[2]
    head = der[tbs_off:off]
    exts_content = b""
    while off < tbs_end:
        t2 = _tlv(der, off, tbs_end)
        if t2 is None:
            raise ValueError("bad trailing TBS element")
        if t2[0] == 0xA3:
            seq = _tlv(der, t2[1], t2[1] + t2[2])
            if seq is None or seq[0] != 0x30:
                raise ValueError("bad extensions element")
            exts_content = der[seq[1] : seq[1] + seq[2]]
            off = t2[1] + t2[2]
            break
        head += der[off : t2[1] + t2[2]]
        off = t2[1] + t2[2]
    head += der[off:tbs_end]  # anything after [3] (none in practice)

    new_exts = _wrap_tlv(0xA3, _wrap_tlv(0x30, exts_content + sct_ext))
    new_tbs = _wrap_tlv(0x30, head + new_exts)
    new_cert = _wrap_tlv(0x30, new_tbs + rest)

    win = find_sct_extension(new_cert)
    if win is None:
        raise RuntimeError("embedded SCT extension not found back")
    tlv_off, tlv_end, v_off, _v_end = win
    digest = sct_digest(new_cert, tlv_off, tlv_end, timestamp_ms,
                        extensions, issuer_key_hash)
    if digest is None:
        raise RuntimeError("TBS reconstruction failed on own output")
    sig = bytearray(signer.sign(digest))
    if len(sig) != signer.sig_len:
        raise RuntimeError("signer broke its fixed-length contract")
    if corrupt_signature:
        sig[-1] ^= 0x01
    sig_off = v_off + 4 + 1 + 32 + 8 + 2 + len(extensions) + 1 + 1 + 2
    out = bytearray(new_cert)
    out[sig_off : sig_off + len(sig)] = sig
    return bytes(out)


def host_verify_sct(digest: bytes, sct: ParsedSct, key: dict) -> bool:
    """The host-lane verdict for one extracted SCT against a registry
    key entry (see :class:`~ct_mapreduce_tpu_torch.verify.lane.
    LogKeyRegistry`). Malformed-for-its-algorithm signatures fail
    closed; the caller has already resolved key presence."""
    if sct.version != 0 or sct.hash_alg != HASH_SHA256:
        return False
    alg = key.get("alg")
    if alg == "rsa":
        if sct.sig_alg != SIG_RSA:
            return False
        return host.verify_rsa_pkcs1_sha256(
            digest, sct.signature, int(key["n"], 16), int(key["e"], 16)
        )
    curve = host.CURVES.get(alg)
    if curve is None or sct.sig_alg != SIG_ECDSA:
        return False
    rs = parse_ecdsa_sig(sct.signature, curve.byte_len)
    if rs is None:
        return False
    return host.verify_ecdsa(
        curve, digest, rs[0], rs[1], int(key["x"], 16), int(key["y"], 16)
    )
