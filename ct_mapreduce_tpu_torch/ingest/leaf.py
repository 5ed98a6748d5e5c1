"""RFC 6962 TLS-structure decoding for CT log entries (a copy of
``ct_mapreduce_tpu.ingest.leaf``).

The reference delegates this to certificate-transparency-go's
``ct.LogEntryFromLeaf`` (reference cmd/ct-fetch/ct-fetch.go:452)
and then stores either the X.509 leaf or the *submitted precertificate*
(``ep.Precert.Submitted``, ct-fetch.go:202-204) plus ``chain[0]`` as
the issuing certificate (ct-fetch.go:221). This module decodes the
same wire structures with a hand-rolled reader — there is no Python CT
library in the image, and the structures are small and stable:

  MerkleTreeLeaf   = version(1) ‖ leaf_type(1) ‖ TimestampedEntry
  TimestampedEntry = timestamp(8) ‖ entry_type(2) ‖ body ‖ extensions<2>
    x509_entry body    = ASN.1Cert<3>
    precert_entry body = issuer_key_hash(32) ‖ TBSCertificate<3>
  extra_data (x509)    = chain: ASN.1Cert<3> list inside a <3> frame
  extra_data (precert) = pre_certificate: ASN.1Cert<3> ‖ chain as above

``<N>`` denotes an N-byte big-endian length prefix (TLS opaque).

Decode failures raise :class:`LeafDecodeError`; callers treat them the
way the reference treats ``LogEntryFromLeaf`` errors — count, log,
skip, never fatal (ct-fetch.go:452-460).
"""

from __future__ import annotations

import base64
import struct
from dataclasses import dataclass, field
from typing import Optional

X509_ENTRY = 0
PRECERT_ENTRY = 1


class LeafDecodeError(ValueError):
    pass


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise LeafDecodeError(
                f"truncated: need {n} bytes at offset {self.pos}, "
                f"have {len(self.buf) - self.pos}"
            )
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def uint(self, width: int) -> int:
        return int.from_bytes(self.take(width), "big")

    def opaque(self, len_width: int) -> bytes:
        return self.take(self.uint(len_width))

    def remaining(self) -> int:
        return len(self.buf) - self.pos


@dataclass
class DecodedEntry:
    """One CT entry, decoded to what the store path needs.

    ``cert_der`` is the certificate the reference stores: the X.509
    leaf for x509 entries, the submitted precertificate (poison
    extension and all) for precert entries. ``issuer_der`` is
    ``chain[0]`` when the chain is non-empty.
    """

    index: int
    timestamp_ms: int
    entry_type: int
    cert_der: bytes
    issuer_der: Optional[bytes]
    chain: list[bytes] = field(default_factory=list)
    issuer_key_hash: Optional[bytes] = None  # precerts only

    @property
    def is_precert(self) -> bool:
        return self.entry_type == PRECERT_ENTRY


def _read_chain(r: _Reader) -> list[bytes]:
    """ASN.1CertChain: an outer <3> frame holding <3>-prefixed certs."""
    frame = _Reader(r.opaque(3))
    chain = []
    while frame.remaining():
        chain.append(frame.opaque(3))
    return chain


def decode_leaf_input(leaf_input: bytes) -> tuple[int, int, bytes, Optional[bytes]]:
    """→ (timestamp_ms, entry_type, body_der, issuer_key_hash).

    For x509 entries ``body_der`` is the full leaf certificate; for
    precert entries it is the TBSCertificate (which the reference does
    NOT store — it stores extra_data's submitted precert instead).
    """
    r = _Reader(leaf_input)
    version = r.uint(1)
    leaf_type = r.uint(1)
    if version != 0 or leaf_type != 0:
        raise LeafDecodeError(
            f"unsupported MerkleTreeLeaf version={version} type={leaf_type}"
        )
    timestamp_ms = r.uint(8)
    entry_type = r.uint(2)
    issuer_key_hash: Optional[bytes] = None
    if entry_type == X509_ENTRY:
        body = r.opaque(3)
    elif entry_type == PRECERT_ENTRY:
        issuer_key_hash = r.take(32)
        body = r.opaque(3)
    else:
        raise LeafDecodeError(f"unknown entry_type {entry_type}")
    r.opaque(2)  # CtExtensions — ignored, like the reference
    return timestamp_ms, entry_type, body, issuer_key_hash


def decode_entry(
    index: int, leaf_input: bytes, extra_data: bytes
) -> DecodedEntry:
    """Decode one get-entries element to the storable certificate."""
    timestamp_ms, entry_type, body, ikh = decode_leaf_input(leaf_input)
    r = _Reader(extra_data)
    if entry_type == X509_ENTRY:
        cert_der = body
        chain = _read_chain(r) if r.remaining() else []
    else:
        cert_der = r.opaque(3)  # the submitted precertificate
        chain = _read_chain(r) if r.remaining() else []
    return DecodedEntry(
        index=index,
        timestamp_ms=timestamp_ms,
        entry_type=entry_type,
        cert_der=cert_der,
        # A zero-length chain[0] counts as no issuer, like the native
        # decoder (ctmr_native.cpp CTMR_NO_CHAIN).
        issuer_der=chain[0] if chain and chain[0] else None,
        chain=chain,
        issuer_key_hash=ikh,
    )


def decode_json_entry(index: int, obj: dict) -> DecodedEntry:
    """Decode one element of a get-entries JSON response. Base64 is
    validated strictly — bad encodings raise :class:`LeafDecodeError`
    (same taxonomy as structural decode failures), keeping this path,
    the Python batch fallback, and the native decoder in agreement."""
    try:
        li = base64.b64decode(obj["leaf_input"], validate=True)
        ed = base64.b64decode(obj.get("extra_data", "") or "", validate=True)
    except (base64.binascii.Error, ValueError) as err:
        raise LeafDecodeError(f"bad base64: {err}") from None
    return decode_entry(index, li, ed)


def leaf_timestamp_ms(leaf_input_b64: str) -> Optional[int]:
    """Timestamp from a base64 leaf_input WITHOUT full decode — reads
    only the first 12 wire bytes (version ‖ type ‖ timestamp). Used by
    the raw-batch path to stamp checkpoints cheaply; returns None on
    any structural surprise."""
    try:
        head = base64.b64decode(leaf_input_b64[:16])
    except (ValueError, base64.binascii.Error):
        return None
    if len(head) < 10 or head[0] != 0 or head[1] != 0:
        return None
    return int.from_bytes(head[2:10], "big")


# ---------------------------------------------------------------------------
# Encoding — used by tests and the synthetic-log replay harness to build
# wire-faithful entries (the reference gets these from real logs).


def encode_leaf_input(
    cert_der: bytes,
    timestamp_ms: int = 0,
    entry_type: int = X509_ENTRY,
    issuer_key_hash: bytes = b"\x00" * 32,
) -> bytes:
    out = [b"\x00\x00", struct.pack(">QH", timestamp_ms, entry_type)]
    if entry_type == PRECERT_ENTRY:
        out.append(issuer_key_hash)
    out.append(len(cert_der).to_bytes(3, "big") + cert_der)
    out.append(b"\x00\x00")  # empty extensions
    return b"".join(out)


def encode_chain(chain: list[bytes]) -> bytes:
    inner = b"".join(len(c).to_bytes(3, "big") + c for c in chain)
    return len(inner).to_bytes(3, "big") + inner


def encode_extra_data(
    chain: list[bytes],
    entry_type: int = X509_ENTRY,
    pre_certificate: Optional[bytes] = None,
) -> bytes:
    if entry_type == PRECERT_ENTRY:
        if pre_certificate is None:
            raise ValueError("precert extra_data needs the submitted precert")
        return (
            len(pre_certificate).to_bytes(3, "big")
            + pre_certificate
            + encode_chain(chain)
        )
    return encode_chain(chain)
