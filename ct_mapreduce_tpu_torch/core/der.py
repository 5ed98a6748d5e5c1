"""Minimal pure-Python DER/X.509 field extraction.

A copy of ``ct_mapreduce_tpu.core.der`` (the port imports nothing of
the JAX package). It is the *reference lane* of the framework: a
dependency-free TLV walker that extracts the fields the DER walker
extracts. The port uses it for the exact host lane and for the CRL/DN
metadata fold: lanes the pre-parsed device step cannot take exactly (the
reference tolerates per-entry parse errors and skips bad entries:
reference cmd/ct-fetch/ct-fetch.go:206-225, so a reject-to-host
lane is contract-compatible).

Field semantics mirror the reference:
  - raw serial content bytes including leading zeros
    (reference storage/types.go:165-178)
  - expiry bucketed to epoch-hour (reference storage/types.go:339-346)
  - issuer CommonName for the CN-prefix filter
    (reference cmd/ct-fetch/ct-fetch.go:56-62)
  - BasicConstraints CA flag (reference cmd/ct-fetch/ct-fetch.go:47-50)
  - CRL distribution point URIs
    (reference storage/issuermetadata.go:48-73)
"""

from __future__ import annotations

import base64
from dataclasses import dataclass, field
from datetime import datetime, timezone

# Universal tags
TAG_BOOLEAN = 0x01
TAG_INTEGER = 0x02
TAG_BIT_STRING = 0x03
TAG_OCTET_STRING = 0x04
TAG_OID = 0x06
TAG_UTF8_STRING = 0x0C
TAG_SEQUENCE = 0x30
TAG_SET = 0x31
TAG_PRINTABLE_STRING = 0x13
TAG_T61_STRING = 0x14
TAG_IA5_STRING = 0x16
TAG_UTC_TIME = 0x17
TAG_GENERALIZED_TIME = 0x18

OID_BASIC_CONSTRAINTS = bytes([0x55, 0x1D, 0x13])  # 2.5.29.19
OID_CRL_DISTRIBUTION_POINTS = bytes([0x55, 0x1D, 0x1F])  # 2.5.29.31
OID_COMMON_NAME = bytes([0x55, 0x04, 0x03])  # 2.5.4.3

# Attribute-type abbreviations used by Go's pkix.Name.String()
_DN_ABBREVIATIONS = {
    bytes([0x55, 0x04, 0x03]): "CN",
    bytes([0x55, 0x04, 0x05]): "SERIALNUMBER",
    bytes([0x55, 0x04, 0x06]): "C",
    bytes([0x55, 0x04, 0x07]): "L",
    bytes([0x55, 0x04, 0x08]): "ST",
    bytes([0x55, 0x04, 0x09]): "STREET",
    bytes([0x55, 0x04, 0x0A]): "O",
    bytes([0x55, 0x04, 0x0B]): "OU",
    bytes([0x55, 0x04, 0x11]): "POSTALCODE",
}


class DerError(ValueError):
    """Malformed DER structure."""


def read_tlv(buf: bytes, off: int) -> tuple[int, int, int]:
    """Read one TLV header at `off`.

    Returns (tag, content_length, content_offset). Only single-byte tags
    are supported (sufficient for X.509). Long-form lengths up to 4
    bytes are handled, matching the device kernel's window.
    """
    if off >= len(buf):
        raise DerError(f"TLV offset {off} beyond buffer of {len(buf)}")
    tag = buf[off]
    if tag & 0x1F == 0x1F:
        raise DerError(f"Multi-byte tag at {off} unsupported")
    if off + 1 >= len(buf):
        raise DerError("Truncated TLV length")
    first = buf[off + 1]
    if first < 0x80:
        length, content_off = first, off + 2
    else:
        n = first & 0x7F
        if n == 0 or n > 4:
            raise DerError(f"Unsupported length-of-length {n} at {off}")
        if off + 2 + n > len(buf):
            raise DerError("Truncated long-form length")
        length = int.from_bytes(buf[off + 2 : off + 2 + n], "big")
        content_off = off + 2 + n
    if content_off + length > len(buf):
        raise DerError(
            f"TLV at {off} (len {length}) overruns buffer of {len(buf)}"
        )
    return tag, length, content_off


def _skip(buf: bytes, off: int) -> int:
    """Offset just past the TLV starting at `off`."""
    _, length, content_off = read_tlv(buf, off)
    return content_off + length


def parse_time(tag: int, content: bytes) -> datetime:
    """Parse UTCTime / GeneralizedTime per RFC 5280."""
    s = content.decode("ascii")
    if tag == TAG_UTC_TIME:
        if not s.endswith("Z") or len(s) != 13:
            raise DerError(f"Bad UTCTime {s!r}")
        yy = int(s[0:2])
        year = 2000 + yy if yy < 50 else 1900 + yy
        rest = s[2:12]
    elif tag == TAG_GENERALIZED_TIME:
        if not s.endswith("Z") or len(s) != 15:
            raise DerError(f"Bad GeneralizedTime {s!r}")
        year = int(s[0:4])
        rest = s[4:14]
    else:
        raise DerError(f"Not a time tag: {tag:#x}")
    return datetime(
        year,
        int(rest[0:2]),
        int(rest[2:4]),
        int(rest[4:6]),
        int(rest[6:8]),
        int(rest[8:10]),
        tzinfo=timezone.utc,
    )


def _escape_dn_value(value: str) -> str:
    """RFC 2253-style escaping, matching Go pkix.Name.String()."""
    out = []
    for i, ch in enumerate(value):
        escape = ch in ",+\"\\<>;"
        if i == 0 and ch in " #":
            escape = True
        if i == len(value) - 1 and ch == " ":
            escape = True
        out.append("\\" + ch if escape else ch)
    return "".join(out)


@dataclass
class NameAttribute:
    oid: bytes
    value: str


def parse_name(buf: bytes, off: int) -> tuple[list[list[NameAttribute]], int]:
    """Parse an X.501 Name (SEQUENCE OF RDN) starting at `off`.

    Returns (RDNs in encoded order — each a list of attributes in
    encoded order, preserving multi-valued RDN structure — and the
    offset past the Name).
    """
    tag, length, content_off = read_tlv(buf, off)
    if tag != TAG_SEQUENCE:
        raise DerError(f"Name is not a SEQUENCE (tag {tag:#x})")
    end = content_off + length
    rdns: list[list[NameAttribute]] = []
    pos = content_off
    while pos < end:
        set_tag, set_len, set_off = read_tlv(buf, pos)
        if set_tag != TAG_SET:
            raise DerError(f"RDN is not a SET (tag {set_tag:#x})")
        set_end = set_off + set_len
        if set_end > end:
            raise DerError("RDN SET overruns its Name")
        apos = set_off
        rdn: list[NameAttribute] = []
        while apos < set_end:
            seq_tag, seq_len, seq_off = read_tlv(buf, apos)
            if seq_tag != TAG_SEQUENCE:
                raise DerError("AttributeTypeAndValue is not a SEQUENCE")
            seq_end = seq_off + seq_len
            if seq_end > set_end:
                raise DerError("AttributeTypeAndValue overruns its RDN")
            oid_tag, oid_len, oid_off = read_tlv(buf, seq_off)
            if oid_tag != TAG_OID:
                raise DerError("Attribute type is not an OID")
            oid = bytes(buf[oid_off : oid_off + oid_len])
            val_tag, val_len, val_off = read_tlv(buf, oid_off + oid_len)
            if val_off + val_len > seq_end:
                # A child escaping its parent TLV silently re-windows
                # identity bytes (the CN window would disagree with the
                # device walker's) — structurally invalid, reject.
                raise DerError("attribute value overruns its ATV frame")
            raw = bytes(buf[val_off : val_off + val_len])
            try:
                value = raw.decode("utf-8")
            except UnicodeDecodeError:
                value = raw.decode("latin-1")
            rdn.append(NameAttribute(oid=oid, value=value))
            apos = seq_off + seq_len
        rdns.append(rdn)
        pos = set_end
    return rdns, end


# pkix.Name.ToRDNSequence appends attribute groups in this fixed order
# (certificate-transparency-go x509/pkix, Go 1.13-era fork); String()
# then renders the sequence reversed.
_GO_CANONICAL_ORDER = [
    bytes([0x55, 0x04, 0x06]),  # C
    bytes([0x55, 0x04, 0x08]),  # ST
    bytes([0x55, 0x04, 0x07]),  # L
    bytes([0x55, 0x04, 0x09]),  # STREET
    bytes([0x55, 0x04, 0x11]),  # POSTALCODE
    bytes([0x55, 0x04, 0x0A]),  # O
    bytes([0x55, 0x04, 0x0B]),  # OU
    bytes([0x55, 0x04, 0x03]),  # CN (single-valued, last occurrence wins)
    bytes([0x55, 0x04, 0x05]),  # SERIALNUMBER (single-valued, last wins)
]
_GO_SINGLE_VALUED = {bytes([0x55, 0x04, 0x03]), bytes([0x55, 0x04, 0x05])}


def render_dn(rdns: list[list[NameAttribute]]) -> str:
    """Render a DN the way the reference observes it: Go
    pkix.Name.String() == FillFromRDNSequence → ToRDNSequence → String.

    Go *canonicalizes*: attributes are regrouped by type into the fixed
    order C, ST, L, STREET, POSTALCODE, O, OU, CN, SERIALNUMBER (one RDN
    per type, multi-valued types '+'-joined), the sequence is rendered
    reversed, CN/SERIALNUMBER keep only the last occurrence, and
    attribute types outside that set are dropped. The reference stores
    aCert.Issuer.String() into the issuer::<id> set
    (reference storage/issuermetadata.go:92-94), so cache parity
    requires reproducing this exactly rather than RFC 4514 structure
    preservation."""
    by_type: dict[bytes, list[str]] = {}
    for rdn in rdns:
        for attr in rdn:
            if attr.oid in _GO_SINGLE_VALUED:
                by_type[attr.oid] = [attr.value]  # last occurrence wins
            elif attr.oid in _DN_ABBREVIATIONS:
                by_type.setdefault(attr.oid, []).append(attr.value)
    parts = []
    for oid in reversed(_GO_CANONICAL_ORDER):
        values = by_type.get(oid)
        if not values:
            continue
        abbrev = _DN_ABBREVIATIONS[oid]
        parts.append(
            "+".join(f"{abbrev}={_escape_dn_value(v)}" for v in values)
        )
    return ",".join(parts)


def common_name(rdns: list[list[NameAttribute]]) -> str:
    """The CommonName, last occurrence winning — Go pkix
    FillFromRDNSequence overwrites CommonName per occurrence."""
    cn = ""
    for rdn in rdns:
        for attr in rdn:
            if attr.oid == OID_COMMON_NAME:
                cn = attr.value
    return cn


@dataclass
class CertFields:
    """Everything the pipeline needs from one certificate."""

    serial: bytes
    not_before: datetime
    not_after: datetime
    issuer_dn: str
    issuer_cn: str
    subject_dn: str
    spki: bytes
    is_ca: bool
    basic_constraints_valid: bool
    crl_distribution_points: list[str] = field(default_factory=list)
    # Structural offsets for device-kernel parity tests:
    serial_off: int = 0
    serial_len: int = 0
    spki_off: int = 0
    spki_len: int = 0
    not_after_tag_off: int = 0
    issuer_off: int = 0
    issuer_len: int = 0
    tbs_off: int = 0
    tbs_len: int = 0

    @property
    def not_after_unix_hour(self) -> int:
        return int(self.not_after.timestamp()) // 3600


def raw_serial_bytes(der: bytes) -> bytes:
    """Extract the raw serialNumber content bytes, preserving leading
    zeros (reference storage/types.go:165-178)."""
    _, _, cert_off = read_tlv(der, 0)
    _, _, tbs_off = read_tlv(der, cert_off)
    pos = tbs_off
    tag, _, _ = read_tlv(der, pos)
    if tag == 0xA0:  # [0] EXPLICIT version
        pos = _skip(der, pos)
    tag, length, content_off = read_tlv(der, pos)
    if tag != TAG_INTEGER:
        raise DerError(f"serialNumber is not an INTEGER (tag {tag:#x})")
    return bytes(der[content_off : content_off + length])


def _parse_general_names_uris(buf: bytes, off: int, end: int) -> list[str]:
    """Collect uniformResourceIdentifier ([6]) GeneralNames in [off, end)."""
    uris = []
    pos = off
    while pos < end:
        tag, length, content_off = read_tlv(buf, pos)
        if tag == 0x86:  # context [6] primitive: URI
            uris.append(bytes(buf[content_off : content_off + length]).decode("latin-1"))
        pos = content_off + length
    return uris


def _parse_crldp(buf: bytes, off: int) -> list[str]:
    """CRLDistributionPoints ::= SEQUENCE OF DistributionPoint."""
    uris: list[str] = []
    seq_tag, seq_len, seq_off = read_tlv(buf, off)
    if seq_tag != TAG_SEQUENCE:
        return uris
    end = seq_off + seq_len
    pos = seq_off
    while pos < end:
        dp_tag, dp_len, dp_off = read_tlv(buf, pos)
        if dp_tag == TAG_SEQUENCE:
            dp_end = dp_off + dp_len
            inner = dp_off
            while inner < dp_end:
                f_tag, f_len, f_off = read_tlv(buf, inner)
                if f_tag == 0xA0:  # [0] distributionPoint
                    g_tag, g_len, g_off = read_tlv(buf, f_off)
                    if g_tag == 0xA0:  # [0] fullName: GeneralNames
                        uris.extend(_parse_general_names_uris(buf, g_off, g_off + g_len))
                inner = f_off + f_len
        pos = dp_off + dp_len
    return uris


def _parse_basic_constraints(buf: bytes, off: int,
                             end: int | None = None) -> bool:
    """BasicConstraints ::= SEQUENCE { cA BOOLEAN DEFAULT FALSE, ... }"""
    tag, length, content_off = read_tlv(buf, off)
    if tag != TAG_SEQUENCE or length == 0:
        return False
    if end is not None and content_off + length > end:
        # The inner SEQUENCE escaping its extnValue window would read
        # the cA flag from bytes outside the extension (the device
        # walker's windowed read rejects this) — invalid, reject.
        raise DerError("BasicConstraints overruns its extnValue")
    b_tag, b_len, b_off = read_tlv(buf, content_off)
    return b_tag == TAG_BOOLEAN and b_len == 1 and buf[b_off] != 0x00


def parse_cert(der: bytes) -> CertFields:
    """Full field extraction from one DER certificate."""
    cert_tag, cert_len, cert_off = read_tlv(der, 0)
    if cert_tag != TAG_SEQUENCE:
        raise DerError("Certificate is not a SEQUENCE")
    tbs_tag, tbs_len, tbs_content = read_tlv(der, cert_off)
    if tbs_tag != TAG_SEQUENCE:
        raise DerError("TBSCertificate is not a SEQUENCE")

    pos = tbs_content
    tag, _, _ = read_tlv(der, pos)
    if tag == 0xA0:  # [0] EXPLICIT version
        pos = _skip(der, pos)

    # serialNumber
    tag, serial_len, serial_off = read_tlv(der, pos)
    if tag != TAG_INTEGER:
        raise DerError("serialNumber is not an INTEGER")
    serial = bytes(der[serial_off : serial_off + serial_len])
    pos = serial_off + serial_len

    # signature AlgorithmIdentifier
    pos = _skip(der, pos)

    # issuer Name
    issuer_start = pos
    issuer_rdns, pos = parse_name(der, pos)
    issuer_end = pos
    issuer_dn = render_dn(issuer_rdns)
    issuer_cn = common_name(issuer_rdns)

    # validity
    val_tag, val_len, val_off = read_tlv(der, pos)
    if val_tag != TAG_SEQUENCE:
        raise DerError("validity is not a SEQUENCE")
    nb_tag, nb_len, nb_off = read_tlv(der, val_off)
    not_before = parse_time(nb_tag, der[nb_off : nb_off + nb_len])
    na_tag_off = nb_off + nb_len
    na_tag, na_len, na_off = read_tlv(der, na_tag_off)
    not_after = parse_time(na_tag, der[na_off : na_off + na_len])
    pos = val_off + val_len

    # subject Name
    subject_rdns, pos = parse_name(der, pos)
    subject_dn = render_dn(subject_rdns)

    # subjectPublicKeyInfo — raw DER range (identity is SHA-256 of this:
    # reference storage/types.go:109-115,155-159)
    spki_start = pos
    spki_tag, spki_content_len, spki_content_off = read_tlv(der, pos)
    if spki_tag != TAG_SEQUENCE:
        raise DerError("subjectPublicKeyInfo is not a SEQUENCE")
    spki_end = spki_content_off + spki_content_len
    spki = bytes(der[spki_start:spki_end])
    pos = spki_end

    # optional issuerUniqueID [1], subjectUniqueID [2], extensions [3]
    is_ca = False
    bc_valid = False
    crldps: list[str] = []
    tbs_end = tbs_content + tbs_len
    while pos < tbs_end:
        tag, length, content_off = read_tlv(der, pos)
        if tag == 0xA3:  # [3] EXPLICIT extensions
            ext_seq_tag, ext_seq_len, ext_seq_off = read_tlv(der, content_off)
            if ext_seq_tag == TAG_SEQUENCE:
                epos = ext_seq_off
                eend = ext_seq_off + ext_seq_len
                while epos < eend:
                    e_tag, e_len, e_off = read_tlv(der, epos)
                    if e_tag == TAG_SEQUENCE:
                        o_tag, o_len, o_off = read_tlv(der, e_off)
                        if o_tag == TAG_OID:
                            oid = bytes(der[o_off : o_off + o_len])
                            vpos = o_off + o_len
                            v_tag, v_len, v_off = read_tlv(der, vpos)
                            if v_tag == TAG_BOOLEAN:  # critical flag
                                vpos = v_off + v_len
                                v_tag, v_len, v_off = read_tlv(der, vpos)
                            if v_off + v_len > e_off + e_len:
                                # extnValue overruns its Extension
                                # frame: structurally invalid (Go's
                                # asn1 errors on this; the device
                                # walker's windowed read rejects it
                                # too — caught by the mutation fuzz).
                                raise DerError(
                                    "extnValue overruns Extension frame"
                                )
                            if v_tag == TAG_OCTET_STRING:
                                if oid == OID_BASIC_CONSTRAINTS:
                                    bc_valid = True
                                    is_ca = _parse_basic_constraints(
                                        der, v_off, v_off + v_len)
                                elif oid == OID_CRL_DISTRIBUTION_POINTS:
                                    crldps = _parse_crldp(der, v_off)
                    epos = e_off + e_len
        pos = content_off + length

    return CertFields(
        serial=serial,
        not_before=not_before,
        not_after=not_after,
        issuer_dn=issuer_dn,
        issuer_cn=issuer_cn,
        subject_dn=subject_dn,
        spki=spki,
        is_ca=is_ca,
        basic_constraints_valid=bc_valid,
        crl_distribution_points=crldps,
        serial_off=serial_off,
        serial_len=serial_len,
        spki_off=spki_start,
        spki_len=spki_end - spki_start,
        not_after_tag_off=na_tag_off,
        issuer_off=issuer_start,
        issuer_len=issuer_end - issuer_start,
        tbs_off=cert_off,
        tbs_len=_skip(der, cert_off) - cert_off,
    )


def pem_to_der(pem: bytes | str) -> bytes:
    """Decode the first PEM CERTIFICATE block (or pass DER through)."""
    if isinstance(pem, str):
        pem = pem.encode("ascii")
    # Accept files with leading text (e.g. `openssl x509 -text` output)
    if b"-----BEGIN" not in pem:
        return bytes(pem)
    pem = pem[pem.index(b"-----BEGIN") :]
    lines = []
    inside = False
    for line in pem.splitlines():
        line = line.strip()
        if line.startswith(b"-----BEGIN"):
            inside = True
            continue
        if line.startswith(b"-----END"):
            break
        if inside:
            lines.append(line)
    return base64.b64decode(b"".join(lines))


def der_to_pem(der: bytes) -> bytes:
    b64 = base64.b64encode(der)
    body = b"\n".join(b64[i : i + 64] for i in range(0, len(b64), 64))
    return b"-----BEGIN CERTIFICATE-----\n" + body + b"\n-----END CERTIFICATE-----\n"
