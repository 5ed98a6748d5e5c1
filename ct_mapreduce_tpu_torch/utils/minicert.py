"""Dependency-free synthetic X.509: canonical DER, hand-assembled.

A copy of ``ct_mapreduce_tpu.utils.minicert`` without its SCT helper.
It builds structurally-canonical certificates from raw TLVs: every
field the ingest pipeline reads (serial INTEGER, issuer Name/CN,
validity, SPKI bytes, BasicConstraints, CRL distribution points) is
real DER in the real places; only the signature bytes are synthetic —
which is exactly the contract of the ingest path, which parses and
never verifies (reference cmd/ct-fetch/ct-fetch.go:198-226). Issuer
identity is SHA-256(SPKI), so each distinct ``issuer_cn`` gets a
distinct deterministic SPKI point.
"""

from __future__ import annotations

import datetime
import hashlib

# OIDs (DER-encoded content bytes)
_OID_COUNTRY = bytes.fromhex("550406")
_OID_ORG = bytes.fromhex("55040a")
_OID_CN = bytes.fromhex("550403")
_OID_BASIC_CONSTRAINTS = bytes.fromhex("551d13")
_OID_CRLDP = bytes.fromhex("551d1f")
_OID_EC_PUBKEY = bytes.fromhex("2a8648ce3d0201")
_OID_P256 = bytes.fromhex("2a8648ce3d030107")
_OID_ECDSA_SHA256 = bytes.fromhex("2a8648ce3d040302")

SERIAL_FIRST_BYTE = 0x4D  # positive, no leading-zero trimming — stampable


def _oid(*arcs: int) -> bytes:
    """DER OID content bytes for an arbitrary arc sequence."""
    body = [bytes([40 * arcs[0] + arcs[1]])]
    for arc in arcs[2:]:
        groups = [arc & 0x7F]
        arc >>= 7
        while arc:
            groups.append((arc & 0x7F) | 0x80)
            arc >>= 7
        body.append(bytes(reversed(groups)))
    return b"".join(body)


def _tlv(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        return bytes([tag, n]) + content
    if n < 0x100:
        return bytes([tag, 0x81, n]) + content
    if n < 0x10000:
        return bytes([tag, 0x82, n >> 8, n & 0xFF]) + content
    if n < 0x1000000:
        return bytes([tag, 0x83, n >> 16, (n >> 8) & 0xFF, n & 0xFF]) + content
    raise ValueError(f"TLV content too long: {n}")


def _name(cn: str, org: str = "Mini Cert Org", country: str = "US") -> bytes:
    # Same attribute order/types the cryptography-built fixtures use:
    # PrintableString country, UTF8String org/CN, one ATV per RDN.
    def atv(oid: bytes, value: str, string_tag: int) -> bytes:
        return _tlv(0x31, _tlv(0x30, _tlv(0x06, oid)
                               + _tlv(string_tag, value.encode("utf-8"))))

    return _tlv(0x30, atv(_OID_COUNTRY, country, 0x13)
                + atv(_OID_ORG, org, 0x0C) + atv(_OID_CN, cn, 0x0C))


def _time(dt: datetime.datetime) -> bytes:
    if dt.year < 2050:
        return _tlv(0x17, dt.strftime("%y%m%d%H%M%SZ").encode("ascii"))
    return _tlv(0x18, dt.strftime("%Y%m%d%H%M%SZ").encode("ascii"))


def _spki(seed: str) -> bytes:
    # A P-256-shaped uncompressed point with deterministic coordinate
    # bytes: SHA-256(SPKI) identity is stable per seed, distinct across
    # seeds. Never validated as a curve point (nothing verifies).
    point = (b"\x04"
             + hashlib.sha256(b"minicert-x:" + seed.encode()).digest()
             + hashlib.sha256(b"minicert-y:" + seed.encode()).digest())
    alg = _tlv(0x30, _tlv(0x06, _OID_EC_PUBKEY) + _tlv(0x06, _OID_P256))
    return _tlv(0x30, alg + _tlv(0x03, b"\x00" + point))


def _extension(oid: bytes, value_der: bytes, critical: bool = False) -> bytes:
    inner = _tlv(0x06, oid)
    if critical:
        inner += bytes([0x01, 0x01, 0xFF])
    inner += _tlv(0x04, value_der)
    return _tlv(0x30, inner)


def _basic_constraints(is_ca: bool) -> bytes:
    # cA DEFAULT FALSE is omitted in canonical DER.
    return _extension(
        _OID_BASIC_CONSTRAINTS,
        _tlv(0x30, bytes([0x01, 0x01, 0xFF]) if is_ca else b""),
        critical=True,
    )


def _crldp(urls: tuple[str, ...]) -> bytes:
    dps = b"".join(
        _tlv(0x30, _tlv(0xA0, _tlv(0xA0, _tlv(0x86, u.encode("ascii")))))
        for u in urls
    )
    return _extension(_OID_CRLDP, _tlv(0x30, dps))


def make_cert(
    serial: int = 1,
    issuer_cn: str = "Mini Issuer CA",
    subject_cn: str | None = None,
    org: str = "Mini Cert Org",
    country: str = "US",
    not_before: datetime.datetime | None = None,
    not_after: datetime.datetime | None = None,
    is_ca: bool = False,
    add_basic_constraints: bool = True,
    crl_dps: tuple[str, ...] = (),
    serial_len: int | None = 16,
    spki_seed: str | None = None,
    extra_ext_bytes: int = 0,
    extra_extensions: int = 0,
    extra_ext_size: int = 40,
    extras_first: bool = True,
) -> bytes:
    """One canonical-DER certificate.

    ``serial`` is stamped big-endian into ``serial_len - 1`` content
    bytes behind the fixed positive first byte, so every value keeps
    identical DER shape (the serial window is restampable, like
    syncerts templates); ``serial_len=None`` encodes it minimally
    instead, exactly as the ``cryptography`` builder does (leading
    0x00 pad iff the high bit is set). ``spki_seed`` defaults to the
    issuer CN — self-consistent chains fall out of using the same CN
    for leaf and issuer. ``extra_ext_bytes`` pads the extension list
    with one opaque private-arc extension (oversize fixtures, e.g. a
    >=2 MiB issuer); ``extra_extensions``/``extra_ext_size``/
    ``extras_first`` instead mirror tests/certgen.py's numbered
    UnrecognizedExtension padding (1.3.6.1.4.1.99999.i, payload
    verbatim as extnValue content, placed before or after
    BasicConstraints)."""
    utc = datetime.timezone.utc
    not_before = not_before or datetime.datetime(2024, 1, 1, tzinfo=utc)
    not_after = not_after or datetime.datetime(2031, 6, 15, tzinfo=utc)
    if serial_len is None:
        serial_body = serial.to_bytes(
            (serial.bit_length() + 8) // 8 or 1, "big")
    else:
        if not 2 <= serial_len <= 20:
            raise ValueError(f"serial_len {serial_len} outside 2..20")
        serial_body = bytes([SERIAL_FIRST_BYTE]) + serial.to_bytes(
            serial_len - 1, "big")

    sig_alg = _tlv(0x30, _tlv(0x06, _OID_ECDSA_SHA256))
    extras = b"".join(
        _extension(_oid(1, 3, 6, 1, 4, 1, 99999, i),
                   bytes([i & 0xFF]) * extra_ext_size)
        for i in range(extra_extensions)
    )
    exts = extras if extras_first else b""
    if add_basic_constraints:
        exts += _basic_constraints(is_ca)
    if not extras_first:
        exts += extras
    if crl_dps:
        exts += _crldp(tuple(crl_dps))
    if extra_ext_bytes:
        exts += _extension(
            bytes.fromhex("2b060104018f6501"),  # 1.3.6.1.4.1.2021.1-ish arc
            _tlv(0x04, b"\xeb" * extra_ext_bytes),
        )
    tbs = _tlv(0x30, b"".join([
        _tlv(0xA0, bytes([0x02, 0x01, 0x02])),  # [0] version v3
        _tlv(0x02, serial_body),
        sig_alg,
        _name(issuer_cn, org, country),
        _tlv(0x30, _time(not_before) + _time(not_after)),
        _name(subject_cn if subject_cn is not None else issuer_cn,
              org, country),
        _spki(spki_seed if spki_seed is not None else issuer_cn),
        # An empty extension list is omitted entirely (RFC 5280 wants
        # >= 1 entry; the cryptography builder omits it the same way).
        _tlv(0xA3, _tlv(0x30, exts)) if exts else b"",
    ]))
    # Synthetic ECDSA-SIG-shaped BIT STRING (never verified).
    sig = _tlv(0x03, b"\x00" + _tlv(0x30, _tlv(0x02, b"\x11" * 32)
                                    + _tlv(0x02, b"\x2f" * 32)))
    return _tlv(0x30, tbs + sig_alg + sig)
