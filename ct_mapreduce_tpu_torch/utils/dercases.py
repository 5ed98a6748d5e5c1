"""Certificates and mutated rows at the DER walker's edges.

The crafted certificates hit every budget and guard of the walker: more
issuer RDNs than ``MAX_RDNS``, more extensions than ``MAX_EXTS``,
long-form lengths of one to four octets (``0x81``-``0x84``, minimal or
not), serial contents of 0 to 47 bytes, lengths of at most 4, and
lengths past the packed row. :func:`boundary_family` puts each frame
of the walk at every offset modulo 16, so a reader of aligned 16-byte
chunks meets every way a frame can straddle two chunks.
:func:`mutate_rows` derives byte flips,
length-octet edits, truncations and over-long extension lists from
packed rows with a NumPy generator, so every run with one seed sees the
same mutants.
"""

from __future__ import annotations

import datetime

import numpy as np

from ct_mapreduce_tpu_torch.utils import minicert
from ct_mapreduce_tpu_torch.utils.minicert import _tlv

_OID_OU = bytes.fromhex("55040b")
_UTC = datetime.timezone.utc


def tlv(tag: int, content: bytes, octets: int = 0) -> bytes:
    """A TLV whose length takes ``octets`` long-form octets (1-4, not
    necessarily minimal), or the minimal form for ``octets == 0``."""
    if octets == 0:
        return _tlv(tag, content)
    n = len(content)
    return (bytes([tag, 0x80 | octets]) + n.to_bytes(octets, "big")
            + content)


def name(n_rdns: int, cn_at: int | None, cn: str = "Crafted CA",
         octets: int = 0) -> bytes:
    """An issuer Name of ``n_rdns`` single-ATV RDNs: an OU in each,
    except the CN at index ``cn_at``."""
    rdns = []
    for i in range(n_rdns):
        oid, value = ((minicert._OID_CN, cn) if i == cn_at
                      else (_OID_OU, f"Unit {i}"))
        rdns.append(_tlv(0x31, _tlv(0x30, _tlv(0x06, oid)
                                    + _tlv(0x0C, value.encode()))))
    return tlv(0x30, b"".join(rdns), octets)


def cert(serial: bytes = b"\x4d\x01\x02\x03", issuer: bytes | None = None,
         n_ext: int = 1, bc_last: bool = False, is_ca: bool = False,
         crldp: str | None = "http://crl.crafted.example/c.crl",
         octets: dict | None = None,
         not_after: datetime.datetime | None = None, version_pad: int = 0,
         ext_value: int = 3) -> bytes:
    """One certificate assembled from parts. ``n_ext`` opaque
    extensions of ``ext_value`` value bytes go before (or, with
    ``bc_last``, after) BasicConstraints; ``octets`` forces the
    long-form length octets of the named frames (``cert``, ``tbs``,
    ``serial``, ``issuer``, ``exts``, ``value``); ``version_pad``
    leading zero bytes widen the version INTEGER."""
    o = octets or {}
    not_after = not_after or datetime.datetime(2031, 6, 15, tzinfo=_UTC)
    sig_alg = _tlv(0x30, _tlv(0x06, minicert._OID_ECDSA_SHA256))
    opaque = [_tlv(0x30, _tlv(0x06, minicert._oid(1, 3, 6, 1, 4, 1, 99999, i))
                   + tlv(0x04, bytes([i & 0xFF]) * ext_value,
                         o.get("value", 0)))
              for i in range(n_ext)]
    bc = minicert._basic_constraints(is_ca)
    exts = b"".join(opaque + [bc] if bc_last else [bc] + opaque)
    if crldp:
        exts += minicert._crldp((crldp,))
    tbs = tlv(0x30, b"".join([
        _tlv(0xA0, _tlv(0x02, bytes(version_pad) + b"\x02")),
        tlv(0x02, serial, o.get("serial", 0)),
        sig_alg,
        issuer if issuer is not None else name(3, 2, octets=o.get("issuer", 0)),
        _tlv(0x30, minicert._time(datetime.datetime(2024, 1, 1, tzinfo=_UTC))
             + minicert._time(not_after)),
        minicert._name("leaf.crafted.example"),
        minicert._spki("crafted"),
        _tlv(0xA3, tlv(0x30, exts, o.get("exts", 0))),
    ]), o.get("tbs", 0))
    sig = _tlv(0x03, b"\x00" + _tlv(0x30, _tlv(0x02, b"\x11" * 32)))
    return tlv(0x30, tbs + sig_alg + sig, o.get("cert", 0))


def crafted() -> list[tuple[bytes, int | None]]:
    """(DER, length or None) pairs; a given length overrides the DER's
    own (at most 4, or past any row the caller packs)."""
    out: list[tuple[bytes, int | None]] = []
    # Issuer RDN budget: the CN as the 12th, 13th or last of up to 16.
    for n, at in ((12, 11), (13, 11), (13, 12), (14, 13), (16, 15), (16, 0)):
        out.append((cert(issuer=name(n, at)), None))
    # Extension budget: a CA BasicConstraints as the 22nd..29th
    # extension; past MAX_EXTS (24) the lane is rejected.
    for n in (21, 22, 23, 24, 25, 28):
        out.append((cert(n_ext=n, bc_last=True, is_ca=True, crldp=None),
                    None))
    # Long-form lengths of 1..4 octets on each frame; 4 octets reject.
    for frame in ("cert", "tbs", "serial", "issuer", "exts", "value"):
        for k in (1, 2, 3, 4):
            try:
                out.append((cert(octets={frame: k}), None))
            except OverflowError:  # content too long for k octets
                pass
    # Serial contents of 0..47 bytes.
    for n in range(48):
        out.append((cert(serial=bytes([0x4D]) + bytes(range(1, n))
                         if n else b""), None))
    # GeneralizedTime, CA, no CRLDP; and the year 0000 in January, where
    # days-from-civil divides a negative year (floor, not truncation).
    out.append((cert(not_after=datetime.datetime(2061, 3, 4, 5, tzinfo=_UTC),
                     is_ca=True, crldp=None), None))
    jan = cert(not_after=datetime.datetime(2061, 1, 4, 5, tzinfo=_UTC))
    out.append((jan.replace(b"20610104", b"00000104"), None))
    base = cert()
    for ln in (0, 1, 2, 3, 4, 5):
        out.append((base, ln))
    # Lengths past the row (the caller packs rows narrower than these).
    for extra in (1, 300, 1 << 20):
        out.append((base, len(base) + extra))
    return out + boundary_family()


def boundary_family() -> list[tuple[bytes, None]]:
    """Four runs of 16 certificates, each run moving some frames by one
    byte a step, so that those frames take every offset modulo 16: a
    version INTEGER with 0..15 leading zeros (the serial and every frame
    after it), serials of 8..23 content bytes (the issuer and after),
    issuer CNs of 16 consecutive lengths (validity, subject, SPKI and
    the extensions), and an opaque extension of 3..18 value bytes ahead
    of BasicConstraints and the CRLDP."""
    out = []
    for i in range(16):
        out.append(cert(version_pad=i))
        out.append(cert(serial=bytes([0x4D]) + bytes(range(1, 8 + i))))
        out.append(cert(issuer=name(3, 2, cn="Boundary CA " + "b" * i)))
        out.append(cert(ext_value=3 + i, bc_last=True, is_ca=i % 2 == 0))
    return [(d, None) for d in out]


def pack(ders: list[tuple[bytes, int | None]], pad: int):
    """uint8[n, pad] rows (each DER cut at ``pad``) and int32[n]
    lengths (the given length, else the DER's own)."""
    data = np.zeros((len(ders), pad), np.uint8)
    length = np.zeros((len(ders),), np.int32)
    for i, (der, ln) in enumerate(ders):
        raw = np.frombuffer(der[:pad], np.uint8)
        data[i, : raw.size] = raw
        length[i] = len(der) if ln is None else ln
    return data, length


def mutate_rows(data: np.ndarray, length: np.ndarray, n: int,
                rng: np.random.Generator):
    """``n`` mutants of random rows of ``data``: a quarter each of byte
    flips (1-3 bytes in the first 400), length-octet edits (a byte set
    to 0x80-0x84, 0x00 or 0xFF), truncations (a shorter length, the
    tail zeroed) and a CA BasicConstraints after 22, 24 or 27 opaque
    extensions, with a CRLDP last (past ``MAX_EXTS`` in all the lane is
    rejected)."""
    pick = rng.integers(0, data.shape[0], n)
    rows = data[pick].copy()
    lens = length[pick].copy()
    lanes = np.arange(n)
    kind = lanes % 4
    span = np.minimum(np.maximum(lens, 1), min(400, rows.shape[1]))
    for _ in range(3):
        sel = (kind == 0) & (rng.random(n) < 0.7)
        pos = (rng.random(n) * span).astype(np.int64)
        rows[lanes[sel], pos[sel]] ^= rng.integers(1, 256, n).astype(
            np.uint8)[sel]
    sel = kind == 1
    pos = (rng.random(n) * np.minimum(span, 160)).astype(np.int64)
    vals = np.array([0x80, 0x81, 0x82, 0x83, 0x84, 0x00, 0xFF], np.uint8)
    rows[lanes[sel], pos[sel]] = vals[rng.integers(0, vals.size, n)][sel]
    sel = kind == 2
    cut = (rng.random(n) * lens).astype(np.int32)
    lens[sel] = cut[sel]
    cols = np.arange(rows.shape[1])[None, :]
    rows[sel[:, None] & (cols >= cut[:, None])] = 0
    for i, n_ext in enumerate((22, 24, 27)):
        sel = (kind == 3) & (lanes // 4 % 3 == i)
        der = cert(serial=bytes([0x4D]) + rng.bytes(11), n_ext=n_ext,
                   bc_last=True, is_ca=True)
        raw = np.frombuffer(der[: rows.shape[1]], np.uint8)
        rows[sel] = 0
        rows[sel, : raw.size] = raw
        lens[sel] = len(der)
    return rows, lens
