"""X.509/DER field extraction on the device (port of
``ct_mapreduce_tpu.ops.der_kernel``).

A per-lane walk of the TBSCertificate yields the fields the map stage
consumes: the serial window, notAfter as epoch hours, the CA flag, the
CRL-distribution-points window, the issuer Name and first-CN windows,
the SPKI window and an ``ok`` bit. A lane whose ``ok`` is False takes
the exact host lane.

The JAX walker reads bytes through one-hot word windows, a workaround
for gathers on a TPU. On a GPU a lane reads its row directly, so this
module keeps the window *semantics* and drops the one-hot mechanics:

- every header group is read through a fixed byte window, and a read
  outside the window that the JAX walker would have fetched returns 0;
- the flat window (``_window``) clamps its base word to ``nw - 1``
  (``nw = ceil(L / 4)``); the scan windows (``_sup_window``) are
  anchored at ``p & ~3`` without a clamp, and bytes past the row are 0;
- window widths: 17 words for the certificate, TBS, version, serial
  and sigAlg headers; 3 for the issuer and SPKI headers; 13 for
  validity plus the subject header; 13 for the UniqueIDs plus ``[3]``;
  8 per RDN round and 11 per extension round.

:func:`walk` is the dispatch the ingest step uses: CUDA tensors go to
the hand-written kernel (:mod:`.der_kernel_cuda`, ``csrc/der_walk.cu``),
CPU tensors to the plain PyTorch version below. There is no fallback
between the two. The plain version keeps the JAX loop structure:
vectorised lanes, active masks, ``while active.any()``.

The JAX walker's outer superblock budget (``outer_max``) never binds
for a lane whose positions stay inside its row, so it is not modelled
here, as the native scalar walker does not model it either.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_RDNS = 12  # RDN components scanned in the issuer Name
MAX_EXTS = 24  # extensions scanned in the TBS

_PAD_WORDS = 16  # the JAX walker's window ceiling (17 words)
_BLOCK_WORDS = 16

# Largest content span `window_bytes_rows` can serve: its window needs
# (6 + n)//4 + 1 words, bounded by min(_PAD_WORDS, _BLOCK_WORDS) + 1.
MAX_FIXED_WINDOW_BYTES = min(_PAD_WORDS, _BLOCK_WORDS) * 4 + 3 - 6  # 61

#: Window widths in bytes (see the module docstring).
W_FIXED = 17 * 4
W_HEADER = 3 * 4
W_VALIDITY = 13 * 4
W_EXT_HEAD = 13 * 4
W_RDN = 8 * 4
W_EXT = 11 * 4

_TIME_LIMIT = 2 ** 30  # header limit of the time parser (no bound)


class ParsedCerts(NamedTuple):
    """Per-lane extraction results (int32 unless noted)."""

    ok: torch.Tensor  # bool — False ⇒ use the host reference lane
    serial_off: torch.Tensor
    serial_len: torch.Tensor
    not_after_hour: torch.Tensor  # hours since Unix epoch, floor-truncated
    is_ca: torch.Tensor  # bool
    has_crldp: torch.Tensor  # bool
    issuer_cn_off: torch.Tensor  # NOT masked by ok (as in the JAX walker)
    issuer_cn_len: torch.Tensor  # 0 ⇒ no CN present
    issuer_off: torch.Tensor  # full issuer Name TLV (host DN-cache key)
    issuer_len: torch.Tensor
    spki_off: torch.Tensor  # offset of the full SPKI TLV
    spki_len: torch.Tensor  # header+content length
    crldp_off: torch.Tensor  # CRLDP extnValue content (host CRL-cache key)
    crldp_len: torch.Tensor  # 0 ⇒ extension absent


class WalkOut(NamedTuple):
    """Everything one walk gives the ingest step."""

    parsed: ParsedCerts
    serials: torch.Tensor  # uint8[B, max_serial_bytes], zero past the length
    fits: torch.Tensor  # bool[B] — serial_len <= max_serial_bytes
    cn_window: torch.Tensor  # uint8[B, K] at issuer_cn_off (K may be 0)


# -- byte access --------------------------------------------------------

class _Rows:
    """``uint8[B, L]`` rows read lane by lane. ``touched`` collects the
    row positions the walk really fetches, when asked to."""

    def __init__(self, data: torch.Tensor, record: bool = False) -> None:
        self.data = data
        self.L = int(data.shape[1])
        self.nw = -(-self.L // 4)
        self.touched: list[torch.Tensor] | None = [] if record else None

    def fetch(self, q: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        """Row bytes at positions ``q`` (int64[B, k]); 0 where ``live``
        is False or ``q`` lies outside ``[0, L)``."""
        inside = live & (q >= 0) & (q < self.L)
        if self.touched is not None:
            self.touched.append(torch.where(inside, q, -1))
        if self.L == 0:
            return torch.zeros_like(q)
        got = torch.gather(self.data, 1, q.clamp(0, self.L - 1))
        return torch.where(inside, got.to(torch.int64), 0)


class _Win:
    """A byte window of ``width`` bytes: window byte ``j`` is row byte
    ``base + j`` (``base`` a multiple of 4); ``a`` is the alignment of
    the anchor position inside the first word."""

    def __init__(self, rows: _Rows, base, a, width: int) -> None:
        self.rows, self.base, self.a, self.width = rows, base, a, width

    def bytes(self, rel: torch.Tensor, n: int) -> torch.Tensor:
        """Window bytes ``rel .. rel + n - 1`` as int64[B, n]; 0 outside
        the window."""
        r = rel[:, None] + torch.arange(n, device=rel.device)[None, :]
        return self.rows.fetch(self.base[:, None] + r,
                               (r >= 0) & (r < self.width))

    def byte(self, rel: torch.Tensor) -> torch.Tensor:
        return self.bytes(rel, 1)[:, 0]


def _flat_window(rows: _Rows, p: torch.Tensor, width: int) -> _Win:
    """``der_kernel._window``: base word clamped to ``nw - 1``."""
    base = (p.clamp(0, (rows.nw - 1) * 4) >> 2) << 2
    return _Win(rows, base, p.clamp(min=0) & 3, width)


def _scan_window(rows: _Rows, p: torch.Tensor, width: int) -> _Win:
    """``der_kernel._sup_window``: anchored at ``p & ~3``, no clamp."""
    return _Win(rows, (p >> 2) << 2, p.clamp(min=0) & 3, width)


class _Hdr(NamedTuple):
    tag: torch.Tensor
    clen: torch.Tensor
    hlen: torch.Tensor
    ok: torch.Tensor


def _read_header(win: _Win, delta, p, limit) -> _Hdr:
    """TLV header at row position ``p + delta`` read through ``win``
    (anchored at ``p``). Short form or long form of up to 3 length
    octets; ``ok`` needs the whole frame inside ``limit``."""
    b = win.bytes(win.a + delta, 5)
    tag, b0, b1, b2, b3 = b.unbind(1)
    short = b0 < 0x80
    n_len = b0 - 0x80
    long_ok = (b0 > 0x80) & (n_len <= 3)
    clen_long = torch.where(
        n_len == 1, b1,
        torch.where(n_len == 2, (b1 << 8) | b2, (b1 << 16) | (b2 << 8) | b3))
    clen = torch.where(short, b0, clen_long)
    hlen = torch.where(short, 2, 2 + n_len)
    pos = p + delta
    ok = (short | long_ok) & (pos >= 0) & (pos + hlen + clen <= limit)
    return _Hdr(tag, clen, hlen, ok)


def _parse_time(win: _Win, delta, p):
    """UTCTime / GeneralizedTime at ``p + delta`` → (epoch hour, ok).
    Every byte that feeds the hour bucket must be an ASCII digit;
    month 1-12, day 1-31, hour 0-23; no calendar check."""
    tag, clen, hlen, hok = _read_header(win, delta, p, _TIME_LIMIT)
    is_utc = tag == 0x17
    is_gen = tag == 0x18
    ok = hok & (is_utc | is_gen) & torch.where(is_utc, clen >= 11, clen >= 13)
    q = win.a + delta + hlen
    body = torch.where(is_utc, q, q + 2)
    # Bytes q..q+3 and body+2..body+7 hold every digit read.
    head = win.bytes(q, 4)
    tail = win.bytes(body + 2, 6)
    digits = torch.cat([head, tail], 1)
    is_digit = (digits >= 0x30) & (digits <= 0x39)
    v = digits - 0x30
    yy = v[:, 0] * 10 + v[:, 1]
    cc = v[:, 2] * 10 + v[:, 3]
    month = v[:, 4] * 10 + v[:, 5]
    day = v[:, 6] * 10 + v[:, 7]
    hour = v[:, 8] * 10 + v[:, 9]
    year = torch.where(is_utc, torch.where(yy >= 50, 1900 + yy, 2000 + yy),
                       yy * 100 + cc)
    digits_ok = (is_digit[:, 0] & is_digit[:, 1] & is_digit[:, 4:].all(1)
                 & (is_utc | (is_digit[:, 2] & is_digit[:, 3])))
    ok = (ok & digits_ok & (month >= 1) & (month <= 12) & (day >= 1)
          & (day <= 31) & (hour <= 23))
    # Days-from-civil (Gregorian) with floor division, as jnp's `//`.
    y = year - (month <= 2).to(torch.int64)
    era = torch.div(y, 400, rounding_mode="floor")
    yoe = y - era * 400
    mp = torch.where(month > 2, month - 3, month + 9)
    doy = torch.div(153 * mp + 2, 5, rounding_mode="floor") + day - 1
    doe = (yoe * 365 + torch.div(yoe, 4, rounding_mode="floor")
           - torch.div(yoe, 100, rounding_mode="floor") + doy)
    days = era * 146097 + doe - 719468
    return days * 24 + hour, ok


def _scan_issuer_cn(rows: _Rows, name_off, name_end, alive0):
    """First CN (OID 2.5.4.3) value inside the issuer Name: one RDN SET
    a round (first ATV only), an 8-word window a round. Returns
    ``(cn_off, cn_len)``, length 0 when absent. Structural breaks stop
    the scan without touching the lane's ``ok``."""
    zero = torch.zeros_like(name_off)
    p, cn_off, cn_len, cnt = name_off, zero, zero.clone(), zero.clone()
    alive = alive0
    active = alive & (p < name_end)
    while bool(active.any()):
        win = _scan_window(rows, p, W_RDN)
        a = win.a
        d0 = torch.zeros_like(p)
        tag, clen, hlen, hok = _read_header(win, d0, p, name_end)
        set_ok = active & hok & (tag == 0x31)
        da = hlen
        atag, _aclen, ahlen, aok = _read_header(win, da, p, name_end)
        do = da + ahlen
        otag, oclen, ohlen, ook = _read_header(win, do, p, name_end)
        oid = win.bytes(a + do + ohlen, 3)
        is_cn = (set_ok & aok & (atag == 0x30) & ook & (otag == 0x06)
                 & (oclen == 3) & (oid[:, 0] == 0x55) & (oid[:, 1] == 0x04)
                 & (oid[:, 2] == 0x03))
        dv = do + ohlen + oclen
        _vtag, vclen, vhlen, vok = _read_header(win, dv, p, name_end)
        take = is_cn & vok & (cn_len == 0)
        cn_off = torch.where(take, p + dv + vhlen, cn_off)
        cn_len = torch.where(take, vclen, cn_len)
        step = active & hok
        p = torch.where(step, p + hlen + clen, p)
        cnt = cnt + step.to(torch.int64)
        alive = alive & torch.where(active, hok, True)
        active = alive & (p < name_end) & (cnt < MAX_RDNS)
    return cn_off, cn_len


def _scan_extensions(rows: _Rows, ext_off, ext_end, alive0):
    """SEQUENCE OF Extension → BasicConstraints CA flag and the first
    CRLDP extnValue window, an 11-word window a round. A header failure
    or an extnValue that overruns its Extension frame rejects the lane,
    and so does a list still unfinished after MAX_EXTS rounds."""
    zero = torch.zeros_like(ext_off)
    false = torch.zeros_like(alive0)
    p, cnt, dp_off, dp_len = ext_off, zero, zero.clone(), zero.clone()
    is_ca, has_crldp = false, false.clone()
    alive = alive0
    active = alive & (p < ext_end)
    while bool(active.any()):
        win = _scan_window(rows, p, W_EXT)
        a = win.a
        d0 = torch.zeros_like(p)
        tag, clen, hlen, hok = _read_header(win, d0, p, ext_end)
        ext_ok = active & hok & (tag == 0x30)
        di = hlen
        otag, oclen, ohlen, ook = _read_header(win, di, p, ext_end)
        oid_ok = ext_ok & ook & (otag == 0x06) & (oclen == 3)
        o = win.bytes(a + di + ohlen, 3)
        o_ce = oid_ok & (o[:, 0] == 0x55) & (o[:, 1] == 0x1D)
        is_bc = o_ce & (o[:, 2] == 0x13)
        is_dp = o_ce & (o[:, 2] == 0x1F)
        dc = di + ohlen + oclen  # optional BOOLEAN critical
        ctag, cclen, chlen, cok = _read_header(win, dc, p, ext_end)
        has_crit = cok & (ctag == 0x01)
        dv = torch.where(has_crit, dc + chlen + cclen, dc)
        vtag, vclen, vhlen, vok = _read_header(win, dv, p, ext_end)
        # The extnValue must fit inside its Extension frame; the overrun
        # test re-reads the header with no limit.
        _t2, vclen2, vhlen2, vok2 = _read_header(win, dv, p, _TIME_LIMIT)
        overrun = ext_ok & vok2 & (dv + vhlen2 + vclen2 > hlen + clen)
        val_ok = vok & (vtag == 0x04) & ~overrun
        db = dv + vhlen  # BasicConstraints ::= SEQUENCE { cA BOOLEAN, .. }
        btag, bclen, bhlen, bok = _read_header(win, db, p, ext_end)
        bc_seq_ok = val_ok & bok & (btag == 0x30)
        df = db + bhlen
        ftag, fclen, fhlen, fok = _read_header(win, df, p, ext_end)
        ca_flag = (bc_seq_ok & (bclen > 0) & fok & (ftag == 0x01)
                   & (fclen == 1) & (win.byte(a + df + fhlen) != 0))
        is_ca = is_ca | (is_bc & ca_flag)
        take_dp = is_dp & val_ok & (dp_len == 0)
        dp_off = torch.where(take_dp, p + dv + vhlen, dp_off)
        dp_len = torch.where(take_dp, vclen, dp_len)
        has_crldp = has_crldp | (is_dp & val_ok)
        step = active & hok
        p = torch.where(step, p + hlen + clen, p)
        cnt = cnt + step.to(torch.int64)
        alive = alive & torch.where(active, hok & ~overrun, True)
        active = alive & (p < ext_end) & (cnt < MAX_EXTS)
    exhausted = alive & (p < ext_end)  # budget ran out mid-list
    return is_ca, has_crldp, dp_off, dp_len, alive & ~exhausted


def _parse(rows: _Rows, length: torch.Tensor, scan_issuer_cn: bool):
    """The walk in int64; returns the ParsedCerts fields before the
    output masks, plus ``ok``."""
    length = length.to(torch.int64)
    limit = length
    ok = length > 4
    zero = torch.zeros_like(length)

    # -- the fixed 17-word window at 0: Certificate + TBS + [0] version
    # + serial + signature AlgorithmIdentifier headers.
    win = _flat_window(rows, zero, W_FIXED)
    a = win.a
    tag, clen, hlen, hok = _read_header(win, zero, zero, limit)
    ok &= hok & (tag == 0x30)
    d_tbs = hlen
    tag, clen, hlen, hok = _read_header(win, d_tbs, zero, limit)
    ok &= hok & (tag == 0x30)
    tbs_end = d_tbs + hlen + clen
    d = d_tbs + hlen
    tag, clen, hlen, hok = _read_header(win, d, zero, tbs_end)
    has_version = hok & (tag == 0xA0)
    dser = d + torch.where(has_version, hlen + clen, 0)
    tag, clen, hlen, hok = _read_header(win, dser, zero, tbs_end)
    ok &= hok & (tag == 0x02) & (a + dser + 5 <= W_FIXED)
    serial_off = dser + hlen
    serial_len = clen
    d_alg = dser + hlen + clen
    tag, clen, hlen, hok = _read_header(win, d_alg, zero, tbs_end)
    ok &= hok & (tag == 0x30) & (a + d_alg + 5 <= W_FIXED)
    p = d_alg + hlen + clen

    # -- issuer Name header: its own 3-word window.
    tag, clen, hlen, hok = _read_header(
        _flat_window(rows, p, W_HEADER), zero, p, tbs_end)
    ok &= hok & (tag == 0x30)
    issuer_off = p
    issuer_len = hlen + clen
    issuer_end = p + hlen + clen
    if scan_issuer_cn:
        cn_off, cn_len = _scan_issuer_cn(rows, p + hlen, issuer_end, ok)
    else:
        cn_off = cn_len = zero
    p = issuer_end

    # -- 13-word window: validity { notBefore, notAfter } + subject header.
    win = _flat_window(rows, p, W_VALIDITY)
    a = win.a
    tag, clen, hlen, hok = _read_header(win, zero, p, tbs_end)
    ok &= hok & (tag == 0x30)
    dnb = hlen
    _nbt, nb_clen, nb_hlen, nb_ok = _read_header(win, dnb, p, tbs_end)
    ok &= nb_ok
    not_after_hour, t_ok = _parse_time(win, dnb + nb_hlen + nb_clen, p)
    ok &= t_ok
    d_subj = hlen + clen
    tag, clen, hlen, hok = _read_header(win, d_subj, p, tbs_end)
    ok &= hok & (tag == 0x30) & (a + d_subj + 5 <= W_VALIDITY)
    p = p + d_subj + hlen + clen

    # -- subjectPublicKeyInfo header: its own 3-word window.
    tag, clen, hlen, hok = _read_header(
        _flat_window(rows, p, W_HEADER), zero, p, tbs_end)
    ok &= hok & (tag == 0x30)
    spki_off = p
    spki_len = hlen + clen
    p = p + hlen + clen

    # -- 13-word window: optional UniqueIDs + [3] + the inner SEQUENCE.
    win = _flat_window(rows, p, W_EXT_HEAD)
    a = win.a
    d = zero
    for _ in range(2):
        tag, clen, hlen, hok = _read_header(win, d, p, tbs_end)
        is_uid = hok & ((tag == 0x81) | (tag == 0x82) | (tag == 0xA1)
                        | (tag == 0xA2))
        d = torch.where(is_uid, d + hlen + clen, d)
    in_win = a + d + 11 <= W_EXT_HEAD
    tag, clen, hlen, hok = _read_header(win, d, p, tbs_end)
    has_ext = hok & (tag == 0xA3) & ((p + d) < tbs_end) & in_win
    # Trailing TBS bytes that are not a well-formed in-window [3] frame
    # send the lane to the exact host lane.
    ok &= has_ext | ((p + d) >= tbs_end)
    de = d + hlen
    etag, eclen, ehlen, eok = _read_header(win, de, p, tbs_end)
    ext_listed = has_ext & eok & (etag == 0x30)
    ok &= torch.where(has_ext, eok & (etag == 0x30), True)
    ext_off = p + de + ehlen
    ext_end = torch.where(ext_listed, p + de + ehlen + eclen, 0)
    is_ca, has_crldp, dp_off, dp_len, ext_ok = _scan_extensions(
        rows, ext_off, ext_end, ok)
    ok &= ext_ok

    def m(x):
        return torch.where(ok, x, 0).to(torch.int32)

    return ParsedCerts(
        ok=ok,
        serial_off=m(serial_off),
        serial_len=m(serial_len),
        not_after_hour=m(not_after_hour),
        is_ca=is_ca & ok,
        has_crldp=has_crldp & ok,
        issuer_cn_off=cn_off.to(torch.int32),
        issuer_cn_len=m(cn_len),
        issuer_off=m(issuer_off),
        issuer_len=m(issuer_len),
        spki_off=m(spki_off),
        spki_len=m(spki_len),
        crldp_off=m(dp_off),
        crldp_len=m(dp_len),
    )


def parse_certs_rows(data: torch.Tensor, length: torch.Tensor,
                     scan_issuer_cn: bool = True) -> ParsedCerts:
    """Plain PyTorch version of the walk: ``data`` uint8[B, L] zero-
    padded DER, ``length`` int32[B]. With ``scan_issuer_cn`` False the
    RDN scan is skipped and ``issuer_cn_off``/``issuer_cn_len`` are 0."""
    return _parse(_Rows(data), length, scan_issuer_cn)


def window_bytes_rows(data: torch.Tensor, off: torch.Tensor,
                      n: int) -> torch.Tensor:
    """``n`` bytes at per-lane ``off`` as int32[B, n], read through the
    flat window of ``(6 + n)//4 + 1`` words (so an ``off`` past the row
    reads the clamped final word, not zeros)."""
    n_words = (3 + n + 3) // 4 + 1
    rows = _Rows(data)
    off = off.to(torch.int64)
    win = _flat_window(rows, off, n_words * 4)
    return win.bytes(win.a, n).to(torch.int32)


def gather_serials_rows(data: torch.Tensor, off: torch.Tensor,
                        ln: torch.Tensor, max_serial_bytes: int = 46):
    """Serial content bytes in a fixed window: (uint8[B, max] zero past
    ``ln``, bool[B] ``ln <= max``)."""
    got = window_bytes_rows(data, off, max_serial_bytes)
    mask = (torch.arange(max_serial_bytes, device=data.device)[None, :]
            < ln[:, None])
    return (torch.where(mask, got, 0).to(torch.uint8),
            ln <= max_serial_bytes)


def walk_plain(data: torch.Tensor, length: torch.Tensor,
               scan_issuer_cn: bool, cn_window: int = 0,
               max_serial_bytes: int = 46) -> WalkOut:
    """Plain PyTorch version of the walker kernel: the walk, the serial
    window and, when ``cn_window`` > 0, the issuer-CN window."""
    parsed = parse_certs_rows(data, length, scan_issuer_cn)
    serials, fits = gather_serials_rows(
        data, parsed.serial_off, parsed.serial_len, max_serial_bytes)
    cn = window_bytes_rows(data, parsed.issuer_cn_off, cn_window).to(
        torch.uint8)
    return WalkOut(parsed, serials, fits, cn)


def walk(data: torch.Tensor, length: torch.Tensor, scan_issuer_cn: bool,
         cn_window: int = 0, max_serial_bytes: int = 46) -> WalkOut:
    """The walker on the rows' device: CUDA tensors launch the
    hand-written kernel, CPU tensors run the plain version. There is no
    fallback between the two."""
    if data.device.type == "cuda":
        from ct_mapreduce_tpu_torch.ops import der_kernel_cuda

        return der_kernel_cuda.walk(data, length, scan_issuer_cn,
                                    cn_window, max_serial_bytes)
    if data.device.type == "cpu":
        return walk_plain(data, length, scan_issuer_cn, cn_window,
                          max_serial_bytes)
    raise ValueError(f"no walker for device {data.device}")


def parse_certs(data: torch.Tensor, length: torch.Tensor,
                scan_issuer_cn: bool = True) -> ParsedCerts:
    """The JAX package's ``parse_certs``: map-stage fields of a batch of
    DER certificates, ``data`` uint8[B, L] zero-padded and ``length``
    int32[B], both on one device. The walk runs on that device through
    :func:`walk`: K3 on a CUDA tensor, the plain walker on a CPU one.
    Lanes with ``ok`` False must be re-parsed on the host."""
    data = data.to(torch.uint8)
    length = length.to(torch.int32)
    if data.dim() != 2 or data.shape[1] < 1:
        raise ValueError(
            f"data must be [B, L] with L >= 1, got {tuple(data.shape)}")
    return walk(data.contiguous(), length.contiguous(),
                scan_issuer_cn).parsed


def footprint(data: torch.Tensor, length: torch.Tensor,
              scan_issuer_cn: bool, cn_window: int = 0,
              max_serial_bytes: int = 46):
    """What the walk (with its serial and CN windows) must read of each
    row, counted with the plain version: ``(sectors, reads)`` int64[B],
    the distinct 32-byte sectors it touches and the bytes it fetches."""
    rows = _Rows(data, record=True)
    parsed = _parse(rows, length, scan_issuer_cn)
    cols = torch.arange(max(max_serial_bytes, cn_window), device=data.device)
    for off, n, ln in ((parsed.serial_off, max_serial_bytes, parsed.serial_len),
                       (parsed.issuer_cn_off, cn_window, None)):
        if n:
            win = _flat_window(rows, off.to(torch.int64), ((6 + n) // 4 + 1) * 4)
            r = win.a[:, None] + cols[None, :n]
            live = (cols[None, :n] < (ln[:, None] if ln is not None else n))
            rows.fetch(win.base[:, None] + r, live.expand_as(r))
    q = torch.cat(rows.touched, 1)
    reads = (q >= 0).sum(1)
    sec = torch.where(q >= 0, q >> 5, -1).sort(dim=1).values
    new = torch.ones_like(sec, dtype=torch.bool)
    new[:, 1:] = sec[:, 1:] != sec[:, :-1]
    return (new & (sec >= 0)).sum(1), reads
