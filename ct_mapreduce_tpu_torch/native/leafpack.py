"""Batch leaf decoding, DER packing, sidecar extraction and embedded-SCT
extraction on top of the native library (a copy of
``ct_mapreduce_tpu.native.leafpack``).

``decode_raw_batch`` takes one get-entries response worth of base64
strings and produces the packed rows plus per-entry issuer DER — the
host fast path between the log client and the device. Without the
native library it decodes entry by entry through the Python leaf codec
(:mod:`ct_mapreduce_tpu_torch.ingest.leaf`), with identical results.

Where this copy departs from the JAX module: ``decode_raw_batch`` can
write the rows into a buffer the caller passes (``data``), so the
ingest sink decodes straight into pinned host memory from which the
rows are copied to the card.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ct_mapreduce_tpu_torch.native import load as load_native
from ct_mapreduce_tpu_torch.telemetry import trace

# Status codes — keep in sync with ctmr_native.cpp.
OK = 0
BAD_B64 = 1
BAD_LEAF = 2
UNSUPPORTED = 3
NO_CHAIN = 4
TOO_LONG = 5  # cert exceeds pad_len — a wider redecode can clear it
ISSUER_TOO_LONG = 6  # issuer DER >= 2 MiB — the cert packed fine; a
# wider redecode is futile, the entry goes straight to the host lane


@dataclass
class DecodedBatch:
    """Packed batch + per-entry metadata for one get-entries response."""

    data: np.ndarray  # uint8[n, pad_len]
    length: np.ndarray  # int32[n]
    timestamp_ms: np.ndarray  # int64[n]
    entry_type: np.ndarray  # int32[n]
    _issuers: Optional[list]  # chain[0] DER per entry; None = lazy
    status: np.ndarray  # int32[n]
    # Issuer grouping: entries with the same chain[0] DER share a group
    # id; group_issuers[g] is that DER; -1 = no issuer.
    issuer_group: Optional[np.ndarray] = None  # int32[n]
    group_issuers: Optional[list] = None  # list[bytes]


@dataclass
class Sidecar:
    """Per-lane pre-parsed identity fields for a packed batch.

    Extracted by the native scalar port of the DER walker
    (``ctmr_extract_sidecars``): ``ok == 0`` means the walker itself
    would reject the lane (the pre-parsed lane then sends it to the
    exact host lane). All arrays length n; offsets index into the
    packed row (cert DER at offset 0).
    """

    ok: np.ndarray  # uint8[n]
    serial_off: np.ndarray  # int32[n]
    serial_len: np.ndarray  # int32[n]
    not_after_hour: np.ndarray  # int32[n] epoch-hour bucket
    is_ca: np.ndarray  # uint8[n]
    has_crldp: np.ndarray  # uint8[n]
    cn_off: np.ndarray  # int32[n] — first issuer-CN value window
    cn_len: np.ndarray  # int32[n] (0 = no CN found)
    issuer_off: np.ndarray  # int32[n] — full issuer Name TLV
    issuer_len: np.ndarray  # int32[n]
    spki_off: np.ndarray  # int32[n]
    spki_len: np.ndarray  # int32[n]
    crldp_off: np.ndarray  # int32[n] — CRLDP extnValue content window
    crldp_len: np.ndarray  # int32[n]


def resolve_threads(n: int, threads: Optional[int] = None) -> int:
    """Effective intra-chunk native thread count for an ``n``-lane call.

    An explicit ``threads`` > 0 is honored as given, clamped only to
    the lane count. Otherwise ``CTMR_DECODE_THREADS``, then
    ``os.cpu_count()`` — auto-sized so every chunk keeps >= 2048 lanes
    (below that the split overhead exceeds the decode it parallelizes).
    """
    if threads is not None and int(threads) > 0:
        return max(1, min(int(threads), max(int(n), 1)))
    t = int(os.environ.get("CTMR_DECODE_THREADS", "0") or 0)
    if t <= 0:
        t = os.cpu_count() or 1
    t = max(1, min(t, n // 2048)) if n >= 4096 else 1
    return max(1, min(t, 256))


def extract_sidecars(data: np.ndarray, length: np.ndarray,
                     threads: Optional[int] = None) -> Optional[Sidecar]:
    """Pre-parsed sidecars for packed rows ``uint8[n, pad]`` +
    ``int32[n]`` lengths, or None when the native library is
    unavailable (no compiler).

    ``threads`` > 1 splits the lane range across the native worker
    pool; every lane's outputs are written by exactly one chunk, so
    results are byte-identical to the serial pass."""
    lib = load_native()
    if lib is None:
        return None
    n = int(data.shape[0])
    data = np.ascontiguousarray(data, np.uint8)
    length = np.ascontiguousarray(length, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    out_u8 = [np.zeros((n,), np.uint8) for _ in range(3)]
    out_i32 = [np.zeros((n,), np.int32) for _ in range(11)]
    ok, is_ca, has_crldp = out_u8
    (serial_off, serial_len, not_after_hour, cn_off, cn_len,
     issuer_off, issuer_len, spki_off, spki_len,
     crldp_off, crldp_len) = out_i32
    t = resolve_threads(n, threads)
    fn, extra = lib.ctmr_extract_sidecars, ()
    if t > 1:
        fn, extra = lib.ctmr_extract_sidecars_mt, (t,)
    fn(
        n, data.ctypes.data_as(u8p), data.shape[1],
        length.ctypes.data_as(i32p),
        ok.ctypes.data_as(u8p),
        serial_off.ctypes.data_as(i32p), serial_len.ctypes.data_as(i32p),
        not_after_hour.ctypes.data_as(i32p),
        is_ca.ctypes.data_as(u8p), has_crldp.ctypes.data_as(u8p),
        cn_off.ctypes.data_as(i32p), cn_len.ctypes.data_as(i32p),
        issuer_off.ctypes.data_as(i32p), issuer_len.ctypes.data_as(i32p),
        spki_off.ctypes.data_as(i32p), spki_len.ctypes.data_as(i32p),
        crldp_off.ctypes.data_as(i32p), crldp_len.ctypes.data_as(i32p),
        *extra,
    )
    return Sidecar(
        ok=ok, serial_off=serial_off, serial_len=serial_len,
        not_after_hour=not_after_hour, is_ca=is_ca, has_crldp=has_crldp,
        cn_off=cn_off, cn_len=cn_len,
        issuer_off=issuer_off, issuer_len=issuer_len,
        spki_off=spki_off, spki_len=spki_len,
        crldp_off=crldp_off, crldp_len=crldp_len,
    )


def extract_scts(data: np.ndarray, length: np.ndarray,
                 threads: Optional[int] = None,
                 issuer_key_hash: Optional[np.ndarray] = None):
    """Embedded-SCT tuples for packed rows: a
    :class:`ct_mapreduce_tpu_torch.verify.sct.SctBatch` — the host half
    of the signature-verification lane (status / RFC 6962 precert digest
    / log id / r / s per lane). ``issuer_key_hash``: uint8[n, 32]
    per-lane SHA-256(issuer SPKI) signed into each digest (None →
    all-zero lanes, no issuer chain). Native scanner when available
    (``ctmr_extract_scts_v2``, lane-range threaded like the sidecar
    pass), else the bit-identical pure-python mirror (also under
    ``CTMR_NATIVE=0``)."""
    from ct_mapreduce_tpu_torch.verify.sct import SctBatch, extract_scts_np

    with trace.span("native.extract_scts", cat="native",
                    entries=int(data.shape[0])):
        lib = (None if os.environ.get("CTMR_NATIVE", "1") == "0"
               else load_native())
        if lib is None:
            return extract_scts_np(data, length, issuer_key_hash)
        n = int(data.shape[0])
        data = np.ascontiguousarray(data, np.uint8)
        length = np.ascontiguousarray(length, np.int32)
        out = SctBatch.empty(n)
        if n == 0:
            return out
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        if issuer_key_hash is None:
            ikh_ptr = ctypes.cast(None, u8p)
        else:
            issuer_key_hash = np.ascontiguousarray(issuer_key_hash, np.uint8)
            if issuer_key_hash.shape != (n, 32):
                raise ValueError(
                    f"issuer_key_hash must be uint8[{n}, 32], got "
                    f"{issuer_key_hash.shape}")
            ikh_ptr = issuer_key_hash.ctypes.data_as(u8p)
        t = resolve_threads(n, threads)
        fn, extra = lib.ctmr_extract_scts_v2, ()
        if t > 1:
            fn, extra = lib.ctmr_extract_scts_v2_mt, (t,)
        fn(
            n, data.ctypes.data_as(u8p), data.shape[1],
            length.ctypes.data_as(i32p),
            ikh_ptr,
            out.ok.ctypes.data_as(u8p),
            out.digest.ctypes.data_as(u8p),
            out.log_id.ctypes.data_as(u8p),
            out.timestamp_ms.ctypes.data_as(i64p),
            out.r.ctypes.data_as(u8p),
            out.s.ctypes.data_as(u8p),
            out.hash_alg.ctypes.data_as(u8p),
            out.sig_alg.ctypes.data_as(u8p),
            *extra,
        )
        return out


def _assign_gid(gid_of: dict, group_issuers: list, der: bytes) -> int:
    """Accumulating DER→group-id assignment."""
    gid = gid_of.get(der)
    if gid is None:
        gid = gid_of[der] = len(group_issuers)
        group_issuers.append(der)
    return gid


def _concat_b64(strings: Sequence[str]) -> tuple[bytes, np.ndarray]:
    offs = np.zeros((len(strings) + 1,), np.int64)
    parts = []
    pos = 0
    for i, s in enumerate(strings):
        b = s.encode("ascii") if isinstance(s, str) else s
        parts.append(b)
        pos += len(b)
        offs[i + 1] = pos
    return b"".join(parts), offs


def decode_raw_batch(
    leaf_inputs: Sequence[str],
    extra_datas: Sequence[str],
    pad_len: int,
    workers: Optional[int] = None,
    threads: Optional[int] = None,
    data: Optional[np.ndarray] = None,
) -> DecodedBatch:
    """Decode one get-entries response into packed rows. ``data``, when
    given, is the ``uint8[n, pad_len]`` C-contiguous buffer the rows are
    written into (every row is rewritten in full, zero padding
    included); otherwise a fresh array is allocated."""
    with trace.span("native.decode_batch", cat="native",
                    entries=len(leaf_inputs), pad=int(pad_len)):
        return _decode_raw_batch(leaf_inputs, extra_datas, pad_len,
                                 workers=workers, threads=threads, data=data)


def _decode_raw_batch(
    leaf_inputs: Sequence[str],
    extra_datas: Sequence[str],
    pad_len: int,
    workers: Optional[int] = None,
    threads: Optional[int] = None,
    data: Optional[np.ndarray] = None,
) -> DecodedBatch:
    """Decode one get-entries response into packed rows.

    ``threads`` > 1 splits the batch across the native library's
    persistent worker pool (one ctypes call; lane ranges decoded in
    parallel with the GIL released). ``workers`` is the alias used
    when ``threads`` is unset; the default is :func:`resolve_threads`.

    Determinism: per-lane outputs are written by exactly one chunk into
    disjoint ranges, and per-chunk issuer groups merge by DER bytes in
    chunk (= lane) order, so the result is byte-identical across thread
    counts."""
    n = len(leaf_inputs)
    if data is None:
        data = np.zeros((n, pad_len), np.uint8)
    elif (data.shape != (n, pad_len) or data.dtype != np.uint8
          or not data.flags.c_contiguous):
        raise ValueError(
            f"data must be C-contiguous uint8[{n}, {pad_len}], got "
            f"{data.dtype}{list(data.shape)}")
    lib = load_native()
    if lib is None:
        return _decode_python(leaf_inputs, extra_datas, pad_len, data)

    t = resolve_threads(n, threads if threads else workers)
    length = np.zeros((n,), np.int32)
    ts = np.zeros((n,), np.int64)
    ety = np.zeros((n,), np.int32)
    status = np.zeros((n,), np.int32)
    out = (data, length, ts, ety, status)

    if t > 1:
        spans = _decode_native_mt(
            lib, leaf_inputs, extra_datas, pad_len, out, t)
        if spans is not None:
            # Merge per-chunk issuer groups by DER bytes in chunk order:
            # the merged group order equals the serial pass's
            # first-appearance order.
            group = np.full((n,), -1, np.int32)
            group_issuers: list = []
            gid_of: dict = {}
            for (lo, hi), span in spans:
                c_group, c_issuers = _issuer_groups(hi - lo, *span)
                remap = np.full((len(c_issuers) + 1,), -1, np.int32)
                for g, der in enumerate(c_issuers):
                    remap[g] = _assign_gid(gid_of, group_issuers, der)
                group[lo:hi] = remap[c_group]
            return DecodedBatch(data, length, ts, ety, None, status,
                                issuer_group=group,
                                group_issuers=group_issuers)
        # A chunk's issuer slice overflowed (pathologically skewed
        # extra_data): retry serial with the undivided buffer.

    span = _decode_native_into(lib, leaf_inputs, extra_datas, pad_len, out)
    if span is None:  # issuer scratch overflow — impossible by sizing
        return _decode_python(leaf_inputs, extra_datas, pad_len, data)
    group, group_issuers = _issuer_groups(n, *span)
    return DecodedBatch(data, length, ts, ety, None, status,
                        issuer_group=group, group_issuers=group_issuers)


def _issuer_groups(
    n: int,
    issuer_off: np.ndarray,
    issuer_len: np.ndarray,
    issuer_buf: np.ndarray,
) -> tuple:
    """Group entries by issuer span. The native decoder dedups
    identical issuer DERs into shared (off, len) spans, so grouping is
    a NumPy unique over the span ids."""
    has = issuer_len > 0
    # off < issuer_cap (< 2^42), len < 2^21: the key fits int64.
    combo = issuer_off * (1 << 21) + issuer_len
    group = np.full((n,), -1, np.int32)
    if not has.any():
        return group, []
    uniq, inverse = np.unique(combo[has], return_inverse=True)
    group[has] = inverse.astype(np.int32)
    buf = issuer_buf.tobytes()
    group_issuers = [
        buf[int(c) >> 21 : (int(c) >> 21) + (int(c) & ((1 << 21) - 1))]
        for c in uniq
    ]
    return group, group_issuers


def _decode_native_into(lib, leaf_inputs, extra_datas, pad_len: int,
                        out: tuple) -> Optional[tuple]:
    """Run the native decoder writing into ``out = (data, length, ts,
    ety, status)``; returns the issuer span arrays ``(issuer_off,
    issuer_len, issuer_buf)``, or None on native scratch overflow."""
    n = len(leaf_inputs)
    data, length, ts, ety, status = out
    li_buf, li_off = _concat_b64(leaf_inputs)
    ed_buf, ed_off = _concat_b64(extra_datas)
    issuer_off = np.zeros((n,), np.int64)
    issuer_len = np.zeros((n,), np.int32)
    # Issuer chain certs are ~1-2 KB; extra_data is an upper bound.
    issuer_cap = max(len(ed_buf), 4096)
    issuer_buf = np.zeros((issuer_cap,), np.uint8)
    # Scratch must hold one decoded leaf_input + extra_data.
    max_li = int(np.max(np.diff(li_off))) if n else 0
    max_ed = int(np.max(np.diff(ed_off))) if n else 0
    scratch = np.zeros((max(max_li + max_ed + 64, 4096),), np.uint8)

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    used = lib.ctmr_decode_entries(
        n,
        li_buf, li_off.ctypes.data_as(i64p),
        ed_buf, ed_off.ctypes.data_as(i64p),
        pad_len,
        data.ctypes.data_as(u8p), length.ctypes.data_as(i32p),
        ts.ctypes.data_as(i64p), ety.ctypes.data_as(i32p),
        issuer_buf.ctypes.data_as(u8p), issuer_cap,
        issuer_off.ctypes.data_as(i64p), issuer_len.ctypes.data_as(i32p),
        status.ctypes.data_as(i32p),
        scratch.ctypes.data_as(u8p), scratch.shape[0],
    )
    if used < 0:
        return None
    return issuer_off, issuer_len, issuer_buf[:used]


def _decode_native_mt(lib, leaf_inputs, extra_datas, pad_len: int,
                      out: tuple, threads: int) -> Optional[list]:
    """One ``ctmr_decode_entries_mt`` call decoding ``threads``
    contiguous lane ranges in parallel. Returns ``[((lo, hi),
    (issuer_off, issuer_len, issuer_buf))]`` per chunk, or None when a
    chunk's issuer slice overflowed (the caller retries serial)."""
    n = len(leaf_inputs)
    data, length, ts, ety, status = out
    li_buf, li_off = _concat_b64(leaf_inputs)
    ed_buf, ed_off = _concat_b64(extra_datas)
    issuer_off = np.zeros((n,), np.int64)
    issuer_len = np.zeros((n,), np.int32)
    # Chunk bounds mirror the C split: lane [n*t//T, n*(t+1)//T).
    bounds = [(n * t) // threads for t in range(threads + 1)]
    # Each chunk's issuer slice must hold that chunk's chain bytes; its
    # base64 extra_data length bounds them.
    iss_each = max(
        4096,
        max(int(ed_off[bounds[t + 1]] - ed_off[bounds[t]])
            for t in range(threads)),
    )
    issuer_buf = np.zeros((threads * iss_each,), np.uint8)
    max_li = int(np.max(np.diff(li_off))) if n else 0
    max_ed = int(np.max(np.diff(ed_off))) if n else 0
    scratch_each = max(max_li + max_ed + 64, 4096)
    scratch = np.zeros((threads * scratch_each,), np.uint8)
    chunk_used = np.zeros((threads,), np.int64)

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.ctmr_decode_entries_mt(
        n,
        li_buf, li_off.ctypes.data_as(i64p),
        ed_buf, ed_off.ctypes.data_as(i64p),
        pad_len,
        data.ctypes.data_as(u8p), length.ctypes.data_as(i32p),
        ts.ctypes.data_as(i64p), ety.ctypes.data_as(i32p),
        issuer_buf.ctypes.data_as(u8p), issuer_buf.shape[0],
        issuer_off.ctypes.data_as(i64p), issuer_len.ctypes.data_as(i32p),
        status.ctypes.data_as(i32p),
        scratch.ctypes.data_as(u8p), scratch_each,
        threads, chunk_used.ctypes.data_as(i64p),
    )
    if rc < 0:
        return None
    return [
        ((bounds[t], bounds[t + 1]),
         (issuer_off[bounds[t]:bounds[t + 1]],
          issuer_len[bounds[t]:bounds[t + 1]],
          issuer_buf))
        for t in range(threads)
        if bounds[t + 1] > bounds[t]
    ]


def pack_ders(ders: Sequence[bytes], pad_len: int,
              threads: Optional[int] = None):
    """Pack pre-decoded DER blobs into the ``[n, pad_len]`` row layout
    through the native packer (parallel over lane ranges when
    ``threads`` > 1); returns ``(data, length, ok, packed_count)``, or
    None when the native library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    n = len(ders)
    blob = np.frombuffer(b"".join(ders) or b"\x00", np.uint8)
    off = np.zeros((n + 1,), np.int64)
    if n:
        off[1:] = np.cumsum([len(d) for d in ders])
    data = np.zeros((n, pad_len), np.uint8)
    length = np.zeros((n,), np.int32)
    ok = np.zeros((n,), np.uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    args = (n, blob.ctypes.data_as(u8p), off.ctypes.data_as(i64p), pad_len,
            data.ctypes.data_as(u8p), length.ctypes.data_as(i32p),
            ok.ctypes.data_as(u8p))
    t = resolve_threads(n, threads)
    if t > 1:
        packed = lib.ctmr_pack_ders_mt(*args, t)
    else:
        packed = lib.ctmr_pack_ders(*args)
    return data, length, ok, int(packed)


def _decode_python(leaf_inputs: Sequence[str], extra_datas: Sequence[str],
                   pad_len: int, data: np.ndarray) -> DecodedBatch:
    """Pure-Python decode with the native decoder's semantics."""
    import base64
    import binascii

    from ct_mapreduce_tpu_torch.ingest import leaf as leaflib

    n = len(leaf_inputs)
    data.fill(0)
    length = np.zeros((n,), np.int32)
    ts = np.zeros((n,), np.int64)
    ety = np.zeros((n,), np.int32)
    status = np.zeros((n,), np.int32)
    issuers: list[Optional[bytes]] = [None] * n
    for i in range(n):
        try:
            li = base64.b64decode(leaf_inputs[i], validate=True)
            ed = base64.b64decode(extra_datas[i] or "", validate=True)
        except (binascii.Error, ValueError):
            status[i] = BAD_B64
            continue
        try:
            e = leaflib.decode_entry(i, li, ed)
        except leaflib.LeafDecodeError as err:
            status[i] = (
                UNSUPPORTED if "unsupported" in str(err)
                or "unknown entry_type" in str(err) else BAD_LEAF
            )
            continue
        ts[i] = e.timestamp_ms
        ety[i] = e.entry_type
        if len(e.cert_der) > pad_len:
            status[i] = TOO_LONG
            continue
        data[i, : len(e.cert_der)] = np.frombuffer(e.cert_der, np.uint8)
        length[i] = len(e.cert_der)
        if not e.issuer_der:  # absent OR zero-length chain[0]
            status[i] = NO_CHAIN
        elif len(e.issuer_der) >= (1 << 21):
            # Native-path parity: >=2 MiB issuer DERs take the exact
            # host lane; the cert row stays packed.
            status[i] = ISSUER_TOO_LONG
        else:
            issuers[i] = e.issuer_der
    group = np.full((n,), -1, np.int32)
    group_issuers: list = []
    gid_of: dict = {}
    for i, der in enumerate(issuers):
        if der is not None:
            group[i] = _assign_gid(gid_of, group_issuers, der)
    return DecodedBatch(data, length, ts, ety, issuers, status,
                        issuer_group=group, group_issuers=group_issuers)
