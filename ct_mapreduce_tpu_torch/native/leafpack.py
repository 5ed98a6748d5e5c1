"""Per-lane sidecar extraction on top of the native library — the
host half of the pre-parsed ingest lane (copied from
``ct_mapreduce_tpu.native.leafpack``)."""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ct_mapreduce_tpu_torch.native import load as load_native


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
