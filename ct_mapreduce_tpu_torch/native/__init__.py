"""Native host-side decoder (C++ via ctypes), copied from
``ct_mapreduce_tpu.native``.

Builds :file:`ctmr_native.cpp` on first use into the checkout's
git-ignored ``build/native`` directory (never beside the source) and
loads it. Bound here: the batch leaf decoder and DER packer the ingest
sink calls, the sidecar extraction of the pre-parsed lane and the
embedded-SCT extraction of the verify lane, each with its
multi-threaded entry point.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

from ct_mapreduce_tpu_torch.device import build_dir

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "ctmr_native.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LOAD_FAILED = False
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def _so_path() -> str:
    """The library's path; its name carries a hash of the source and
    the flags, so an edit of either builds anew."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir("native"),
                        f"libctmr_native-{h.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    # Compile to a temp path and rename atomically — a concurrent
    # process must never dlopen a half-written .so.
    tmp = f"{so}.build.{os.getpid()}"
    for cxx in ("g++", "c++", "clang++"):
        try:
            res = subprocess.run(
                [cxx, *_CXX_FLAGS, "-o", tmp, _SRC],
                capture_output=True, timeout=240,
            )
        except (FileNotFoundError, subprocess.TimeoutExpired):
            continue
        if res.returncode == 0:
            os.replace(tmp, so)
            return True
    if os.path.exists(tmp):
        os.unlink(tmp)
    return False


def load() -> Optional[ctypes.CDLL]:
    """The shared library, or None when unavailable (no compiler)."""
    global _LIB, _LOAD_FAILED
    if _LIB is not None or _LOAD_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LOAD_FAILED:
            return _LIB
        so = _so_path()
        if not os.path.exists(so):
            if not _build(so):
                _LOAD_FAILED = True
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            _LOAD_FAILED = True
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        decode_args = [
            ctypes.c_int64,
            ctypes.c_char_p, i64p,
            ctypes.c_char_p, i64p,
            ctypes.c_int64,
            u8p, i32p,
            i64p, i32p,
            u8p, ctypes.c_int64,
            i64p, i32p,
            i32p,
            u8p, ctypes.c_int64,
        ]
        lib.ctmr_decode_entries.restype = ctypes.c_int64
        lib.ctmr_decode_entries.argtypes = decode_args
        lib.ctmr_decode_entries_mt.restype = ctypes.c_int64
        lib.ctmr_decode_entries_mt.argtypes = decode_args + [
            ctypes.c_int64, i64p]
        pack_args = [
            ctypes.c_int64,
            u8p, i64p,
            ctypes.c_int64,
            u8p, i32p, u8p,
        ]
        lib.ctmr_pack_ders.restype = ctypes.c_int64
        lib.ctmr_pack_ders.argtypes = pack_args
        lib.ctmr_pack_ders_mt.restype = ctypes.c_int64
        lib.ctmr_pack_ders_mt.argtypes = pack_args + [ctypes.c_int64]
        sidecar_args = [
            ctypes.c_int64,
            u8p, ctypes.c_int64, i32p,
            u8p,
            i32p, i32p,
            i32p,
            u8p, u8p,
            i32p, i32p,
            i32p, i32p,
            i32p, i32p,
            i32p, i32p,
        ]
        lib.ctmr_extract_sidecars.restype = None
        lib.ctmr_extract_sidecars.argtypes = sidecar_args
        # Lane-range split over the native worker pool.
        lib.ctmr_extract_sidecars_mt.restype = None
        lib.ctmr_extract_sidecars_mt.argtypes = sidecar_args + [
            ctypes.c_int64]
        sct_args = [
            ctypes.c_int64,
            u8p, ctypes.c_int64, i32p,
            u8p,
            u8p,
            u8p, u8p,
            i64p,
            u8p, u8p,
            u8p, u8p,
        ]
        lib.ctmr_extract_scts_v2.restype = None
        lib.ctmr_extract_scts_v2.argtypes = sct_args
        lib.ctmr_extract_scts_v2_mt.restype = None
        lib.ctmr_extract_scts_v2_mt.argtypes = sct_args + [ctypes.c_int64]
        _LIB = lib
        return _LIB
