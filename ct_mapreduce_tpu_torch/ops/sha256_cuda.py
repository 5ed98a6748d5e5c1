"""Wrapper of the hand-written Hopper fingerprint kernel
(``csrc/sha256_fp.cu``), which replaces the JAX package's Pallas
SHA-256 (``ops/pallas_sha256.py::_kernel``) with the message build of
``pipeline.fingerprints`` fused in front.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use (into the checkout's
git-ignored ``build/cuda``), and loaded with ``ctypes``. The plain
PyTorch version beside it is
:func:`ct_mapreduce_tpu_torch.ops.sha256.fingerprints_plain`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import torch

from ct_mapreduce_tpu_torch.core.packing import MAX_SERIAL_BYTES
from ct_mapreduce_tpu_torch.device import build_dir

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "sha256_fp.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: Kernel launches made through :func:`fingerprint64` (a launch of an
#: empty batch does not count: nothing runs).
LAUNCHES = 0

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found; the fingerprint kernel cannot build")


def build() -> str:
    """Compile the kernel library unless a build of this exact source
    and these flags exists (the file name carries a hash of both);
    returns its path. Raises with the compiler's output when the build
    fails."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    so = os.path.join(build_dir("cuda"),
                      f"libsha256_fp-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.build.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.ctmr_sha256_fp.restype = ctypes.c_int
            lib.ctmr_sha256_fp.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_void_p,
            ]
            _LIB = lib
        return _LIB


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, want {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fingerprint64(issuer_idx: torch.Tensor, exp_hour: torch.Tensor,
                  serials: torch.Tensor,
                  serial_len: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream: ``int32[B, 4]``
    fingerprints (uint32 bit patterns of digest words 4..7).

    All inputs must be contiguous CUDA tensors on one device:
    ``issuer_idx``, ``exp_hour`` and ``serial_len`` int32[B],
    ``serials`` uint8[B, 46]."""
    global LAUNCHES
    dev = serials.device
    if dev.type != "cuda":
        raise ValueError(f"the fingerprint kernel needs CUDA tensors, got {dev}")
    b = int(issuer_idx.shape[0]) if issuer_idx.dim() == 1 else -1
    _check("issuer_idx", issuer_idx, torch.int32, (b,), dev)
    _check("exp_hour", exp_hour, torch.int32, (b,), dev)
    _check("serials", serials, torch.uint8, (b, MAX_SERIAL_BYTES), dev)
    _check("serial_len", serial_len, torch.int32, (b,), dev)
    out = torch.empty((b, 4), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    lib = _lib()
    rc = lib.ctmr_sha256_fp(
        issuer_idx.data_ptr(), exp_hour.data_ptr(), serials.data_ptr(),
        serial_len.data_ptr(), out.data_ptr(), b, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fingerprint kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
