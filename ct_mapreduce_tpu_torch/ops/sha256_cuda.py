"""Wrapper of the hand-written Hopper fingerprint kernel
(``csrc/sha256_fp.cu``), which replaces the JAX package's Pallas
SHA-256 (``ops/pallas_sha256.py::_kernel``) with the message build of
``pipeline.fingerprints`` fused in front.

Built by :mod:`.cuda_build` at first use and loaded with ``ctypes``.
The plain PyTorch version beside it is
:func:`ct_mapreduce_tpu_torch.ops.sha256.fingerprints_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from ct_mapreduce_tpu_torch.core.packing import MAX_SERIAL_BYTES
from ct_mapreduce_tpu_torch.ops import cuda_build
from ct_mapreduce_tpu_torch.ops.cuda_build import check_tensor

#: Kernel launches made through :func:`fingerprint64` (a launch of an
#: empty batch does not count: nothing runs).
LAUNCHES = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.ctmr_sha256_fp.restype = ctypes.c_int
    lib.ctmr_sha256_fp.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p,
    ]


LIB = cuda_build.Library("sha256_fp.cu", (), _bind)
build = LIB.build


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
    check_tensor("issuer_idx", issuer_idx, torch.int32, (b,), dev)
    check_tensor("exp_hour", exp_hour, torch.int32, (b,), dev)
    check_tensor("serials", serials, torch.uint8, (b, MAX_SERIAL_BYTES), dev)
    check_tensor("serial_len", serial_len, torch.int32, (b,), dev)
    out = torch.empty((b, 4), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    rc = LIB.get().ctmr_sha256_fp(
        issuer_idx.data_ptr(), exp_hour.data_ptr(), serials.data_ptr(),
        serial_len.data_ptr(), out.data_ptr(), b, dev.index or 0,
        cuda_build.stream_of(dev))
    cuda_build.raise_on(rc, "fingerprint kernel")
    LAUNCHES += 1
    return out
