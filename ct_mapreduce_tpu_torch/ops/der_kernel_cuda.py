"""Wrapper of the hand-written Hopper DER walker K3
(``csrc/der_walk.cu``), which replaces the JAX package's XLA walker
``ops/der_kernel.py::parse_certs_rows`` together with
``gather_serials_rows`` and the CN window of ``window_bytes_rows``: one
launch writes every ``ParsedCerts`` field, the serial window with
``fits``, and the issuer-CN window when one is asked for.

Built by :mod:`.cuda_build` at first use and loaded with ``ctypes``.
The plain PyTorch version beside it is
:func:`ct_mapreduce_tpu_torch.ops.der_kernel.walk_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from ct_mapreduce_tpu_torch.ops import cuda_build
from ct_mapreduce_tpu_torch.ops.cuda_build import check_tensor
from ct_mapreduce_tpu_torch.ops.der_kernel import (
    MAX_FIXED_WINDOW_BYTES, ParsedCerts, WalkOut)

#: Kernel launches made through :func:`walk` (an empty batch launches
#: nothing and does not count).
LAUNCHES = 0

#: Widest serial window the kernel's shared-memory staging is sized for
#: (``kMaxSerial`` in ``csrc/der_walk.cu``).
MAX_SERIAL_WINDOW = 256

#: Row order of the kernel's int32 field block and uint8 flag block.
FIELDS = ("serial_off", "serial_len", "not_after_hour", "issuer_cn_off",
          "issuer_cn_len", "issuer_off", "issuer_len", "spki_off",
          "spki_len", "crldp_off", "crldp_len")
FLAGS = ("ok", "is_ca", "has_crldp", "fits")


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ctmr_der_walk.restype = ctypes.c_int
    lib.ctmr_der_walk.argtypes = [p, p, ctypes.c_longlong, i, i, i, i,
                                  p, p, p, p, i, p]


LIB = cuda_build.Library("der_walk.cu", ("der_walk.cuh",), _bind)
build = LIB.build


def walk(data: torch.Tensor, length: torch.Tensor, scan_issuer_cn: bool,
         cn_window: int = 0, max_serial_bytes: int = 46) -> WalkOut:
    """Launch the walker on the current stream over contiguous CUDA
    ``data`` uint8[B, L] (L >= 1) and ``length`` int32[B]."""
    global LAUNCHES
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"the walker kernel needs CUDA tensors, got {dev}")
    if data.dim() != 2 or data.shape[1] < 1:
        raise ValueError(f"data must be [B, L] with L >= 1, got {tuple(data.shape)}")
    b, row_len = (int(x) for x in data.shape)
    check_tensor("data", data, torch.uint8, (b, row_len), dev)
    check_tensor("length", length, torch.int32, (b,), dev)
    if not 0 <= cn_window <= MAX_FIXED_WINDOW_BYTES:
        raise ValueError(f"cn_window {cn_window} outside 0..{MAX_FIXED_WINDOW_BYTES}")
    if cn_window and not scan_issuer_cn:
        raise ValueError("a CN window needs the issuer-CN scan")
    if not 1 <= max_serial_bytes <= MAX_SERIAL_WINDOW:
        raise ValueError(
            f"max_serial_bytes {max_serial_bytes} outside 1..{MAX_SERIAL_WINDOW}"
            ": the kernel stages the serial window in shared memory sized for "
            f"at most {MAX_SERIAL_WINDOW} bytes a lane")
    fields = torch.empty((len(FIELDS), b), dtype=torch.int32, device=dev)
    flags = torch.empty((len(FLAGS), b), dtype=torch.uint8, device=dev)
    serials = torch.empty((b, max_serial_bytes), dtype=torch.uint8, device=dev)
    cn = torch.empty((b, cn_window), dtype=torch.uint8, device=dev)
    if b:
        rc = LIB.get().ctmr_der_walk(
            data.data_ptr(), length.data_ptr(), b, row_len,
            int(scan_issuer_cn), cn_window, max_serial_bytes,
            fields.data_ptr(), flags.data_ptr(), serials.data_ptr(),
            cn.data_ptr() if cn_window else None, dev.index or 0,
            cuda_build.stream_of(dev))
        cuda_build.raise_on(rc, "walker kernel")
        LAUNCHES += 1
    f = dict(zip(FIELDS, fields.unbind(0)))
    g = dict(zip(FLAGS, flags.view(torch.bool).unbind(0)))
    parsed = ParsedCerts(ok=g["ok"], is_ca=g["is_ca"],
                         has_crldp=g["has_crldp"], **f)
    return WalkOut(parsed, serials, g["fits"], cn)
