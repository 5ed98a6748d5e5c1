"""Wrapper of the hand-written Hopper Bloom bit-scatter K5
(``csrc/bloom_scatter.cu``), which replaces the XLA scatters of the JAX
package's filter build, ``filter/cascade.py::_layer_bits_jit`` and
``filter/fused.py::_fused_bits_jit``.

Built by :mod:`.cuda_build` at first use and loaded with ``ctypes``.
The plain PyTorch version beside it is
:func:`ct_mapreduce_tpu_torch.ops.bloom.bloom_scatter_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from ct_mapreduce_tpu_torch.ops import cuda_build
from ct_mapreduce_tpu_torch.ops.cuda_build import check_tensor

#: Kernel launches made through :func:`scatter` (an empty batch launches
#: nothing and does not count).
LAUNCHES = 0


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.ctmr_bloom_scatter.restype = ctypes.c_int
    lib.ctmr_bloom_scatter.argtypes = [p, p, p, p, p, ctypes.c_uint, p,
                                       ctypes.c_longlong, ctypes.c_int, p]


LIB = cuda_build.Library("bloom_scatter.cu", (), _bind)
build = LIB.build


def scatter(words: torch.Tensor, keys: torch.Tensor, gid: torch.Tensor,
            offs: torch.Tensor, ms: torch.Tensor, ks: torch.Tensor,
            layer: int) -> torch.Tensor:
    """Launch the kernel on the current stream: OR the probe bits of
    ``keys`` into ``words`` (in place; returned).

    All tensors contiguous, on one CUDA device: ``words`` int32[W],
    ``keys`` int32[B, 4] starting on a 16-byte boundary, ``gid``
    int32[B], ``offs`` int64[G], ``ms`` and ``ks`` int32[G]. The kernel
    trusts ``gid`` to index the group vectors and every probe to land
    inside the arena."""
    global LAUNCHES
    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"the Bloom scatter kernel needs CUDA tensors, got {dev}")
    b = int(keys.shape[0]) if keys.dim() == 2 else -1
    g = int(ms.shape[0]) if ms.dim() == 1 else -1
    check_tensor("words", words, torch.int32, (int(words.shape[0]),), dev)
    check_tensor("keys", keys, torch.int32, (b, 4), dev)
    check_tensor("gid", gid, torch.int32, (b,), dev)
    check_tensor("offs", offs, torch.int64, (g,), dev)
    check_tensor("ms", ms, torch.int32, (g,), dev)
    check_tensor("ks", ks, torch.int32, (g,), dev)
    if keys.data_ptr() % 16:
        raise ValueError("keys must start on a 16-byte boundary "
                         "(the kernel reads a key as one uint4)")
    if not 0 <= int(layer) <= 0xFFFFFFFF:
        raise ValueError(f"layer {layer} is not a uint32")
    if b == 0:
        return words
    rc = LIB.get().ctmr_bloom_scatter(
        keys.data_ptr(), gid.data_ptr(), offs.data_ptr(), ms.data_ptr(),
        ks.data_ptr(), int(layer), words.data_ptr(), b, dev.index or 0,
        cuda_build.stream_of(dev))
    cuda_build.raise_on(rc, "Bloom scatter kernel")
    LAUNCHES += 1
    return words
