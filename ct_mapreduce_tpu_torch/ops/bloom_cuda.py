"""Wrapper of the hand-written Hopper Bloom bit-scatter K5
(``csrc/bloom_scatter.cu``), which replaces the XLA scatters of the JAX
package's filter build, ``filter/cascade.py::_layer_bits_jit`` and
``filter/fused.py::_fused_bits_jit``.

Built by :mod:`.cuda_build` at first use and loaded with ``ctypes``.
The plain PyTorch version beside it is
:func:`ct_mapreduce_tpu_torch.ops.bloom.bloom_scatter_plain`; the NumPy
model of the kernel's schedule is :func:`~.bloom.binned_model`.
"""

from __future__ import annotations

import ctypes

import torch

from ct_mapreduce_tpu_torch.ops import bloom, cuda_build
from ct_mapreduce_tpu_torch.ops.cuda_build import check_tensor

#: Kernel launches made through :func:`scatter` (an empty batch launches
#: nothing and does not count).
LAUNCHES = 0
#: Runs made through :func:`scatter_phases` (timing only).
PHASE_LAUNCHES = 0
#: The kernel's phases, in one launch: prep, count, scan, bin, own.
PHASES = ("prep", "count", "scan", "bin", "own")


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    args = [p, p, p, p, p, i, i, ctypes.c_uint, p, ll, ll, p, ll, i, p]
    lib.ctmr_bloom_scatter.restype = i
    lib.ctmr_bloom_scatter.argtypes = args
    lib.ctmr_bloom_scatter_phases.restype = i
    lib.ctmr_bloom_scatter_phases.argtypes = [i] + args


LIB = cuda_build.Library("bloom_scatter.cu", (), _bind)
build = LIB.build


def _checked(words, keys, gid, offs, ms, ks, layer, kmax):
    """The launch's arguments after the checks: (lanes, groups, kmax,
    scratch bytes, whether it launches)."""
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
    n_words = int(words.shape[0])
    if n_words * 32 > bloom.MAX_ARENA_BITS:
        raise ValueError(f"an arena of {n_words} words passes "
                         f"{bloom.MAX_ARENA_BITS} bits")
    # A kmax read off the card is known to bound ks; one the caller gives
    # is checked by the kernel, which therefore runs even at 0.
    launches = b > 0 and g > 0
    if kmax is None:
        kmax = int(ks.max()) if g > 0 else 0
        launches = launches and kmax > 0
    if not 0 <= kmax <= bloom.KMAX_LIMIT:
        raise ValueError(f"kmax {kmax} is outside [0, {bloom.KMAX_LIMIT}]")
    if b * kmax >= 1 << 31:
        raise ValueError(f"{b} lanes of {kmax} probes pass the probe "
                         "lists' 32-bit slots")
    return b, g, kmax, bloom.scratch_bytes(b, kmax, n_words, g), launches


def _launch(fn, words, keys, gid, offs, ms, ks, layer, b, g, kmax,
            nbytes) -> None:
    dev = words.device
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    rc = fn(keys.data_ptr(), gid.data_ptr(), offs.data_ptr(), ms.data_ptr(),
            ks.data_ptr(), g, kmax, int(layer), words.data_ptr(),
            int(words.shape[0]), b, scratch.data_ptr(), nbytes,
            dev.index or 0, cuda_build.stream_of(dev))
    cuda_build.raise_on(rc, "Bloom scatter kernel")


def scatter(words: torch.Tensor, keys: torch.Tensor, gid: torch.Tensor,
            offs: torch.Tensor, ms: torch.Tensor, ks: torch.Tensor,
            layer: int, kmax: int | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream: OR the probe bits of
    ``keys`` into ``words`` (in place; returned).

    All tensors contiguous, on one CUDA device: ``words`` int32[W]
    (W * 32 at most 2^31 - 1 bits), ``keys`` int32[B, 4] starting on a
    16-byte boundary, ``gid`` int32[B], ``offs`` int64[G], ``ms`` and
    ``ks`` int32[G]. ``kmax`` must be at least every ``ks`` (a lane makes
    at most ``kmax`` probes); without it the wrapper reads ``ks.max()``
    off the card. A ``kmax`` below a group's k traps the kernel before
    it writes anything: the launch fails, and with it the process's CUDA
    context, raised at the next synchronising call. The scratch
    (``bloom.scratch_bytes``, mostly the ``B * kmax * 4``-byte probe
    lists) comes from torch's caching allocator. One cooperative
    launch: every block is resident, so a card shared with other work
    may refuse it (an error, raised). The kernel trusts ``gid`` to index
    the group vectors and every probe to land inside the arena."""
    global LAUNCHES
    b, g, kmax, nbytes, launches = _checked(words, keys, gid, offs, ms, ks,
                                            layer, kmax)
    if not launches:
        return words
    _launch(LIB.get().ctmr_bloom_scatter, words, keys, gid, offs, ms, ks,
            layer, b, g, kmax, nbytes)
    LAUNCHES += 1
    return words


def scatter_phases(words: torch.Tensor, keys: torch.Tensor,
                   gid: torch.Tensor, offs: torch.Tensor, ms: torch.Tensor,
                   ks: torch.Tensor, layer: int, kmax: int | None = None,
                   phases: int = len(PHASES)) -> torch.Tensor:
    """:func:`scatter`'s first ``phases`` phases alone (0-5, see PHASES;
    0 launches nothing), for measuring: each phase's time is the
    difference of two prefixes, and only all 5 set the words."""
    global PHASE_LAUNCHES
    if not 0 <= phases <= len(PHASES):
        raise ValueError(f"phases {phases} is outside [0, {len(PHASES)}]")
    b, g, kmax, nbytes, launches = _checked(words, keys, gid, offs, ms, ks,
                                            layer, kmax)
    if not launches or phases == 0:
        return words
    fn = LIB.get().ctmr_bloom_scatter_phases
    _launch(lambda *a: fn(phases, *a), words, keys, gid, offs, ms, ks, layer,
            b, g, kmax, nbytes)
    PHASE_LAUNCHES += 1
    return words
