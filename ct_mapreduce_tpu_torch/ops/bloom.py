"""The Bloom bit-scatter of the filter build (K5) and its plain PyTorch
version.

:func:`bloom_scatter` ORs the probe bits of a batch of keys into a
packed ``uint32`` word arena (``int32`` bit patterns): lane ``l`` of
group ``gid[l]`` sets, for ``i < ks[g]``, bit ``offs[g] + ((a + i·b) mod
ms[g])`` with ``a = (k0 ^ layer·0x9E3779B9) + k2`` and ``b = ((k1 ^
layer·0x85EBCA6B) + k3) | 1`` in wrapping uint32 arithmetic. Bit ``j``
is word ``j >> 5``, bit ``j & 31``. One group at offset 0 is the
one-layer build of ``filter/cascade.py``; many groups side by side are
the fused layer round of ``filter/fused.py``.

A CUDA arena launches the hand-written kernel
(:mod:`~ct_mapreduce_tpu_torch.ops.bloom_cuda`, ``csrc/bloom_scatter.cu``),
a CPU arena runs :func:`bloom_scatter_plain`. There is no fallback
between the two.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GOLD = 0x9E3779B9
MIX = 0x85EBCA6B

#: 32-bit integer operations a lane needs at the least, for the
#: operations half of the kernel's bound: the two key mixes (2 XOR, 2
#: ADD, 1 OR, the two layer products folded to constants) and the group
#: gather's index arithmetic.
OPS_PER_LANE = 6
#: Operations a probe needs at the least: the multiply-add ``a + i·b``,
#: the modulo by a run-time ``m`` (a multiply-high against its
#: reciprocal, a multiply-subtract and a compare-and-correct: 4), the
#: offset add, the word index shift and the bit-mask shift.
OPS_PER_PROBE = 8

#: Words packed a step by the plain version (bounds its int64 scratch).
_PACK_WORDS = 1 << 20


def bloom_scatter_plain(words: torch.Tensor, keys: torch.Tensor,
                        gid: torch.Tensor, offs: torch.Tensor,
                        ms: torch.Tensor, ks: torch.Tensor,
                        layer: int) -> torch.Tensor:
    """Plain PyTorch version of the scatter: the words ride in ``int64``
    masked with ``0xFFFFFFFF`` after every add and multiply (``uint32``
    tensors lack that arithmetic on the CPU), the probes are written
    with ``index_put_`` into a bool arena, which is packed to words and
    ORed into ``words`` (in place; also returned)."""
    dev = words.device
    n = int(keys.shape[0])
    if n == 0 or int(ks.numel()) == 0:
        return words
    k64 = keys.to(torch.int64) & M32
    gold = (int(layer) * GOLD) & M32
    mix = (int(layer) * MIX) & M32
    a = ((k64[:, 0] ^ gold) + k64[:, 2]) & M32
    b = (((k64[:, 1] ^ mix) + k64[:, 3]) & M32) | 1
    g = gid.to(torch.int64)
    m = ms.to(torch.int64)[g]
    kk = ks.to(torch.int64)[g]
    off = offs.to(torch.int64)[g]
    i = torch.arange(int(ks.max()), dtype=torch.int64, device=dev)
    pos = ((a[:, None] + ((i[None, :] * b[:, None]) & M32)) & M32) \
        % m[:, None]
    live = i[None, :] < kk[:, None]
    tgt = (off[:, None] + pos)[live]
    n_words = int(words.shape[0])
    bits = torch.zeros((n_words * 32,), dtype=torch.bool, device=dev)
    bits.index_put_((tgt,), torch.ones_like(tgt, dtype=torch.bool))
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    for w0 in range(0, n_words, _PACK_WORDS):
        w1 = min(n_words, w0 + _PACK_WORDS)
        chunk = bits[w0 * 32: w1 * 32].view(w1 - w0, 32).to(torch.int64)
        packed = (chunk << shifts).sum(dim=1)
        packed = torch.where(packed >= 1 << 31, packed - (1 << 32), packed)
        words[w0:w1] |= packed.to(torch.int32)
    return words


def bloom_scatter(words: torch.Tensor, keys: torch.Tensor,
                  gid: torch.Tensor, offs: torch.Tensor, ms: torch.Tensor,
                  ks: torch.Tensor, layer: int) -> torch.Tensor:
    """OR the probe bits of ``keys`` into ``words`` (in place; returned).

    ``words`` int32[W] arena; ``keys`` int32[B, 4] (uint32 bit
    patterns); ``gid`` int32[B] group of each lane; ``offs`` int64[G]
    bit offsets, ``ms`` int32[G] layer sizes (bits), ``ks`` int32[G]
    probe counts. Every probe must land inside the arena. CUDA tensors
    launch K5; CPU tensors run the plain version."""
    if words.device.type == "cuda":
        from ct_mapreduce_tpu_torch.ops import bloom_cuda

        return bloom_cuda.scatter(words, keys, gid, offs, ms, ks, layer)
    if words.device.type == "cpu":
        return bloom_scatter_plain(words, keys, gid, offs, ms, ks, layer)
    raise ValueError(f"no Bloom scatter path for device {words.device}")
