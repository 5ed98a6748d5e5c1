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

import numpy as np
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

#: K5's schedule (``csrc/bloom_scatter.cu``): regions of at least
#: 2^MIN_REGION_BITS bits, at most MAX_REGIONS of them (the region grows
#: past 2^29-bit arenas), work items of at most CHUNK probes, tiles
#: (and blocks) of LANE_THREADS lanes.
MIN_REGION_BITS = 18
MAX_REGIONS = 2048
CHUNK = 16384
LANE_THREADS = 256
#: The largest ``kmax`` the kernel takes (its bin phase holds
#: LANE_THREADS * kmax probes twice and their 16-bit ranks, 10 B each, in
#: shared memory); the cascade's k is at most 16.
KMAX_LIMIT = 32
#: The largest arena, in bits: a bit index fits 32 bits.
MAX_ARENA_BITS = (1 << 31) - 1


def region_bits(n_words: int, min_bits: int = MIN_REGION_BITS) -> int:
    """log2 of K5's region size in bits for an arena of ``n_words``."""
    r = min_bits
    while -(-n_words * 32 // (1 << r)) > MAX_REGIONS:
        r += 1
    return r


def scratch_bytes(n: int, kmax: int, n_words: int, n_groups: int) -> int:
    """Bytes of scratch K5 takes for ``n`` lanes: the region counts, a
    reciprocal a group and the probe lists (``n * kmax * 4``), each part
    16-byte aligned (the source's ``layout``)."""

    def a16(x: int) -> int:
        return (x + 15) & ~15

    regions = max(1, -(-n_words * 32 // (1 << region_bits(n_words))))
    off = a16(4 * regions)  # counts
    off = a16(off + 4 * n_groups)  # reciprocals
    return a16(off + 4 * n * kmax)  # probe lists


def _check_kmax(kmax: int, ks) -> None:
    """K5's prep phase traps on a group of more than ``kmax`` probes
    (its probe lists hold ``kmax`` a lane); the host paths raise."""
    most = int(ks.max()) if len(ks) else 0
    if kmax < most:
        raise ValueError(f"kmax {kmax} is below a group's k of {most}")


def binned_model(words: np.ndarray, keys: np.ndarray, gid: np.ndarray,
                 offs: np.ndarray, ms: np.ndarray, ks: np.ndarray,
                 layer: int, kmax: int | None = None,
                 min_region_bits: int = MIN_REGION_BITS,
                 chunk: int = CHUNK) -> dict:
    """NumPy model of K5's schedule, phase for phase, at the kernel's
    region size unless named: ORs the probe bits of ``keys`` into the
    uint32 ``words`` (in place) and returns what the phases made.

    prep: a reciprocal ``floor((2^32 - 1) / m)`` a group (a group whose
    k passes ``kmax`` raises ValueError: the kernel traps); count: probes
    by region (the modulo a multiply-high and one correction); scan:
    list offsets and work items of at most ``chunk`` probes; bin: each
    probe's bit offset in its region, in its region's list, a tile of
    LANE_THREADS lanes at a time (past LANE_THREADS regions, over the
    tile's own region range, which every probe of the tile must fall
    in); own: a region's words loaded, ORed and stored by its one item,
    or, for a region of several items, each item's words ORed from
    zero."""
    words = np.asarray(words)
    n_words = int(words.shape[0])
    n = int(keys.shape[0])
    ks = np.asarray(ks, np.int64)
    if kmax is None:
        kmax = int(ks.max()) if ks.size else 0
    _check_kmax(kmax, ks)
    r_bits = region_bits(n_words, min_region_bits)
    regions = max(1, -(-n_words * 32 // (1 << r_bits)))
    # prep
    m32 = np.asarray(ms, np.uint64)
    minv = np.uint64(M32) // m32
    # count
    keys = np.asarray(keys, np.uint32).astype(np.uint64)
    gold = np.uint64((int(layer) * GOLD) & M32)
    mix = np.uint64((int(layer) * MIX) & M32)
    a = ((keys[:, 0] ^ gold) + keys[:, 2]) & np.uint64(M32)
    b = (((keys[:, 1] ^ mix) + keys[:, 3]) & np.uint64(M32)) | np.uint64(1)
    g = np.asarray(gid, np.int64)
    m, inv = m32[g], minv[g]
    k = ks[g]
    i = np.arange(max(kmax, 0), dtype=np.uint64)
    x = (a[:, None] + i[None, :] * b[:, None]) & np.uint64(M32)
    q = (x * inv[:, None]) >> np.uint64(32)
    rem = x - q * m[:, None]
    rem = np.where(rem >= m[:, None], rem - m[:, None], rem)
    live = i[None, :].astype(np.int64) < k[:, None]
    tgt = (np.asarray(offs, np.int64)[g][:, None] + rem.astype(np.int64))
    region = tgt >> r_bits
    tile = np.broadcast_to((np.arange(n) // LANE_THREADS)[:, None],
                           tgt.shape)
    off_g = np.asarray(offs, np.int64)[g]
    has = k > 0
    lo = np.where(has, off_g >> r_bits, np.iinfo(np.int64).max)
    hi = np.where(has, (off_g + m.astype(np.int64) - 1) >> r_bits, -1)
    nt = -(-n // LANE_THREADS)
    pad = nt * LANE_THREADS - n
    t_lo = np.pad(lo, (0, pad), constant_values=np.iinfo(np.int64).max
                  ).reshape(nt, LANE_THREADS).min(1)
    t_hi = np.pad(hi, (0, pad), constant_values=-1).reshape(
        nt, LANE_THREADS).max(1)
    spans = t_hi - t_lo + 1
    inside = ((region >= t_lo[tile]) & (region <= t_hi[tile])) | ~live
    if not inside.all():
        raise AssertionError("a probe left its tile's region range")
    tgt, region, tile = tgt[live], region[live], tile[live]
    counts = np.bincount(region, minlength=regions)
    # scan
    start = np.concatenate(([0], np.cumsum(counts)[:-1]))
    per = -(-counts // chunk)
    items = [(r, int(start[r]) + j * chunk,
              int(min(start[r] + (j + 1) * chunk, start[r] + counts[r])),
              int(per[r]) > 1)
             for r in range(regions) for j in range(int(per[r]))]
    # bin: each region's list, its tiles' runs in tile order
    order = np.lexsort((tile, region))
    lists = (tgt[order] & ((1 << r_bits) - 1)).astype(np.uint32)
    # own
    rwords = 1 << (r_bits - 5)
    out = words.view(np.uint32)
    for r, s, e, shared in items:
        w0 = r * rwords
        nw = min(rwords, n_words - w0)
        bits = np.zeros((nw * 32,), bool)
        bits[lists[s:e]] = True
        mine = np.packbits(bits, bitorder="little").view("<u4")
        # One item loads, ORs and stores its region; each of several ORs
        # its words from zero into the arena: an OR either way.
        out[w0:w0 + nw] |= mine
    return {"region_bits": r_bits, "regions": regions,
            "counts": counts, "items": items,
            "shared_items": sum(1 for it in items if it[3]),
            "probes": int(counts.sum()),
            "max_tile_span": int(spans.max()) if spans.size else 0}


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
                  ks: torch.Tensor, layer: int,
                  kmax: int | None = None) -> torch.Tensor:
    """OR the probe bits of ``keys`` into ``words`` (in place; returned).

    ``words`` int32[W] arena; ``keys`` int32[B, 4] (uint32 bit
    patterns); ``gid`` int32[B] group of each lane; ``offs`` int64[G]
    bit offsets, ``ms`` int32[G] layer sizes (bits), ``ks`` int32[G]
    probe counts. Every probe must land inside the arena. CUDA tensors
    launch K5 (``kmax``, the largest of ``ks`` when the caller knows it
    on the host, spares the kernel's wrapper a read of ``ks`` off the
    card; one below a group's k traps the kernel); CPU tensors run the
    plain version (and raise on such a ``kmax``)."""
    if words.device.type == "cuda":
        from ct_mapreduce_tpu_torch.ops import bloom_cuda

        return bloom_cuda.scatter(words, keys, gid, offs, ms, ks, layer,
                                  kmax)
    if words.device.type == "cpu":
        if kmax is not None:
            _check_kmax(kmax, ks)
        return bloom_scatter_plain(words, keys, gid, offs, ms, ks, layer)
    raise ValueError(f"no Bloom scatter path for device {words.device}")
