"""Bloom filter-cascade primitives (port of
``ct_mapreduce_tpu.filter.cascade``): the crlite-style exact-membership
structure compiled from the aggregation state.

A cascade over an *included* key set I and an *excluded* key set X
(both ``uint32[n, 4]`` fingerprint rows, disjoint) is a list of Bloom
layers: layer 0 holds I at the target false-positive rate, layer 1
holds the members of X that layer 0 false-positives on, layer 2 the
members of I that layer 1 false-positives on, and so on until a layer
produces no false positives against its complement set. Querying walks
the layers; the index of the first missing layer decides (odd ⇒
included), and a key passing every layer is decided by the layer-count
parity. Every key of I ∪ X is answered exactly; keys outside both sets
see roughly the layer-0 false-positive rate.

Probe positions derive from the key words by Kirsch-Mitzenmacher double
hashing in wrapping uint32 arithmetic, identical in the host NumPy lane
(:func:`_probe_np`) and the device lane, so both build bit-equal
bitmaps. The device lane is :func:`ops.bloom.bloom_scatter` on
``device`` (CUDA unless named): on a CUDA arena that is the
hand-written kernel K5, which ORs the probe bits straight into packed
little-endian ``uint32`` words; on the CPU its plain PyTorch version.
Small layers (or ``CTMR_FILTER_DEVICE=0``) take the NumPy lane, as in
the JAX package.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ct_mapreduce_tpu_torch.device import resolve_device
from ct_mapreduce_tpu_torch.ops import bloom
from ct_mapreduce_tpu_torch.telemetry import trace

# Knuth multiplicative-hash constants used to decorrelate layers: the
# key words are already uniform (SHA-256 output), the layer index is
# not — mixing it through these keeps layer ℓ's probes independent of
# layer ℓ+2's over the same keys.
_GOLD = np.uint32(0x9E3779B9)
_MIX = np.uint32(0x85EBCA6B)

# Below this many keys a layer builds on the host: the launch and the
# copies to and from the card dwarf the work.
DEVICE_BUILD_MIN = 4096

# A cascade that has not converged after this many layers indicates
# either non-disjoint inputs or a pathological fingerprint cluster;
# fail loudly rather than looping.
MAX_LAYERS = 64

# Stall escalation. The double-hash probe mixes the layer index into
# each key word linearly, so two distinct keys agreeing in the low
# log2(m) bits of all four words probe the same positions at every
# level of an m-bit layer; once the chase isolates such a pair, the
# alternation would ping-pong forever. When every complement key
# false-positives on a layer (the stall signature), the layer rebuilds
# with doubled m (k recomputed from the same sizing formula) until the
# twins separate. (m, k) are stored per layer in the artifact, and
# builds that never stall are unaffected.
MAX_SIZE_ESCALATIONS = 32


def device_enabled() -> bool:
    """Filter layers may use the device lane (CTMR_FILTER_DEVICE: 0
    forces the host lane)."""
    v = os.environ.get("CTMR_FILTER_DEVICE", "").strip().lower()
    if v in ("0", "f", "false"):
        return False
    return True


def layer_k(m: int, n: int) -> int:
    """``k = (m/n) ln 2`` probes clamped to [1, 16] — split out so
    stall escalation recomputes k from the same formula it grew m
    under (one sizing rule everywhere)."""
    return min(16, max(1, round((m / n) * math.log(2))))


def layer_params(n: int, p: float) -> tuple[int, int]:
    """Bloom sizing for ``n`` keys at false-positive rate ``p``:
    ``m = -n ln p / (ln 2)^2`` bits rounded up to whole uint32 words,
    ``k = (m/n) ln 2`` probes (clamped to [1, 16]). Identical (n, p)
    always yields identical (m, k)."""
    if n <= 0:
        raise ValueError("layer over an empty key set")
    m = max(64, math.ceil(-n * math.log(p) / (math.log(2) ** 2)))
    m = ((m + 31) // 32) * 32
    return m, layer_k(m, n)


def _probe_np(keys: np.ndarray, m: int, k: int, layer: int) -> np.ndarray:
    """Probe positions ``int64[n, k]`` in [0, m) for uint32[n, 4] keys
    (the host lane; the device lane's arithmetic is the same)."""
    keys = np.asarray(keys, np.uint32)
    # Layer-mix scalars wrapped in Python int space (numpy scalar
    # uint32 multiply warns on overflow; the array arithmetic below
    # wraps silently like the device lane).
    lay_gold = np.uint32((layer * int(_GOLD)) & 0xFFFFFFFF)
    lay_mix = np.uint32((layer * int(_MIX)) & 0xFFFFFFFF)
    a = (keys[:, 0] ^ lay_gold) + keys[:, 2]
    b = ((keys[:, 1] ^ lay_mix) + keys[:, 3]) | np.uint32(1)
    i = np.arange(k, dtype=np.uint32)
    pos = a[:, None] + i[None, :] * b[:, None]
    return (pos % np.uint32(m)).astype(np.int64)


def _pack_words(bits: np.ndarray) -> np.ndarray:
    """bool[m] (m % 32 == 0) → little-endian uint32[m/32] words; bit
    ``j`` of the bitmap is word ``j >> 5`` bit ``j & 31``."""
    return np.packbits(bits, bitorder="little").view("<u4")


def keys_tensor(keys: np.ndarray, device) -> torch.Tensor:
    """uint32[n, 4] keys → int32[n, 4] bit patterns on ``device``."""
    arr = np.ascontiguousarray(np.asarray(keys, np.uint32).reshape(-1, 4))
    return torch.from_numpy(arr.view(np.int32)).to(device)


def words_numpy(words: torch.Tensor) -> np.ndarray:
    """An int32 word arena → host uint32 words (a copy it owns)."""
    return np.array(words.cpu().numpy().view(np.uint32), copy=True)


def build_layer(keys: np.ndarray, m: int, k: int, layer: int,
                use_device: bool | None = None,
                device=None) -> np.ndarray:
    """One Bloom layer over ``keys``: uint32[m/32] bitmap words.

    Large layers scatter on ``device`` (CUDA unless named: K5 ORs the
    bits straight into the words; on the CPU its plain version); small
    layers or ``CTMR_FILTER_DEVICE=0`` take the bit-equal NumPy lane."""
    n = int(keys.shape[0])
    if use_device is None:
        use_device = device_enabled() and n >= DEVICE_BUILD_MIN
    with trace.span("filter.layer", cat="filter", keys=n, m=m,
                    device=int(bool(use_device))):
        if use_device:
            dev = resolve_device(device)
            words = torch.zeros((m // 32,), dtype=torch.int32, device=dev)
            if n:
                bloom.bloom_scatter(
                    words, keys_tensor(keys, dev),
                    torch.zeros((n,), dtype=torch.int32, device=dev),
                    torch.zeros((1,), dtype=torch.int64, device=dev),
                    torch.tensor([m], dtype=torch.int32, device=dev),
                    torch.tensor([k], dtype=torch.int32, device=dev),
                    layer, kmax=k)
            return words_numpy(words)
        bits = np.zeros((m,), bool)
        if n:
            bits[_probe_np(keys, m, k, layer).reshape(-1)] = True
        return _pack_words(bits)


def layer_contains(words: np.ndarray, m: int, k: int, layer: int,
                   keys: np.ndarray) -> np.ndarray:
    """bool[n]: all ``k`` probe bits set for each key (vectorized
    host probe; the build's false-positive chase and every query path
    share this one implementation).

    Probes short-circuit: a lane leaves the working set at its first
    unset bit, so non-members cost ~1/(1-fill) probes instead of ``k``.
    Results are bit-identical to probing all ``k``."""
    n = int(keys.shape[0])
    if n == 0:
        return np.zeros((0,), bool)
    keys = np.asarray(keys, np.uint32)
    lay_gold = np.uint32((layer * int(_GOLD)) & 0xFFFFFFFF)
    lay_mix = np.uint32((layer * int(_MIX)) & 0xFFFFFFFF)
    a = (keys[:, 0] ^ lay_gold) + keys[:, 2]
    b = ((keys[:, 1] ^ lay_mix) + keys[:, 3]) | np.uint32(1)
    w = np.asarray(words, np.uint32)
    hit = np.ones((n,), bool)
    alive = np.arange(n, dtype=np.int64)
    for i in range(k):
        if alive.size == 0:
            break
        pos = ((a[alive] + np.uint32(i) * b[alive])
               % np.uint32(m)).astype(np.int64)
        ok = ((w[pos >> 5] >> (pos & 31).astype(np.uint32)) & 1) \
            .astype(bool)
        hit[alive[~ok]] = False
        alive = alive[ok]
    return hit


def _unique_rows(keys: np.ndarray) -> np.ndarray:
    """Sorted-unique uint32[n, 4] rows (deterministic set canon)."""
    if keys.shape[0] == 0:
        return keys.reshape(0, 4).astype(np.uint32)
    return np.unique(np.asarray(keys, np.uint32), axis=0)


@dataclass
class BloomLayer:
    m: int  # bits
    k: int  # probes per key
    words: np.ndarray  # uint32[m / 32]


@dataclass
class FilterCascade:
    """An exact-membership cascade over one included key set, relative
    to the excluded universe it was built against."""

    fp_rate: float
    n_included: int
    layers: list[BloomLayer] = field(default_factory=list)

    @classmethod
    def build(cls, included: np.ndarray, excluded: np.ndarray,
              fp_rate: float, use_device: bool | None = None,
              device=None) -> "FilterCascade":
        """Build the cascade. ``included``/``excluded`` are
        ``uint32[n, 4]`` fingerprint rows; rows present in both sets
        (a 128-bit fingerprint collision between distinct identities)
        are dropped from the excluded side so the alternation
        converges."""
        inc = _unique_rows(np.asarray(included).reshape(-1, 4))
        exc = _unique_rows(np.asarray(excluded).reshape(-1, 4))
        if inc.shape[0] and exc.shape[0]:
            tag = lambda a: {bytes(r.tobytes()) for r in a}  # noqa: E731
            both = tag(inc) & tag(exc)
            if both:
                keep = np.array(
                    [bytes(r.tobytes()) not in both for r in exc], bool)
                exc = exc[keep]
        cascade = cls(fp_rate=float(fp_rate), n_included=int(inc.shape[0]))
        cur_in, cur_out = inc, exc
        level = 0
        while cur_in.shape[0]:
            if level >= MAX_LAYERS:
                raise RuntimeError(
                    f"filter cascade did not converge in {MAX_LAYERS} "
                    "layers (non-disjoint inputs?)")
            # Layer 0 carries the target rate; deeper layers hold tiny
            # FP sets where 0.5 (≈1.44 bits/entry) converges fastest —
            # the crlite sizing convention.
            p = fp_rate if level == 0 else 0.5
            m, k = layer_params(int(cur_in.shape[0]), p)
            words = build_layer(cur_in, m, k, level, use_device=use_device,
                                device=device)
            if cur_out.shape[0] == 0:
                cascade.layers.append(BloomLayer(m=m, k=k, words=words))
                break
            hits = layer_contains(words, m, k, level, cur_out)
            esc = 0
            while bool(hits.all()):
                # Stall: every complement key false-positives (low-bit
                # twins — see MAX_SIZE_ESCALATIONS). Grow the layer
                # until they separate; identical keys never do.
                esc += 1
                if esc > MAX_SIZE_ESCALATIONS:
                    raise RuntimeError(
                        "filter cascade stalled: complement keys "
                        "false-positive at every layer size "
                        "(non-disjoint inputs?)")
                m *= 2
                k = layer_k(m, int(cur_in.shape[0]))
                words = build_layer(cur_in, m, k, level,
                                    use_device=use_device, device=device)
                hits = layer_contains(words, m, k, level, cur_out)
            cascade.layers.append(BloomLayer(m=m, k=k, words=words))
            cur_in, cur_out = cur_out[hits], cur_in
            level += 1
        return cascade

    def contains(self, keys: np.ndarray) -> np.ndarray:
        """bool[n] membership verdicts. Exact for every key of the
        build's included ∪ excluded sets; probabilistic (≈ layer-0
        rate) outside them."""
        keys = np.asarray(keys, np.uint32).reshape(-1, 4)
        n = keys.shape[0]
        ans = np.zeros((n,), bool)
        undecided = np.arange(n)
        depth = len(self.layers)
        for level, layer in enumerate(self.layers):
            if undecided.size == 0:
                return ans
            hit = layer_contains(layer.words, layer.m, layer.k, level,
                                 keys[undecided])
            ans[undecided[~hit]] = (level % 2) == 1
            undecided = undecided[hit]
        ans[undecided] = (depth % 2) == 1
        return ans

    def total_bits(self) -> int:
        return sum(layer.m for layer in self.layers)

    def bits_per_entry(self) -> float:
        return self.total_bits() / max(1, self.n_included)
