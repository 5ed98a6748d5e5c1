"""K5's region-binned schedule (``csrc/bloom_scatter.cu``), modelled in
NumPy by ``ops/bloom.py::binned_model`` at the kernel's region size,
against the port's plain version and the JAX package's fused scatter
(``filter/fused.py::_scatter_np`` and ``_fused_bits_jit``, jitted on the
CPU), one layer and fused, on arenas non-zero on entry and with lanes in
shuffled group order. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``). Tolerance: exact equality.
"""

import os
import re

import numpy as np
import pytest
import torch

from ct_mapreduce_tpu.filter import fused as jfused
from ct_mapreduce_tpu_torch.filter.cascade import layer_params
from ct_mapreduce_tpu_torch.ops import bloom

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "ct_mapreduce_tpu_torch", "csrc")


def _shape(name: str, rng):
    """keys uint32[n, 4], gid int32[n], offs, ms, ks int64[G], the arena
    to start from (uint32) and the lane cuts of the dispatches."""
    if name == "one_layer":
        n = 40_000
        m, k = layer_params(n, 0.01)  # 383,488 bits: two regions
        ms, ks = np.array([m]), np.array([k])
        gid = np.zeros((n,), np.int32)
    elif name == "dense_one_region":
        n = 12_000  # 84,000 probes in 2^16 bits: six work items
        ms, ks = np.array([1 << 16]), np.array([7])
        gid = np.zeros((n,), np.int32)
    else:
        sizes = rng.multinomial(50_000 - 64, np.full(64, 1 / 64)) + 1
        params = np.array([layer_params(int(c), 0.02) for c in sizes])
        ms, ks, n = params[:, 0], params[:, 1], 50_000
        gid = np.repeat(np.arange(64), sizes).astype(np.int32)
        if name != "fused":
            gid = rng.permutation(gid)
    offs = np.concatenate(([0], np.cumsum(ms)[:-1])).astype(np.int64)
    words = np.zeros((int(ms.sum()) // 32,), np.uint32)
    cuts = [0, n]
    if name == "fused_nonzero_two_dispatches":
        words = (rng.integers(0, 2**32, words.shape, np.uint32)
                 * (rng.random(words.shape) < 0.05)).astype(np.uint32)
        cuts = [0, n // 3, n]
    keys = rng.integers(0, 2**32, (n, 4), np.uint32)
    return (keys, gid, offs, ms.astype(np.int64), ks.astype(np.int64),
            words, cuts)


SHAPES = ["one_layer", "dense_one_region", "fused", "fused_shuffled",
          "fused_nonzero_two_dispatches"]


@pytest.mark.parametrize("name", SHAPES)
def test_binned_model_matches_plain_and_jax(name):
    rng = np.random.default_rng(SHAPES.index(name) + 7)
    keys, gid, offs, ms, ks, words, cuts = _shape(name, rng)
    layer = 3
    model = words.copy()
    plain = torch.from_numpy(words.view(np.int32).copy())
    jnp_arena = np.unpackbits(words.view(np.uint8), bitorder="little"
                              ).astype(bool)
    import jax.numpy as jnp

    jit_arena = jnp.asarray(jnp_arena)
    kmax = int(ks.max())
    stats = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        k_, g_ = keys[lo:hi], gid[lo:hi]
        stats.append(bloom.binned_model(model, k_, g_, offs, ms, ks, layer))
        bloom.bloom_scatter_plain(
            plain, torch.from_numpy(k_.view(np.int32)), torch.from_numpy(g_),
            torch.from_numpy(offs), torch.from_numpy(ms.astype(np.int32)),
            torch.from_numpy(ks.astype(np.int32)), layer)
        jfused._scatter_np(jnp_arena, k_, g_, layer, offs, ms, ks, kmax)
        jit_arena = jfused._fused_bits_jit()(
            jit_arena, jnp.asarray(k_), jnp.asarray(g_),
            jnp.ones((hi - lo,), bool), np.uint32(layer),
            jnp.asarray(offs.astype(np.int32)),
            jnp.asarray(ms.astype(np.int32)),
            jnp.asarray(ks.astype(np.int32)), kmax)
    np.testing.assert_array_equal(model.view(np.int32), plain.numpy())
    np.testing.assert_array_equal(
        model, np.packbits(jnp_arena, bitorder="little").view("<u4"))
    np.testing.assert_array_equal(
        model, np.packbits(np.asarray(jit_arena), bitorder="little")
        .view("<u4"))
    st = stats[-1]
    assert st["region_bits"] == bloom.MIN_REGION_BITS
    assert st["probes"] == int(ks[gid[cuts[-2]:]].sum())
    assert int(st["counts"].sum()) == st["probes"]
    if name == "dense_one_region":
        assert (st["regions"], len(st["items"]), st["shared_items"]) == (1, 6, 6)
    if name == "one_layer":
        assert st["regions"] == 2 and st["max_tile_span"] == 2
    if name == "fused":  # a tile's lanes reach one or two regions
        assert st["max_tile_span"] <= 2


def test_binned_model_small_regions_match_plain():
    """The schedule at 2^10-bit regions: hundreds of regions, tiles
    over many of them, items cut at 1,000 probes."""
    rng = np.random.default_rng(3)
    keys, gid, offs, ms, ks, words, _cuts = _shape("fused_shuffled", rng)
    model = words.copy()
    st = bloom.binned_model(model, keys, gid, offs, ms, ks, 5,
                            min_region_bits=10, chunk=1000)
    plain = torch.from_numpy(words.view(np.int32).copy())
    bloom.bloom_scatter_plain(
        plain, torch.from_numpy(keys.view(np.int32)), torch.from_numpy(gid),
        torch.from_numpy(offs), torch.from_numpy(ms.astype(np.int32)),
        torch.from_numpy(ks.astype(np.int32)), 5)
    np.testing.assert_array_equal(model.view(np.int32), plain.numpy())
    assert st["regions"] > 300 and st["max_tile_span"] > 100
    assert all(e - s <= 1000 for _r, s, e, _sh in st["items"])


def test_reciprocal_modulo_is_exact():
    """The kernel's modulo: q = umulhi(x, floor((2^32 - 1) / m)), r = x -
    q m, minus m once if r >= m, equals x mod m for every uint32 x and m
    in [1, 2^31 - 1]."""
    rng = np.random.default_rng(11)
    m = np.concatenate(([1, 2, 3, 63, 64, 65, 96, (1 << 31) - 1, 1 << 30],
                        rng.integers(1, 1 << 31, 4000))).astype(np.uint64)
    x = np.concatenate(([0, 1, (1 << 32) - 1, (1 << 32) - 2, 1 << 31],
                        rng.integers(0, 1 << 32, 4000))).astype(np.uint64)
    mm, xx = np.meshgrid(m, x[:200])
    mm = np.concatenate((mm.ravel(), m[:4000]))
    xx = np.concatenate((xx.ravel(), x[:4000]))
    minv = np.uint64(0xFFFFFFFF) // mm
    q = (xx * minv) >> np.uint64(32)
    r = xx - q * mm
    assert (r < 2 * mm).all()
    r = np.where(r >= mm, r - mm, r)
    np.testing.assert_array_equal(r, xx % mm)


def _constants(path: str) -> dict:
    with open(path) as f:
        src = f.read()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}


def test_schedule_constants_match_the_sources():
    from ct_mapreduce_tpu_torch.tools import mosaic_probe

    c = _constants(os.path.join(CSRC, "bloom_scatter.cu"))
    assert (c["kMinRegionBits"], c["kMaxRegions"], c["kChunk"],
            c["kLaneThreads"]) == (bloom.MIN_REGION_BITS, bloom.MAX_REGIONS,
                                   bloom.CHUNK, bloom.LANE_THREADS)
    assert _constants(os.path.join(CSRC, "mosaic_probe.cu"))[
        "kWindowWords"] == mosaic_probe.WINDOW_WORDS


@pytest.mark.parametrize("n_words,want", [
    (1, 18), ((1 << 29) // 32, 18), ((1 << 29) // 32 + 1, 19),
    ((1 << 31) // 32 - 1, 20)])
def test_region_bits_and_scratch(n_words, want):
    """Regions stay 2^18 bits up to 2^29-bit arenas and grow so that at
    most MAX_REGIONS cover the largest arena; the scratch is the probe
    lists plus a few KB of tables."""
    assert bloom.region_bits(n_words) == want
    assert -(-n_words * 32 // (1 << want)) <= bloom.MAX_REGIONS
    n, kmax = 1 << 20, 7
    extra = bloom.scratch_bytes(n, kmax, n_words, 1024) - 4 * n * kmax
    assert 0 < extra < 64 * 1024


@pytest.mark.parametrize("path", ["plain", "model"])
def test_a_kmax_below_a_group_k_raises(path):
    """K5 traps on a group of more than ``kmax`` probes (its lists hold
    ``kmax`` a lane); the CPU dispatch and the model raise instead, and
    take a ``kmax`` that bounds every k."""
    rng = np.random.default_rng(21)
    keys, gid, offs, ms, ks, words, _cuts = _shape("fused_shuffled", rng)
    kmax = int(ks.max())
    if path == "model":
        with pytest.raises(ValueError, match="kmax"):
            bloom.binned_model(words.copy(), keys, gid, offs, ms, ks, 1,
                               kmax=kmax - 1)
        got = words.copy()
        bloom.binned_model(got, keys, gid, offs, ms, ks, 1, kmax=kmax)
        got = got.view(np.int32)
    else:
        args = (torch.from_numpy(keys.view(np.int32)), torch.from_numpy(gid),
                torch.from_numpy(offs), torch.from_numpy(ms.astype(np.int32)),
                torch.from_numpy(ks.astype(np.int32)), 1)
        with pytest.raises(ValueError, match="kmax"):
            bloom.bloom_scatter(torch.from_numpy(words.view(np.int32).copy()),
                                *args, kmax=kmax - 1)
        got = bloom.bloom_scatter(
            torch.from_numpy(words.view(np.int32).copy()), *args,
            kmax=kmax).numpy()
    want = torch.from_numpy(words.view(np.int32).copy())
    bloom.bloom_scatter_plain(
        want, torch.from_numpy(keys.view(np.int32)), torch.from_numpy(gid),
        torch.from_numpy(offs), torch.from_numpy(ms.astype(np.int32)),
        torch.from_numpy(ks.astype(np.int32)), 1)
    np.testing.assert_array_equal(got, want.numpy())


def test_k5_timed_shapes():
    """``tools/kernel_times.k5_shapes``: 2^20 lanes in each shape; one
    layer at offset 0; the fused round laid out group by group over
    1,024 groups; filter-scale's first dispatch over the leading groups
    of its round, every probe inside the arena."""
    from ct_mapreduce_tpu_torch.tools import kernel_times

    shapes = kernel_times.k5_shapes(torch.device("cpu"), 5)
    assert set(shapes) == {"layer", "fused", "scale_dispatch"}
    for name, sh in shapes.items():
        gid, ms, ks = (sh[x].numpy() for x in ("gid", "ms", "ks"))
        offs = sh["offs"].numpy()
        assert sh["keys"].shape == (1 << 20, 4) and gid.shape == (1 << 20,)
        assert sh["probes"] == int(ks[gid].sum())
        assert sh["kmax"] == int(ks.max()) <= bloom.KMAX_LIMIT
        assert (offs % 32 == 0).all() and sh["total_bits"] % 32 == 0
        assert int(offs[-1] + ms[-1]) == sh["total_bits"]
        if name != "layer":
            assert sh["groups"] == 1024
            assert (np.diff(gid) >= 0).all()  # group by group
    assert shapes["fused"]["groups_reached"] == 1024
    assert 1 < shapes["scale_dispatch"]["groups_reached"] < 1024


def test_kernel_times_needs_a_card():
    """The timing script refuses to run without a CUDA device."""
    from ct_mapreduce_tpu_torch.tools import kernel_times

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert kernel_times.main([]) == 2
