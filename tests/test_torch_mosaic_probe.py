"""The port's probe ladder (``ct_mapreduce_tpu_torch/tools/mosaic_probe.py``)
against ``tools/mosaic_probe.py``.

Each plain stage takes the original's random words (``_rows``) and must
equal its NumPy reference ``r_*``; stage 9 takes the original's real
certificates (``_cert_rows``) and must equal its host-parser oracle.
The port's own certificate rows are held to the port's host parser,
and the command line runs the ladder on the CPU. Tolerance: exact
equality.
"""

import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from ct_mapreduce_tpu_torch.tools import kernel_times
from ct_mapreduce_tpu_torch.tools import mosaic_probe as tprobe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jprobe():
    spec = importlib.util.spec_from_file_location(
        "jax_mosaic_probe", os.path.join(ROOT, "tools", "mosaic_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_names_and_order_follow_the_original(jprobe):
    assert tuple(name for name, _k, _r in jprobe.STAGES) == tprobe.STAGES
    assert (jprobe.LANES, jprobe.WORDS) == (tprobe.LANES, tprobe.WORDS)


@pytest.mark.parametrize("stage", range(9))
def test_plain_stage_matches_numpy_reference(jprobe, stage):
    _name, _kernel, ref = jprobe.STAGES[stage]
    for seed in (0, 1):
        w = jprobe._rows(seed)
        got = tprobe.plain_stage(stage, tprobe.to_tensor(w, "cpu")).numpy()
        np.testing.assert_array_equal(got, ref(w))


def test_serial_stage_matches_host_parser_oracle(jprobe):
    w, oracle = jprobe._cert_rows()
    got = tprobe.plain_stage(tprobe.SERIAL_STAGE, tprobe.to_tensor(w, "cpu"))
    np.testing.assert_array_equal(got.numpy(), oracle)
    w, oracle = tprobe.cert_words()
    got = tprobe.plain_stage(tprobe.SERIAL_STAGE, tprobe.to_tensor(w, "cpu"))
    np.testing.assert_array_equal(got.numpy(), oracle)
    assert len(np.unique(oracle)) > 40


def test_serial_window_model_matches_plain_and_oracle(jprobe):
    """The model of stage 9's kernel (a window of WINDOW_WORDS words,
    reads past it from the row) against the host-parser oracles of both
    certificate corpora and the plain version on random words and on
    crafted rows whose version, serial header or serial runs past the
    window and past the row."""
    for w, oracle in (jprobe._cert_rows(), tprobe.cert_words()):
        got, past = tprobe.serial_window_model(w)
        np.testing.assert_array_equal(got, oracle)
        assert not past.any()  # the window covers the corpus
    for w in (tprobe.random_words(7, 512), tprobe.crafted_serial_rows(7)):
        got, past = tprobe.serial_window_model(w)
        want = tprobe.plain_stage(tprobe.SERIAL_STAGE,
                                  tprobe.to_tensor(w, "cpu")).numpy()
        np.testing.assert_array_equal(got, want)
        assert past.any() and not past.all()


@pytest.mark.parametrize("rows", ["random", "edges"])
def test_fori_masked_model_matches_reference_and_plain(jprobe, rows):
    """Stage 4's one-pass model (each low byte weighed by its residue's
    trip count) equals the original's eight-trip reference and the plain
    version, on the original's random rows and on the edge words."""
    cases = ([jprobe._rows(seed) for seed in range(4)] if rows == "random"
             else [tprobe.crafted_masked_rows()])
    for w in cases:
        want = jprobe.r_fori_masked(w)
        np.testing.assert_array_equal(tprobe.fori_masked_model(w), want)
        np.testing.assert_array_equal(
            tprobe.plain_stage(4, tprobe.to_tensor(w, "cpu")).numpy(), want)
    if rows == "edges":
        assert tprobe.fori_masked_model(cases[0]).max() == 64 * 255 * 3


def test_mod3_mulhi_is_exact_over_uint32():
    edges = [0, 1, 2, 3, 4, 5, (1 << 24) - 1, 1 << 24, 0x7FFFFFFF,
             0x80000000, 0xAAAAAAAA, 0xAAAAAAAB, 0xFFFFFFFD, 0xFFFFFFFE,
             0xFFFFFFFF]
    x = np.concatenate([np.array(edges, np.uint64), np.random.default_rng(
        3).integers(0, 2**32, 1 << 16, dtype=np.uint64)]).astype(np.uint32)
    np.testing.assert_array_equal(tprobe.mod3_mulhi(x), x % 3)


def test_kernel_constants_match_the_models():
    """The source's stage-4 trip count and row shape are the models'."""
    with open(os.path.join(ROOT, "ct_mapreduce_tpu_torch", "csrc",
                           "mosaic_probe.cu")) as f:
        src = f.read()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kMaskedTrips"] == tprobe.MASKED_TRIPS
    assert consts["kWords"] == tprobe.WORDS
    assert consts["kThreads"] == tprobe.LANES  # stage 8's tile of lanes
    assert consts["kWindowWords"] == tprobe.WINDOW_WORDS
    assert consts["kForiWindowWords"] == tprobe.FORI_WINDOW_WORDS
    assert consts["kForiReads"] == tprobe.FORI_READS
    assert consts["kWordLanes"] == tprobe.WORD_LANES  # stages 1 and 7
    assert consts["kWordThreads"] == tprobe.WORD_THREADS
    assert tprobe.word_grid(1 << 20) == (1024, tprobe.WORD_THREADS)
    assert tprobe.word_grid(1) == (1, tprobe.WORD_THREADS)


def _tiles(w: np.ndarray) -> list[np.ndarray]:
    """``w`` repeated to whole 128-lane tiles (the references' width),
    cut into them."""
    n = -(-w.shape[1] // tprobe.LANES) * tprobe.LANES
    w = np.tile(w, (1, -(-n // w.shape[1])))[:, :n]
    return [w[:, i:i + tprobe.LANES] for i in range(0, n, tprobe.LANES)]


def _fori_last_offsets(words: np.ndarray) -> np.ndarray:
    """The offset of each lane's last (16th) stage-3 read."""
    w = words.astype(np.int64)
    lanes = np.arange(w.shape[1])
    off = np.zeros(w.shape[1], np.int64)
    for _ in range(tprobe.FORI_READS - 1):
        byte = (w[off >> 2, lanes] >> ((3 - (off & 3)) * 8)) & 0xFF
        off = (off + 1 + (byte & 3)) % tprobe.WRAP
    return off


@pytest.mark.parametrize("rows", ["random", "crafted"])
def test_fori_window_model_matches_reference_and_plain(jprobe, rows):
    """Stage 3's window model (the first FORI_WINDOW_WORDS words, reads
    past them from the row) equals the original's reference and the plain
    version on the original's random rows and on the edge rows: every
    byte 0xFF or 0, walks whose last read lands at each offset 15..60."""
    cases = ([jprobe._rows(seed) for seed in range(4)] if rows == "random"
             else _tiles(tprobe.crafted_fori_rows(3)))
    for w in cases:
        want = jprobe.r_fori_reads(w)
        got, _past = tprobe.fori_window_model(w)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tprobe.plain_stage(3, tprobe.to_tensor(w, "cpu")).numpy(), want)
        # No walk reads past word 15, so a window of 16 words holds all.
        assert not tprobe.fori_window_model(w, 16)[1].any()


def test_fori_window_reach_on_random_and_crafted_rows(jprobe):
    """The share of random rows whose walk leaves the window is the exact
    share of 15 steps uniform in 1..4 summing to 4 * FORI_WINDOW_WORDS or
    more (0.97% at 12 words; none past word 15); the edge rows put the
    last read on each side of the window's end."""
    win = tprobe.FORI_WINDOW_WORDS
    assert tprobe.fori_reach_share(16) == 0.0
    assert 0 < tprobe.fori_reach_share(15) < 1e-9
    assert abs(tprobe.fori_reach_share(12) - 0.0097190) < 1e-7
    assert abs(tprobe.fori_reach_share(11) - 0.0833562) < 1e-7
    n = 1 << 16
    _out, past = tprobe.fori_window_model(tprobe.random_words(11, n))
    p = tprobe.fori_reach_share(win)
    assert abs(past.mean() - p) < 5 * (p * (1 - p) / n) ** 0.5
    for seed in range(4):
        assert _fori_last_offsets(jprobe._rows(seed)).max() <= 60
    crafted = tprobe.crafted_fori_rows(5)
    last = _fori_last_offsets(crafted)
    _out, past = tprobe.fori_window_model(crafted)
    np.testing.assert_array_equal(past, last >= 4 * win)
    assert set(last.tolist()) == set(range(15, 61))
    assert {win - 1, win, 15} <= set((last >> 2).tolist())
    assert (crafted == 0xFFFFFFFF).all(0).any() and (crafted == 0).all(0).any()


def test_crafted_dyn_rows_match_reference(jprobe):
    """Stage 2's edge rows: byte 0 takes each of the 256 values, so the
    second read reaches every word 0..62 (offsets 248-251 in word 62) and
    wraps 252-255 to word 0; the plain version equals the original's
    reference on them."""
    w = tprobe.crafted_dyn_rows(2)
    assert sorted((w[0] >> 24).tolist()) == list(range(256))
    for tile in _tiles(w):
        np.testing.assert_array_equal(
            tprobe.plain_stage(2, tprobe.to_tensor(tile, "cpu")).numpy(),
            jprobe.r_onehot_dyn(tile))
    q = (w[0] >> 24).astype(np.int64) % tprobe.WRAP
    assert set((q >> 2).tolist()) == set(range(63))
    assert set((w[0] >> 24)[q < 4].tolist()) == {0, 1, 2, 3, 252, 253, 254, 255}


def test_stage2_floor_inputs_stand_for_the_stage():
    """The inputs of stage 2's floors (``kernel_times``): the word index a
    lane is the word the plain version's second read takes, and on the
    no-scatter rows that word is word 0, the other bytes unchanged."""
    words = tprobe.random_words(8, 4096)
    ln = tprobe._Lanes(tprobe.to_tensor(words, "cpu"), record=True)
    tprobe._PLAIN[2](ln)
    np.testing.assert_array_equal(kernel_times.dyn_word_index(words)[0],
                                  ln.words_read[1].numpy())
    ns = kernel_times.no_scatter_words(words, 8)
    assert (kernel_times.dyn_word_index(ns) == 0).all()
    np.testing.assert_array_equal(ns[1:], words[1:])
    np.testing.assert_array_equal(ns[0] & 0xFFFFFF, words[0] & 0xFFFFFF)
    assert len(set((ns[0] >> 24).tolist())) == 8


def test_onehot_library_matches_plain_and_reference(jprobe):
    """Stage 1's library form (``kernel_times.onehot_library``, byte 2 of
    each little-endian word 4) equals the plain version and the original's
    reference on the original's random rows."""
    import torch

    for seed in range(4):
        w = jprobe._rows(seed)
        t = tprobe.to_tensor(w, "cpu")
        got = kernel_times.onehot_library(t)
        assert got.dtype == torch.int32 and got.shape == (1, tprobe.LANES)
        assert torch.equal(got, tprobe.plain_stage(1, t))
        np.testing.assert_array_equal(got.numpy(), jprobe.r_onehot_read(w))


def test_crafted_step_rows_match_reference(jprobe):
    """Stage 7's edge rows: the first length octet at each of its 256
    values under each pair of following bytes; the plain version equals
    the original's reference on them, tile by tile, and the headers end
    below, at and above the clip at 255."""
    w = tprobe.crafted_step_rows(5, copies=2)
    assert w.shape == (tprobe.WORDS, 2 * 256 * len(tprobe.STEP_TAILS))
    for tile in _tiles(w):
        np.testing.assert_array_equal(
            tprobe.plain_stage(7, tprobe.to_tensor(tile, "cpu")).numpy(),
            jprobe.r_tlv_step(tile))
    l0 = (w[0] >> 16) & 0xFF
    tail = w[0] & 0xFFFF
    for b2, b3 in tprobe.STEP_TAILS:
        assert sorted(l0[tail == (b2 << 8 | b3)].tolist()) == sorted(
            list(range(256)) * 2)
    nlen = np.where(l0 >= 0x80, l0 & 0x7F, 0)
    content = np.where(l0 >= 0x80, np.where(nlen == 1, tail >> 8, tail), l0)
    end = 2 + nlen + content
    assert (end < 255).any() and (end == 255).any() and (end > 255).any()
    got = tprobe.plain_stage(7, tprobe.to_tensor(w, "cpu")).numpy()[0]
    np.testing.assert_array_equal(got, np.minimum(end, 255))


def test_offset_tensor_holds_the_words_off_alignment():
    """The unaligned views of the card tests: the same words, contiguous,
    4 B a word of offset past the buffer's start."""
    import torch

    words = tprobe.random_words(6, 130)
    for offset in (1, 2, 3):
        v = tprobe.offset_tensor(words, "cpu", offset)
        assert v.is_contiguous() and v.shape == (tprobe.WORDS, 130)
        assert v.data_ptr() - v.untyped_storage().data_ptr() == 4 * offset
        assert torch.equal(v, tprobe.to_tensor(words, "cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        tprobe.empty_launch(1, tprobe.LANES, "cpu")


def _walk_offsets(words: np.ndarray) -> np.ndarray:
    """The offsets each lane's stage-8 walk reads its headers at."""
    w = words.astype(np.int64)
    lanes = np.arange(w.shape[1])

    def byte(q):
        q = np.clip(q, 0, tprobe.ROW_BYTES - 1)
        return (w[q >> 2, lanes] >> ((3 - (q & 3)) * 8)) & 0xFF

    off, seen = np.zeros(w.shape[1], np.int64), []
    for _ in range(12):
        seen.append(off.copy())
        l0, l1, l2, tag = byte(off + 1), byte(off + 2), byte(off + 3), byte(off)
        nlen = np.where(l0 >= 0x80, l0 & 0x7F, 0)
        content = np.where(l0 >= 0x80,
                           np.where(nlen == 1, l1, l1 * 256 + l2), l0)
        off = np.where(tag & 0x20, off + 2 + nlen,
                       off + 2 + nlen + content) % tprobe.WRAP
    return np.stack(seen, 1)


def test_crafted_tlv_rows_match_reference_and_reach_the_row_end(jprobe):
    """The stage-8 edge rows: the plain version equals the original's
    reference on them, and their walks read headers at each offset
    248-251 (a 4-byte read over the row's last words) and in long form
    of 127 length octets."""
    w = tprobe.crafted_tlv_rows(9)
    assert w.shape == (tprobe.WORDS, jprobe.LANES)
    np.testing.assert_array_equal(
        tprobe.plain_stage(8, tprobe.to_tensor(w, "cpu")).numpy(),
        jprobe.r_tlv_walk(w))
    offs = _walk_offsets(w)
    assert {248, 249, 250, 251} <= set(offs.ravel().tolist())
    assert offs.max() < tprobe.WRAP
    assert (w == 0xFFFFFFFF).all(0).any() and (w == 0).all(0).any()


@pytest.mark.parametrize("stage", range(10))
def test_footprint_sectors_match_brute_force(stage):
    """The sectors of ``footprint`` are the distinct (word, lane // 8)
    pairs of the words each lane reads, counted one by one on 64 lanes."""
    words, _ = tprobe.stage_inputs(stage, 64, seed=stage)
    ln = tprobe._Lanes(tprobe.to_tensor(words, "cpu"), record=True)
    tprobe._PLAIN[stage](ln)
    touched = [set() for _ in range(64)]
    for read in ln.words_read:
        for lane, k in enumerate(read.tolist()):
            if k >= 0:
                touched[lane].add(k)
    sectors = {(k, lane // 8) for lane in range(64) for k in touched[lane]}
    n_words, share, _reads = tprobe.footprint(
        stage, tprobe.to_tensor(words, "cpu"))
    assert n_words.tolist() == [len(t) for t in touched]
    assert round(float(share.sum())) == len(sectors)
    for g in range(8):
        got = float(share[8 * g:8 * g + 8].sum())
        assert round(got) == sum(1 for _k, h in sectors if h == g)
    if stage in (0, 4, 5):
        assert len(sectors) == 64 * tprobe.WORDS // 8


def test_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "ct_mapreduce_tpu_torch.tools.mosaic_probe",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert [ln.split()[:2] for ln in lines[:10]] == [
        ["PASS", f"{name}:"] for name in tprobe.STAGES]
    assert lines[10] == "10/10 stages passed"
