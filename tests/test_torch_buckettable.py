"""The port's bucket table and pre-parsed step against the JAX package.

Each case feeds the same seeded numpy batches to the JAX functions and
the port's (on the CPU), and requires byte-identical rows after every
batch and identical per-lane outcomes. Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_mapreduce_tpu.ops import buckettable as jbt
from ct_mapreduce_tpu.ops import pipeline as jpipeline
from ct_mapreduce_tpu_torch.ops import buckettable as tbt
from ct_mapreduce_tpu_torch.ops import pipeline as tpipeline

B = 256


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy → torch, uint32 as int32 bit patterns."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _batches(seed: int, n_batches: int, sign_heavy: bool = False):
    """Keys with within-batch duplicates, cross-batch replays, an
    all-zero key and invalid lanes. ``sign_heavy`` draws key words
    around the 2^31 boundary, with keys that differ only in the sign
    bit of one word, where a signed sort would reorder the slots."""
    rng = np.random.default_rng(seed)
    out, prev = [], None
    for _ in range(n_batches):
        keys = rng.integers(0, 1 << 32, (B, 4), dtype=np.uint64).astype(np.uint32)
        if sign_heavy:
            keys[:, 0] = rng.integers(0, 4, B).astype(np.uint32) << 30
            keys[:, 1] = (rng.integers(0, 2, B).astype(np.uint32) << 31) | 5
            keys[:, 2] ^= np.uint32(1 << 31)
        dup = rng.random(B) < 0.2
        keys[dup] = keys[rng.integers(0, B, int(dup.sum()))]
        if prev is not None:
            keys[:32] = prev[-32:]
        keys[7] = 0
        meta = rng.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.uint32)
        valid = rng.random(B) < 0.95
        out.append((keys, meta, valid))
        prev = keys
    return out


CASES = {
    # 32 buckets = 768 slots; three batches reach ~65% load, so some
    # buckets fill and later keys hop.
    "dups_and_hops": dict(capacity=24 * 32, max_probes=32, seed=1, n=3),
    # 8 buckets = 192 slots for 512+ keys: full buckets, then max_probes
    # overflow on most lanes of the later batches.
    "overflow": dict(capacity=24 * 8, max_probes=2, seed=2, n=3),
    "sign_bits": dict(capacity=24 * 64, max_probes=32, seed=3, n=2,
                      sign_heavy=True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def insert_runs(request):
    c = CASES[request.param]
    batches = _batches(c["seed"], c["n"], c.get("sign_heavy", False))
    jt = jbt.make_table(c["capacity"])
    tt = tbt.make_table(c["capacity"], device="cpu")
    steps = []
    for keys, meta, valid in batches:
        jt, jwu, jov = jbt.insert(jt, jnp.asarray(keys), jnp.asarray(meta),
                                  jnp.asarray(valid), max_probes=c["max_probes"])
        tt, twu, tov = tbt.insert(tt, _t(keys), _t(meta), _t(valid),
                                  max_probes=c["max_probes"])
        steps.append(dict(
            jrows=np.asarray(jt.rows), trows=tbt.host_rows(tt).copy(),
            jcount=int(jt.count), tcount=int(tt.count),
            jwu=np.asarray(jwu), twu=twu.numpy(),
            jov=np.asarray(jov), tov=tov.numpy()))
    return request.param, c, batches, jt, tt, steps


def test_insert_matches_jax_after_every_batch(insert_runs):
    name, _c, _b, _jt, _tt, steps = insert_runs
    for s in steps:
        np.testing.assert_array_equal(s["trows"], s["jrows"])
        np.testing.assert_array_equal(s["twu"], s["jwu"])
        np.testing.assert_array_equal(s["tov"], s["jov"])
        assert s["tcount"] == s["jcount"]
    last = steps[-1]
    if name == "overflow":
        assert last["tov"].sum() > 0
    else:
        assert last["tov"].sum() == 0
        # Some bucket is full, so the batch exercised hops.
        assert (last["trows"][:, tbt.FILL_WORD] == tbt.SLOTS).any()


def test_contains_matches_jax(insert_runs):
    _name, c, batches, jt, tt, _ = insert_runs
    rng = np.random.default_rng(c["seed"] + 100)
    probe = np.concatenate([b[0] for b in batches] + [
        rng.integers(0, 1 << 32, (64, 4), dtype=np.uint64).astype(np.uint32)])
    want = np.asarray(jbt.contains(jt, jnp.asarray(probe),
                                   max_probes=c["max_probes"]))
    got = tbt.contains(tt, _t(probe), max_probes=c["max_probes"]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tbt.contains_np(tbt.host_rows(tt), probe, max_probes=c["max_probes"]),
        jbt.contains_np(np.asarray(jt.rows), probe, max_probes=c["max_probes"]))


def test_numpy_helpers_match_jax(insert_runs):
    _name, c, _b, jt, tt, _ = insert_runs
    jk, jm = jbt.drain_np(jt)
    tk, tm = tbt.drain_np(tt)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tm, jm)
    jrows = np.asarray(jt.rows).copy()
    trows = tbt.host_rows(tt).copy()
    np.testing.assert_array_equal(tbt.fill_counts_np(trows),
                                  jbt.fill_counts_np(jrows))
    # Host rebuild of the drained keys into a table twice the size.
    nb = 2 * jrows.shape[0]
    jr = np.zeros((nb, jbt.ROW_WORDS), np.uint32)
    tr = np.zeros((nb, tbt.ROW_WORDS), np.uint32)
    assert tbt.bulk_insert_np(tr, tk, tm, max_probes=c["max_probes"]) == \
        jbt.bulk_insert_np(jr, jk, jm, max_probes=c["max_probes"])
    np.testing.assert_array_equal(tr, jr)


def test_bucket_count_matches_jax():
    for cap, ceiling in [(1, None), (24, None), (25, None), (1 << 22, None),
                         (1 << 22, 1 << 22), (5000, 4000), (100, 30)]:
        assert tbt.bucket_count(cap, ceiling) == jbt.bucket_count(cap, ceiling)


def test_home_bucket_has_no_int64_overflow():
    keys = np.array([[0, 0xFFFFFFFF, 0, 1], [0xFFFFFFFF, 0xFFFFFFFF, 1, 1],
                     [0x80000000, 0x7FFFFFFF, 0, 1]], np.uint32)
    want = (keys[:, 0] ^ (keys[:, 1] * np.uint32(0x9E3779B9))) & np.uint32(
        (1 << 22) - 1)
    got = tbt._home_bucket(_t(keys), 1 << 22).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_insert_rejects_batches_past_2_25_lanes():
    n = (1 << 25) + 1
    table = tbt.BucketTable(
        rows=torch.empty((8, tbt.ROW_WORDS), dtype=torch.int32, device="meta"),
        count=torch.empty((), dtype=torch.int64, device="meta"))
    keys = torch.empty((n, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\^25"):
        tbt.insert(table, keys, keys[:, 0], keys[:, 0] > 0)


@pytest.mark.parametrize("flag_cap", [8, 64])
def test_preparsed_core_matches_jax(flag_cap):
    """The packed readback and the overflow bitmask of a 2-chunk step
    on a tiny table; with flag_cap 8 the overflow ids spill."""
    rng = np.random.default_rng(40 + flag_cap)
    k, b, n_iss = 2, 64, 40
    slen = rng.integers(0, 47, (k, b)).astype(np.int32)
    ser = rng.integers(0, 256, (k, b, 46), dtype=np.uint8)
    ser[np.arange(46)[None, None, :] >= slen[..., None]] = 0
    ser[1, :16] = ser[0, :16]  # replays across chunks
    slen[1, :16] = slen[0, :16]
    nah = rng.integers(400_000, 460_000, (k, b)).astype(np.int32)
    nah[1, :16] = nah[0, :16]
    ii = rng.integers(-2, n_iss + 3, (k, b)).astype(np.int32)
    ii[1, :16] = ii[0, :16]
    ins = rng.random((k, b)) < 0.9
    jt = jbt.make_table(24 * 2)
    tt = tbt.make_table(24 * 2, device="cpu")
    jt, jout = jpipeline.ingest_step_preparsed(
        jt, ser, slen, nah, ii, ins, np.int32(400_000),
        num_issuers=n_iss, max_probes=2, flag_cap=flag_cap)
    tt, tout = tpipeline.preparsed_core(
        tt, *(torch.from_numpy(a) for a in (ser, slen, nah, ii, ins)),
        400_000, num_issuers=n_iss, max_probes=2, flag_cap=flag_cap)
    packed = tout.packed.numpy()
    np.testing.assert_array_equal(packed, np.asarray(jout.packed))
    np.testing.assert_array_equal(tout.overflow_bits.numpy().view(np.uint32),
                                  np.asarray(jout.overflow_bits))
    np.testing.assert_array_equal(tbt.host_rows(tt), np.asarray(jt.rows))
    if flag_cap == 8:
        assert (packed[:, 1] > flag_cap).any()  # the spill case
