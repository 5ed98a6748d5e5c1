"""The port's open-addressing table (``ops/hashtable.py``) and the
open-layout paths of its aggregator against the JAX package.

Every insert runs on the JAX ``hashtable.insert`` and the port's (on the
CPU) with the same seeded numpy inputs, and the two tables must hold the
same rows bit for bit, the same count and the same per-lane
``was_unknown`` and overflow flags after each call; the assertions of
``tests/test_hashtable.py`` then hold on the port's results. Also here:
``tests/test_table_parity.py``'s random workload through both layouts of
the port, the non-sharded case of ``tests/test_layouts.py`` on the
port's aggregator, and open-layout checkpoints (ck01 and ck02) crossing
between the packages with equal drains and ``ckpt_state_digest``.
Tolerance: exact equality.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_mapreduce_tpu.agg.aggregator import (
    HostSnapshotAggregator,
    TpuAggregator,
)
from ct_mapreduce_tpu.ops import hashtable as jht
from ct_mapreduce_tpu.tune import harness as jharness
from ct_mapreduce_tpu_torch.agg import merge
from ct_mapreduce_tpu_torch.agg.aggregator import (
    TorchAggregator,
    ckpt_state_digest,
)
from ct_mapreduce_tpu_torch.ops import buckettable as bt
from ct_mapreduce_tpu_torch.ops import hashtable as ht
from ct_mapreduce_tpu_torch.ops import pipeline
from ct_mapreduce_tpu_torch.utils import syncerts


def rand_keys(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32)


def as_tuple(k):
    return tuple(int(x) for x in k)


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


class Both:
    """A JAX table and a port table driven in lockstep."""

    def __init__(self, capacity: int):
        self.j = jht.make_table(capacity)
        self.t = ht.make_table(capacity, device="cpu")

    def insert(self, keys, meta, valid, max_probes=32):
        """Insert into both; require equal rows, count and flags, and
        return the port's ``(was_unknown, overflowed)`` as numpy."""
        keys = np.asarray(keys, np.uint32)
        meta = np.asarray(meta, np.uint32)
        valid = np.asarray(valid, bool)
        self.j, ju, jo = jht.insert(self.j, jnp.asarray(keys),
                                    jnp.asarray(meta), jnp.asarray(valid),
                                    max_probes=max_probes)
        self.t, tu, to = ht.insert(self.t, _t(keys), _t(meta),
                                   torch.from_numpy(valid),
                                   max_probes=max_probes)
        np.testing.assert_array_equal(ht.host_rows(self.t),
                                      np.asarray(self.j.rows))
        assert int(self.t.count) == int(self.j.count)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        return tu.numpy(), to.numpy()

    def contains(self, keys, max_probes=32):
        keys = np.asarray(keys, np.uint32)
        got = ht.contains(self.t, _t(keys), max_probes=max_probes).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jht.contains(self.j, jnp.asarray(keys),
                                         max_probes=max_probes)))
        return got

    @property
    def count(self) -> int:
        return int(self.t.count)


# -- tests/test_hashtable.py on the port ----------------------------------


def test_insert_then_reinsert():
    s = Both(256)
    keys = rand_keys(16)
    meta = np.arange(16, dtype=np.uint32)
    unknown, overflow = s.insert(keys, meta, np.ones(16, bool))
    assert unknown.all() and not overflow.any()
    assert s.count == 16
    unknown2, overflow2 = s.insert(keys, meta, np.ones(16, bool))
    assert not unknown2.any() and not overflow2.any()
    assert s.count == 16


def test_within_batch_duplicates():
    s = Both(256)
    base = rand_keys(4, seed=1)
    keys = np.concatenate([base, base, base[:2]])
    unknown, _ = s.insert(keys, np.zeros(len(keys), np.uint32),
                          np.ones(len(keys), bool))
    assert unknown.sum() == 4
    seen = set()
    for i, k in enumerate(keys):
        if unknown[i]:
            assert as_tuple(k) not in seen
        seen.add(as_tuple(k))
    assert s.count == 4


def test_invalid_lanes_ignored():
    s = Both(64)
    valid = np.array([True, False] * 4)
    unknown, _ = s.insert(rand_keys(8, seed=2), np.zeros(8, np.uint32), valid)
    assert unknown[valid].all() and not unknown[~valid].any()
    assert s.count == 4


def test_invalid_then_valid_same_key():
    s = Both(64)
    k = rand_keys(1, seed=3)
    unknown, _ = s.insert(np.concatenate([k, k]), np.zeros(2, np.uint32),
                          np.array([False, True]))
    assert list(unknown) == [False, True]
    assert s.count == 1


def test_collision_pressure_tiny_table():
    s = Both(64)
    oracle = set()
    rng = np.random.default_rng(7)
    for batch in range(6):
        keys = rng.integers(0, 4, size=(8, 4), dtype=np.uint32)
        keys[:, 0] = rng.integers(0, 2**32, size=8, dtype=np.uint32)
        unknown, overflow = s.insert(keys, np.zeros(8, np.uint32),
                                     np.ones(8, bool))
        batch_seen = set()
        for i, kk in enumerate(keys):
            t = as_tuple(kk)
            if overflow[i]:
                continue
            assert bool(unknown[i]) == (t not in oracle
                                        and t not in batch_seen), (batch, i)
            batch_seen.add(t)
        oracle |= batch_seen
    assert s.count <= len(oracle)


def test_contains():
    s = Both(128)
    keys = rand_keys(32, seed=5)
    s.insert(keys[:16], np.zeros(16, np.uint32), np.ones(16, bool))
    got = s.contains(keys)
    assert got[:16].all() and not got[16:].any()


def test_meta_scattered_and_drain():
    s = Both(128)
    keys = rand_keys(10, seed=6)
    meta = (np.arange(10, dtype=np.uint32) << 8) | 7
    s.insert(keys, meta, np.ones(10, bool))
    got_keys, got_meta = ht.drain_np(s.t)
    jk, jm = jht.drain_np(s.j)
    np.testing.assert_array_equal(got_keys, jk)
    np.testing.assert_array_equal(got_meta, jm)
    assert got_keys.shape[0] == 10
    by_key = {as_tuple(k): int(m) for k, m in zip(got_keys, got_meta)}
    for k, m in zip(keys, meta):
        assert by_key[as_tuple(k)] == int(m)


def test_randomized_parity_vs_python_set():
    s = Both(1024)
    oracle = set()
    rng = np.random.default_rng(11)
    pool = rand_keys(300, seed=12)
    for _ in range(10):
        keys = pool[rng.integers(0, len(pool), size=64)]
        valid = rng.random(64) > 0.1
        unknown, overflow = s.insert(keys, np.zeros(64, np.uint32), valid)
        assert not overflow.any()
        batch_first = {}
        for i in range(64):
            t = as_tuple(keys[i])
            if not valid[i]:
                assert not unknown[i]
                continue
            assert bool(unknown[i]) == (t not in oracle
                                        and t not in batch_first)
            batch_first[t] = True
        oracle |= set(batch_first)
    assert s.count == len(oracle)


def test_contains_np_matches_device_contains():
    s = Both(512)
    keys = rand_keys(200, seed=21)
    _, overflow = s.insert(keys, np.arange(200, dtype=np.uint32),
                           np.ones(200, bool))
    assert not overflow.any()
    probe = np.concatenate([keys[:50], rand_keys(50, seed=22),
                            np.zeros((1, 4), np.uint32)])
    dev = s.contains(probe)
    host = ht.contains_np(ht.host_rows(s.t)[:, :4], probe)
    np.testing.assert_array_equal(host, dev)
    np.testing.assert_array_equal(
        host, jht.contains_np(np.asarray(s.j.keys), probe))
    assert host[:50].all()


def test_lane_partition_invariant_under_pressure():
    rng = np.random.default_rng(33)
    s = Both(128)
    pool = rand_keys(200, seed=34)
    oracle = set()
    for _ in range(12):
        keys = pool[rng.integers(0, len(pool), size=96)]
        valid = rng.random(96) > 0.15
        unknown, overflow = s.insert(keys, np.zeros(96, np.uint32), valid,
                                     max_probes=3)
        known = valid & ~unknown & ~overflow
        assert not (unknown & overflow).any()
        assert not unknown[~valid].any() and not overflow[~valid].any()
        for i in np.flatnonzero(valid & unknown):
            oracle.add(as_tuple(keys[i]))
        for i in np.flatnonzero(known):
            assert as_tuple(keys[i]) in oracle
    assert s.count == len(oracle)
    present = np.array([k for k in pool if as_tuple(k) in oracle])
    if present.size:
        assert s.contains(present, max_probes=3).all()


def test_probe_width_env(monkeypatch):
    """``CTMR_PROBE_WIDTH`` as in the JAX module: a bad value warns and
    selects 4."""
    monkeypatch.setenv("CTMR_PROBE_WIDTH", "0")
    with pytest.warns(UserWarning, match="CTMR_PROBE_WIDTH"):
        assert ht._probe_width_from_env() == 4
    monkeypatch.setenv("CTMR_PROBE_WIDTH", "8")
    assert ht._probe_width_from_env() == 8
    with pytest.raises(ValueError, match="power of two"):
        ht.make_table(48, device="cpu")


# -- tests/test_table_parity.py on the port -------------------------------


def test_random_workload_equivalence():
    """Both layouts of the port agree with each other and with a
    sequential-set oracle on who reports unknown, on counts, membership
    and drained (key, meta) contents."""
    rng = np.random.default_rng(42)
    cap = 1 << 11
    s_open = ht.make_table(cap, device="cpu")
    s_bkt = bt.make_table(cap, device="cpu")
    oracle: set = set()
    pool = rng.integers(0, 2**32, size=(500, 4), dtype=np.uint32)
    for round_i in range(8):
        n = int(rng.integers(32, 200))
        pick = rng.integers(0, len(pool), size=n)
        keys = np.zeros((256, 4), np.uint32)
        keys[:n] = pool[pick]
        meta = np.zeros((256,), np.uint32)
        meta[:n] = rng.integers(0, 2**16, size=n).astype(np.uint32)
        valid = np.zeros((256,), bool)
        valid[:n] = rng.random(n) > 0.1
        s_open, u_open, o_open = pipeline.table_insert(
            s_open, _t(keys), _t(meta), torch.from_numpy(valid))
        s_bkt, u_bkt, o_bkt = pipeline.table_insert(
            s_bkt, _t(keys), _t(meta), torch.from_numpy(valid))
        u_open, u_bkt = u_open.numpy()[:n], u_bkt.numpy()[:n]
        assert not o_open.any() and not o_bkt.any()
        assert (u_open == u_bkt).all(), round_i
        batch_first = set()
        for i in range(n):
            t = as_tuple(keys[i])
            expect = valid[i] and t not in oracle and t not in batch_first
            assert bool(u_bkt[i]) == expect, (round_i, i)
            if valid[i]:
                batch_first.add(t)
        oracle.update(as_tuple(keys[i]) for i in range(n) if valid[i])
        assert int(s_open.count) == int(s_bkt.count) == len(oracle)
    probe = np.concatenate(
        [pool[:200], rng.integers(0, 2**32, size=(64, 4), dtype=np.uint32)])
    want = np.array([as_tuple(k) in oracle for k in probe])
    assert (pipeline.table_contains(s_open, _t(probe)).numpy() == want).all()
    assert (pipeline.table_contains(s_bkt, _t(probe)).numpy() == want).all()
    ko, mo = ht.drain_np(s_open)
    kb, mb = bt.drain_np(s_bkt)
    as_map = lambda k, m: {  # noqa: E731
        as_tuple(kk): int(mm) for kk, mm in zip(k, m)}
    assert as_map(ko, mo) == as_map(kb, mb)


def test_table_layout_env(monkeypatch):
    """``CTMR_TABLE`` selects the layout; an unknown value warns and
    selects bucket, as in the JAX package."""
    monkeypatch.setenv("CTMR_TABLE", "open")
    assert isinstance(pipeline.make_table(64, device="cpu"), ht.TableState)
    monkeypatch.setenv("CTMR_TABLE", "cuckoo")
    with pytest.warns(UserWarning, match="CTMR_TABLE"):
        assert pipeline.table_layout() == "bucket"
    assert isinstance(pipeline.make_table(64, "bucket", device="cpu"),
                      bt.BucketTable)


# -- tests/test_layouts.py (non-sharded) on the port ----------------------


@pytest.fixture(scope="module")
def templates():
    return [syncerts.make_template(issuer_cn=f"Layout CA {k}",
                                   serial_len=10 + k) for k in range(2)]


def _ents(tpl, lo, hi):
    return [(syncerts.stamp_serial(tpl, j), tpl.issuer_der)
            for j in range(lo, hi)]


@pytest.mark.parametrize("writer,reader", [
    ("open", "bucket"), ("bucket", "open"),
])
def test_checkpoint_layout_survives_env_change(monkeypatch, tmp_path,
                                               templates, writer, reader):
    """A checkpoint restores in the WRITER's layout whatever
    ``CTMR_TABLE`` says at load time, and ingest keeps exact counts."""
    monkeypatch.setenv("CTMR_TABLE", writer)
    a = TorchAggregator(capacity=1 << 10, batch_size=64, device="cpu")
    ents = _ents(templates[0], 0, 150)
    assert a.ingest(ents).was_unknown.all()
    path = str(tmp_path / "agg.npz")
    a.save_checkpoint(path)
    monkeypatch.setenv("CTMR_TABLE", reader)
    b = TorchAggregator(capacity=1 << 10, batch_size=64, device="cpu")
    b.load_checkpoint(path)
    want_cls = bt.BucketTable if writer == "bucket" else ht.TableState
    assert isinstance(b.table, want_cls)
    assert not b.ingest(ents).was_unknown.any()
    assert b.ingest(_ents(templates[1], 9000, 9060)).was_unknown.all()
    assert b.drain().total == 210


# -- open-layout checkpoints across the two packages ----------------------


def _same_drain(a, b):
    sa, sb = a.drain(), b.drain()
    assert (sa.counts, sa.crls, sa.dns, sa.total) == (
        sb.counts, sb.crls, sb.dns, sb.total)


def test_open_ck01_crosses_both_ways(monkeypatch, tmp_path, templates):
    """With ``CTMR_TABLE=open``: a JAX ck01 loads in the port, and the
    port, ingesting on, writes a ck01 the JAX package loads; drains and
    digests equal at each crossing, and the port's file holds the same
    arrays as the JAX package's after the same ingest."""
    monkeypatch.setenv("CTMR_TABLE", "open")
    kw = dict(capacity=1 << 10, batch_size=64, max_capacity=1 << 12)
    j = TpuAggregator(**kw)
    j.configure_checkpointing(mode="ck01")
    j.ingest(_ents(templates[0], 0, 120))
    jpath = str(tmp_path / "jax.npz")
    j.save_checkpoint(jpath)
    t = TorchAggregator(device="cpu", **kw)
    t.configure_checkpointing(mode="ck01")
    t.load_checkpoint(jpath)
    assert isinstance(t.table, ht.TableState)
    assert ckpt_state_digest(t) == jharness.ckpt_state_digest(j)
    _same_drain(t, j)
    # Both ingest on (through a grow); then the port's file goes back.
    more = _ents(templates[1], 500, 1000)
    j.ingest(more)
    t.ingest(more)
    assert t.capacity == j.capacity == 1 << 11
    tpath, jpath2 = str(tmp_path / "port.npz"), str(tmp_path / "jax2.npz")
    t.save_checkpoint(tpath)
    j.save_checkpoint(jpath2)
    with np.load(tpath, allow_pickle=True) as zt, \
            np.load(jpath2, allow_pickle=True) as zj:
        assert str(zt["layout"]) == "open"
        assert sorted(zt.files) == sorted(zj.files)
        for name in zj.files:
            np.testing.assert_array_equal(zt[name], zj[name], err_msg=name)
    back = TpuAggregator(**kw)
    back.load_checkpoint(tpath)
    assert isinstance(back.table, jht.TableState)
    assert jharness.ckpt_state_digest(back) == ckpt_state_digest(t)
    _same_drain(back, t)


def test_open_ck02_chain_crosses(monkeypatch, tmp_path, templates):
    """An open-layout ck02 base and two segments written by the port
    restore in the JAX ``TpuAggregator`` to the writer's digest; the
    report readers of both packages refuse to replay the chain onto an
    open base, with the same message."""
    monkeypatch.setenv("CTMR_TABLE", "open")
    kw = dict(capacity=1 << 11, batch_size=64)
    t = TorchAggregator(device="cpu", **kw)
    t.configure_checkpointing(mode="ck02")
    path = str(tmp_path / "chain.npz")
    for lo in (0, 100, 200):
        t.ingest(_ents(templates[0], lo, lo + 100))
        t.save_checkpoint(path)
    assert os.path.exists(path + ".ckseg-00000002")
    j = TpuAggregator(**kw)
    j.load_checkpoint(path)
    assert jharness.ckpt_state_digest(j) == ckpt_state_digest(t)
    r = TorchAggregator(device="cpu", **kw)
    r.load_checkpoint(path)
    assert ckpt_state_digest(r) == ckpt_state_digest(t)
    with pytest.raises(RuntimeError) as jerr:
        HostSnapshotAggregator(capacity=1 << 10).load_checkpoint(path)
    with pytest.raises(RuntimeError) as terr:
        merge.SnapshotReader().load_checkpoint(path)
    lead = str(jerr.value).split(";")[0]
    assert lead == "host-only chain replay needs the bucket layout"
    assert str(terr.value).split(";")[0] == lead
