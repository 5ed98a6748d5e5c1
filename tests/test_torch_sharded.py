"""The port's sharded dedup (``agg/sharded.py``, ``agg/sharded_agg.py``)
against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices ``conftest.py`` gives;
the port side on a mesh of repeated ``cpu`` devices (one table a
shard), through the plain tensor-op paths. Inputs are made from a numpy
seed: leaves of several issuers with replays within and across steps,
an expired leaf, a CA certificate, a leaf expiring in the current hour,
a 70-byte issuer CN matched by a 64-byte prefix (host lane), invalid
lanes and byte-flipped rows the walker rejects. A dispatch factor of
0.25 makes the routing cap bite (``dispatch_dropped``) on meshes of 1
and 2 shards, and one small shard's inserts overflow their probe
chains. Tolerance:
exact equality (integers, flags and table bytes).
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from ct_mapreduce_tpu.agg import sharded as jsharded
from ct_mapreduce_tpu.agg.sharded_agg import ShardedAggregator as JShardedAgg
from ct_mapreduce_tpu_torch.agg import sharded as tsharded
from ct_mapreduce_tpu_torch.agg.sharded_agg import ShardedAggregator
from ct_mapreduce_tpu_torch.core import der, packing
from ct_mapreduce_tpu_torch.native import leafpack
from ct_mapreduce_tpu_torch.parallel import make_mesh
from ct_mapreduce_tpu_torch.utils import dercases, syncerts

UTC = datetime.timezone.utc
NOW = datetime.datetime(2025, 1, 1, 12, tzinfo=UTC)
NOW_HOUR = int(NOW.timestamp()) // 3600
B = 128
STEPS = 2
LONG_CN = "Sharded Long CA " + "z" * 54  # 70 bytes
PREFIXES = ("Sharded Issuer 1", "Sharded Issuer 3", LONG_CN[:64])


def _templates():
    def tpl(cn, slen, key="ec", **delta):
        return syncerts.make_template(
            issuer_cn=cn, not_after=NOW + datetime.timedelta(**delta),
            serial_len=slen, key_type=key, rich_extensions=slen % 2 == 0)

    t = [tpl(f"Sharded Issuer {i}", 8 + 3 * i, "rsa2048" if i % 2 else "ec",
             days=100 + 40 * i) for i in range(4)]
    t += [tpl(LONG_CN, 10, days=300),
          tpl("Sharded Issuer 1", 9, days=-3),  # expired
          tpl("Sharded Issuer 3", 11, minutes=20)]  # boundary hour
    ca = der.parse_cert(t[1].issuer_der)
    t.append(syncerts.CertTemplate(t[1].issuer_der, t[1].issuer_der,
                                   ca.serial_off, ca.serial_len))
    return t


@pytest.fixture(scope="module")
def steps():
    """STEPS walker batches of B lanes: (data, length, issuer, valid,
    template of each lane, byte-flipped lanes)."""
    tpls = _templates()
    rng = np.random.default_rng(1515)
    out, pool, counter = [], [], 1
    for _ in range(STEPS):
        tof = rng.integers(0, len(tpls), B)
        ctr = np.zeros(B, np.int64)
        for i in range(B):
            if pool and rng.random() < 0.3:
                tof[i], ctr[i] = pool[rng.integers(len(pool))]
            else:
                ctr[i], counter = counter, counter + 1
                pool.append((tof[i], ctr[i]))
        pairs = [(syncerts.stamp_serial(tpls[t], int(c)), None)
                 for t, c in zip(tof, ctr)]
        data, length = dercases.pack(pairs, 2048)
        flip = rng.random(B) < 0.05
        data[flip, rng.integers(0, 200, B)[flip]] ^= 0x5A
        issuer = (tof % 6).astype(np.int32)
        valid = rng.random(B) > 0.04
        out.append((data, length, issuer, valid, tof, flip))
    return out


def _prefix_arrays():
    enc = [p.encode() for p in PREFIXES]
    k = min(61, max(len(e) for e in enc))
    arr = np.zeros((len(enc), k), np.uint8)
    lens = np.zeros((len(enc), 2), np.int32)
    for i, e in enumerate(enc):
        arr[i, : min(len(e), k)] = np.frombuffer(e[:k], np.uint8)
        lens[i] = (min(len(e), k), len(e))
    return arr, lens


def jax_mesh(n):
    devs = np.array(jax.devices()[:n])
    assert devs.size == n, "conftest must provide 8 virtual devices"
    return JMesh(devs, ("shard",))


def torch_mesh(n):
    return make_mesh(f"shard:{n}", devices=["cpu"] * n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture
def layout(request, monkeypatch):
    monkeypatch.setenv("CTMR_TABLE", request.param)
    return request.param


@pytest.mark.parametrize("layout", ["bucket", "open"], indirect=True)
@pytest.mark.parametrize("n", [1, 2, 8])
def test_step_matches_jax(steps, layout, n):
    """One sharded step after another, both packages: every output and
    every shard's rows bit for bit."""
    cap = 24 * n if layout == "bucket" else 32 * n
    jd = jsharded.ShardedDedup(jax_mesh(n), capacity=cap, max_probes=4,
                               dispatch_factor=0.25)
    td = tsharded.ShardedDedup(torch_mesh(n), capacity=cap, max_probes=4,
                               dispatch_factor=0.25)
    assert td.capacity == jd.capacity
    pfx, lens = _prefix_arrays()
    spilled = overflowed = 0
    for data, length, issuer, valid, _tof, _flip in steps:
        jo = jd.step(data, length, issuer, valid, NOW_HOUR, pfx, lens)
        to = td.step(data, length, issuer, valid, NOW_HOUR, pfx, lens)
        for name in jsharded.ShardedStepOut._fields:
            np.testing.assert_array_equal(
                _np(getattr(to, name)), np.asarray(getattr(jo, name)),
                err_msg=name)
        spilled += int(_np(to.dispatch_dropped).sum())
        overflowed += int(_np(to.probe_overflow).sum())
        np.testing.assert_array_equal(td.host_rows(), np.asarray(jd.rows))
        np.testing.assert_array_equal(td.counts(), np.asarray(jd.count))
        assert td.total_count() == jd.total_count()
    # The routing cap bites on the narrow meshes, the probe chains
    # overflow on one shard's small table.
    assert n == 8 or spilled > 0
    assert n > 1 or overflowed > 0
    jk, jm = jd.drain_np()
    tk, tm = td.drain_np()
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tm, jm)
    probe = np.concatenate([tk[:40], tk[:8] ^ np.uint32(1)])
    np.testing.assert_array_equal(td.contains_np(probe), jd.contains_np(probe))
    fn_j = (jsharded._contains_global_bucket if layout == "bucket"
            else jsharded._contains_global)
    fn_t = (tsharded._contains_global_bucket if layout == "bucket"
            else tsharded._contains_global)
    rows = td.host_rows()
    np.testing.assert_array_equal(
        fn_t(torch.from_numpy(rows.view(np.int32)),
             torch.from_numpy(probe.view(np.int32)), n, 4).numpy(),
        np.asarray(fn_j(jnp.asarray(rows), jnp.asarray(probe),
                        n_shards=n, max_probes=4)))


@pytest.mark.parametrize("n_shards", [8, 40])
def test_dispatch_matches_jax(n_shards):
    """The port's ``_dispatch`` against the reference's, called with jnp
    inputs: the per-shard cumsum ranks (8) and the stable-sort ranks
    (40) alike."""
    rng = np.random.RandomState(11)
    b, cap = 257, 24 if n_shards == 8 else 4
    payload = rng.randint(0, 2**31, size=(b, 5)).astype(np.uint32)
    dest = rng.randint(0, n_shards, size=(b,)).astype(np.int32)
    active = rng.rand(b) < 0.85
    want = [np.asarray(x) for x in jsharded._dispatch(
        jnp.asarray(payload), jnp.asarray(dest), jnp.asarray(active),
        n_shards, cap)]
    got = [x.numpy() for x in tsharded._dispatch(
        torch.from_numpy(payload.view(np.int32)), torch.from_numpy(dest),
        torch.from_numpy(active), n_shards, cap)]
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    placed = got[2] >= 0
    np.testing.assert_array_equal(got[3][placed], want[3][placed])
    assert (~placed & active).any()  # the cap bites


def test_zipfian_issuer_skew_routes_evenly():
    """A Zipf-hot issuer does not skew routing: the port's shard hash
    equals the reference's and ``shard_of_np`` on fingerprints of one
    hot issuer, and spreads them within 2x of an even share."""
    rng = np.random.RandomState(7)
    b = 512
    weights = 1.0 / np.arange(1, 9) ** 1.5
    issuer_idx = rng.choice(8, size=b, p=weights / weights.sum())
    assert (issuer_idx == 0).sum() > 0.5 * b
    fps = np.array([packing.fingerprint_host(
        int(issuer_idx[i]), NOW_HOUR + 100, b"\x01" + i.to_bytes(8, "big"))
        for i in range(b)], np.uint32)
    dest = tsharded._shard_of(torch.from_numpy(fps.view(np.int32)), 8)
    np.testing.assert_array_equal(
        dest.numpy(), np.asarray(jsharded._shard_of(jnp.asarray(fps), 8)))
    np.testing.assert_array_equal(dest.numpy(),
                                  tsharded.shard_of_np(fps, 8))
    assert np.bincount(dest.numpy(), minlength=8).max() <= 2 * b // 8


@pytest.mark.parametrize("n", [2, 8])
def test_aggregator_walker_matches_jax_and_one_device(steps, n):
    """``ShardedAggregator`` against the reference's over the same
    entries (results and metrics, ``dispatch_spill`` included, bit for
    bit), and against a single-device aggregator (unknown count and
    drain)."""
    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator

    tpls = _templates()
    entries = []
    # Unflipped rows: a flipped issuer name would put the DN set at the
    # mercy of which copy of a serial reads unknown.
    for data, length, _issuer, valid, tof, flip in steps:
        entries += [(data[i, : length[i]].tobytes(), tpls[tof[i]].issuer_der)
                    for i in range(B) if valid[i] and not flip[i]]
    kw = dict(capacity=24 * 8 * n, batch_size=256, now=NOW,
              cn_prefixes=PREFIXES, dispatch_factor=0.0)
    j = JShardedAgg(jax_mesh(n), **kw)
    t = ShardedAggregator(torch_mesh(n), **kw)
    kw.pop("dispatch_factor")
    one = TorchAggregator(device="cpu", **kw)
    jr, tr, orr = j.ingest(entries), t.ingest(entries), one.ingest(entries)
    np.testing.assert_array_equal(tr.was_unknown, jr.was_unknown)
    np.testing.assert_array_equal(tr.filtered, jr.filtered)
    # A spilled first sighting takes the host lane, after the device took
    # a later copy: which lane reads unknown may move, never how many.
    assert tr.was_unknown.sum() == orr.was_unknown.sum()
    assert t.metrics == j.metrics
    assert n == 8 or t.metrics["dispatch_spill"] > 0
    assert t.drain() == one.drain()
    snap_j = j.drain()
    snap_t = t.drain()
    assert snap_t.counts == snap_j.counts and snap_t.total == snap_j.total


@pytest.mark.parametrize("n", [1, 8])
def test_preparsed_routing_matches_jax(steps, n):
    """The pre-parsed lane over the mesh, routed on the host: the same
    was-unknown lanes, drains and shard rows as the reference's, and
    the walker lane's drain."""
    kw = dict(capacity=24 * 8 * n, batch_size=64, now=NOW,
              cn_prefixes=PREFIXES)
    j = JShardedAgg(jax_mesh(n), **kw)
    t = ShardedAggregator(torch_mesh(n), **kw)
    w = ShardedAggregator(torch_mesh(n), **kw)
    tpls = _templates()
    idx_j = np.array([j.registry.get_or_assign(tp.issuer_der)
                      for tp in tpls], np.int32)
    idx_t = np.array([t.registry.get_or_assign(tp.issuer_der)
                      for tp in tpls], np.int32)
    np.testing.assert_array_equal(idx_j, idx_t)
    for tp in tpls:
        w.registry.get_or_assign(tp.issuer_der)
    from ct_mapreduce_tpu.native import leafpack as jleafpack

    for data, length, _issuer, valid, tof, _flip in steps:
        ii = idx_t[tof]
        sc_t = leafpack.extract_sidecars(data, length)
        sc_j = jleafpack.extract_sidecars(data, length)
        rj = j.ingest_preparsed(sc_j, ii, valid, data, length)
        rt = t.ingest_preparsed(sc_t, ii, valid, data, length)
        rw = w.ingest_packed(data, length, ii, valid)
        np.testing.assert_array_equal(rt.was_unknown, rj.was_unknown)
        np.testing.assert_array_equal(rt.was_unknown, rw.was_unknown)
    np.testing.assert_array_equal(t.dedup.host_rows(), np.asarray(j.dedup.rows))
    assert t.drain() == w.drain()
    assert t.drain().counts == j.drain().counts
