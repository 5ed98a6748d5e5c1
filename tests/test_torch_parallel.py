"""The port's mesh, distributed helpers and sharded aggregator
(``parallel/``, ``agg/sharded_agg.py``, ``models/ingest_model.py``,
``serve/snapshot.py``'s sharded views), on the CPU.

The cases of ``tests/test_parallel.py`` and the JAX package's tests
that needed a mesh (``test_serve.py::test_view_sharded_aggregator``,
``::test_replica_pool_shard_routed_block_pinning``,
``test_contains_parity.py::test_contains_parity_sharded_view``,
``test_layouts.py::test_checkpoint_topology_mismatch_rehashes[bucket]``,
``::test_host_snapshot_reads_sharded_bucket_checkpoint``,
``test_filter.py::test_zero_false_negatives_sharded_layout``) on a
port mesh of repeated ``cpu`` devices; the JAX side, where there is
one, on the 8 virtual CPU devices ``conftest.py`` gives. Checkpoints
(ck01 and a ck02 chain) written by either package's
``ShardedAggregator`` load in the other, at another topology, to an
equal drain and report. Tolerance: exact equality.
"""

import datetime
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from ct_mapreduce_tpu.agg.aggregator import TpuAggregator
from ct_mapreduce_tpu.agg import sharded as jsharded
from ct_mapreduce_tpu.agg.sharded_agg import ShardedAggregator as JShardedAgg
from ct_mapreduce_tpu.parallel import mesh as jmesh
from ct_mapreduce_tpu_torch.agg import sharded as tsharded
from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
from ct_mapreduce_tpu_torch.agg.merge import SnapshotReader
from ct_mapreduce_tpu_torch.agg.sharded_agg import ShardedAggregator
from ct_mapreduce_tpu_torch.config import CTConfig
from ct_mapreduce_tpu_torch.core import packing
from ct_mapreduce_tpu_torch.ops import hashtable
from ct_mapreduce_tpu_torch.parallel import (
    DistributedCoordinator,
    Mesh,
    device_barrier,
    distributed,
    initialize_multihost,
    is_leader,
    make_mesh,
    parse_mesh_shape,
)
from ct_mapreduce_tpu_torch.serve.snapshot import ReplicaPool, capture_view
from ct_mapreduce_tpu_torch.tools import global_mesh
from ct_mapreduce_tpu_torch.utils import minicert

UTC = datetime.timezone.utc
FUTURE = datetime.datetime(2031, 6, 15, tzinfo=UTC)
NOW = datetime.datetime(2025, 1, 1, tzinfo=UTC)


def cpu_mesh(n: int, spec: str = "") -> Mesh:
    return make_mesh(spec or f"shard:{n}", devices=["cpu"] * n)


def jax_mesh(n: int) -> JMesh:
    return JMesh(np.array(jax.devices()[:n]), ("shard",))


def _entries(n_issuers=2, per=6, dupes=2, base=5000):
    out = []
    for i in range(n_issuers):
        cn = f"Shard CA {i}"
        issuer = minicert.make_cert(serial=1, issuer_cn=cn, is_ca=True,
                                    not_after=FUTURE, spki_seed=f"s{i}")
        uniq = per - dupes
        for s in range(per):
            leaf = minicert.make_cert(
                serial=base + (s % uniq), issuer_cn=cn,
                subject_cn="s.example.com", not_after=FUTURE,
                spki_seed=f"s{i}", crl_dps=(f"http://crl{i}.example/x.crl",))
            out.append((leaf, issuer))
    return out


def _topo_entries(n, issuer_cn, base=5000):
    ca = minicert.make_cert(issuer_cn=issuer_cn, is_ca=True)
    return [(minicert.make_cert(serial=base + i, issuer_cn=issuer_cn,
                                subject_cn=f"x{i}.example.com",
                                not_after=FUTURE), ca)
            for i in range(n)]


# -- mesh spec --------------------------------------------------------------


@pytest.mark.parametrize("spec", ["", "shard:8", "data:4,expert:2",
                                  "data:-1,expert:2", " shard : 2 "])
def test_parse_mesh_shape_matches_jax(spec):
    t, j = parse_mesh_shape(spec), jmesh.parse_mesh_shape(spec)
    assert (t.axis_names, t.axis_sizes) == (j.axis_names, j.axis_sizes)
    for n in (8, 16):
        assert t.resolve(n) == j.resolve(n)


@pytest.mark.parametrize("spec,n", [("shard", 8), ("a:2,a:2", 8),
                                    ("a:-1,b:-1", 8), ("a:-1,b:3", 8),
                                    ("shard:4", 1)])
def test_parse_mesh_shape_errors_match_jax(spec, n):
    with pytest.raises(ValueError) as te:
        parse_mesh_shape(spec).resolve(n)
    with pytest.raises(ValueError) as je:
        jmesh.parse_mesh_shape(spec).resolve(n)
    assert str(te.value) == str(je.value)


def test_make_mesh():
    mesh = make_mesh("", devices=["cpu"] * 8)
    assert mesh.size == 8 and mesh.axis_names == ("shard",)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert mesh.ranks.tolist() == [0] * 8
    mesh2 = make_mesh("data:2,expert:4", devices=["cpu"] * 8)
    assert mesh2.devices.shape == (2, 4)
    assert mesh2.axis_names == ("data", "expert")
    flat = mesh2.flatten()
    assert flat.axis_names == ("shard",) and flat.devices.shape == (8,)
    with pytest.raises(ValueError, match="mesh needs 4 devices, only 1"):
        make_mesh("shard:4", devices=["cpu"])
    ranked = make_mesh("shard:4", devices=["cpu"] * 4, ranks=[0, 0, 1, 1])
    assert ranked.ranks.tolist() == [0, 0, 1, 1]


# -- distributed helpers (one process) --------------------------------------


def test_leader_and_barrier(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize_multihost()  # no group in the environment: stays local
    assert not torch.distributed.is_initialized()
    assert is_leader() and distributed.rank() == 0
    assert distributed.world_size() == 1
    device_barrier("test")
    assert distributed.kv_put("k", "v") is False
    assert distributed.kv_get("k") is None
    devs, ranks = distributed.global_mesh_devices(["cpu", "cpu"])
    assert devs == [torch.device("cpu")] * 2 and ranks == [0, 0]
    with pytest.raises(ValueError, match="address"):
        initialize_multihost("127.0.0.1:1", num_processes=2)


def test_local_device_has_no_silent_cpu_fallback():
    assert distributed.local_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.local_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            global_mesh.run(0, 1, "", 2, 4, 0, None, "unused")
    else:
        assert distributed.local_device().type == "cuda"


def test_distributed_coordinator_protocol():
    c = DistributedCoordinator("t")
    with pytest.raises(RuntimeError):
        c.send_start()
    assert c.await_leader() is True
    c.send_start()
    with pytest.raises(RuntimeError):
        c.await_start()  # leaders must not await
    c.close()


# -- ShardedAggregator ------------------------------------------------------


def test_sharded_aggregator_matches_single_device():
    entries = _entries()
    sharded = ShardedAggregator(cpu_mesh(8), capacity=1 << 12,
                                batch_size=32, now=NOW)
    single = TorchAggregator(capacity=1 << 12, batch_size=32, now=NOW,
                             device="cpu")
    r_sh, r_si = sharded.ingest(entries), single.ingest(entries)
    np.testing.assert_array_equal(r_sh.was_unknown, r_si.was_unknown)
    np.testing.assert_array_equal(r_sh.filtered, r_si.filtered)
    snap_sh, snap_si = sharded.drain(), single.drain()
    assert snap_sh == snap_si
    assert snap_sh.total == 8  # 2 issuers x 4 unique
    with pytest.raises(ValueError, match="divide over 8"):
        ShardedAggregator(cpu_mesh(8), batch_size=12)
    with pytest.raises(ValueError, match="one process"):
        ShardedAggregator(make_mesh("shard:2", ["cpu", "cpu"], [0, 1]),
                          batch_size=32)


def test_sharded_aggregator_grows_and_stages():
    """Growth rebuilds the mesh table and re-hashes; the staged envelope
    over the mesh folds as K sharded steps; both drain as one device."""
    entries = _topo_entries(200, "Grow CA")
    a = ShardedAggregator(cpu_mesh(4), capacity=96, batch_size=64, now=NOW)
    one = TorchAggregator(capacity=96, batch_size=64, now=NOW, device="cpu")
    cap0 = a.capacity
    assert a.ingest(entries).was_unknown.all()
    one.ingest(entries)
    assert a.capacity > cap0 and a.capacity == a.dedup.capacity
    assert a.drain() == one.drain()
    more = _topo_entries(64, "Grow CA", base=9000)
    data, length = _pack([e[0] for e in more], 64)
    idx = np.full((1, 64), a.registry.get_or_assign(more[0][1]), np.int32)
    pend = a.ingest_staged_submit(data[None], length[None], idx,
                                  np.ones((1, 64), bool), [data])
    assert pend.complete().was_unknown.all()
    assert a.drain().total == 264


def _pack(ders, b):
    pad = max(len(d) for d in ders)
    data = np.zeros((b, pad), np.uint8)
    length = np.zeros((b,), np.int32)
    for i, d in enumerate(ders):
        data[i, : len(d)] = np.frombuffer(d, np.uint8)
        length[i] = len(d)
    return data, length


@pytest.mark.parametrize("mode", ["ck01", "ck02"])
def test_checkpoint_across_packages_and_topologies(tmp_path, mode):
    """A port 8-shard aggregator's checkpoint (ck01, or a ck02 base plus
    one segment) loads in the JAX package's single-chip and 8-shard
    aggregators, the port's single-device one, a port 2-shard mesh and
    the host reader, to one drain and report; a JAX 8-shard checkpoint
    loads in the port's 2-shard mesh and single device alike."""
    from ct_mapreduce_tpu.agg.merge import load_checkpoints as jload
    from ct_mapreduce_tpu_torch.agg.merge import load_checkpoints

    first, second = _entries(), _entries(base=7000)
    w = ShardedAggregator(cpu_mesh(8), capacity=1 << 12, batch_size=32,
                          now=NOW)
    w.configure_checkpointing(mode=mode)
    w.ingest(first)
    path = str(tmp_path / "sh.npz")
    w.save_checkpoint(path)
    w.ingest(second)
    w.save_checkpoint(path)
    assert os.path.exists(path + ".ckmanifest.json") == (mode == "ck02")
    with np.load(path, allow_pickle=True) as z:
        assert int(z["n_shards"]) == 8 and z["count"].shape == (8,)
    want = w.drain()
    readers = [TorchAggregator(capacity=1 << 10, batch_size=32, now=NOW,
                               device="cpu"),
               ShardedAggregator(cpu_mesh(2), capacity=1 << 10,
                                 batch_size=32, now=NOW), SnapshotReader()]
    for r in readers:
        r.load_checkpoint(path)
        assert r.drain() == want
    assert readers[1].dedup.n_shards == 2
    assert not readers[1].ingest(first + second).was_unknown.any()
    for jr in (TpuAggregator(capacity=1 << 10, batch_size=32, now=NOW),
               JShardedAgg(jax_mesh(8), capacity=1 << 12, batch_size=32,
                           now=NOW)):
        jr.load_checkpoint(path)
        snap = jr.drain()
        assert (snap.counts, snap.crls, snap.dns, snap.total) == (
            want.counts, want.crls, want.dns, want.total)
    assert load_checkpoints([path]).drain() == want
    assert jload([path]).drain().counts == want.counts

    # And back: the JAX package's 8-shard checkpoint on the port.
    j = JShardedAgg(jax_mesh(8), capacity=1 << 12, batch_size=32, now=NOW)
    j.configure_checkpointing(mode=mode)
    j.ingest(first)
    jpath = str(tmp_path / "jsh.npz")
    j.save_checkpoint(jpath)
    j.ingest(second)
    j.save_checkpoint(jpath)
    for r in (ShardedAggregator(cpu_mesh(2), capacity=1 << 10,
                                batch_size=32, now=NOW),
              TorchAggregator(capacity=1 << 10, batch_size=32, now=NOW,
                              device="cpu")):
        r.load_checkpoint(jpath)
        assert r.drain() == want


@pytest.mark.parametrize("layout", ["bucket"])
def test_checkpoint_topology_mismatch_rehashes(monkeypatch, tmp_path,
                                               layout):
    """A multi-shard writer records positions in shard-local addressing;
    a single-device reader re-hashes every row, and back."""
    monkeypatch.setenv("CTMR_TABLE", layout)
    a = ShardedAggregator(cpu_mesh(8), capacity=1 << 12, batch_size=64,
                          now=NOW)
    ents = _topo_entries(150, f"Topo CA {layout}")
    assert a.ingest(ents).was_unknown.all()
    path = str(tmp_path / "topo.npz")
    a.save_checkpoint(path)
    with np.load(path, allow_pickle=True) as z:
        assert int(z["n_shards"]) == 8
    b = TorchAggregator(capacity=1 << 10, batch_size=64, now=NOW,
                        device="cpu")
    b.load_checkpoint(path)
    assert not b.ingest(ents).was_unknown.any()
    more = _topo_entries(60, f"Topo CA {layout} 2", base=9000)
    assert b.ingest(more).was_unknown.all()
    assert b.drain().total == 210
    c = ShardedAggregator(cpu_mesh(8), capacity=1 << 12, batch_size=64,
                          now=NOW)
    c.load_checkpoint(path)
    assert not c.ingest(ents).was_unknown.any()
    assert c.drain().total == 150


def test_host_snapshot_reads_sharded_bucket_checkpoint(monkeypatch,
                                                       tmp_path):
    """storage-statistics' CPU reader re-hashes a mesh writer's
    snapshot, and reports it as the writer's drain."""
    from ct_mapreduce_tpu_torch.cmd import storage_statistics

    monkeypatch.setenv("CTMR_TABLE", "bucket")
    a = ShardedAggregator(cpu_mesh(8), capacity=1 << 12, batch_size=64,
                          now=NOW)
    assert a.ingest(_topo_entries(120, "HostSnap CA")).was_unknown.all()
    path = str(tmp_path / "host.npz")
    a.save_checkpoint(path)
    h = SnapshotReader()
    h.load_checkpoint(path)
    assert h.drain().total == 120
    cfg = CTConfig.load(argv=[], env={})
    cfg.backend, cfg.agg_state_path = "tpu", path
    out = io.StringIO()
    assert storage_statistics.report_from_tpu_snapshot(cfg, out, 1) == 0
    assert "overall totals: 1 issuers, 120 serials" in out.getvalue()


# -- composition root -------------------------------------------------------


def test_build_aggregator_selects_path():
    from ct_mapreduce_tpu_torch.models.ingest_model import (
        IngestModel,
        build_aggregator,
    )

    cfg = CTConfig(table_bits=12, batch_size=64)
    agg = build_aggregator(cfg, mesh=cpu_mesh(8))
    assert isinstance(agg, ShardedAggregator)
    assert agg.dedup.n_shards == 8
    cfg1 = CTConfig(table_bits=12, batch_size=64, mesh_shape="shard:1")
    assert type(build_aggregator(cfg1, device="cpu")) is TorchAggregator
    assert type(build_aggregator(cfg1, mesh=cpu_mesh(1))) is TorchAggregator
    model = IngestModel.from_config(cfg, mesh=cpu_mesh(4))
    assert isinstance(model.aggregator, ShardedAggregator)


def test_build_aggregator_multi_axis_mesh_flattens():
    from ct_mapreduce_tpu_torch.models.ingest_model import build_aggregator

    cfg = CTConfig(table_bits=12, batch_size=60,  # 60 % 8 != 0: rounds up
                   mesh_shape="data:4,expert:2")
    agg = build_aggregator(cfg, mesh=cpu_mesh(8, "data:4,expert:2"))
    assert isinstance(agg, ShardedAggregator)
    assert agg.dedup.n_shards == 8 and agg.mesh.axis_names == ("shard",)
    assert agg.batch_size % 8 == 0 and agg.batch_size == 64
    assert agg.dedup.capacity >= (1 << 12)
    assert agg.dedup.capacity == jsharded.mesh_capacity(8, 1 << 12,
                                                        "bucket")


# -- sharded views ----------------------------------------------------------


def _identity(agg, entries):
    """(issuer index, exp hour, serial bytes) of each entry."""
    from ct_mapreduce_tpu_torch.core.der import parse_cert
    from ct_mapreduce_tpu_torch.core.types import Issuer

    items = []
    for der_, issuer_der in entries:
        c = parse_cert(der_)
        idx = agg.registry.index_of_issuer_id(
            Issuer.from_spki(parse_cert(issuer_der).spki).id())
        items.append((idx, c.not_after_unix_hour, c.serial))
    return items


def test_view_sharded_aggregator():
    """The sharded read view routes fingerprints to their home shard's
    row block: equal to the aggregator's own contains and the global
    probe."""
    agg = ShardedAggregator(cpu_mesh(8), capacity=1 << 12, batch_size=64,
                            now=NOW)
    fed = _topo_entries(64, "View CA")
    agg.ingest(fed)
    items = _identity(agg, fed + _topo_entries(16, "View CA", base=90000))
    view = capture_view(agg, epoch=1)
    assert view.n_shards == 8
    got = view.lookup(items)
    assert got[:64].all() and not got[64:].any()
    fps = np.array([packing.fingerprint_host(i, e, s) for i, e, s in items],
                   np.uint32)
    np.testing.assert_array_equal(view.contains_fps(fps),
                                  agg._device_contains(fps))
    dview = capture_view(agg, epoch=2, device=True)  # global rows pinned
    np.testing.assert_array_equal(dview.contains_fps(fps),
                                  view.contains_fps(fps))
    assert dview._dev_blocks is None and dview._dev_rows is not None


def test_replica_pool_shard_routed_block_pinning():
    """The pool pins per-shard row blocks, each on its shard's device,
    never the global rows, and the routed probe answers as the host."""
    agg = ShardedAggregator(cpu_mesh(8), capacity=1 << 12, batch_size=64,
                            now=NOW)
    fed = _topo_entries(64, "Pool CA")
    agg.ingest(fed)
    items = _identity(agg, fed + _topo_entries(16, "Pool CA", base=90000))
    pool = ReplicaPool(agg, n_replicas=2, max_staleness_s=1e9,
                       device=True).warm()
    host = capture_view(agg, epoch=99).lookup(items)
    for v in pool._replicas:
        assert v.n_shards == 8
        assert v._dev_blocks is not None and v._dev_rows is None
        block = v.rows.shape[0] // v.n_shards
        assert [b.shape[0] for b in v._dev_blocks] == [block] * 8
        assert v.pinned_devices == list(agg.dedup.devices)
        got = v.lookup(items)
        assert got[:64].all() and not got[64:].any()
        np.testing.assert_array_equal(got, host)


def test_contains_parity_sharded_view():
    """The sharded global contains against the routed host probe and the
    JAX package's global contains, on one set of open-layout rows."""
    n_shards, max_probes = 8, 32
    rng = np.random.default_rng(41)
    kept = rng.integers(1, 2**32, size=(256, 4), dtype=np.uint64).astype(
        np.uint32)
    absent = rng.integers(1, 2**32, size=(128, 4), dtype=np.uint64).astype(
        np.uint32)
    cap_loc = 1 << int((len(kept) * 4 // n_shards).bit_length())
    dest = tsharded.shard_of_np(kept, n_shards)
    blocks = []
    for s in range(n_shards):
        state = hashtable.make_table(cap_loc, device="cpu")
        sel = kept[dest == s]
        state, _wu, ovf = hashtable.insert(
            state, torch.from_numpy(sel.view(np.int32)),
            torch.arange(1, len(sel) + 1, dtype=torch.int32),
            torch.ones((len(sel),), dtype=torch.bool), max_probes=max_probes)
        assert not bool(ovf.any())
        blocks.append(state.rows.numpy().view(np.uint32))
    rows = np.concatenate(blocks)
    probe = np.concatenate([kept, absent])
    want = np.arange(len(probe)) < len(kept)
    dev = tsharded._contains_global(torch.from_numpy(rows.view(np.int32)),
                                    torch.from_numpy(probe.view(np.int32)),
                                    n_shards, max_probes).numpy()
    np.testing.assert_array_equal(dev, want)
    np.testing.assert_array_equal(dev, np.asarray(jsharded._contains_global(
        jnp.asarray(rows), jnp.asarray(probe), n_shards=n_shards,
        max_probes=max_probes)))
    dest_p = tsharded.shard_of_np(probe, n_shards)
    host = np.zeros((len(probe),), bool)
    for s in np.unique(dest_p):
        sel = dest_p == s
        host[sel] = hashtable.contains_np(
            rows[s * cap_loc:(s + 1) * cap_loc], probe[sel], max_probes)
    np.testing.assert_array_equal(host, want)


def test_zero_false_negatives_sharded_layout():
    from ct_mapreduce_tpu_torch.filter.artifact import build_from_aggregator

    issuer = minicert.make_cert(serial=1, issuer_cn="Filter CA", is_ca=True)
    ents = [(minicert.make_cert(serial=1000 + s, issuer_cn="Filter CA",
                                subject_cn=f"f{s}.example",
                                not_after=FUTURE), issuer)
            for s in range(120)]
    agg = ShardedAggregator(cpu_mesh(8), capacity=1 << 13, batch_size=32,
                            now=NOW)
    agg.enable_filter_capture()
    agg.ingest(ents + ents[:20])
    snap = agg.drain()
    assert sum(len(v) for v in agg.filter_capture.values()) == snap.total
    items = [(agg.registry.issuer_at(idx).id(), eh, sb)
             for (idx, eh), ss in agg.filter_capture.items()
             for sb in sorted(ss)]
    art = build_from_aggregator(agg, fp_rate=0.01, device="cpu")
    for iss, eh, sb in items:
        assert art.query(iss, eh, sb)
    art01 = build_from_aggregator(agg, fp_rate=0.01, fmt="fl01",
                                  device="cpu")
    iss, eh, sb = items[0]
    assert not art01.query(iss, eh + 24, sb)


# -- stripes ----------------------------------------------------------------


def test_stripe_cursor_resumes_at_max_of_start_and_saved():
    """A fleet stripe keeps its own cursor under ``<url><suffix>`` and
    resumes at max(stripe start, saved cursor), its end fixed."""
    from ct_mapreduce_tpu_torch.ingest.ctclient import CTLogClient
    from ct_mapreduce_tpu_torch.ingest.sync import LogWorker
    from ct_mapreduce_tpu_torch.storage.certdb import FilesystemDatabase
    from ct_mapreduce_tpu_torch.storage.mockbackend import MockBackend
    from ct_mapreduce_tpu_torch.storage.mockcache import MockRemoteCache
    from ct_mapreduce_tpu_torch.utils.fakelog import FakeLog

    log = FakeLog()
    issuer = minicert.make_cert(serial=1, issuer_cn="Stripe CA", is_ca=True)
    for i in range(20):
        log.add_cert(minicert.make_cert(serial=100 + i,
                                        issuer_cn="Stripe CA"), issuer)
    db = FilesystemDatabase(MockBackend(), MockRemoteCache())
    client = CTLogClient(log.url, transport=log.transport)
    w = LogWorker(client, db, offset=10, limit=5, state_suffix="#w1")
    assert (w.start_pos, w.end_pos) == (10, 14)
    w.position = 12
    w.save_state()
    w2 = LogWorker(client, db, offset=10, limit=5, state_suffix="#w1")
    assert (w2.start_pos, w2.end_pos) == (12, 14)
    assert db.get_log_state(client.short_url).max_entry == 0
    w3 = LogWorker(client, db, offset=0, limit=10, state_suffix="#w0")
    assert (w3.start_pos, w3.end_pos) == (0, 9)
