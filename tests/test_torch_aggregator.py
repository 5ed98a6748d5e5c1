"""The port's two ingest lanes against the JAX package.

``TpuAggregator`` and ``TorchAggregator`` (on the CPU) take the same
seeded batches through the pre-parsed lane (``ingest_preparsed``) and
the walker lane (``ingest_packed``, ``ingest``): replays, expired and CA
leaves, a CN filter with an over-long prefix (host lane), a leaf
expiring within the current hour (host lane), a table grow and probe
overflow to the host lane. Per-lane results, table rows, metrics and
drained snapshots must be equal, and the two lanes drain the same;
tolerance is exact equality.
"""

import copy
import dataclasses
import datetime
import os
import subprocess
import sys

import numpy as np
import pytest

from ct_mapreduce_tpu.agg.aggregator import TpuAggregator
from ct_mapreduce_tpu.native import leafpack as jleafpack
from ct_mapreduce_tpu_torch import convert
from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
from ct_mapreduce_tpu_torch.config import CTConfig
from ct_mapreduce_tpu_torch.core import der, packing
from ct_mapreduce_tpu_torch.models.ingest_model import IngestModel
from ct_mapreduce_tpu_torch.native import leafpack as tleafpack
from ct_mapreduce_tpu_torch.ops import buckettable
from ct_mapreduce_tpu_torch.utils import syncerts

UTC = datetime.timezone.utc
NOW = datetime.datetime(2025, 1, 1, tzinfo=UTC)
PAD = 2048
N = 40  # lanes per ingest; the step runs them as 2 chunks of 20
LONG_CN = "Long" + "x" * 70
PREFIXES = ("Issuer A", "Issuer B", "Issuer C", LONG_CN[:69])
# Table: 2 buckets growing once to 4 (the ceiling) in the second
# batch; one hop allowed, so full buckets overflow to the host lane.
AGG_KW = dict(capacity=48, batch_size=20, now=NOW, max_probes=1,
              grow_at=0.9, max_capacity=96, cn_prefixes=PREFIXES)
N_BATCHES = 6
CARRY_AFTER = 3  # batches the JAX side runs before state is carried over
# The clock of each batch. The leaf expiring 30 minutes after NOW goes
# to the device an hour before NOW and to the exact host lane at NOW, so
# its serials cross between the two dedup domains both ways and the
# cross-domain guards decide.
HOUR = datetime.timedelta(hours=1)
NOW_BY_BATCH = [NOW - HOUR, NOW - HOUR, NOW, NOW, NOW - HOUR, NOW - HOUR]


def _templates():
    def tpl(cn, slen, key="ec", **delta):
        return syncerts.make_template(
            issuer_cn=cn, not_after=NOW + datetime.timedelta(**delta),
            serial_len=slen, key_type=key, rich_extensions=True,
            crl_dp=f"http://crl.{cn[:8].replace(' ', '').lower()}.example/x.crl")

    t = [tpl("Issuer A", 8, days=400), tpl("Issuer B", 12, "rsa2048", days=700),
         tpl("Issuer C", 16, days=900), tpl("Issuer D", 20, "rsa2048", days=300),
         tpl(LONG_CN, 10, days=500),  # undecidable CN prefix: host lane
         tpl("Issuer A", 9, days=-30),  # expired
         tpl("Issuer C", 11, minutes=30)]  # boundary hour: host lane
    ca = der.parse_cert(t[1].issuer_der)  # a CA certificate as a leaf
    t.append(syncerts.CertTemplate(leaf_der=t[1].issuer_der,
                                   issuer_der=t[1].issuer_der,
                                   serial_off=ca.serial_off,
                                   serial_len=ca.serial_len))
    return t


def _batches(templates):
    rng = np.random.default_rng(5)
    w = np.array([30, 20, 15, 10, 5, 4, 15, 3], float)
    w /= w.sum()
    pool, counter, out = [], 1, []
    for _ in range(N_BATCHES):
        tof = rng.choice(len(templates), size=N, p=w)
        entries = []
        for i in range(N):
            if pool and rng.random() < 0.4:  # replay an earlier serial
                tof[i], c = pool[rng.integers(len(pool))]
            else:
                c, counter = counter, counter + 1
                pool.append((tof[i], c))
            entries.append(
                (syncerts.stamp_serial(templates[tof[i]], int(c)), 0))
        packed = packing.pack_entries(entries, pad_len=PAD)
        valid = packed.valid.copy()
        valid[-2:] = False
        out.append((packed.data, packed.length, tof, valid))
    return out


def _result(res):
    return (res.was_unknown.copy(), res.filtered.copy(), res.exp_hours.copy(),
            list(res.serials), res.host_lane_count)


def _snapshot(snap):
    return snap.counts, snap.crls, snap.dns, snap.total


def _ingest(agg, leafpack, batch, idx_of, now=None):
    if now is not None:
        agg._fixed_now = now
    data, length, tof, valid = batch
    sc = leafpack.extract_sidecars(data, length)
    return agg.ingest_preparsed(sc, idx_of[tof], valid, data, length)


def _ingest_walker(agg, batch, idx_of, now=None):
    if now is not None:
        agg._fixed_now = now
    data, length, tof, valid = batch
    return agg.ingest_packed(data, length, idx_of[tof], valid)


def _carry(agg):
    return dict(
        rows=np.asarray(agg.table.rows).copy(),
        count=int(np.asarray(agg.table.count)),
        registry=agg.registry.to_json(),
        host=copy.deepcopy({k: getattr(agg, k) for k in (
            "host_serials", "crl_sets", "dn_sets", "_crl_raw_seen",
            "_dn_raw_seen", "metrics", "issuer_totals",
            "_table_fill", "_device_written")}))


def _from_carried(c):
    agg = TorchAggregator(device="cpu", **AGG_KW)
    agg.table = convert.table_from_numpy(c["rows"], c["count"], device="cpu")
    agg.capacity = agg.table.capacity
    agg.registry = convert.registry_from_json(c["registry"])
    for k, v in copy.deepcopy(c["host"]).items():
        setattr(agg, k, v)
    return agg


@pytest.fixture(scope="module")
def corpus():
    templates = _templates()
    return templates, _batches(templates)


@pytest.fixture(scope="module")
def jax_run(corpus):
    """The JAX reference, run once: per-batch results, rows and
    metrics, the state after CARRY_AFTER batches, the final drain."""
    templates, batches = corpus
    agg = TpuAggregator(**AGG_KW)
    idx_of = np.array([agg.registry.get_or_assign(t.issuer_der)
                       for t in templates], np.int32)
    steps, carried = [], None
    for i, batch in enumerate(batches):
        if i == CARRY_AFTER:
            carried = _carry(agg)
        res = _ingest(agg, jleafpack, batch, idx_of, NOW_BY_BATCH[i])
        steps.append(dict(res=_result(res), rows=np.asarray(agg.table.rows).copy(),
                          metrics=dict(agg.metrics), capacity=agg.capacity))
    return dict(idx_of=idx_of, steps=steps, carried=carried,
                snapshot=_snapshot(agg.drain()),
                totals=agg.issuer_totals.copy())


@pytest.fixture(scope="module")
def jax_walker_run(corpus):
    """The JAX reference's walker lane, run once over the same batches."""
    templates, batches = corpus
    agg = TpuAggregator(**AGG_KW)
    idx_of = np.array([agg.registry.get_or_assign(t.issuer_der)
                       for t in templates], np.int32)
    steps, carried = [], None
    for i, batch in enumerate(batches):
        if i == CARRY_AFTER:
            carried = _carry(agg)
        res = _ingest_walker(agg, batch, idx_of, NOW_BY_BATCH[i])
        steps.append(dict(res=_result(res), rows=np.asarray(agg.table.rows).copy(),
                          metrics=dict(agg.metrics), capacity=agg.capacity))
    return dict(idx_of=idx_of, steps=steps, carried=carried,
                snapshot=_snapshot(agg.drain()),
                totals=agg.issuer_totals.copy())


def _check_batch(agg, res, want):
    got = _result(res)
    for g, w in zip(got[:3], want["res"][:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3:] == want["res"][3:]
    np.testing.assert_array_equal(buckettable.host_rows(agg.table), want["rows"])
    assert agg.metrics == want["metrics"]
    assert agg.capacity == want["capacity"]


def test_slice_matches_jax_batch_by_batch(corpus, jax_run):
    templates, batches = corpus
    agg = TorchAggregator(device="cpu", **AGG_KW)
    idx_of = np.array([agg.registry.get_or_assign(t.issuer_der)
                       for t in templates], np.int32)
    np.testing.assert_array_equal(idx_of, jax_run["idx_of"])
    for i, (batch, want) in enumerate(zip(batches, jax_run["steps"])):
        _check_batch(agg, _ingest(agg, tleafpack, batch, idx_of,
                                  NOW_BY_BATCH[i]), want)
    assert _snapshot(agg.drain()) == jax_run["snapshot"]
    np.testing.assert_array_equal(agg.issuer_totals, jax_run["totals"])
    # The corpus reached every path it is meant to.
    m = agg.metrics
    assert agg.capacity > AGG_KW["capacity"]
    assert m["overflow"] > 0 and m["host_lane"] > m["overflow"]
    assert m["filtered_ca"] and m["filtered_expired"] and m["filtered_cn"]
    assert agg.host_serials and m["known"] > 0


def test_slice_continues_from_carried_jax_state(corpus, jax_run):
    """State taken out of the JAX aggregator through convert.py continues
    in the port exactly as it does in JAX."""
    templates, batches = corpus
    c = jax_run["carried"]
    agg = _from_carried(c)
    assert convert.registry_to_json(agg.registry) == c["registry"]
    rows, count = convert.table_to_numpy(agg.table)
    np.testing.assert_array_equal(rows, c["rows"])
    assert count == c["count"]
    idx_of = np.array([agg.registry.get_or_assign(t.issuer_der)
                       for t in templates], np.int32)
    np.testing.assert_array_equal(idx_of, jax_run["idx_of"])
    for i in range(CARRY_AFTER, N_BATCHES):
        _check_batch(agg, _ingest(agg, tleafpack, batches[i], idx_of,
                                  NOW_BY_BATCH[i]), jax_run["steps"][i])
    assert _snapshot(agg.drain()) == jax_run["snapshot"]


def test_walker_lane_matches_jax_batch_by_batch(corpus, jax_walker_run):
    templates, batches = corpus
    agg = TorchAggregator(device="cpu", **AGG_KW)
    idx_of = np.array([agg.registry.get_or_assign(t.issuer_der)
                       for t in templates], np.int32)
    np.testing.assert_array_equal(idx_of, jax_walker_run["idx_of"])
    for i, (batch, want) in enumerate(zip(batches, jax_walker_run["steps"])):
        _check_batch(agg, _ingest_walker(agg, batch, idx_of, NOW_BY_BATCH[i]),
                     want)
    assert _snapshot(agg.drain()) == jax_walker_run["snapshot"]
    np.testing.assert_array_equal(agg.issuer_totals, jax_walker_run["totals"])
    m = agg.metrics
    assert agg.capacity > AGG_KW["capacity"]
    assert m["overflow"] > 0 and m["host_lane"] > m["overflow"]
    assert m["filtered_ca"] and m["filtered_expired"] and m["filtered_cn"]
    assert agg.host_serials and m["known"] > 0


def test_walker_lane_continues_from_carried_jax_state(corpus, jax_walker_run):
    templates, batches = corpus
    agg = _from_carried(jax_walker_run["carried"])
    idx_of = np.array([agg.registry.get_or_assign(t.issuer_der)
                       for t in templates], np.int32)
    for i in range(CARRY_AFTER, N_BATCHES):
        _check_batch(agg, _ingest_walker(agg, batches[i], idx_of,
                                         NOW_BY_BATCH[i]),
                     jax_walker_run["steps"][i])
    assert _snapshot(agg.drain()) == jax_walker_run["snapshot"]


def test_walker_drain_equals_preparsed_drain(corpus, jax_run, jax_walker_run):
    """The two lanes of the port, on the same batches, drain the same
    (and as the two lanes of the JAX package do)."""
    templates, batches = corpus
    snaps = []
    for walker in (True, False):
        agg = TorchAggregator(device="cpu", **AGG_KW)
        idx_of = np.array([agg.registry.get_or_assign(t.issuer_der)
                           for t in templates], np.int32)
        for i, batch in enumerate(batches):
            if walker:
                _ingest_walker(agg, batch, idx_of, NOW_BY_BATCH[i])
            else:
                _ingest(agg, tleafpack, batch, idx_of, NOW_BY_BATCH[i])
        snaps.append(_snapshot(agg.drain()))
    assert snaps[0] == snaps[1] == jax_run["snapshot"] == jax_walker_run["snapshot"]


def test_walker_lane_matches_jax_on_every_corpus(corpus):
    """The walker lane, without a CN filter, over the walker tests'
    corpora (syncerts, certgen, grammar mutants, the recorded shard,
    crafted rows, byte-flip mutants), whose rejected lanes take the
    exact host lane: per-lane results, rows, metrics and the drain as
    JAX's."""
    from test_torch_der_kernel import corpus_rows

    templates, _ = corpus
    data, length = corpus_rows(PAD)
    n = data.shape[0]
    issuer = np.arange(n) % 4
    valid = np.ones((n,), bool)
    valid[::97] = False
    kw = dict(AGG_KW, cn_prefixes=())  # no CN filter: the RDN scan is off
    out = []
    for agg in (TpuAggregator(**kw), TorchAggregator(device="cpu", **kw)):
        idx_of = np.array([agg.registry.get_or_assign(t.issuer_der)
                           for t in templates], np.int32)
        agg._fixed_now = NOW
        res = agg.ingest_packed(data, length, idx_of[issuer], valid)
        out.append((_result(res), np.asarray(agg.table.rows).copy(),
                    dict(agg.metrics), _snapshot(agg.drain())))
    (jres, jrows, jm, jsnap), (tres, trows, tm, tsnap) = out
    for g, w in zip(tres[:3], jres[:3]):
        np.testing.assert_array_equal(g, w)
    assert tres[3:] == jres[3:]
    np.testing.assert_array_equal(trows.view(np.uint32), jrows)
    assert (tm, tsnap) == (jm, jsnap)
    assert tm["host_lane"] > 100 and tm["parse_errors"] > 0 and tm["inserted"] > 100


def test_ingest_entries_matches_jax(corpus):
    """``ingest`` of (leaf, issuer) pairs: chunked to the batch size,
    replays, and a leaf past the largest length bucket (host lane)."""
    from ct_mapreduce_tpu_torch.utils import minicert

    templates, _ = corpus
    big = minicert.make_cert(serial=77, issuer_cn="Issuer B",
                             extra_ext_bytes=packing.LENGTH_BUCKETS[-1])
    rng = np.random.default_rng(8)
    entries = []
    for i in range(50):
        t = templates[[1, 0, 2, 3, 1][i % 5]]  # an RSA leaf in every chunk
        entries.append((syncerts.stamp_serial(t, int(rng.integers(1, 30))),
                        t.issuer_der))
    entries.insert(17, (big, templates[1].issuer_der))
    out = []
    for agg in (TpuAggregator(**AGG_KW), TorchAggregator(device="cpu", **AGG_KW)):
        agg._fixed_now = NOW - HOUR
        res = agg.ingest(entries)
        out.append((_result(res), res.issuer_idx.copy(), dict(agg.metrics),
                    _snapshot(agg.drain())))
    (jres, jidx, jm, jsnap), (tres, tidx, tm, tsnap) = out
    for g, w in zip(tres[:3], jres[:3]):
        np.testing.assert_array_equal(g, w)
    assert tres[3:] == jres[3:]
    np.testing.assert_array_equal(tidx, jidx)
    assert (tm, tsnap) == (jm, jsnap)
    assert tres[4] >= 1 and tres[3][17] is not None  # the oversized leaf


def test_overflow_spill_past_flag_cap_matches_jax(corpus):
    """A tiny table, growth off, one hop: most lanes overflow, past the
    compacted flag capacity, so the fold reads the full overflow bitmask
    (the ``flag_cap_spill`` counter) and the host lane takes the lanes."""
    from ct_mapreduce_tpu.telemetry import metrics as jmetrics
    from ct_mapreduce_tpu_torch.telemetry import metrics as tmetrics

    templates, _ = corpus
    n = 512
    entries = [(syncerts.stamp_serial(templates[i % 4], 50_000 + i), 0)
               for i in range(n)]
    pb = packing.pack_entries(entries, pad_len=PAD)
    kw = dict(capacity=32, batch_size=n, now=NOW, max_probes=1, grow_at=0,
              max_capacity=32)
    out = []
    for agg_cls, leafpack, metrics, extra in (
            (TpuAggregator, jleafpack, jmetrics, {}),
            (TorchAggregator, tleafpack, tmetrics, {"device": "cpu"})):
        agg = agg_cls(**kw, **extra)
        idx_of = np.array([agg.registry.get_or_assign(t.issuer_der)
                           for t in templates], np.int32)
        sink, prev = metrics.InMemSink(), metrics.get_sink()
        metrics.set_sink(sink)
        try:
            res = _ingest(agg, leafpack, (pb.data, pb.length,
                                          np.arange(n) % 4, pb.valid), idx_of)
        finally:
            metrics.set_sink(prev)
        counters = sink.snapshot()["counters"]
        out.append((_result(res), dict(agg.metrics),
                    _snapshot(agg.drain()),
                    {k: counters.get(k) for k in (
                        "ingest.flag_cap_spill", "ingest.d2h_flag_bytes",
                        "ingest.d2h_readback_bytes")}))
    (jres, jm, jsnap, jc), (tres, tm, tsnap, tc) = out
    for g, w in zip(tres[:3], jres[:3]):
        np.testing.assert_array_equal(g, w)
    assert tres[3:] == jres[3:]
    assert (tm, tsnap, tc) == (jm, jsnap, jc)
    assert tm["overflow"] > 64 and tc["ingest.flag_cap_spill"] == 1


def test_sidecars_match_jax_native(corpus):
    """The copied C++ walker against the JAX package's, on the corpus
    and on byte-flipped copies of it (which the walker must reject or
    parse exactly the same way)."""
    _templates, batches = corpus
    data = np.concatenate([b[0] for b in batches])
    length = np.concatenate([b[1] for b in batches])
    rng = np.random.default_rng(77)
    mutated = np.repeat(data, 4, axis=0)
    rows = np.arange(mutated.shape[0])
    for _ in range(3):
        mutated[rows, rng.integers(0, 400, rows.size)] ^= rng.integers(
            1, 256, rows.size).astype(np.uint8)
    data = np.concatenate([data, mutated])
    length = np.concatenate([length, np.repeat(length, 4)])
    want = jleafpack.extract_sidecars(data, length)
    assert 0 < want.ok.sum() < len(want.ok)
    got = tleafpack.extract_sidecars(data, length, threads=3)
    for name in want.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_table_from_numpy_validates_rows():
    with pytest.raises(ValueError, match="uint32"):
        convert.table_from_numpy(np.zeros((4, 128), np.int32), 0, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        convert.table_from_numpy(np.zeros((3, 128), np.uint32), 0, device="cpu")


def test_ingest_model_from_config(tmp_path, corpus):
    ini = tmp_path / "ct.ini"
    ini.write_text("batchSize = 32\ntableBits = 10\ntableGrowAt = 0.5\n"
                   "tableMaxBits = 12\nissuerCNFilter = Issuer A,Issuer B\n")
    cfg = CTConfig.load(["-config", str(ini)], env={"tableMaxBits": "13"})
    assert (cfg.batch_size, cfg.table_bits, cfg.table_grow_at,
            cfg.table_max_bits) == (32, 10, 0.5, 13)
    # The default lane is the walker lane.
    assert not cfg.preparsed_ingest
    assert not IngestModel.from_config(cfg, device="cpu").preparsed
    cfg = CTConfig.load(["-config", str(ini)],
                        env={"preparsedIngest": "true", "meshShape": "data:2",
                             "logExpiredEntries": "true"})
    # Two devices asked for, one visible on the CPU: refused as the JAX
    # package refuses it (a mesh of repeated devices is built only from
    # an explicit mesh).
    with pytest.raises(ValueError, match="mesh needs 2 devices, only 1"):
        IngestModel.from_config(cfg, device="cpu")
    cfg.mesh_shape = ""
    model = IngestModel.from_config(cfg, device="cpu")
    agg = model.aggregator
    assert agg.capacity == 64 * 24 and agg.max_capacity == 128 * 24
    assert agg.cn_prefixes == ("Issuer A", "Issuer B")
    templates, batches = corpus
    reg = model.aggregator.registry
    idx_of = np.array([reg.get_or_assign(t.issuer_der) for t in templates],
                      np.int32)
    data, length, tof, valid = batches[0]
    res = model.ingest_packed(data, length, idx_of[tof], valid)
    # A run of fresh serials from one template: all new but the replays.
    fresh, flen = syncerts.stamp_batch_array(templates[0], 10_000, N, PAD)
    res2 = model.ingest_packed(fresh, flen, np.full((N,), idx_of[0]),
                               np.ones((N,), bool))
    assert res2.was_unknown.all()
    assert res.was_unknown.sum() + N == model.drain().total
    # The walker lane through the same entry point, on the same rows.
    walker = IngestModel.from_config(
        dataclasses.replace(cfg, preparsed_ingest=False), device="cpu")
    assert not walker.preparsed
    w_idx = np.array([walker.aggregator.registry.get_or_assign(t.issuer_der)
                      for t in templates], np.int32)
    wres = walker.ingest_packed(data, length, w_idx[tof], valid)
    wres2 = walker.ingest_packed(fresh, flen, np.full((N,), w_idx[0]),
                                 np.ones((N,), bool))
    np.testing.assert_array_equal(wres.was_unknown, res.was_unknown)
    np.testing.assert_array_equal(wres2.was_unknown, res2.was_unknown)
    assert walker.drain() == model.drain()
    entries = [(syncerts.stamp_serial(templates[0], 10_000 + i),
                templates[0].issuer_der) for i in range(3)]
    assert walker.ingest(entries).was_unknown.sum() == 0  # seen above


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import ct_mapreduce_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for m in ('ops.der_kernel', 'ops.der_kernel_cuda', 'ops.cuda_build',"
        " 'tools.mosaic_probe', 'utils.dercases', 'agg.ckpt', 'agg.merge',"
        " 'config.profile', 'ingest.leaf', 'ingest.sync',"
        " 'telemetry.trace', 'cmd.ct_fetch', 'cmd.storage_statistics',"
        " 'engine', 'storage.interfaces', 'storage.certdb',"
        " 'storage.localdisk', 'storage.mockcache', 'storage.knowncerts',"
        " 'storage.issuermetadata', 'storage.noop', 'storage.rediscache',"
        " 'ingest.ctclient', 'ingest.health', 'ingest.overlap',"
        " 'telemetry.flight', 'telemetry.metrics', 'utils.fakelog',"
        " 'utils.backoff', 'utils.durations', 'parallel.mesh',"
        " 'ops.hashtable', 'serve', 'serve.snapshot', 'serve.server',"
        " 'serve.batcher', 'serve.cache', 'serve.client', 'cmd.ct_query',"
        " 'cmd.ct_getcert', 'filter', 'filter.cascade', 'filter.stream',"
        " 'filter.cache', 'filter.spill', 'filter.fused', 'filter.artifact',"
        " 'ops.bloom', 'ops.bloom_cuda', 'cmd.ct_filter', 'ops.bigint',"
        " 'ops.ecdsa', 'ops.ecdsa_cuda', 'verify', 'verify.host',"
        " 'verify.sct', 'verify.lane', 'distrib', 'distrib.delta',"
        " 'distrib.container', 'distrib.publish', 'audit', 'audit.loglist',"
        " 'audit.quarantine', 'audit.driver', 'audit.fixture',"
        " 'core.divergence', 'tools.audit'):\n"
        "    assert p.__name__ + '.' + m in sys.modules, m\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and ("
        "m == 'ct_mapreduce_tpu' or m.startswith('ct_mapreduce_tpu.') "
        "or m.startswith('jax'))]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 75


def test_open_layout_checkpoint_matches_jax(tmp_path, monkeypatch, corpus):
    """``CTMR_TABLE=open``: one batch of one certificate, then
    ``save_checkpoint``. The port builds the open-addressing table (it
    used to build the bucket table and write ``layout="bucket"``), and
    its drain and every checkpoint array equal the JAX package's."""
    monkeypatch.setenv("CTMR_TABLE", "open")
    templates, _ = corpus
    entries = [(syncerts.stamp_serial(templates[0], 7), templates[0].issuer_der)]
    kw = dict(capacity=1 << 10, batch_size=64, now=NOW)
    j = TpuAggregator(**kw)
    t = TorchAggregator(device="cpu", **kw)
    paths = {}
    for name, agg in (("jax", j), ("port", t)):
        agg.configure_checkpointing(mode="ck01")
        assert agg.ingest(entries).was_unknown.all()
        paths[name] = str(tmp_path / f"{name}.npz")
        agg.save_checkpoint(paths[name])
    assert _snapshot(t.drain()) == _snapshot(j.drain())
    with np.load(paths["port"], allow_pickle=True) as zt, \
            np.load(paths["jax"], allow_pickle=True) as zj:
        assert str(zt["layout"]) == "open"
        assert zt["keys"].shape == (1 << 10, 4)
        assert sorted(zt.files) == sorted(zj.files)
        for name in zj.files:
            np.testing.assert_array_equal(zt[name], zj[name], err_msg=name)
