"""The port's ingest sink (``ingest/sync.py::AggregatorSink``) against the
JAX package's, on the CPU.

The same raw get-entries pages (the ``leaf_input``/``extra_data``
base64 of ``tests/fakelog.py``) go through the JAX
``AggregatorSink(TpuAggregator)`` and the port's
``AggregatorSink(TorchAggregator(device="cpu"))``: two issuers with
CRL distribution points, replays within and across pages, a CA leaf,
an expired leaf, a serial too long for the device (the exact host
lane), a leaf too wide for the rows (the per-entry lane), an
undecodable entry, an entry with no chain and pages of wider leaves (a
row-width change). Drains,
aggregator metrics, issuer totals, the table fill and the sink's
counters must be equal in every configuration: depth 0 and 2, a table
that grows mid-stream, the oversized leaf, staged K = 3 (a 1024-byte
envelope between 512-byte ones, a partial ring at ``flush()``),
pre-parsed, and the per-entry ``store()`` path. Staged equals
unstaged, also where the ring flushes inside a chunk sequence, and the
reference ``storage-statistics`` report prints the same text for the
port's checkpoint as for the JAX one.

The cases share chunk shapes (32 lanes; 512- and 1024-byte rows; one
table size but in the grow case), so the JAX side compiles each program
once for the file. Tolerance: exact equality.
"""

import base64
import datetime
import io

import numpy as np
import pytest

from ct_mapreduce_tpu.agg.aggregator import TpuAggregator
from ct_mapreduce_tpu.ingest import sync as jsync
from ct_mapreduce_tpu.telemetry import metrics as jmetrics
from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
from ct_mapreduce_tpu_torch.ingest import leaf as leaflib
from ct_mapreduce_tpu_torch.ingest import sync as tsync
from ct_mapreduce_tpu_torch.telemetry import metrics as tmetrics
from ct_mapreduce_tpu_torch.utils import minicert

UTC = datetime.timezone.utc
NOW = datetime.datetime(2025, 1, 1, tzinfo=UTC)
FLUSH = 32  # lanes a chunk; the pages hold 32 entries each
CAP = 1 << 9  # 32 buckets: the table the grow case grows into
GROW_CAP = 1 << 7  # 8 buckets, grown twice mid-stream
ISSUERS = [minicert.make_cert(serial=1, issuer_cn=f"Sink CA {k}", is_ca=True)
           for k in range(2)]
COUNTERS = ("ct-fetch.insertCertificate", "ct-fetch.parseLeafError",
            "ct-fetch.noChainError")


def _wire(leaf: bytes, issuer, k: int) -> tuple[str, str]:
    li = base64.b64encode(leaflib.encode_leaf_input(leaf, 1000 + k)).decode()
    chain = [issuer] if issuer is not None else []
    ed = base64.b64encode(leaflib.encode_extra_data(chain)).decode()
    return li, ed


def _pages(wide=(3, 4, 5), too_wide=None):
    """8 pages of 32 entries. ``wide`` pages carry leaves that need
    1024-byte rows; ``too_wide`` = (page, lane) puts a leaf wider than
    the rows there (the exact host lane)."""
    pages = []
    serial = 100
    for p in range(8):
        lis, eds = [], []
        for j in range(FLUSH):
            k = j % 2
            kw = dict(issuer_cn=f"Sink CA {k}", subject_cn="sink.example",
                      crl_dps=(f"http://crl{k}.example/ca.crl",))
            if p in wide:
                kw["extra_ext_bytes"] = 300
            if j == 7 and p > 0:  # a replay of the previous page
                s = serial - FLUSH
            else:
                s, serial = serial, serial + 1
            if p == 1 and j == 3:
                leaf = minicert.make_cert(serial=s, is_ca=True, **kw)
            elif p == 2 and j == 4:
                leaf = minicert.make_cert(
                    serial=s, not_after=NOW - datetime.timedelta(days=2), **kw)
            elif p == 3 and j == 5:
                leaf = minicert.make_cert(serial=s | (1 << 400),
                                          serial_len=None, **kw)
            elif (p, j) == too_wide:
                kw["extra_ext_bytes"] = 1200
                leaf = minicert.make_cert(serial=s, **kw)
            else:
                leaf = minicert.make_cert(serial=s, **kw)
            issuer = None if (p == 6 and j == 8) else ISSUERS[k]
            li, ed = _wire(leaf, issuer, j)
            if p == 7 and j == 9:
                li = base64.b64encode(b"\x00\x01garbage").decode()
            lis.append(li)
            eds.append(ed)
        pages.append((lis, eds))
    return pages


PAGES = _pages()
# An oversized leaf and two width changes in the middle of a ring.
PAGES_FLUSHING = _pages(wide=(2, 5), too_wide=(4, 6))


def _run(pkg: str, pages=PAGES, per_entry: bool = False, cap: int = CAP,
         **kw) -> dict:
    sync, metrics = (jsync, jmetrics) if pkg == "jax" else (tsync, tmetrics)
    if pkg == "jax":
        agg = TpuAggregator(capacity=cap, batch_size=FLUSH, now=NOW)
    else:
        agg = TorchAggregator(capacity=cap, batch_size=FLUSH, now=NOW,
                              device="cpu")
    sink = sync.AggregatorSink(agg, flush_size=FLUSH, **kw)
    sink.PAD_LEN = 1024  # narrow rows (512) for the minicert leaves
    metrics.get_sink().reset()
    for n, (lis, eds) in enumerate(pages):
        if per_entry:
            for i, (li, ed) in enumerate(zip(lis, eds)):
                try:
                    e = leaflib.decode_entry(i, base64.b64decode(li),
                                             base64.b64decode(ed))
                except leaflib.LeafDecodeError:
                    continue
                sink.store(e, "log")
        else:
            sink.store_raw_batch(sync.RawBatch(lis, eds, n * FLUSH, "log"))
    sink.close()
    snap = agg.drain()
    counters = metrics.get_sink().snapshot()["counters"]
    return {
        "counts": snap.counts, "crls": snap.crls, "dns": snap.dns,
        "total": snap.total, "metrics": dict(agg.metrics),
        "issuer_totals": agg.issuer_totals.tolist(),
        "fill": int(agg._table_fill), "capacity": agg.capacity,
        "counters": {k: counters.get(k, 0.0) for k in COUNTERS},
    }


CASES = {
    "depth0": dict(device_queue_depth=0),
    "depth2": dict(device_queue_depth=2),
    "grow": dict(device_queue_depth=2, cap=GROW_CAP),
    "oversized": dict(device_queue_depth=2, pages=PAGES_FLUSHING),
    "staged": dict(chunks_per_dispatch=3, staging_depth=2),
    "preparsed": dict(preparsed=True, device_queue_depth=2),
    "store": dict(device_queue_depth=2, per_entry=True),
}


@pytest.fixture(scope="module")
def port_runs():
    return {}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sink_matches_jax(case, port_runs):
    kw = CASES[case]
    want = _run("jax", **kw)
    got = _run("port", **kw)
    port_runs[case] = got
    assert got == want
    # The pages reach every route the cases are meant to cover.
    m = got["metrics"]
    assert m["filtered_ca"] and m["filtered_expired"] and m["host_lane"]
    assert m["known"] > 0 and got["total"] > 200
    assert got["capacity"] > 192 * 2 ** (case == "grow")
    if case != "store":
        # 256 entries less the undecodable one and the chainless one.
        assert got["counters"]["ct-fetch.insertCertificate"] == 254
        assert got["counters"]["ct-fetch.parseLeafError"] == 1
        assert got["counters"]["ct-fetch.noChainError"] == 1


def test_staged_equals_unstaged(port_runs):
    runs = {c: port_runs.get(c) or _run("port", **CASES[c])
            for c in ("depth2", "staged")}
    keys = ("counts", "crls", "dns", "total", "issuer_totals", "fill")
    assert ({k: runs["staged"][k] for k in keys}
            == {k: runs["depth2"][k] for k in keys})


def test_staged_ring_flushes_keep_every_chunk(monkeypatch, port_runs):
    """K = 3 over pages whose row width changes inside a ring and one of
    whose chunks carries a leaf wider than the rows: the ring flushes at
    each width change, around the oversized chunk and at ``flush()``,
    and the drain equals the unstaged drain of both packages. (The JAX
    staged sink drops the chunk after such a flush; see ROADMAP.md
    queue 3.)"""
    sizes = []
    real = TorchAggregator.ingest_staged_submit

    def spy(self, data, length, issuer_idx, valid, host_chunks):
        sizes.append((len(host_chunks), data.shape[-1]))
        return real(self, data, length, issuer_idx, valid, host_chunks)

    monkeypatch.setattr(TorchAggregator, "ingest_staged_submit", spy)
    got = _run("port", pages=PAGES_FLUSHING, chunks_per_dispatch=3,
               staging_depth=2)
    assert sum(k for k, _ in sizes) == 8 and len(sizes) >= 5
    assert {w for _, w in sizes} == {512, 1024}
    want = port_runs.get("oversized") or _run("jax", **CASES["oversized"])
    keys = ("counts", "crls", "dns", "total", "issuer_totals", "fill",
            "counters")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


# Pages of other sizes than the flush size (whole chunks then run past
# it by up to a page) with a flush() every third page, as ct-fetch's
# cursor saves do.
VARIED_SIZES = (5, 32, 17, 30, 3, 29, 11)


def _varied_pages(pages=PAGES):
    lis = [li for p in pages for li in p[0]]
    eds = [ed for p in pages for ed in p[1]]
    out, at, k = [], 0, 0
    while at < len(lis):
        n = VARIED_SIZES[k % len(VARIED_SIZES)]
        out.append((lis[at:at + n], eds[at:at + n]))
        at, k = at + n, k + 1
    return out


@pytest.mark.parametrize("kw", [
    dict(device_queue_depth=0), dict(device_queue_depth=2),
    dict(chunks_per_dispatch=3, staging_depth=2)],
    ids=["depth0", "depth2", "staged"])
def test_row_buffers_stay_bounded(kw, port_runs):
    """Chunks of varying length and width, partial chunks and partial
    rings at flush(): the sink's row buffers never outnumber the chunks
    or envelopes in use at once, and a second pass of the same pages
    allocates none. The drain equals the whole-page run's."""
    agg = TorchAggregator(capacity=CAP, batch_size=FLUSH, now=NOW,
                          device="cpu")
    sink = tsync.AggregatorSink(agg, flush_size=FLUSH, **kw)
    sink.PAD_LEN = 1024
    keep = (sink.staging_depth if sink.chunks_per_dispatch > 1
            else sink.device_queue_depth)
    pool = sink._row_bufs
    allocated = []
    for _ in range(2):
        for n, (lis, eds) in enumerate(_varied_pages()):
            sink.store_raw_batch(tsync.RawBatch(lis, eds, n, "log"))
            assert pool.live <= keep + 1
            if n % 3 == 2:
                sink.flush()
        sink.close()
        assert pool.live <= keep + 1
        allocated.append(pool.allocated)
    assert allocated[1] == allocated[0] <= keep + 1
    snap = agg.drain()
    want = port_runs.get("depth2") or _run("port", **CASES["depth2"])
    assert ((snap.counts, snap.crls, snap.dns, snap.total, agg._table_fill)
            == (want["counts"], want["crls"], want["dns"], want["total"],
                want["fill"]))


def test_pool_grows_and_retires():
    """A request above the capacity doubles it; the smaller buffers are
    dropped as they come back, so ``live`` counts only buffers of the
    current capacity."""
    pool = tsync._PinnedPool(pin=False)
    a, b = pool.take(100), pool.take(50)
    assert (pool.capacity, pool.live, pool.allocated) == (128, 2, 2)
    pool.give(a)
    c = pool.take(128)
    assert c is a and pool.allocated == 2
    d = pool.take(129)
    assert (pool.capacity, d.numel(), pool.live) == (256, 256, 3)
    pool.give(b)
    pool.give(c)
    assert pool.live == 1 and pool.take(10) is not b
    assert pool.allocated == 4
    assert tsync._rows_of(d, (3, 5)).shape == (3, 5)


def test_narrow_in_place_keeps_every_row():
    """A wide chunk narrowed in its own buffer equals the narrow view."""
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 3, 7, 64, 1000):
        for narrow in (48, 32):
            data = rng.integers(0, 256, (n, 96), dtype=np.uint8)
            want = data[:, :narrow].copy()
            got = tsync._narrow_in_place(data, narrow)
            assert got.flags.c_contiguous
            assert n == 0 or np.shares_memory(got, data)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ini", [
    "batchSize = 32\ntableBits = 9\ndeviceQueueDepth = 3\n"
    "decodeWorkers = 2\ndecodeThreads = 1\nchunksPerDispatch = 4\n"
    "stagingDepth = 3\n",
    "batchSize = 64\ntableBits = 8\ndeviceQueueDepth = 0\n"
    "preparsedIngest = true\n"], ids=["staged", "preparsed"])
def test_build_sink_reads_the_config(tmp_path, monkeypatch, ini):
    """The port's ``build_sink`` sets every sink directive as ct-fetch's
    does from the same ini."""
    from ct_mapreduce_tpu.cmd.ct_fetch import build_sink as jbuild
    from ct_mapreduce_tpu.config import CTConfig as JConfig
    from ct_mapreduce_tpu_torch.config import CTConfig

    for env in ("CTMR_PREPARSED", "CTMR_CHUNKS_PER_DISPATCH",
                "CTMR_STAGING_DEPTH"):
        monkeypatch.delenv(env, raising=False)
    path = tmp_path / "ct.ini"
    path.write_text(ini + "backend = tpu\n")
    argv = ["-config", str(path)]
    jsink, jmodel = jbuild(JConfig.load(argv, env={}), None)
    sink, model = tsync.build_sink(CTConfig.load(argv, env={}),
                                   device="cpu")
    keys = ("flush_size", "device_queue_depth", "decode_workers",
            "decode_threads", "preparsed", "chunks_per_dispatch",
            "staging_depth")
    assert ({k: getattr(sink, k) for k in keys}
            == {k: getattr(jsink, k) for k in keys})
    assert sink.aggregator is model.aggregator
    assert model.aggregator.capacity == jmodel.aggregator.capacity


def test_unported_options_raise():
    """Every sink option builds: the verify lane (its verifier on the
    aggregator's device, the JAX sink's knobs), the overlap pipeline and
    the PEM backend."""
    from ct_mapreduce_tpu_torch.verify.lane import SignatureVerifier

    agg = TorchAggregator(capacity=CAP, device="cpu")
    vsink = tsync.AggregatorSink(agg, verify_signatures=True,
                                 verify_precomp_window=0,
                                 verify_qtable_size=3)
    assert isinstance(vsink.verifier, SignatureVerifier)
    assert vsink.verifier.device == agg.device
    assert (vsink.verifier.window, vsink.verifier.qtable_size) == (0, 3)
    sink = tsync.AggregatorSink(agg, overlap_workers=2, backend=object())
    assert sink._overlap is not None and agg.want_serials
    sink.close()


def test_report_text_of_port_checkpoint(tmp_path):
    """The reference report (``storage-statistics --backend=tpu``) prints
    the same text for the port's sink checkpoint as for the JAX one."""
    from ct_mapreduce_tpu.cmd.storage_statistics import (
        report_from_tpu_snapshot,
    )
    from ct_mapreduce_tpu.config import CTConfig as JConfig

    texts = []
    for pkg in ("jax", "port"):
        path = str(tmp_path / f"{pkg}.npz")
        if pkg == "jax":
            agg = TpuAggregator(capacity=CAP, batch_size=FLUSH, now=NOW)
        else:
            agg = TorchAggregator(capacity=CAP, batch_size=FLUSH, now=NOW,
                                  device="cpu")
        sync = jsync if pkg == "jax" else tsync
        sink = sync.AggregatorSink(agg, flush_size=FLUSH,
                                   device_queue_depth=2)
        sink.PAD_LEN = 1024
        for n, (lis, eds) in enumerate(PAGES[:5]):
            sink.store_raw_batch(sync.RawBatch(lis, eds, n * FLUSH, "log"))
        sink.checkpointed_save(lambda: agg.save_checkpoint(path))
        out = io.StringIO()
        assert report_from_tpu_snapshot(JConfig(agg_state_path=path), out,
                                        verbosity=2) == 0
        texts.append(out.getvalue())
    assert texts[0] == texts[1] and "serials" in texts[0]
