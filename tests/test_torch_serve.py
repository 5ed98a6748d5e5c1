"""The port's query plane (``ct_mapreduce_tpu_torch/serve/``) against
the JAX package's, on the CPU.

The cases of ``tests/test_serve.py`` that need no mesh run on a port
``TorchAggregator(device="cpu")``: the micro-batcher, snapshot views
(host and device mode, host-lane serials, the pin-failure fallback),
the threaded ingest+query consistency stress through a growing table,
the HTTP API, the replica pool at mixed epochs, the hot-serial cache,
oversized-bulk splits and the staleness surface. The two sharded cases
of that file are in ``tests/test_torch_parallel.py``.

Parity: the same entries go through the JAX ``TpuAggregator`` and the
port's, in both table layouts; their captured views hold the same rows
bit for bit and answer every lookup the same, in host and in device
mode. The first two cases of ``tests/test_contains_parity.py`` run the
port's ``contains`` and ``contains_np`` of both layouts over the same
corpus, on tables whose rows equal the JAX ones. Tolerance: exact
equality.
"""

import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_mapreduce_tpu.agg.aggregator import TpuAggregator
from ct_mapreduce_tpu.ops import buckettable as jbt
from ct_mapreduce_tpu.ops import hashtable as jht
from ct_mapreduce_tpu.serve.snapshot import capture_view as jcapture_view
from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
from ct_mapreduce_tpu_torch.core import der as hostder
from ct_mapreduce_tpu_torch.core.types import ExpDate, Issuer
from ct_mapreduce_tpu_torch.ops import buckettable as tbt
from ct_mapreduce_tpu_torch.ops import hashtable as tht
from ct_mapreduce_tpu_torch.serve import snapshot as snapmod
from ct_mapreduce_tpu_torch.serve.batcher import (
    DeadlineExceeded,
    MicroBatcher,
    Overloaded,
)
from ct_mapreduce_tpu_torch.serve.cache import HotSerialCache
from ct_mapreduce_tpu_torch.serve.server import (
    MembershipOracle,
    QueryServer,
    resolve_serve,
)
from ct_mapreduce_tpu_torch.serve.snapshot import (
    ReplicaPool,
    SnapshotManager,
    capture_view,
)
from ct_mapreduce_tpu_torch.telemetry import metrics as tmetrics
from ct_mapreduce_tpu_torch.telemetry import trace
from ct_mapreduce_tpu_torch.utils import syncerts


@pytest.fixture(scope="module")
def template():
    return syncerts.make_template(issuer_cn="Serve Test CA")


def _agg(**kw):
    kw.setdefault("capacity", 1 << 12)
    kw.setdefault("batch_size", 64)
    return TorchAggregator(device="cpu", **kw)


def _entries(tpl, js):
    return [(syncerts.stamp_serial(tpl, j), tpl.issuer_der) for j in js]


def _serial_bytes(tpl, j: int) -> bytes:
    der = syncerts.stamp_serial(tpl, j)
    return der[tpl.serial_off : tpl.serial_off + tpl.serial_len]


def _identity(tpl):
    """(issuer_id, exp_hour) shared by every restamp of a template."""
    eh = hostder.parse_cert(tpl.leaf_der).not_after_unix_hour
    issuer_id = Issuer.from_spki(
        hostder.parse_cert(tpl.issuer_der).spki).id()
    return issuer_id, eh


@contextlib.contextmanager
def _sink():
    sink = tmetrics.InMemSink()
    prev = tmetrics.get_sink()
    tmetrics.set_sink(sink)
    try:
        yield sink
    finally:
        tmetrics.set_sink(prev)


# -- MicroBatcher ---------------------------------------------------------


def test_batcher_coalesces_concurrent_requests():
    sizes = []

    def oracle(items):
        sizes.append(len(items))
        time.sleep(0.02)
        return [it * 2 for it in items]

    b = MicroBatcher(oracle, max_batch=64, max_delay_s=0.005)
    try:
        results = {}

        def client(k):
            results[k] = b.submit([k])[0]

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert results == {k: 2 * k for k in range(24)}
        assert sum(sizes) == 24
        assert max(sizes) > 1, f"no coalescing happened: {sizes}"
    finally:
        b.close()


def test_batcher_respects_max_batch():
    sizes = []

    def oracle(items):
        sizes.append(len(items))
        return items

    b = MicroBatcher(oracle, max_batch=4, max_delay_s=0.05)
    try:
        outs = []
        threads = [threading.Thread(
            target=lambda k=k: outs.append(tuple(b.submit([k, k])))
        ) for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert sorted(outs) == sorted((k, k) for k in range(6))
        assert max(sizes) <= 4
    finally:
        b.close()


def test_batcher_sheds_on_full_queue_with_explicit_rejection():
    release = threading.Event()

    def oracle(items):
        release.wait(timeout=5)
        return items

    b = MicroBatcher(oracle, max_batch=8, max_delay_s=0.001,
                     max_queue_lanes=4)
    try:
        accepted, shed = [], []

        def client(k):
            try:
                accepted.append(b.submit([k])[0])
            except Overloaded:
                shed.append(k)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
            time.sleep(0.002)  # deterministic arrival order
        release.set()
        for t in threads:
            t.join(timeout=10)
        assert shed, "no request was shed despite a 4-lane cap"
        assert accepted, "every request was shed"
        assert sorted(accepted + shed) == list(range(12))
    finally:
        release.set()
        b.close()


def test_batcher_deadline_expires_queued_request():
    release = threading.Event()

    def oracle(items):
        release.wait(timeout=5)
        return items

    b = MicroBatcher(oracle, max_batch=8, max_delay_s=0.001)
    try:
        first = threading.Thread(target=lambda: b.submit([0]))
        first.start()
        time.sleep(0.02)  # the worker is now blocked inside the oracle
        threading.Timer(0.1, release.set).start()
        with pytest.raises(DeadlineExceeded):
            b.submit([1], timeout_s=0.01)
        first.join(timeout=5)
    finally:
        release.set()
        b.close()


def test_batcher_close_fails_pending_loudly():
    hold = threading.Event()

    def oracle(items):
        hold.wait(timeout=5)
        return items

    b = MicroBatcher(oracle, max_batch=2, max_delay_s=0.001)

    def client():
        with contextlib.suppress(RuntimeError):
            b.submit([1])

    t = threading.Thread(target=client)
    t.start()
    time.sleep(0.02)
    hold.set()
    b.close()
    t.join(timeout=5)
    with pytest.raises(RuntimeError):
        b.submit([2])


# -- snapshot views -------------------------------------------------------


def test_view_membership_and_staleness(template):
    agg = _agg()
    agg.ingest(_entries(template, range(40)))
    issuer_id, eh = _identity(template)
    idx = agg.registry.index_of_issuer_id(issuer_id)
    view = capture_view(agg, epoch=1)
    present = [(idx, eh, _serial_bytes(template, j)) for j in range(40)]
    absent = [(idx, eh, _serial_bytes(template, j))
              for j in range(1000, 1010)]
    got = view.lookup(present + absent)
    assert got[:40].all()
    assert not got[40:].any()
    assert view.age_s() >= 0
    odd = [(-1, eh, b"\x01"), (idx, 0, b"\x01"), (idx, eh, b"\x01" * 64)]
    assert not view.lookup(odd).any()
    # The view is PINNED: later ingest (in place on the CPU rows) must
    # not leak in.
    agg.ingest(_entries(template, [500]))
    assert not view.lookup([(idx, eh, _serial_bytes(template, 500))])[0]
    assert capture_view(agg, epoch=2).lookup(
        [(idx, eh, _serial_bytes(template, 500))])[0]


def test_view_covers_host_lane_serials(template):
    agg = _agg()
    issuer_idx = agg.registry.get_or_assign(template.issuer_der)
    agg.ingest(_entries(template, range(4)))
    fields = hostder.parse_cert(syncerts.stamp_serial(template, 99))
    agg._host_dedup(fields, issuer_idx, fields.not_after_unix_hour)
    view = capture_view(agg, epoch=1)
    _, eh = _identity(template)
    assert view.lookup([(issuer_idx, eh, _serial_bytes(template, 99))])[0]


def test_view_device_mode_parity(template):
    """device=True pins a copy on the aggregator's device and probes it
    with the layout's ``contains`` on power-of-two padded batches; the
    answers equal the host path's."""
    agg = _agg()
    agg.ingest(_entries(template, range(33)))
    issuer_id, eh = _identity(template)
    idx = agg.registry.index_of_issuer_id(issuer_id)
    items = [(idx, eh, _serial_bytes(template, j)) for j in range(50)]
    host = capture_view(agg, epoch=1, device=False).lookup(items)
    dview = capture_view(agg, epoch=1, device=True)
    dev = dview.lookup(items)
    assert np.array_equal(host, dev)
    assert host[:33].all() and not host[33:].any()
    assert dview.pinned_device == torch.device("cpu")


def test_sharded_view_refused(template):
    """What is refused of a sharded view: only pinned blocks that do not
    match its shard count. (The name dates from when every sharded view
    was refused; a sharded view is now served, and an empty 2-shard view
    answers unknown through the routed probe.)"""
    view = snapmod.TableView(1, np.zeros((4, 5), np.uint32), "open", 2, 32,
                             0, {}, np.zeros(4, np.int64), {}, {}, None, 0, 4)
    assert not view.contains_fps(np.arange(12, dtype=np.uint32).reshape(
        3, 4)).any()
    with pytest.raises(ValueError, match="1 blocks for 2 shards"):
        snapmod.TableView(1, None, "open", 2, 32, 0, {},
                          np.zeros(4, np.int64), {}, {}, None, 0, 4,
                          dev_blocks=[torch.zeros((2, 5), dtype=torch.int32)])


def test_snapshot_manager_staleness_refresh(template):
    mgr = SnapshotManager(_agg(), max_staleness_s=1000.0)
    v1 = mgr.view()
    assert mgr.view() is v1  # fresh enough → same epoch
    v2 = mgr.refresh()
    assert v2.epoch == v1.epoch + 1
    mgr.max_staleness_s = 0.0
    assert mgr.view().epoch > v2.epoch  # stale → refreshed


# -- the concurrency acceptance test --------------------------------------


@pytest.mark.parametrize("layout", ["bucket", "open"])
def test_concurrent_ingest_query_consistency(template, layout, monkeypatch):
    """A writer thread feeds batches through a growing table while
    reader threads query through a MembershipOracle with a tight
    staleness bound: a serial acked before the answering view's capture
    reads known, a serial never fed never does, and refreshes keep
    landing."""
    monkeypatch.setenv("CTMR_TABLE", layout)
    agg = _agg(capacity=1 << 10, max_capacity=1 << 14, grow_at=0.55)
    issuer_idx = agg.registry.get_or_assign(template.issuer_der)
    _, eh = _identity(template)
    oracle = MembershipOracle(agg, max_batch=256, max_delay_s=0.002,
                              max_staleness_s=0.05)
    fresh_ages: list[float] = []
    epoch_walls: dict[int, float] = {}
    acked: dict[int, float] = {}
    acked_lock = threading.Lock()
    stop = threading.Event()
    errors: list[str] = []
    n_batches, batch = 14, 64  # 896 lanes > 0.55 x 1024 ⇒ grow fires

    def writer():
        try:
            for b in range(n_batches):
                agg.ingest(_entries(template, range(b * batch,
                                                    (b + 1) * batch)))
                now = time.time()
                with acked_lock:
                    for j in range(batch):
                        acked[b * batch + j] = now
        except Exception as err:  # pragma: no cover - fails the test
            errors.append(f"writer: {err!r}")
        finally:
            stop.set()

    def reader(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set() or r.integers(2) == 0:
            with acked_lock:
                known_now = dict(acked)
            if not known_now:
                time.sleep(0.001)
                continue
            js = list(known_now)
            pick = [js[int(r.integers(len(js)))] for _ in range(4)]
            ghosts = [int(r.integers(10**6, 2 * 10**6)) for _ in range(2)]
            items = [(issuer_idx, eh, _serial_bytes(template, j))
                     for j in pick + ghosts]
            try:
                res = oracle.query_raw(items)
            except Overloaded:
                continue
            for rep in list(oracle.snapshots._replicas):
                epoch_walls[rep.epoch] = rep.created_wall
            for (known, epoch, age), j in zip(res, pick + ghosts):
                if j in known_now:
                    wall = epoch_walls.get(epoch)
                    if not known and wall is not None \
                            and known_now[j] < wall - 0.05:
                        errors.append(f"acked serial {j} invisible in "
                                      f"epoch {epoch}")
                elif known:
                    errors.append(f"false positive: ghost serial {j}")
                if not stop.is_set():
                    fresh_ages.append(age)
            if stop.is_set():
                break

    w = threading.Thread(target=writer)
    readers = [threading.Thread(target=reader, args=(s,)) for s in (1, 2)]
    w.start()
    for t in readers:
        t.start()
    w.join(timeout=60)
    for t in readers:
        t.join(timeout=30)
    deadline = time.time() + 30
    while (oracle.snapshots.stats()["snapshot_epoch"] < 3
           and time.time() < deadline):
        with contextlib.suppress(Overloaded):
            oracle.query_raw([(issuer_idx, eh, _serial_bytes(template, 0))])
        time.sleep(0.05)
    pool_stats = oracle.snapshots.stats()
    oracle.close()
    assert not errors, errors[:10]
    assert agg.capacity > 1 << 10, "table never grew; raise n_batches"
    assert fresh_ages, "no answers recorded"
    assert pool_stats["snapshot_epoch"] >= 3, pool_stats
    assert pool_stats["replicas"] >= 2, pool_stats
    final = capture_view(agg, epoch=99)
    assert final.layout == layout
    items = [(issuer_idx, eh, _serial_bytes(template, j))
             for j in range(n_batches * batch)]
    assert final.lookup(items).all()


# -- HTTP server ----------------------------------------------------------


def _post(url, payload, timeout=10):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get_error(url):
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(url, timeout=10)
    return ei.value.code, json.loads(ei.value.read())


def test_query_server_http_api(template):
    agg = _agg()
    agg.ingest(_entries(template, range(20)))
    issuer_id, eh = _identity(template)
    exp_id = ExpDate.from_unix_hour(eh).id()
    srv = QueryServer(agg, 0, host="127.0.0.1", max_delay_s=0.001).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        queries = [{"issuer": issuer_id, "expDate": exp_id,
                    "serial": _serial_bytes(template, j).hex()}
                   for j in (0, 5, 19, 777)]
        code, body = _post(f"{base}/query", {"queries": queries})
        assert code == 200
        assert [r["known"] for r in body["results"]] == [
            True, True, True, False]
        assert body["epoch"] >= 1 and body["staleness_s"] >= 0
        code, body = _post(f"{base}/query", {
            "issuer": issuer_id, "expDate": exp_id,
            "serial": _serial_bytes(template, 5).hex()})
        assert code == 200 and body["known"] is True
        code, body = _post(f"{base}/query", {
            "issuer": "nosuchissuer=", "expDate": exp_id,
            "serial": "4d00"})
        assert code == 200 and body["known"] is False
        for bad in ({"queries": []},
                    {"issuer": issuer_id, "expDate": exp_id,
                     "serial": "zz"},
                    {"issuer": issuer_id, "expDate": "June 15",
                     "serial": "4d00"}):
            req = urllib.request.Request(
                f"{base}/query", data=json.dumps(bad).encode(),
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=10)
            assert ei.value.code == 400
        from urllib.parse import quote

        with urllib.request.urlopen(
                f"{base}/issuer/{quote(issuer_id, safe='')}",
                timeout=10) as resp:
            meta = json.loads(resp.read())
        assert meta["unknown_total"] == 20
        assert meta["dns"] == 1 and meta["crls"] == 1
        assert "staleness_s" in meta
        assert _get_error(f"{base}/issuer/doesnotexist")[0] == 404
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as resp:
            h = json.loads(resp.read())
        assert h["healthy"] and h["queue_cap"] > 0
        assert h["snapshot_epoch"] >= 1
        # No filter-first tier on this server: the /filter routes answer
        # 404, as the JAX package's do.
        code, body = _get_error(f"{base}/filter")
        assert code == 404 and "not armed" in body["error"]
        assert _get_error(f"{base}/filter/manifest")[0] == 404
        # A breach of the SLO hook flips /healthz to 503.
        srv.slo_check = lambda: ["serve_p99"]
        code, body = _get_error(f"{base}/healthz")
        assert code == 503 and body["degraded"] == ["serve_p99"]
    finally:
        srv.stop()


def test_query_server_sheds_with_429(template):
    agg = _agg()
    agg.ingest(_entries(template, [0]))
    issuer_id, eh = _identity(template)
    exp_id = ExpDate.from_unix_hour(eh).id()
    srv = QueryServer(agg, 0, host="127.0.0.1", max_queue_lanes=2,
                      max_delay_s=0.001).start()
    try:
        q = {"issuer": issuer_id, "expDate": exp_id,
             "serial": _serial_bytes(template, 0).hex()}
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/query",
            data=json.dumps({"queries": [q, q, q]}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 429
        assert json.loads(ei.value.read())["error"] == "overloaded"
        code, body = _post(f"http://127.0.0.1:{srv.port}/query", q)
        assert code == 200 and body["known"] is True
    finally:
        srv.stop()


def test_query_server_getcert_proxy():
    """/getcert proxies one log entry as PEM through the server's
    transport override."""
    from urllib.parse import urlencode

    from ct_mapreduce_tpu_torch.utils import fakelog, minicert

    log = fakelog.FakeLog()
    ca = minicert.make_cert(serial=1, issuer_cn="Proxy CA", is_ca=True)
    leaf = minicert.make_cert(serial=1000, issuer_cn="Proxy CA",
                              subject_cn="proxy.example.com", is_ca=False)
    log.add_cert(leaf, ca, timestamp_ms=1700000000000)
    srv = QueryServer(_agg(capacity=1 << 10), 0, host="127.0.0.1",
                      transport=log.transport).start()
    try:
        qs = urlencode({"log": log.url, "index": 0})
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/getcert?{qs}",
                timeout=10) as resp:
            body = json.loads(resp.read())
        assert body["pem"].encode() == hostder.der_to_pem(leaf)
        qs = urlencode({"log": log.url, "index": 99})
        code, _ = _get_error(f"http://127.0.0.1:{srv.port}/getcert?{qs}")
        assert code in (404, 502)
    finally:
        srv.stop()


def test_serve_batch_spans_recorded(template):
    tracer = trace.enable()
    t0 = tracer.now_us()
    try:
        agg = _agg()
        agg.ingest(_entries(template, range(8)))
        issuer_id, eh = _identity(template)
        idx = agg.registry.index_of_issuer_id(issuer_id)
        oracle = MembershipOracle(agg, max_batch=64, max_delay_s=0.01)
        threads = [threading.Thread(
            target=lambda j=j: oracle.query_raw(
                [(idx, eh, _serial_bytes(template, j))])
        ) for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        oracle.close()
        spans = [e for e in tracer.events()
                 if e.get("ph") == "X" and e["name"] == "serve.batch"
                 and e["ts"] >= t0]
        assert spans, "no serve.batch spans recorded"
        assert sum(e["args"]["lanes"] for e in spans) == 8
        waits = [e for e in tracer.events()
                 if e.get("ph") == "X" and e["name"] == "serve.wait"
                 and e["ts"] >= t0]
        assert len(waits) == 8
    finally:
        trace.disable()


# -- replica pool ---------------------------------------------------------


@pytest.mark.parametrize("layout", ["bucket", "open"])
def test_replica_pool_mixed_epoch_parity_fuzz(template, layout, monkeypatch):
    """N replicas at MIXED epochs through table growth: on every
    replica, every serial acked before its capture reads known and
    ghosts read absent."""
    monkeypatch.setenv("CTMR_TABLE", layout)
    agg = _agg(capacity=1 << 10, max_capacity=1 << 14, grow_at=0.55)
    issuer_idx = agg.registry.get_or_assign(template.issuer_der)
    _, eh = _identity(template)
    pool = ReplicaPool(agg, n_replicas=3, max_staleness_s=1e9, device=True)
    rng = np.random.default_rng(7)
    acked = 0
    truth_at_capture: dict[int, int] = {}
    for _stage in range(6):
        agg.ingest(_entries(template, range(acked, acked + 96)))
        acked += 96
        v = pool.refresh()  # staggered: swaps exactly ONE replica
        truth_at_capture[v.epoch] = acked
    assert agg.capacity > 1 << 10, "table never grew"
    reps = list(pool._replicas)
    assert len(reps) == 3
    assert len({r.epoch for r in reps}) == 3, "epochs not mixed"
    for r in reps:
        assert r.pinned_device == torch.device("cpu")
        n_known = truth_at_capture[r.epoch]
        pick = [int(j) for j in rng.integers(0, acked, size=48)]
        ghosts = [int(j) for j in rng.integers(10**6, 2 * 10**6, size=16)]
        got = r.lookup([(issuer_idx, eh, _serial_bytes(template, j))
                        for j in pick + ghosts])
        for k, j in enumerate(pick):
            if j < n_known:
                assert got[k], f"epoch {r.epoch}: serial {j} reads absent"
        assert not got[len(pick):].any(), f"ghost hit at epoch {r.epoch}"
    served = {pool.view().epoch for _ in range(9)}
    assert served == {r.epoch for r in reps}
    assert pool.floor_epoch() == min(r.epoch for r in reps)


def test_view_device_fallback_to_host(template, monkeypatch):
    """A view that cannot pin a device copy degrades to the host mirror
    (serve.device_fallback) instead of failing the batch."""
    agg = _agg()
    agg.ingest(_entries(template, range(10)))
    issuer_id, eh = _identity(template)
    idx = agg.registry.index_of_issuer_id(issuer_id)
    with _sink() as sink:
        view = capture_view(agg, epoch=1, device=True)

        def no_device(*a, **k):
            raise RuntimeError("no device")

        monkeypatch.setattr(snapmod, "_place", no_device)
        items = [(idx, eh, _serial_bytes(template, j)) for j in range(12)]
        got = view.lookup(items)
        assert got[:10].all() and not got[10:].any()
        assert view._device is False  # latched to the host path
        assert sink.snapshot()["counters"].get(
            "serve.device_fallback", 0) >= 1
        assert view.lookup(items[:3]).all()


@pytest.mark.parametrize("fault", ["oom", "other"])
def test_view_cuda_pin_falls_back_only_when_out_of_memory(
        template, monkeypatch, fault):
    """A view whose target is a CUDA device degrades to the host mirror
    only when the card is out of memory at pin time; any other fault
    is raised (the batch fails) and no fallback is counted."""
    agg = _agg()
    agg.ingest(_entries(template, range(10)))
    issuer_id, eh = _identity(template)
    idx = agg.registry.index_of_issuer_id(issuer_id)
    err = (torch.cuda.OutOfMemoryError("out of memory") if fault == "oom"
           else RuntimeError("CUDA error: an illegal memory access"))

    def failing_place(*a, **k):
        raise err

    with _sink() as sink:
        view = capture_view(agg, epoch=1, device=True,
                            devices=[torch.device("cuda", 0)])
        monkeypatch.setattr(snapmod, "_place", failing_place)
        items = [(idx, eh, _serial_bytes(template, j)) for j in range(12)]
        def fallbacks():
            return sink.snapshot()["counters"].get("serve.device_fallback", 0)

        if fault == "oom":
            got = view.lookup(items)
            assert got[:10].all() and not got[10:].any()
            assert view._device is False
            assert fallbacks() == 1
        else:
            with pytest.raises(RuntimeError, match="illegal memory access"):
                view.lookup(items)
            assert view._device is True
            assert fallbacks() == 0


# -- hot-serial cache ------------------------------------------------------


def test_hot_serial_cache_unit():
    c = HotSerialCache(capacity=2)
    c.put(("a",), known=False, epoch=1, created_wall=0.0)
    assert c.get(("a",), floor_epoch=1).known is False
    assert c.get(("a",), floor_epoch=2) is None
    assert c.get(("a",), floor_epoch=1) is None
    c.put(("a",), True, 3, 0.0)
    c.put(("b",), True, 3, 0.0)
    c.put(("c",), True, 3, 0.0)
    assert len(c) == 2
    assert c.get(("a",), 3) is None
    c.put(("b",), False, 2, 0.0)  # an older epoch must not downgrade
    assert c.get(("b",), 2).known is True
    disabled = HotSerialCache(capacity=0)
    disabled.put(("x",), True, 1, 0.0)
    assert disabled.get(("x",), 1) is None and len(disabled) == 0


def test_oracle_cache_hit_and_epoch_invalidation(template):
    agg = _agg()
    agg.ingest(_entries(template, range(20)))
    issuer_id, eh = _identity(template)
    idx = agg.registry.index_of_issuer_id(issuer_id)
    oracle = MembershipOracle(agg, max_batch=64, max_delay_s=0.001,
                              max_staleness_s=1e9, replicas=2,
                              cache_size=128)
    try:
        present = (idx, eh, _serial_bytes(template, 3))
        ghost = (idx, eh, _serial_bytes(template, 999))
        r1 = oracle.query_raw([present, ghost])
        assert r1[0][0] is True and r1[1][0] is False
        assert len(oracle.cache) == 2
        hits0, misses0 = oracle.cache.hits, oracle.cache.misses
        r2 = oracle.query_raw([present, ghost])
        assert oracle.cache.hits == hits0 + 2
        assert oracle.cache.misses == misses0
        assert r2[0][0] is True and r2[1][0] is False
        assert r2[0][1] <= r1[0][1] + 1
        agg.ingest(_entries(template, [999]))
        for _ in range(oracle.snapshots.n_replicas):
            oracle.snapshots.refresh()
        assert oracle.query_raw([ghost])[0][0] is True
    finally:
        oracle.close()


def test_bulk_split_oversized_submit_under_ingest(template):
    agg = _agg()
    agg.ingest(_entries(template, range(40)))
    issuer_id, eh = _identity(template)
    idx = agg.registry.index_of_issuer_id(issuer_id)
    tracer = trace.enable()
    t0 = tracer.now_us()
    stop = threading.Event()
    with _sink() as sink:
        oracle = MembershipOracle(agg, max_batch=16, max_delay_s=0.001,
                                  max_staleness_s=0.05, cache_size=-1)

        def bg_ingest():
            j0 = 2000
            while not stop.is_set() and j0 < 2600:
                agg.ingest(_entries(template, range(j0, j0 + 64)))
                j0 += 64

        bg = threading.Thread(target=bg_ingest)
        bg.start()
        try:
            items = [(idx, eh, _serial_bytes(template, j)) for j in range(40)]
            items += [(idx, eh, _serial_bytes(template, j))
                      for j in range(5000, 5020)]
            for _ in range(3):
                res = oracle.query_raw(items)
                assert [r[0] for r in res] == [True] * 40 + [False] * 20
        finally:
            stop.set()
            bg.join(timeout=60)
            oracle.close()
            trace.disable()
        counters = sink.snapshot()["counters"]
    assert counters.get("serve.split_requests", 0) >= 3
    spans = [e for e in tracer.events()
             if e.get("ph") == "X" and e["name"] == "serve.batch"
             and e["ts"] >= t0]
    assert spans and all(e["args"]["lanes"] <= 16 for e in spans)


def test_refresh_in_flight_and_age_surfaced(template, monkeypatch):
    agg = _agg()
    with _sink() as sink:
        mgr = SnapshotManager(agg, max_staleness_s=1000.0)
        assert mgr.refresh_in_flight is False
        seen = {}
        orig = snapmod.capture_view

        def spying_capture(a, epoch, device=False, devices=None):
            seen["in_flight"] = mgr.refresh_in_flight
            return orig(a, epoch, device=device, devices=devices)

        monkeypatch.setattr(snapmod, "capture_view", spying_capture)
        mgr.refresh()
        monkeypatch.setattr(snapmod, "capture_view", orig)
        assert seen["in_flight"] is True
        assert mgr.refresh_in_flight is False
        st = mgr.stats()
        assert st["refresh_in_flight"] is False
        assert st["snapshot_epoch"] == 1 and st["snapshot_age_s"] >= 0
        mgr.view()
        assert "serve.snapshot_age_s" in sink.snapshot()["gauges"]
        pool = ReplicaPool(agg, n_replicas=2, max_staleness_s=1e9,
                           device=False).warm()
        pst = pool.stats()
        assert pst["refresh_in_flight"] is False
        assert pst["replicas"] == 2 and len(pst["replica_epochs"]) == 2
        assert pst["snapshot_age_s"] is not None


def test_resolve_serve_layering(monkeypatch):
    for k in ("CTMR_SERVE_REPLICAS", "CTMR_SERVE_DEVICE",
              "CTMR_SERVE_CACHE_SIZE", "CTMR_SERVE_FILTER_FIRST"):
        monkeypatch.delenv(k, raising=False)
    assert resolve_serve() == (2, True, 4096)
    assert resolve_serve(replicas=5, device=False, cache_size=64) == \
        (5, False, 64)
    assert resolve_serve(cache_size=-1)[2] == 0
    monkeypatch.setenv("CTMR_SERVE_REPLICAS", "7")
    monkeypatch.setenv("CTMR_SERVE_DEVICE", "0")
    monkeypatch.setenv("CTMR_SERVE_CACHE_SIZE", "99")
    assert resolve_serve() == (7, False, 99)
    assert resolve_serve(replicas=3, device=True, cache_size=16) == \
        (3, True, 16)
    monkeypatch.setenv("CTMR_SERVE_REPLICAS", "banana")
    assert resolve_serve()[0] == 2
    # The env arms the filter-first tier and its distribution store
    # (cold until the aggregator has a capture); the explicit flag wins.
    monkeypatch.setenv("CTMR_SERVE_FILTER_FIRST", "1")
    oracle = MembershipOracle(_agg(capacity=1 << 10))
    try:
        assert oracle.filter_first and oracle.filter_tier is None
        assert oracle.distributor is not None
        assert oracle.stats()["filter_first"] is True
    finally:
        oracle.close()
    oracle = MembershipOracle(_agg(capacity=1 << 10), filter_first=False)
    try:
        assert not oracle.filter_first and oracle.distributor is None
    finally:
        oracle.close()


# -- parity with the JAX package's views ----------------------------------


@pytest.mark.parametrize("layout", ["bucket", "open"])
def test_views_match_jax(template, layout, monkeypatch):
    """The same entries through both packages' aggregators, in one
    layout, with one serial in the exact host lane: the captured views
    hold the same rows bit for bit and answer every lookup the same, in
    host and device mode, with the same issuer metadata. (Rows after a
    grow are held equal in tests/test_torch_hashtable.py.)"""
    monkeypatch.setenv("CTMR_TABLE", layout)
    kw = dict(capacity=1 << 10, batch_size=64, max_capacity=1 << 10)
    j = TpuAggregator(**kw)
    t = TorchAggregator(device="cpu", **kw)
    other = syncerts.make_template(issuer_cn="Serve Other CA",
                                   serial_len=12, key_type="rsa2048")
    for b in range(6):
        ents = _entries(template, range(b * 64, b * 64 + 48))
        ents += _entries(other, range(b * 16, b * 16 + 16))
        j.ingest(ents)
        t.ingest(ents)
    assert t.capacity == j.capacity
    for agg, tpl in ((j, template), (t, template)):
        fields = hostder.parse_cert(syncerts.stamp_serial(tpl, 5000))
        idx = agg.registry.get_or_assign(tpl.issuer_der)
        agg._host_dedup(fields, idx, fields.not_after_unix_hour)
    jv, tv = jcapture_view(j, epoch=1), capture_view(t, epoch=1)
    assert tv.layout == jv.layout == layout
    assert np.array_equal(tv.rows, np.asarray(jv.rows))
    assert tv.table_fill == jv.table_fill
    items = []
    for tpl, top in ((template, 450), (other, 120)):
        iid, eh = _identity(tpl)
        idx = t.registry.index_of_issuer_id(iid)
        assert idx == j.registry.index_of_issuer_id(iid)
        items += [(idx, eh, _serial_bytes(tpl, k)) for k in range(0, top, 3)]
        items += [(idx, eh, _serial_bytes(tpl, 5000)), (-1, eh, b"\x01"),
                  (idx, eh + 1, _serial_bytes(tpl, 0))]
    want = jv.lookup(items)
    assert want.any() and not want.all()
    assert np.array_equal(tv.lookup(items), want)
    dj = jcapture_view(j, epoch=2, device=True).lookup(items)
    dt = capture_view(t, epoch=2, device=True).lookup(items)
    assert np.array_equal(dj, want) and np.array_equal(dt, want)
    for tpl in (template, other):
        iid, _ = _identity(tpl)
        assert tv.issuer_meta(iid) == jv.issuer_meta(iid)


# -- tests/test_contains_parity.py on the port ----------------------------


def _corpus(seed: int, n: int):
    """Random fingerprint rows split into kept / evicted / absent."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, size=(3 * n, 4), dtype=np.uint32)
    _, first = np.unique(keys.view([("", np.uint32)] * 4), return_index=True)
    keys = keys[np.sort(first)]
    n = len(keys) // 3
    return keys[:n], keys[n : 2 * n], keys[2 * n : 3 * n]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _build(mod, jmod, cap, kept, evicted, max_probes):
    """A table of each package holding exactly ``kept``: insert
    kept+evicted, then rebuild a fresh table with only kept (the
    grow-and-rehash shape). The two packages' rows must be equal."""
    meta = np.arange(len(kept) + len(evicted), dtype=np.uint32) + 1
    both = np.concatenate([kept, evicted])
    valid = np.ones((both.shape[0],), bool)
    for keys, m, v in ((both, meta, valid),
                       (kept, meta[: len(kept)], valid[: len(kept)])):
        state = mod.make_table(cap, device="cpu")
        state, wu, ovf = mod.insert(state, _t(keys), _t(m),
                                    torch.from_numpy(v),
                                    max_probes=max_probes)
        assert not ovf.any(), "corpus overflowed; raise cap"
        jstate = jmod.make_table(cap)
        jstate, jwu, _ = jmod.insert(jstate, jnp.asarray(keys),
                                     jnp.asarray(m), jnp.asarray(v),
                                     max_probes=max_probes)
        assert np.array_equal(np.asarray(jstate.rows),
                              mod.host_rows(state))
        assert np.array_equal(np.asarray(jwu), wu.numpy())
    assert wu.all()
    return state


def _surfaces(kept, evicted, max_probes):
    open_state = _build(tht, jht, 1 << int((len(kept) * 4).bit_length()),
                        kept, evicted, max_probes)
    bucket_state = _build(tbt, jbt, int(len(kept) * 4), kept, evicted,
                          max_probes)
    return {
        "hashtable.contains_np": lambda p: tht.contains_np(
            tht.host_rows(open_state), p, max_probes=max_probes),
        "hashtable.contains": lambda p: tht.contains(
            open_state, _t(p), max_probes=max_probes).numpy(),
        "buckettable.contains_np": lambda p: tbt.contains_np(
            tbt.host_rows(bucket_state), p, max_probes=max_probes),
        "buckettable.contains": lambda p: tbt.contains(
            bucket_state, _t(p), max_probes=max_probes).numpy(),
    }


def test_contains_parity_open_vs_bucket_vs_device():
    kept, evicted, absent = _corpus(3, 512)
    probe = np.concatenate([kept, evicted, absent])
    want = np.concatenate([np.ones((len(kept),), bool),
                           np.zeros((len(evicted) + len(absent),), bool)])
    for name, fn in _surfaces(kept, evicted, 32).items():
        miss = np.nonzero(fn(probe) != want)[0]
        assert miss.size == 0, f"{name} disagrees on {miss.size} lanes"


def test_contains_parity_within_batch_duplicates():
    kept, evicted, absent = _corpus(23, 128)
    rng = np.random.default_rng(5)
    pool = np.concatenate([kept, evicted, absent])
    pick = rng.integers(0, len(pool), size=1024)
    probe = pool[pick]
    want = pick < len(kept)
    for name, fn in _surfaces(kept, evicted, 32).items():
        assert np.array_equal(fn(probe), want), f"{name} diverged"
    # The view's probe pads to a power of two (min 16) on every path.
    assert [snapmod._pow2_width(n) for n in (1, 16, 17, 1024, 1025)] == [
        16, 16, 32, 1024, 2048]
