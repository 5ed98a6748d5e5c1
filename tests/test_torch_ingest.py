"""The port's log client, sync engine and health endpoint
(``ct_mapreduce_tpu_torch/ingest/{ctclient,sync,health}.py``) against the
JAX package's, on the client, worker, sync and health cases of
``tests/test_ingest.py``, and the port's loopback log server
(``utils/fakelog.py``) against ``tests/fakelog.py``.

Every case runs the same certificates (``tests/certgen.py``) through
both packages: the JAX modules over ``tests/fakelog.py`` and
``TpuAggregator``, the port's over its own ``FakeLog`` and
``TorchAggregator(device="cpu")``. The reference case's assertions hold
on both, and what each observed (entries, cursors, drains, health
answers) must be equal. Tolerance: exact equality.
"""

import datetime
import importlib
import json
import queue
import threading
import urllib.request
from types import SimpleNamespace

import pytest

from ct_mapreduce_tpu.agg.aggregator import TpuAggregator
from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
from ct_mapreduce_tpu_torch.utils import fakelog as tfakelog

from tests import certgen
from tests import fakelog as jfakelog

UTC = datetime.timezone.utc
NOW = datetime.datetime(2025, 1, 1, tzinfo=UTC)
FUTURE = datetime.datetime(2031, 6, 15, tzinfo=UTC)
PKGS = ("jax", "port")


def _pkg(name: str) -> SimpleNamespace:
    root = "ct_mapreduce_tpu" if name == "jax" else "ct_mapreduce_tpu_torch"
    mod = {m: importlib.import_module(f"{root}.{m}") for m in (
        "ingest.ctclient", "ingest.sync", "ingest.health", "core.der",
        "core.types", "storage.certdb", "storage.mockbackend",
        "storage.mockcache")}
    return SimpleNamespace(
        name=name, ctclient=mod["ingest.ctclient"], sync=mod["ingest.sync"],
        HealthServer=mod["ingest.health"].HealthServer,
        der=mod["core.der"], types=mod["core.types"],
        FakeLog=jfakelog.FakeLog if name == "jax" else tfakelog.FakeLog,
        db=lambda: mod["storage.certdb"].FilesystemDatabase(
            mod["storage.mockbackend"].MockBackend(),
            mod["storage.mockcache"].MockRemoteCache()),
        agg=lambda batch_size: (
            TpuAggregator(capacity=1 << 12, batch_size=batch_size, now=NOW)
            if name == "jax" else
            TorchAggregator(capacity=1 << 12, batch_size=batch_size,
                            now=NOW, device="cpu")))


P = {name: _pkg(name) for name in PKGS}


def both(case):
    """Run ``case(pkg)`` on both packages; the records must match."""
    records = [case(P[name]) for name in PKGS]
    assert records[0] == records[1]
    return records[1]


def _leaf(serial: int, issuer_cn: str, subject_cn="leaf.example.com"):
    return certgen.make_cert(serial=serial, issuer_cn=issuer_cn,
                             subject_cn=subject_cn, is_ca=False,
                             not_after=FUTURE)


def _issuer(issuer_cn: str):
    return certgen.make_cert(serial=1, issuer_cn=issuer_cn, is_ca=True,
                             not_after=FUTURE)


def _run_engine(m, sink, db, logs, num_threads=1, timeout=60, **kw):
    engine = m.sync.LogSyncEngine(sink, db, num_threads=num_threads, **kw)
    engine.start_store_threads()
    for log in logs:
        engine.sync_log(log.url, transport=log.transport)
    engine.wait_for_downloads(timeout=timeout)
    engine.stop()
    return engine


def _state(db, short):
    st = db.get_log_state(short)
    return (st.max_entry, st.last_entry_time)


# -- the loopback log ---------------------------------------------------


def test_port_fakelog_pages_equal_reference_fakelog():
    """The port's log answers every request byte for byte as
    ``tests/fakelog.py`` does (pages, caps, tails, errors, 429/5xx), and
    its HTTP server returns those bytes over a real socket."""
    issuer = _issuer("Page CA")
    leaves = [_leaf(100 + s, "Page CA") for s in range(8)]
    logs = [jfakelog.FakeLog(), tfakelog.FakeLog()]
    for log in logs:
        for s in range(7):
            log.add_cert(leaves[s], issuer, timestamp_ms=1700000000000 + s)
        log.add_precert(leaves[7], issuer, timestamp_ms=5)
        log.add_garbage()
        log.max_batch = 4
    urls = ["/ct/v1/get-sth", "/ct/v1/get-entries?start=0&end=9",
            "/ct/v1/get-entries?start=4&end=6",
            "/ct/v1/get-entries?start=8&end=8",
            "/ct/v1/get-entries?start=9&end=12",
            "/ct/v1/get-entry-and-proof?leaf_index=7&tree_size=9",
            "/ct/v1/nothing-here"]
    answers = [[log.transport(log.url + u) for u in urls] for log in logs]
    assert answers[0] == answers[1]
    for log in logs:
        log.rate_limit_hits, log.retry_after = 1, "2"
        log.server_error_hits = 1
    errs = [[log.transport(log.url + urls[0]) for _ in range(3)]
            for log in logs]
    assert errs[0] == errs[1]
    assert [e[0] for e in errs[1]] == [429, 503, 200]

    with tfakelog.LogServer(logs[1]) as srv:
        assert srv.url.endswith("/fake")
        for u, (status, _, body) in zip(urls[:-1], answers[0]):
            req = urllib.request.Request(srv.url + u)
            try:
                with urllib.request.urlopen(req, timeout=10) as resp:
                    got = (resp.status, resp.read())
            except urllib.error.HTTPError as err:
                got = (err.code, err.read())
            assert got == (status, body), u


# -- client -------------------------------------------------------------


def test_short_url():
    def case(m):
        rec = [m.ctclient.short_url("https://ct.example.com/log/"),
               m.ctclient.short_url("ct.example.com/log"),
               m.ctclient.short_url("http://127.0.0.1:8080/fake")]
        assert rec[:2] == ["ct.example.com/log"] * 2
        return rec
    both(case)


def test_client_sth_and_entries():
    leaf, issuer = _leaf(1, "Ingest CA"), _issuer("Ingest CA")

    def case(m):
        log = m.FakeLog()
        for s in range(5):
            log.add_cert(leaf, issuer, timestamp_ms=s)
        c = m.ctclient.CTLogClient(log.url, transport=log.transport)
        entries = c.get_raw_entries(1, 3)
        rec = [c.get_sth().tree_size, [e.index for e in entries],
               [(e.leaf_input, e.extra_data) for e in entries]]
        assert rec[:2] == [5, [1, 2, 3]]
        return rec
    both(case)


def test_client_429_backoff_and_retry_after():
    leaf, issuer = _leaf(2, "Ingest CA"), _issuer("Ingest CA")

    def case(m):
        log = m.FakeLog()
        log.add_cert(leaf, issuer)
        log.rate_limit_hits, log.retry_after = 2, "3"
        sleeps = []
        c = m.ctclient.CTLogClient(log.url, transport=log.transport,
                                   sleep=sleeps.append)
        rec = [c.get_sth().tree_size, list(sleeps)]
        assert rec == [1, [3.0, 3.0]]  # Retry-After honored, then success
        log.rate_limit_hits, log.retry_after = 1, None
        sleeps.clear()
        c.get_sth()
        assert len(sleeps) == 1 and 0 < sleeps[0] <= 300.0  # jittered
        return rec + [len(log.requests)]
    both(case)


def test_client_5xx_backoff_same_lane():
    leaf, issuer = _leaf(2, "Ingest CA"), _issuer("Ingest CA")

    def case(m):
        log = m.FakeLog()
        log.add_cert(leaf, issuer)
        log.server_error_hits, log.server_error_status = 2, 503
        log.retry_after = "7"
        sleeps = []
        c = m.ctclient.CTLogClient(log.url, transport=log.transport,
                                   sleep=sleeps.append)
        rec = [c.get_sth().tree_size, list(sleeps)]
        assert rec == [1, [7.0, 7.0]]  # Retry-After honored on 5xx too
        log.server_error_hits, log.server_error_status = 1, 502
        log.retry_after = None
        sleeps.clear()
        c.get_sth()
        assert len(sleeps) == 1 and 0 < sleeps[0] <= 300.0
        return rec
    both(case)


def test_client_non_retryable_status_still_raises():
    leaf, issuer = _leaf(2, "Ingest CA"), _issuer("Ingest CA")

    def case(m):
        log = m.FakeLog()
        log.add_cert(leaf, issuer)
        sleeps = []
        c = m.ctclient.CTLogClient(log.url, transport=log.transport,
                                   sleep=sleeps.append)
        with pytest.raises(m.ctclient.CTClientError) as err:
            c.get_raw_entries(5, 9)  # beyond tree size → 400: no retry
        assert sleeps == []
        return err.value.status
    both(case)


def test_client_window_clamps_to_served_page():
    leaf, issuer = _leaf(4, "Ingest CA"), _issuer("Ingest CA")

    def case(m):
        log = m.FakeLog()
        for s in range(10):
            log.add_cert(leaf, issuer, timestamp_ms=s)
        log.max_batch = 3  # the server's real cap, discovered on the wire
        c = m.ctclient.CTLogClient(log.url, transport=log.transport)
        rec = [[e.index for e in c.get_raw_entries(0, 9)], c.page_size,
               [e.index for e in c.get_raw_entries(3, 9)],
               log.requests[-1].endswith("start=3&end=5"),
               [e.index for e in c.get_raw_entries(9, 9)], c.page_size]
        assert rec == [[0, 1, 2], 3, [3, 4, 5], True, [9], 3]
        return rec
    both(case)


# -- LogWorker resume window --------------------------------------------


def test_worker_resume_and_limit():
    leaf, issuer = _leaf(3, "Ingest CA"), _issuer("Ingest CA")

    def case(m):
        log = m.FakeLog()
        for _ in range(10):
            log.add_cert(leaf, issuer)
        db = m.db()
        db.save_log_state(m.types.CertificateLog(
            short_url="ct.example.com/fake", max_entry=4))
        c = m.ctclient.CTLogClient(log.url, transport=log.transport)
        w, w2, w3 = (m.sync.LogWorker(c, db), m.sync.LogWorker(c, db, offset=7),
                     m.sync.LogWorker(c, db, limit=2))
        rec = [(w.start_pos, w.end_pos), w2.start_pos,
               (w3.start_pos, w3.end_pos)]
        assert rec == [(4, 9), 7, (4, 5)]
        return rec
    both(case)


def test_cursor_saved_on_download_error():
    """A transport failure mid-range still runs the exit state save:
    progress up to the failure survives. The reference case answers 500,
    which the client now retries with real sleeps of up to 5 minutes
    (it does not finish); here the client's sleep is a no-op and its
    retry budget 3, so it gives up and the exit save runs as there."""
    leaf, issuer = _leaf(5, "Ingest CA"), _issuer("Ingest CA")

    def case(m):
        log = m.FakeLog()
        for _ in range(6):
            log.add_cert(leaf, issuer)
        log.max_batch = 2  # 3 get-entries requests for the full range
        calls = {"n": 0}

        def failing_transport(url):
            if "get-entries" in url:
                calls["n"] += 1
                if calls["n"] >= 2:
                    return 500, {}, b"transport down"
            return log.transport(url)

        db = m.db()
        c = m.ctclient.CTLogClient(log.url, transport=failing_transport,
                                   sleep=lambda s: None, max_retries=3)
        w = m.sync.LogWorker(c, db)
        with pytest.raises(m.ctclient.CTClientError):
            w.run(queue.Queue(), threading.Event(), save_period_s=1e9)
        st = db.get_log_state("ct.example.com/fake")
        assert st.max_entry == 2  # first batch durable, not lost
        return st.max_entry, calls["n"]
    both(case)


# -- end-to-end sync ----------------------------------------------------


def test_sync_end_to_end_database_sink():
    issuer_der = _issuer("E2E CA")
    serials = [100, 101, 102, 101, 100, 103]  # dupes dedup to 4
    leaves = {s: _leaf(s, "E2E CA", "x.example.com") for s in set(serials)}
    ca_cert = certgen.make_cert(serial=200, issuer_cn="E2E CA", is_ca=True,
                                not_after=FUTURE)

    def case(m):
        log = m.FakeLog()
        for s in serials:
            log.add_cert(leaves[s], issuer_der)
        log.add_garbage()  # tolerated, skipped (ct-fetch.go:452-460)
        log.add_cert(ca_cert, issuer_der)  # filtered out: CA
        log.add_garbage()  # trailing garbage: the cursor still advances
        db = m.db()
        sink = m.sync.DatabaseSink(db, now=NOW)
        _run_engine(m, sink, db, [log], num_threads=2, timeout=30)
        issuer = m.types.Issuer.from_spki(certgen.spki_of(issuer_der))
        exp = m.types.ExpDate.from_time(m.der.parse_cert(issuer_der).not_after)
        known = db.get_known_certificates(exp, issuer)
        st = db.get_log_state("ct.example.com/fake")
        rec = [known.count(), sorted(s.hex_string() for s in known.known()),
               [known.was_unknown(m.types.Serial.from_der_cert(leaves[s]))
                for s in sorted(leaves)], st.max_entry]
        assert rec[0] == 4 and not any(rec[2]) and rec[3] == 9
        assert st.last_update_time is not None
        return rec
    both(case)


def test_sync_stop_event_checkpoints():
    leaf, issuer = _leaf(5, "Ingest CA"), _issuer("Ingest CA")

    def case(m):
        log = m.FakeLog()
        for _ in range(30):
            log.add_cert(leaf, issuer)
        db = m.db()
        sink = m.sync.DatabaseSink(db, now=NOW)
        _run_engine(m, sink, db, [log], timeout=30, limit=10)
        st = db.get_log_state("ct.example.com/fake")
        assert st.max_entry == 10  # limit clamp honored
        return st.max_entry
    both(case)


def test_sync_end_to_end_aggregator_sink():
    issuer_der = _issuer("Agg CA")
    leaves = [_leaf(s, "Agg CA", "y.example.com") for s in (500, 501, 500, 502)]

    def case(m):
        log = m.FakeLog()
        for leaf in leaves:
            log.add_cert(leaf, issuer_der)
        agg = m.agg(64)
        db = m.db()
        sink = m.sync.AggregatorSink(agg, flush_size=3)
        _run_engine(m, sink, db, [log])
        snap = agg.drain()
        assert snap.total == 3 and sink.entries_in == 4  # 500, 501, 502
        return snap.counts, _state(db, "ct.example.com/fake")
    both(case)


def test_sync_raw_batch_mode_matches_per_entry():
    """The raw-batch path and the per-entry path give the same aggregate
    state and cursor, garbage and CA entries included, in each package."""
    issuer_der = _issuer("Raw CA")
    leaves = [_leaf(s, "Raw CA", "r.example.com")
              for s in (700, 701, 700, 702, 703, 701)]
    ca = certgen.make_cert(serial=900, issuer_cn="Raw CA", is_ca=True,
                           not_after=FUTURE)

    def case(m):
        results = []
        for raw in (False, True):
            log = m.FakeLog()
            for i, leaf in enumerate(leaves):
                log.add_cert(leaf, issuer_der, timestamp_ms=1700000000000 + i)
            log.add_garbage()
            log.add_cert(ca, issuer_der)
            agg = m.agg(64)
            db = m.db()
            sink = m.sync.AggregatorSink(agg, flush_size=4)
            engine = _run_engine(m, sink, db, [log], num_threads=2,
                                 raw_batches=raw)
            assert not engine.errors, engine.errors
            snap = agg.drain()
            results.append((snap.counts, snap.total,
                            _state(db, "ct.example.com/fake")))
        assert results[0][:2] == results[1][:2]
        assert results[0][2][0] == results[1][2][0] == 8
        assert results[1][1] == 4 and results[1][2][1] is not None
        return results
    both(case)


def test_sync_multi_log_shared_sink():
    """Several logs, one downloader each, one shared aggregator: dedup
    spans logs and each log keeps its own cursor."""
    issuer_der = _issuer("Multi CA")
    leaf = {s: _leaf(s, "Multi CA", "m.example.com") for s in range(700, 705)}

    def case(m):
        log_a = m.FakeLog(url="https://ct.example.com/a")
        log_b = m.FakeLog(url="https://ct.example.com/b")
        for s in (700, 701, 702):
            log_a.add_cert(leaf[s], issuer_der)
        for s in (701, 702, 703, 704):  # overlaps a on 701/702
            log_b.add_cert(leaf[s], issuer_der)
        agg = m.agg(64)
        db = m.db()
        sink = m.sync.AggregatorSink(agg, flush_size=3)
        _run_engine(m, sink, db, [log_a, log_b], num_threads=2)
        snap = agg.drain()
        rec = [snap.total, sink.entries_in,
               db.get_log_state("ct.example.com/a").max_entry,
               db.get_log_state("ct.example.com/b").max_entry, snap.counts]
        assert rec[:4] == [5, 7, 3, 4]
        return rec
    both(case)


def test_sync_contention_stress_exact_totals():
    """Four logs with overlapping serials, four store workers, a ragged
    flush size and depth 3: exact totals, entry for entry."""
    issuer_der = _issuer("Race CA")
    leaf = {s: _leaf(s, "Race CA", "r.example.com") for s in range(900, 947)}

    def case(m):
        logs, unique = [], set()
        for k in range(4):
            log = m.FakeLog(url=f"https://ct.example.com/race{k}")
            for s in range(900 + 10 * k, 900 + 10 * k + 17):
                log.add_cert(leaf[s], issuer_der)
                unique.add(s)
            logs.append(log)
        agg = m.agg(32)
        db = m.db()
        sink = m.sync.AggregatorSink(agg, flush_size=7, device_queue_depth=3)
        _run_engine(m, sink, db, logs, num_threads=4, timeout=90)
        snap = agg.drain()
        rec = [snap.total, sink.entries_in, snap.counts,
               [db.get_log_state(f"ct.example.com/race{k}").max_entry
                for k in range(4)]]
        assert rec[0] == len(unique) and rec[1] == 4 * 17
        assert rec[3] == [17] * 4
        return rec
    both(case)


def test_sync_engine_checkpoint_hook_runs_before_cursor():
    """The pre-cursor save: the checkpoint hook runs after the log's own
    entries are through the sink and before its cursor is written, and
    ``checkpoint_now`` with no download in flight runs it directly."""
    issuer_der = _issuer("Hook CA")
    leaves = [_leaf(s, "Hook CA") for s in range(40, 46)]

    def case(m):
        log = m.FakeLog()
        for leaf in leaves:
            log.add_cert(leaf, issuer_der)
        agg = m.agg(64)
        db = m.db()
        sink = m.sync.AggregatorSink(agg, flush_size=64)
        seen = []

        def hook():
            sink.flush()
            seen.append((agg.drain().total,
                         db.get_log_state("ct.example.com/fake").max_entry))

        engine = _run_engine(m, sink, db, [log], raw_batches=True,
                             checkpoint_hook=hook)
        engine.checkpoint_now()
        assert seen[0] == (6, 0) and seen[-1] == (6, 6)
        return seen
    both(case)


# -- health -------------------------------------------------------------


class _FakeEngine:
    def __init__(self):
        self.updates = {}

    def last_updates(self):
        return dict(self.updates)


def test_health_transitions():
    def case(m):
        eng = _FakeEngine()
        h = m.HealthServer(eng, polling_delay_mean_s=10.0, addr="127.0.0.1:0")
        rec = [h.status()[0]]  # 503 before the first update
        eng.updates["log"] = datetime.datetime.now(UTC)
        code, body = h.status()
        rec += [code, body["status"]]
        eng.updates["log"] = (datetime.datetime.now(UTC)
                              - datetime.timedelta(seconds=25))
        code, body = h.status()
        rec += [code, body["stalled"]]
        assert rec == [503, 200, "ok", 500, ["log"]]
        return rec
    both(case)


def test_health_http_server():
    def case(m):
        eng = _FakeEngine()
        eng.updates["log"] = datetime.datetime.now(UTC)
        h = m.HealthServer(eng, polling_delay_mean_s=10.0, addr="127.0.0.1:0")
        h.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{h.port}/health", timeout=5) as resp:
                rec = [resp.status, sorted(json.loads(resp.read()))]
        finally:
            h.stop()
        assert rec[0] == 200
        return rec
    both(case)


def test_polling_delay_positive():
    def case(m):
        delays = [m.sync.polling_delay(600.0, 10) for _ in range(100)]
        assert min(delays) >= 1.0
        return m.sync.polling_delay(0.0, 10)  # clamped to the floor
    both(case)
