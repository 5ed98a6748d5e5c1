"""The port's overlapped ingest (``ct_mapreduce_tpu_torch/ingest/overlap.py``
behind ``AggregatorSink(overlap_workers=...)``) against the JAX
package's, on the seven cases of ``tests/test_overlap.py``, on the CPU.

Every case runs the same wire batches (``minicert`` leaves under two
issuers, base64 ``leaf_input``/``extra_data`` as a log serves them)
through the JAX sink over ``TpuAggregator`` and the port's sink over
``TorchAggregator(device="cpu")``; the reference case's assertions hold
on both, and the drains, counters and event orders must be equal.
Beyond the reference cases: the pinned-pool bound of the overlapped
sink. Tolerance: exact equality.
"""

import base64
import datetime
import threading
import time

import numpy as np
import pytest

from ct_mapreduce_tpu.agg.aggregator import TpuAggregator
from ct_mapreduce_tpu.ingest import overlap as jover
from ct_mapreduce_tpu.ingest import sync as jsync
from ct_mapreduce_tpu.native import leafpack as jleafpack
from ct_mapreduce_tpu.telemetry import metrics as jmetrics
from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
from ct_mapreduce_tpu_torch.ingest import leaf as leaflib
from ct_mapreduce_tpu_torch.ingest import overlap as tover
from ct_mapreduce_tpu_torch.ingest import sync as tsync
from ct_mapreduce_tpu_torch.native import leafpack as tleafpack
from ct_mapreduce_tpu_torch.telemetry import metrics as tmetrics
from ct_mapreduce_tpu_torch.utils import minicert

UTC = datetime.timezone.utc
NOW = datetime.datetime(2025, 1, 1, tzinfo=UTC)
PKGS = ("jax", "port")
ISSUERS = [minicert.make_cert(serial=1, issuer_cn=f"Ovl CA {k}", is_ca=True)
           for k in range(2)]
MOD = {"jax": (jsync, jover, jleafpack, jmetrics),
       "port": (tsync, tover, tleafpack, tmetrics)}


def wire_batch(pkg: str, start: int, n: int,
               duplicate_of: int | None = None):
    """n wire entries alternating two issuers; serials start..start+n
    (or re-serials of an earlier window when ``duplicate_of`` is set)."""
    lis, eds = [], []
    base = duplicate_of if duplicate_of is not None else start
    for j in range(n):
        k = j % 2
        leaf = minicert.make_cert(serial=base + j, issuer_cn=f"Ovl CA {k}",
                                  subject_cn="ovl.example", is_ca=False)
        lis.append(base64.b64encode(
            leaflib.encode_leaf_input(leaf, 1000 + start + j)).decode())
        eds.append(base64.b64encode(
            leaflib.encode_extra_data([ISSUERS[k]])).decode())
    return MOD[pkg][0].RawBatch(lis, eds, start, "ovl-log")


def make_sink(pkg: str, overlap_workers: int, depth: int = 2,
              flush_size: int = 32):
    if pkg == "jax":
        agg = TpuAggregator(capacity=1 << 12, batch_size=flush_size, now=NOW)
    else:
        agg = TorchAggregator(capacity=1 << 12, batch_size=flush_size,
                              now=NOW, device="cpu")
    sink = MOD[pkg][0].AggregatorSink(agg, flush_size=flush_size,
                                      device_queue_depth=depth,
                                      overlap_workers=overlap_workers)
    return agg, sink


def _fill(agg) -> int:
    return int(agg._table_fill)


def test_overlap_exact_parity_with_serial():
    """The same wire batches through the serial path and the overlap
    scheduler, in each package: counts, totals, host lane, inserts,
    knowns and per-issuer totals all equal — the submit-stage reorder
    point keeps insertion order, so the duplicate batch attributes
    identically."""
    def run(pkg, overlap_workers):
        batches = [wire_batch(pkg, i * 64, 64) for i in range(4)]
        batches.append(wire_batch(pkg, 4 * 64, 64, duplicate_of=0))
        agg, sink = make_sink(pkg, overlap_workers)
        for rb in batches:
            sink.store_raw_batch(rb)
        sink.close()
        snap = agg.drain()
        return {"counts": snap.counts, "total": snap.total,
                "fill": _fill(agg), "host_lane": agg.metrics["host_lane"],
                "inserted": agg.metrics["inserted"],
                "known": agg.metrics["known"],
                "issuer_totals": agg.issuer_totals.tolist()}

    runs = {(pkg, w): run(pkg, w) for pkg in PKGS for w in (0, 2)}
    first = runs[("jax", 0)]
    assert first["total"] == 4 * 64 and first["known"] == 64
    assert first["host_lane"] == 0
    for key, rec in runs.items():
        assert rec == first, key


def test_overlap_ordered_drain_under_slow_consumer():
    """A slow drain consumer neither reorders completions (FIFO =
    submission order) nor stalls submissions beyond the depth."""
    def run(pkg):
        agg, sink = make_sink(pkg, overlap_workers=2, depth=2)
        events = []
        ev_lock = threading.Lock()
        second_submit = threading.Event()
        orig_submit = sink._submit_chunk
        orig_complete = sink._complete_item

        def slow_complete(pending, der_of):
            # The first fold waits (bounded) for the second submit: a
            # pipeline that overlaps lets it through whatever a submit
            # costs (the port's plain CPU step runs inside its submit;
            # the JAX submit only queues); a serial one would not.
            second_submit.wait(30.0)
            time.sleep(0.05)
            with ev_lock:
                events.append(("complete", id(pending)))
            orig_complete(pending, der_of)

        def spy_submit(prep):
            items = orig_submit(prep)
            with ev_lock:
                for kind, payload, _ in items:
                    if kind == "pending":
                        events.append(("submit", id(payload)))
                if sum(k == "submit" for k, _ in events) >= 2:
                    second_submit.set()
            return items

        sink._complete_item = slow_complete
        sink._submit_chunk = spy_submit
        for i in range(5):
            sink.store_raw_batch(wire_batch(pkg, i * 32, 32))
        sink.close()
        assert agg.drain().total == 5 * 32
        sub_ids = [i for k, i in events if k == "submit"]
        com_ids = [i for k, i in events if k == "complete"]
        assert len(sub_ids) == len(com_ids) == 5
        assert com_ids == sub_ids  # FIFO
        kinds = [k for k, _ in events]
        assert kinds.index("complete") >= 2  # stages overlapped
        return agg.drain().counts, len(sub_ids)

    assert run("jax") == run("port")


def test_overlap_decode_failure_surfaces_and_shuts_down():
    """A decode worker raising mid-stream neither hangs the queues nor
    gets swallowed: flush()/close() raise OverlapError with the original
    as __cause__, and work already submitted still folds exactly."""
    def run(pkg):
        over = MOD[pkg][1]
        agg, sink = make_sink(pkg, overlap_workers=2, depth=2)
        boom = RuntimeError("decoder exploded")
        orig_prepare = sink._prepare_chunk
        calls = {"n": 0}

        def failing_prepare(pairs):
            calls["n"] += 1
            if calls["n"] == 2:
                raise boom
            return orig_prepare(pairs)

        sink._prepare_chunk = failing_prepare
        deadline = time.monotonic() + 60.0  # the no-hang budget
        with pytest.raises(over.OverlapError) as exc_info:
            for i in range(4):
                sink.store_raw_batch(wire_batch(pkg, i * 32, 32))
            sink.flush()
        assert exc_info.value.__cause__ is boom
        with pytest.raises(over.OverlapError):
            sink.store_raw_batch(wire_batch(pkg, 999 * 32, 32))
        with pytest.raises(over.OverlapError):
            sink.close()
        assert time.monotonic() < deadline, "shutdown hung"
        total = agg.drain().total
        assert total % 32 == 0 and 32 <= total <= 3 * 32
        return type(exc_info.value).__name__

    assert run("jax") == run("port") == "OverlapError"


def test_overlap_flush_is_reusable_barrier():
    """flush() drains everything in flight but keeps the pipeline
    alive: a second wave lands exactly on the same sink."""
    def run(pkg):
        agg, sink = make_sink(pkg, overlap_workers=2)
        sink.store_raw_batch(wire_batch(pkg, 0, 64))
        sink.flush()
        first = agg.drain()
        assert first.total == 64
        sink.store_raw_batch(wire_batch(pkg, 64, 64))
        sink.close()
        second = agg.drain()
        assert second.total == 128
        return first.counts, second.counts

    assert run("jax") == run("port")


def test_issuer_too_long_status_skips_futile_redecode():
    """A >= 2 MiB issuer DER gets its own status (ISSUER_TOO_LONG): the
    batch pays no full-width redecode, and the entry still lands through
    the exact host lane, in either package."""
    huge_issuer = minicert.make_cert(
        serial=1, issuer_cn="Huge CA", is_ca=True,
        extra_ext_bytes=(1 << 21) + 256)
    assert len(huge_issuer) >= (1 << 21)
    small = [minicert.make_cert(serial=50 + i, issuer_cn="Ovl CA 0",
                                subject_cn="s.example", is_ca=False)
             for i in range(3)]
    victim = minicert.make_cert(serial=99, issuer_cn="Huge CA",
                                subject_cn="v.example", is_ca=False)
    lis = [base64.b64encode(leaflib.encode_leaf_input(d, i)).decode()
           for i, d in enumerate(small + [victim])]
    eds = ([base64.b64encode(
        leaflib.encode_extra_data([ISSUERS[0]])).decode()] * len(small)
        + [base64.b64encode(
            leaflib.encode_extra_data([huge_issuer])).decode()])

    dec_j = jleafpack._decode_python(lis, eds, 2048)
    dec_t = tleafpack._decode_python(lis, eds, 2048,
                                     np.zeros((len(lis), 2048), np.uint8))
    assert dec_t.status[-1] == tleafpack.ISSUER_TOO_LONG
    assert dec_t.length[-1] == len(victim)  # the cert row IS packed
    np.testing.assert_array_equal(dec_t.status, dec_j.status)
    np.testing.assert_array_equal(dec_t.length, dec_j.length)
    np.testing.assert_array_equal(dec_t.data, dec_j.data)
    dec_nat = tleafpack.decode_raw_batch(lis, eds, 2048)
    np.testing.assert_array_equal(dec_nat.status, dec_t.status)

    def run(pkg):
        leafpack = MOD[pkg][2]
        pads_seen = []
        orig = leafpack.decode_raw_batch

        def spy(l, e, pad_len, workers=None, threads=None, **kw):
            pads_seen.append(pad_len)
            return orig(l, e, pad_len, workers=workers, threads=threads,
                        **kw)

        agg, sink = make_sink(pkg, overlap_workers=0, flush_size=64)
        leafpack.decode_raw_batch = spy
        try:
            sink.store_raw_batch(MOD[pkg][0].RawBatch(lis, eds, 0, "log"))
            sink.flush()
        finally:
            leafpack.decode_raw_batch = orig
        assert pads_seen == [sink.PAD_LEN // 2], pads_seen
        snap = agg.drain()
        assert snap.total == len(small) + 1
        return snap.counts, agg.metrics["host_lane"]

    assert run("jax") == run("port")


def test_overlap_queue_highwater_gauges():
    """The bounded-queue high-water marks are tracked and exported as
    the same gauges in both packages."""
    def run(pkg):
        metrics = MOD[pkg][3]
        agg, sink = make_sink(pkg, overlap_workers=2, depth=2)
        ovl = sink._overlap
        for i in range(6):
            sink.store_raw_batch(wire_batch(pkg, i * 32, 32))
        ovl.drain_all()
        hw = ovl.publish_highwater()
        cap_prepared, cap_drain = ovl._max_prepared, ovl.queue_depth
        sink.close()
        assert 1 <= hw["prepared"] <= cap_prepared
        assert 0 <= hw["drain_queue"] <= cap_drain
        fresh = metrics.InMemSink()
        prev = metrics.get_sink()
        metrics.set_sink(fresh)
        try:
            agg2, sink2 = make_sink(pkg, overlap_workers=2, depth=1)
            ovl2 = sink2._overlap
            for i in range(4):
                sink2.store_raw_batch(wire_batch(pkg, i * 32, 32))
            ovl2.drain_all()
            occ = ovl2.occupancy(1.0)
            sink2.close()
        finally:
            metrics.set_sink(prev)
        gauges = fresh.snapshot()["gauges"]
        keys = sorted(k for k in gauges if k.startswith("overlap."))
        for key in ("overlap.prepared_highwater", "overlap.prepared_capacity",
                    "overlap.drain_queue_highwater",
                    "overlap.drain_queue_capacity"):
            assert key in gauges, sorted(gauges)
        assert gauges["overlap.prepared_highwater"] >= 1
        assert "lock" in occ
        return keys, sorted(occ), (cap_prepared, cap_drain), agg.drain().total

    assert run("jax") == run("port")


def test_overlap_lock_wait_sampled_outside_store_envelope():
    """dispatchLockWait is its own sample, one per submitted chunk."""
    def run(pkg):
        metrics = MOD[pkg][3]
        fresh = metrics.InMemSink()
        prev = metrics.get_sink()
        metrics.set_sink(fresh)
        try:
            agg, sink = make_sink(pkg, overlap_workers=2, depth=2)
            for i in range(4):
                sink.store_raw_batch(wire_batch(pkg, i * 32, 32))
            sink.close()
        finally:
            metrics.set_sink(prev)
        samples = fresh.snapshot()["samples"]
        assert "ct-fetch.dispatchLockWait" in samples
        assert "ct-fetch.storeCertificate" in samples
        assert samples["ct-fetch.dispatchLockWait"]["count"] >= 4
        assert samples["ct-fetch.dispatchLockWait"]["min"] >= 0.0
        return (samples["ct-fetch.dispatchLockWait"]["count"],
                samples["ct-fetch.storeCertificate"]["count"])

    assert run("jax") == run("port")


@pytest.mark.parametrize("staged", [False, True], ids=["unstaged", "staged"])
def test_overlap_pool_stays_within_its_bound(staged):
    """With the overlap pipeline, decoded chunks waiting for the submit
    thread hold row buffers too: the pool never keeps more than
    ``row_buffer_bound()`` (depth + prepared window + 2), however slow
    the fold, and the serial bound (depth + 1) still holds without
    overlap. The drain equals the JAX overlapped sink's."""
    kw = dict(chunks_per_dispatch=2, staging_depth=1) if staged else {}

    def run(pkg, overlap_workers):
        if pkg == "jax":
            agg = TpuAggregator(capacity=1 << 12, batch_size=32, now=NOW)
        else:
            agg = TorchAggregator(capacity=1 << 12, batch_size=32, now=NOW,
                                  device="cpu")
        sink = MOD[pkg][0].AggregatorSink(
            agg, flush_size=32, device_queue_depth=1,
            overlap_workers=overlap_workers, **kw)
        if pkg == "port":
            orig = sink._complete_item

            def slow(pending, der_of):
                time.sleep(0.02)
                orig(pending, der_of)

            sink._complete_item = slow
        bound = sink.row_buffer_bound() if pkg == "port" else None
        for i in range(8):
            sink.store_raw_batch(wire_batch(pkg, i * 32, 32))
        sink.close()
        if pkg == "port":
            pool = sink._row_bufs
            assert 1 <= pool.allocated == pool.live <= bound
        return agg.drain().counts, bound

    want, _ = run("jax", 2)
    got, bound = run("port", 2)
    assert got == want
    assert bound == 1 + (2 + 1) + 2  # depth + prepared window + 2
    got0, bound0 = run("port", 0)
    assert got0 == want and bound0 == 2  # depth + 1


def test_overlap_pool_under_thread_stress():
    """More decode workers than cores and a short switch interval: the
    decode threads share the pinned pool and the issuer registry, and
    a lost update would show as a pool past its bound or a drain off
    the JAX serial sink's."""
    import os
    import sys

    agg, sink = make_sink("jax", overlap_workers=0, depth=2)
    for i in range(12):
        sink.store_raw_batch(wire_batch("jax", i * 32, 32))
    sink.close()
    want = agg.drain()
    workers = 2 * (os.cpu_count() or 1) + 1
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        agg, sink = make_sink("port", overlap_workers=workers, depth=2)
        bound = sink.row_buffer_bound()
        deadline = time.monotonic() + 60.0
        for i in range(12):
            sink.store_raw_batch(wire_batch("port", i * 32, 32))
        sink.close()
        assert time.monotonic() < deadline
    finally:
        sys.setswitchinterval(interval)
    pool = sink._row_bufs
    assert 1 <= pool.allocated == pool.live <= bound
    got = agg.drain()
    assert (got.counts, got.crls, got.dns, got.total) == (
        want.counts, want.crls, want.dns, want.total)
