"""Overlapped ingest: decode ‖ H2D/device ‖ drain as a staged pipeline
(a copy of ``ct_mapreduce_tpu.ingest.overlap``; the port imports nothing
of the JAX package).

While batch N runs on the device, batch N+1 decodes on a background
pool through the native leafpack path (``decode_raw_batch`` releases
the GIL) and its host-to-device copy is queued; batch N−1's fold
(readback, host lane, PEM writes) is consumed from a bounded queue on a
dedicated thread. With decode and device fully overlapped, the wall
drops toward ``max(decode, device)`` instead of their sum.

Stage layout (each box a thread or pool; queues are bounded):

    producer ──chunks──▶ [decode pool]      (sink._prepare_chunk)
                 │ futures, FIFO
                 ▼
             [submit thread]                (sink._submit_chunk, under
                 │ drain queue, ≤ depth      the dispatch lock; device
                 ▼                           steps queue on the stream)
             [drain consumer]               (sink._complete_item:
                                             readback + fold + PEMs)

Ordering contract: chunks are SUBMITTED to the device in exactly the
order the producer handed them in (decode runs ahead out of order, a
reorder point at the submit thread restores it), and completions are
FIFO — so the dedup table sees the same insertion order as the serial
path and results are identical.

Failure contract: a stage exception (decode worker raise, submit
failure, drain failure) latches the pipeline into a failed state —
``submit_chunk``/``drain_all``/``close`` re-raise it as
:class:`OverlapError`, queues keep draining so nothing hangs, and
already-submitted device work is still completed (the aggregator's
counts stay exact for everything that reached the device).

Memory: each decoded chunk holds one of the sink's pinned row buffers
until its fold, so the pool holds at most the prepared window, the
drain queue and the two items the submit and fold threads hold
(``AggregatorSink.row_buffer_bound``).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ct_mapreduce_tpu_torch.telemetry import flight, metrics, trace


class OverlapError(RuntimeError):
    """A pipeline stage failed; the original exception is ``__cause__``."""


_SENTINEL = object()


class OverlapIngestPipeline:
    """Three-stage overlap scheduler over one :class:`AggregatorSink`.

    ``decode_workers`` sizes the decode pool (each worker runs one
    whole-chunk native decode with the GIL released); ``queue_depth``
    bounds device batches that are submitted-but-undrained — the
    double-buffer depth. Memory bound: at most ``decode_workers + 1``
    prepared chunks plus ``queue_depth`` in-flight device batches are
    alive at once.

    **Sizing vs intra-chunk decode threads.** Host decode parallelism
    now has two axes: this pool runs W whole chunks concurrently, and
    inside each chunk the native worker pool splits lane ranges over T
    threads (``decodeThreads`` directive / ``CTMR_DECODE_THREADS``,
    ``leafpack.resolve_threads``). Both axes burn the same cores, so
    size them as **W × T ≤ host cores**: oversubscribing buys nothing
    (the native pool runs one parallel region at a time; an extra
    region decodes serially) and inflates the prepared-chunk memory
    window. ``decode_workers=0`` (the default) auto-sizes W from
    ``os.cpu_count() / T`` clamped to [1, 8] — with T at its own
    default (all cores) that is W=1, i.e. intra-chunk threads do the
    scaling and this pool only keeps one chunk decoding ahead of the
    device; pinning T smaller (e.g. ``decodeThreads=4`` on a 32-core
    host) shifts the parallelism back to whole-chunk pipelining.
    The ``overlapWorkers`` directive overrides W explicitly.
    """

    def __init__(self, sink, decode_workers: int = 0, queue_depth: int = 2,
                 max_prepared: Optional[int] = None):
        self._sink = sink
        if int(decode_workers) <= 0:
            decode_workers = self._auto_workers(sink)
        self.decode_workers = max(1, int(decode_workers))
        self.queue_depth = max(1, int(queue_depth))
        self._pool = ThreadPoolExecutor(
            max_workers=self.decode_workers, thread_name_prefix="ovl-decode"
        )
        # Reorder point: decode futures in producer order. The submit
        # loop waits on the HEAD future, so device submission order ==
        # producer order regardless of decode completion order.
        self._order_q: "queue.Queue" = queue.Queue()
        # Double buffer: blocks the submit loop once `queue_depth`
        # batches are submitted-but-undrained.
        self._drain_q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        self._failed = threading.Event()
        self._exc: Optional[BaseException] = None
        self._exc_lock = threading.Lock()
        # Bound decoded-but-unsubmitted chunks (each pins ~chunk bytes
        # twice: packed host rows + the enqueued device buffer).
        self._max_prepared = max_prepared or self.decode_workers + 1
        self._prepared_sem = threading.BoundedSemaphore(self._max_prepared)
        self._closed = False
        # Per-stage busy seconds (wall time spent inside the stage) —
        # the occupancy gauges. Busy sums exceeding the wall clock is
        # the overlap actually happening. "lock" is the submit thread's
        # wait for the sink's dispatch lock — sampled SEPARATELY so the
        # submit gauge (and a storeCertificate-derived dispatch budget)
        # measures submit work, not lock contention.
        self.busy = {"decode": 0.0, "submit": 0.0, "drain": 0.0,
                     "lock": 0.0}
        self._busy_lock = threading.Lock()
        # Bounded-queue depth high-water marks: how full the prepared
        # window (decoded-but-unsubmitted chunks) and the drain queue
        # (submitted-but-unfolded batches) ever got. A decode-starved
        # pipeline never fills the prepared window; a drain-starved one
        # pins the drain queue at its cap — these gauges tell the two
        # apart.
        self.highwater = {"prepared": 0, "drain_queue": 0}
        self._prepared_in_use = 0
        self._hw_lock = threading.Lock()
        self._submit_t = threading.Thread(
            target=self._submit_loop, name="ovl-submit", daemon=True)
        self._drain_t = threading.Thread(
            target=self._drain_loop, name="ovl-drain", daemon=True)
        self._submit_t.start()
        self._drain_t.start()

    @staticmethod
    def _auto_workers(sink=None) -> int:
        """Default decode-pool width: the W of the W × T ≤ cores rule
        (docstring above), honoring the sink's configured intra-chunk
        thread count when it has one."""
        import os

        from ct_mapreduce_tpu_torch.native import leafpack

        cores = os.cpu_count() or 1
        t = leafpack.resolve_threads(
            1 << 20, getattr(sink, "decode_threads", None))
        return max(1, min(8, cores // max(1, t)))

    # -- producer side ---------------------------------------------------
    def submit_chunk(self, pairs) -> None:
        """Enqueue one raw (leaf_input, extra_data) chunk for the
        pipeline. Blocks when the decode stage is saturated
        (backpressure toward the downloader queue); raises
        :class:`OverlapError` once any stage has failed."""
        if self._closed:
            raise OverlapError("overlap pipeline is closed")
        self._raise_if_failed()
        while not self._prepared_sem.acquire(timeout=0.1):
            # select{failure | slot} — a dead submit loop must surface
            # as an error here, never as a hung producer.
            self._raise_if_failed()
        with self._hw_lock:
            self._prepared_in_use += 1
            if self._prepared_in_use > self.highwater["prepared"]:
                self.highwater["prepared"] = self._prepared_in_use
        try:
            fut = self._pool.submit(self._decode_one, pairs)
        except BaseException:
            self._release_prepared()
            raise
        self._order_q.put(fut)

    def drain_all(self) -> None:
        """Barrier: block until every chunk submitted so far is decoded,
        stepped, and folded; re-raise the first stage failure. Markers
        flow through both stage loops even after a failure (the loops
        keep consuming), so this never hangs on a failed pipeline."""
        if self._closed:
            self._raise_if_failed()
            return
        marker = threading.Event()
        self._order_q.put(marker)
        while not marker.wait(timeout=0.25):
            if not self._drain_t.is_alive():
                break  # closed underneath us; nothing left in flight
        self._raise_if_failed()

    def close(self) -> None:
        """Stop the stage threads after the work in flight finishes and
        re-raise any latched stage failure. Idempotent."""
        if not self._closed:
            self._closed = True
            self._order_q.put(_SENTINEL)
            self._pool.shutdown(wait=True)
            self._submit_t.join(timeout=60.0)
            self._drain_t.join(timeout=60.0)
        self._raise_if_failed()

    def occupancy(self, wall_s: float) -> dict[str, float]:
        """Per-stage busy fraction of ``wall_s``, also published as
        ``overlap.<stage>_occupancy`` gauges (plus the bounded-queue
        high-water gauges)."""
        with self._busy_lock:
            busy = dict(self.busy)
        out = {}
        for stage, busy_s in busy.items():
            frac = busy_s / wall_s if wall_s > 0 else 0.0
            out[stage] = frac
            metrics.set_gauge("overlap", f"{stage}_occupancy", value=frac)
        self.publish_highwater()
        return out

    def publish_highwater(self) -> dict[str, int]:
        """Export the bounded-queue high-water marks as gauges:
        ``overlap.prepared_highwater`` (cap ``prepared_capacity``) and
        ``overlap.drain_queue_highwater`` (cap ``queue_depth``)."""
        with self._hw_lock:
            hw = dict(self.highwater)
        metrics.set_gauge("overlap", "prepared_highwater",
                          value=float(hw["prepared"]))
        metrics.set_gauge("overlap", "prepared_capacity",
                          value=float(self._max_prepared))
        metrics.set_gauge("overlap", "drain_queue_highwater",
                          value=float(hw["drain_queue"]))
        metrics.set_gauge("overlap", "drain_queue_capacity",
                          value=float(self.queue_depth))
        stage = getattr(self._sink, "staging_depths", None)
        if stage is not None:
            depths = stage()
            if depths:
                metrics.set_gauge(
                    "overlap", "staging_ring_highwater",
                    value=float(depths["staging_ring_highwater"]))
                metrics.set_gauge(
                    "overlap", "staging_ring_capacity",
                    value=float(depths["staging_ring_capacity"]))
                hw.update(depths)
        return hw

    def queue_depths(self) -> dict[str, int]:
        """Instantaneous bounded-queue depths (plus caps and high-water
        marks) — the ``/healthz`` surface for telling a decode-starved
        pipeline from a drain-starved one while it runs."""
        with self._hw_lock:
            prepared = self._prepared_in_use
            hw = dict(self.highwater)
        depths = {
            "prepared": prepared,
            "prepared_capacity": self._max_prepared,
            "prepared_highwater": hw["prepared"],
            "drain_queue": self._drain_q.qsize(),
            "drain_queue_capacity": self.queue_depth,
            "drain_queue_highwater": hw["drain_queue"],
        }
        # Staged mode adds the third bounded stage: the sink's staging
        # ring (decoded-and-staged but undispatched chunks).
        stage = getattr(self._sink, "staging_depths", None)
        if stage is not None:
            depths.update(stage())
        return depths

    # -- stage bodies ----------------------------------------------------
    def _decode_one(self, pairs):
        t0 = time.perf_counter()
        try:
            with trace.span("ingest.decode", cat="ingest",
                            entries=len(pairs)):
                return self._sink._prepare_chunk(pairs)
        finally:
            self._add_busy("decode", time.perf_counter() - t0)

    def _submit_loop(self) -> None:
        while True:
            item = self._order_q.get()
            if item is _SENTINEL:
                self._flush_sink_staging()
                self._drain_q.put(_SENTINEL)
                return
            if isinstance(item, threading.Event):  # drain_all barrier
                # A barrier covers everything SUBMITTED so far — in
                # staged mode that includes chunks parked in the sink's
                # staging ring, which must dispatch (as a padded
                # partial envelope) before the marker passes.
                self._flush_sink_staging()
                self._drain_q.put(item)
                continue
            try:
                prep = item.result()
            except BaseException as err:
                self._release_prepared()
                self._fail(err)
                continue  # keep consuming so close()/drain_all() return
            if self._failed.is_set():
                self._release_prepared()
                continue
            # Dispatch-lock wait is sampled SEPARATELY from the
            # storeCertificate envelope (its own busy bucket + the
            # dispatchLockWait sample): lock contention is not submit
            # work, and folding it in would overstate the submit
            # occupancy gauge and the dispatch budget.
            t_lock = time.perf_counter()
            try:
                with trace.span("ingest.submit_locked", cat="ingest"), \
                        self._sink._dispatch_lock:
                    lock_s = time.perf_counter() - t_lock
                    self._add_busy("lock", lock_s)
                    metrics.add_sample("ct-fetch", "dispatchLockWait",
                                       value=lock_s)
                    t0 = time.perf_counter()
                    try:
                        with metrics.measure("ct-fetch", "storeCertificate"), \
                                trace.span("ingest.submit", cat="ingest"):
                            work = self._sink._submit_chunk(prep)
                    finally:
                        self._add_busy("submit", time.perf_counter() - t0)
            except BaseException as err:
                self._fail(err)
                continue
            finally:
                self._release_prepared()
            self._enqueue_drain(work)

    def _enqueue_drain(self, work) -> None:
        for kind, payload, der_of in work:
            self._drain_q.put((kind, payload, der_of))
            depth = self._drain_q.qsize()
            with self._hw_lock:
                if depth > self.highwater["drain_queue"]:
                    self.highwater["drain_queue"] = depth

    def _flush_sink_staging(self) -> None:
        """Dispatch whatever sits in the sink's staging ring (staged
        mode only; a sink without a ring no-ops). Runs on the submit
        thread so ring access stays serialized under the dispatch
        lock. After a latched failure the ring is left undispatched —
        the same already-decoded-work-is-dropped contract a decode
        failure applies."""
        flush = getattr(self._sink, "_flush_staging_items", None)
        if flush is None or self._failed.is_set():
            return
        try:
            with self._sink._dispatch_lock:
                work = flush()
        except BaseException as err:
            self._fail(err)
            return
        self._enqueue_drain(work)

    def _drain_loop(self) -> None:
        while True:
            item = self._drain_q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, threading.Event):
                item.set()
                continue
            kind, payload, der_of = item
            t0 = time.perf_counter()
            try:
                with trace.span("ingest.drain", cat="ingest"):
                    if kind == "pending":
                        self._sink._complete_item(payload, der_of)
                    else:  # "result": oversized exact lane, already folded
                        self._sink._store_pems(payload, der_of)
            except BaseException as err:
                self._fail(err)
            finally:
                self._add_busy("drain", time.perf_counter() - t0)

    # -- shared plumbing -------------------------------------------------
    def _release_prepared(self) -> None:
        with self._hw_lock:
            self._prepared_in_use -= 1
        self._prepared_sem.release()

    def _add_busy(self, stage: str, seconds: float) -> None:
        with self._busy_lock:
            self.busy[stage] += seconds

    def _fail(self, err: BaseException) -> None:
        first = False
        with self._exc_lock:
            if self._exc is None:
                self._exc = err
                first = True
        self._failed.set()
        metrics.incr_counter("overlap", "stage_error")
        if first:
            # Latch-time post-mortem: the FIRST stage failure dumps the
            # trace ring + metric snapshots (no-op unless a flight
            # recorder is installed), so a wedged or crashed run leaves
            # an artifact even if the OverlapError never surfaces.
            trace.instant("overlap.stage_error", cat="ingest",
                          error=repr(err)[:500])
            flight.dump(f"overlap stage failure: {err!r}")

    def _raise_if_failed(self) -> None:
        if self._failed.is_set():
            raise OverlapError(
                f"overlap pipeline stage failed: {self._exc!r}"
            ) from self._exc
