"""Deadline-driven dynamic micro-batching for the query plane.

The device ``contains`` kernels (and their vectorized host mirrors)
are batch ops: one probe of 512 lanes costs barely more than one probe
of 1 — random-access table reads are latency-priced per DISPATCH, not
per lane. An online query plane therefore wants the
inference-serving discipline: concurrent single-key requests coalesce
into one batch, bounded by a max batch size and a max delay, with
admission control so overload sheds loudly instead of queueing without
bound.

:class:`MicroBatcher` is that loop, oracle-agnostic: callers
``submit()`` lists of opaque items and block; one worker thread
collects whatever is queued — releasing a batch as soon as
``max_batch`` lanes are waiting or ``max_delay_s`` has passed since
the OLDEST queued request — runs ``run_batch`` over the concatenation,
and scatters results back. Guarantees:

- **Bounded wait.** A request waits at most ``max_delay_s`` for its
  batch to form, plus at most one in-flight batch execution before its
  own runs (single worker, FIFO) — so p99 wait ≤ max_delay + ~2×batch
  execution, asserted from the ``serve.wait``/``serve.batch`` spans by
  the bench serve leg.
- **Bounded queue.** Admission beyond ``max_queue_lanes`` queued lanes
  raises :class:`Overloaded` immediately (the ``serve.shed`` counter);
  nothing is silently dropped and nothing queues unboundedly.
- **Deadlines.** A request whose deadline passes while it is still
  queued is failed with :class:`DeadlineExceeded` rather than running
  stale work the client already gave up on.

A copy of ``ct_mapreduce_tpu.serve.batcher`` on the port's
``telemetry``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from ct_mapreduce_tpu_torch.telemetry import trace
from ct_mapreduce_tpu_torch.telemetry.metrics import (
    add_sample,
    incr_counter,
    set_gauge,
)


class Overloaded(RuntimeError):
    """Admission queue full — the explicit load-shedding rejection."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before its batch executed."""


class _Pending:
    __slots__ = ("items", "deadline", "enq_t", "done", "result", "error",
                 "trace_ctx")

    def __init__(self, items: list, deadline: Optional[float],
                 enq_t: float) -> None:
        self.items = items
        self.deadline = deadline
        self.enq_t = enq_t
        self.done = threading.Event()
        self.result: Optional[list] = None
        self.error: Optional[Exception] = None
        # Cross-process correlation: the submitter's trace
        # context crosses to the batch worker thread with the request.
        self.trace_ctx = trace.get_trace_context()


class MicroBatcher:
    """Coalesce concurrent ``submit()`` calls into bounded batches.

    ``run_batch(items) -> results`` must be length-preserving; it runs
    on the single worker thread, so an oracle that is not itself
    thread-safe needs no locking. A request of up to ``max_batch``
    items is never split across batches (its results come from one
    epoch); a bulk submission LARGER than ``max_batch`` is split into
    max_batch-sized sub-requests at admission (``serve.split_requests``)
    and reassembled in order — so oversized bulks coalesce legally with
    concurrent traffic instead of forcing one illegal oversized batch,
    at the cost that their results may span epochs (each sub-batch is
    individually epoch-consistent; callers that surface an epoch should
    report the minimum).
    """

    def __init__(
        self,
        run_batch: Callable[[list], list],
        max_batch: int = 4096,
        max_delay_s: float = 0.002,
        max_queue_lanes: int = 1 << 16,
        name: str = "serve-batcher",
    ) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._run_batch = run_batch
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.max_queue_lanes = int(max_queue_lanes)
        self._cv = threading.Condition()
        self._queue: deque[_Pending] = deque()
        self._queued_lanes = 0
        self._closed = False
        self._thread = threading.Thread(
            target=self._worker, name=name, daemon=True)
        self._thread.start()

    # -- client side -----------------------------------------------------
    def submit(self, items: list, timeout_s: Optional[float] = None) -> list:
        """Run ``items`` through the oracle as part of some batch;
        blocks until the batch executes. Raises :class:`Overloaded` on
        a full admission queue and :class:`DeadlineExceeded` when
        ``timeout_s`` elapses first."""
        if not items:
            return []
        now = time.monotonic()
        n = len(items)
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if self._queued_lanes + n > self.max_queue_lanes:
                incr_counter("serve", "shed", value=float(n))
                raise Overloaded(
                    f"admission queue full ({self._queued_lanes} lanes "
                    f"queued, cap {self.max_queue_lanes}); retry later")
            deadline = None if timeout_s is None else now + timeout_s
            if n <= self.max_batch:
                parts = [_Pending(items, deadline, now)]
            else:
                # Oversized bulk: admit as max_batch-sized sub-requests
                # under this ONE admission decision (all or shed), so
                # the worker can legally coalesce and cap every batch.
                incr_counter("serve", "split_requests")
                parts = [
                    _Pending(items[i : i + self.max_batch], deadline, now)
                    for i in range(0, n, self.max_batch)
                ]
            self._queue.extend(parts)
            self._queued_lanes += n
            set_gauge("serve", "queue_lanes", value=float(self._queued_lanes))
            incr_counter("serve", "requests")
            incr_counter("serve", "lanes", value=float(n))
            self._cv.notify()
        with trace.span("serve.wait", cat="serve", lanes=n):
            for p in parts:
                p.done.wait()
        add_sample("serve", "wait_s", value=time.monotonic() - now)
        err = next((p.error for p in parts if p.error is not None), None)
        if err is not None:
            raise err
        if len(parts) == 1:
            return parts[0].result
        return [r for p in parts for r in p.result]

    def queue_lanes(self) -> int:
        with self._cv:
            return self._queued_lanes

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5)
        # Anything still queued fails loudly rather than hanging its
        # waiter forever.
        with self._cv:
            drained = list(self._queue)
            self._queue.clear()
            self._queued_lanes = 0
        for p in drained:
            p.error = RuntimeError("MicroBatcher closed")
            p.done.set()

    # -- worker side -----------------------------------------------------
    def _collect(self) -> list:
        """Block until a batch is due, then pop it (whole requests,
        up to ``max_batch`` lanes). Returns [] on shutdown."""
        with self._cv:
            while not self._queue:
                if self._closed:
                    return []
                self._cv.wait()
            # Deadline-driven formation: release when max_batch lanes
            # are waiting, or max_delay_s after the OLDEST request
            # enqueued — whichever first. New arrivals notify. (Only
            # this worker pops, so the queue cannot empty mid-wait.)
            due = self._queue[0].enq_t + self.max_delay_s
            while self._queued_lanes < self.max_batch and not self._closed:
                remaining = due - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            batch: list[_Pending] = []
            lanes = 0
            while self._queue:
                head = self._queue[0]
                if batch and lanes + len(head.items) > self.max_batch:
                    break
                self._queue.popleft()
                batch.append(head)
                lanes += len(head.items)
            self._queued_lanes -= lanes
            set_gauge("serve", "queue_lanes", value=float(self._queued_lanes))
        return batch

    def _worker(self) -> None:
        while True:
            batch = self._collect()
            if not batch:
                if self._closed:
                    return
                continue
            now = time.monotonic()
            live = []
            for p in batch:
                if p.deadline is not None and now > p.deadline:
                    incr_counter("serve", "deadline_expired")
                    p.error = DeadlineExceeded(
                        f"deadline passed {now - p.deadline:.3f}s before "
                        "the batch executed")
                    p.done.set()
                else:
                    live.append(p)
            if not live:
                continue
            flat = [it for p in live for it in p.items]
            # Single-context batches adopt the submitter's trace ids on
            # this worker thread, so serve.batch and everything the
            # oracle nests under it correlate with the client's request;
            # a coalesced batch spanning traces stays untagged (one span
            # cannot honestly belong to several traces).
            ctxs = {p.trace_ctx for p in live if p.trace_ctx is not None}
            only = ctxs.pop() if len(ctxs) == 1 else (None,)
            try:
                with trace.trace_context(*only), \
                        trace.span("serve.batch", cat="serve",
                                   lanes=len(flat), requests=len(live)):
                    results = self._run_batch(flat)
                if len(results) != len(flat):
                    raise RuntimeError(
                        f"oracle returned {len(results)} results for "
                        f"{len(flat)} items")
            except Exception as err:
                incr_counter("serve", "batch_errors")
                for p in live:
                    p.error = err
                    p.done.set()
                continue
            incr_counter("serve", "batches")
            add_sample("serve", "batch_lanes", value=float(len(flat)))
            pos = 0
            for p in live:
                p.result = list(results[pos : pos + len(p.items)])
                pos += len(p.items)
                p.done.set()
