"""Span tracing: the recording half of ``ct_mapreduce_tpu.telemetry.trace``.

A bounded ring of Chrome trace-event "complete" spans, written as JSON
on :func:`export`. Off by default: :func:`span` then returns a shared
no-op context manager, so an instrumented hot path costs one global
read. Instant events (``instant``) mark one-off moments such as a
stage failure; the flight recorder reads the ring through
``snapshot_events``. The span names are the JAX package's (``ingest.decode``,
``ingest.h2d``, ``device.step``, ``device.fold``, ...), so one trace
viewer reads either package's traces.

Cross-process correlation, as in the JAX package: a request thread
scopes a ``trace_id``/``parent_id`` pair with :class:`trace_context`
(usually parsed from a W3C-style ``traceparent`` header that the query
client mints with :func:`mint_traceparent`), and every span recorded on
that thread meanwhile carries it. Not copied: the JAX profiler
annotations, the fleet's process-wide attributes and the ``CTMR_TRACE``
switch at import time; call :func:`enable` instead.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

DEFAULT_RING = 1 << 16

# Per-thread trace context: (trace_id, parent_id) or absent.
_ctx = threading.local()


class trace_context:
    """Context manager scoping a (trace_id, parent_id) pair to the
    calling thread; restores the previous context on exit. A falsy
    ``trace_id`` makes it a no-op (so callers can pass a parse result
    straight through)."""

    __slots__ = ("_ids", "_prev")

    def __init__(self, trace_id: Optional[str],
                 parent_id: Optional[str] = None):
        self._ids = (trace_id, parent_id) if trace_id else None

    def __enter__(self):
        self._prev = getattr(_ctx, "ids", None)
        if self._ids is not None:
            _ctx.ids = self._ids
        return self

    def __exit__(self, *exc):
        _ctx.ids = self._prev
        return False


def get_trace_context() -> Optional[tuple]:
    """The calling thread's (trace_id, parent_id), or None."""
    return getattr(_ctx, "ids", None)


# Wire shape: "00-<32 hex trace_id>-<16 hex span_id>-01" (version and
# sampled flag fixed; only the two ids are meaningful here).
TRACEPARENT_HEADER = "traceparent"


def mint_traceparent() -> tuple[str, str, str]:
    """(header_value, trace_id, span_id) for a new client-side root."""
    trace_id, span_id = os.urandom(16).hex(), os.urandom(8).hex()
    return f"00-{trace_id}-{span_id}-01", trace_id, span_id


def parse_traceparent(header: Optional[str]) -> Optional[tuple]:
    """(trace_id, span_id) from a traceparent header, or None on any
    malformation: propagation must never reject a request."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(version, 16), int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def _tagged_args(args) -> Optional[dict]:
    """Span args merged with the calling thread's trace context
    (span-local args win)."""
    ids = getattr(_ctx, "ids", None)
    if ids is None:
        return dict(args) if args else None
    merged = {"trace_id": ids[0]}
    if ids[1]:
        merged["parent_id"] = ids[1]
    if args:
        merged.update(args)
    return merged


class _NullSpan:
    """Shared no-op context manager: the disabled-tracing fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span; records a complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._tracer._complete(self._name, self._cat, self._t0,
                               time.perf_counter_ns(), self._args)
        return False


class SpanTracer:
    def __init__(self, path: Optional[str] = None,
                 ring_size: int = DEFAULT_RING):
        self.path = path or None
        self.ring_size = max(16, int(ring_size))
        # deque.append is GIL-atomic: the hot path never takes a lock.
        self._events: deque = deque(maxlen=self.ring_size)
        self._t0_ns = time.perf_counter_ns()
        self._pid = os.getpid()
        self._threads_lock = threading.Lock()
        self._thread_names: dict[int, str] = {}

    def now_us(self) -> float:
        """Current timestamp on the tracer's own clock (µs since
        construction), for callers windowing :meth:`events`."""
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    def _tid(self) -> int:
        tid = threading.get_ident()
        if tid not in self._thread_names:
            with self._threads_lock:
                self._thread_names.setdefault(
                    tid, threading.current_thread().name)
        return tid

    def _complete(self, name: str, cat: str, t0_ns: int, t1_ns: int,
                  args) -> None:
        ev = {"name": name, "ph": "X", "ts": (t0_ns - self._t0_ns) / 1e3,
              "dur": max(t1_ns - t0_ns, 0) / 1e3, "pid": self._pid,
              "tid": self._tid()}
        if cat:
            ev["cat"] = cat
        tagged = _tagged_args(args)
        if tagged:
            ev["args"] = tagged
        self._events.append(ev)

    def span(self, name: str, cat: str = "", **args) -> _Span:
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "", **args) -> None:
        ev = {"name": name, "ph": "i", "s": "t",  # thread-scoped instant
              "ts": (time.perf_counter_ns() - self._t0_ns) / 1e3,
              "pid": self._pid, "tid": self._tid()}
        if cat:
            ev["cat"] = cat
        tagged = _tagged_args(args)
        if tagged:
            ev["args"] = tagged
        self._events.append(ev)

    def events(self) -> list[dict]:
        """Ring contents plus thread-name metadata, oldest first."""
        with self._threads_lock:
            meta = [{"name": "thread_name", "ph": "M", "pid": self._pid,
                     "tid": tid, "args": {"name": tname}}
                    for tid, tname in sorted(self._thread_names.items())]
        return meta + list(self._events)

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Write the Chrome trace JSON; returns the path (None when no
        path is known or the file cannot be written)."""
        path = path or self.path
        if not path:
            return None
        try:
            with open(path, "w") as fh:
                json.dump({"traceEvents": self.events(),
                           "displayTimeUnit": "ms"}, fh)
        except OSError:
            return None
        return path


_tracer: Optional[SpanTracer] = None


def enabled() -> bool:
    return _tracer is not None


def enable(path: Optional[str] = None,
           ring_size: int = DEFAULT_RING) -> SpanTracer:
    """Install the global tracer (re-enabling keeps the live ring and
    only updates its export path)."""
    global _tracer
    if _tracer is None:
        _tracer = SpanTracer(path=path, ring_size=ring_size)
    elif path:
        _tracer.path = path
    return _tracer


def disable() -> None:
    global _tracer
    _tracer = None


def span(name: str, cat: str = "", **args):
    """A span context manager; the shared no-op when tracing is off."""
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return t.span(name, cat, **args)


def instant(name: str, cat: str = "", **args) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, cat, **args)


def snapshot_events() -> list[dict]:
    """Current ring contents (for the flight recorder); [] when off."""
    t = _tracer
    return t.events() if t is not None else []


def export(path: Optional[str] = None) -> Optional[str]:
    t = _tracer
    return t.export(path) if t is not None else None
