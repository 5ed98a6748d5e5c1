"""Span tracing: the recording half of ``ct_mapreduce_tpu.telemetry.trace``.

A bounded ring of Chrome trace-event "complete" spans, written as JSON
on :func:`export`. Off by default: :func:`span` then returns a shared
no-op context manager, so an instrumented hot path costs one global
read. Instant events (``instant``) mark one-off moments such as a
stage failure; the flight recorder reads the ring through
``snapshot_events``. The span names are the JAX package's (``ingest.decode``,
``ingest.h2d``, ``device.step``, ``device.fold``, ...), so one trace
viewer reads either package's traces. Not copied: the JAX profiler
annotations, the fleet trace context and the ``CTMR_TRACE`` switch at
import time; call :func:`enable` instead.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

DEFAULT_RING = 1 << 16


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
        if args:
            ev["args"] = dict(args)
        self._events.append(ev)

    def span(self, name: str, cat: str = "", **args) -> _Span:
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "", **args) -> None:
        ev = {"name": name, "ph": "i", "s": "t",  # thread-scoped instant
              "ts": (time.perf_counter_ns() - self._t0_ns) / 1e3,
              "pid": self._pid, "tid": self._tid()}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = dict(args)
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
