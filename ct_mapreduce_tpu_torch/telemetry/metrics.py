"""Metrics: a global-sink API in the style the reference emits through
(armon/go-metrics — counters, gauges, timing samples with dotted key
paths), with an in-memory sink periodically dumped to stderr and an
optional StatsD UDP sink. A copy of ``ct_mapreduce_tpu.telemetry.metrics``:
the port imports nothing of the JAX package.

Reference: reference telemetry/telemetry.go (MetricsDumper on a
ticker, :24-87) and reference engine/engine.go:50-86 (StatsD when
configured, else in-mem + dumper). Metric names are the JAX package's,
so a dashboard keyed on them reads either package.

Sink topology: the PRIMARY sink is always snapshot-capable (an
:class:`InMemSink`) so ``MetricsDumper`` and the flight recorder work
in every configuration; non-snapshot emitters (StatsD) ride as fanout
sinks. ``set_sink`` with a snapshot-less sink therefore installs a
fresh ``InMemSink`` as primary and demotes the argument to fanout.
"""

from __future__ import annotations

import atexit
import math
import socket
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Optional


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over an ascending list (non-empty)."""
    rank = max(1, math.ceil(q * len(sorted_vals)))
    return sorted_vals[rank - 1]


class InMemSink:
    SAMPLE_RING = 4096  # per-key sample bound on hot paths

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}
        self.samples: dict[str, list[float]] = defaultdict(list)

    def incr_counter(self, key: str, value: float) -> None:
        with self._lock:
            self.counters[key] += value

    def set_gauge(self, key: str, value: float) -> None:
        with self._lock:
            self.gauges[key] = value

    def add_sample(self, key: str, value: float) -> None:
        with self._lock:
            samples = self.samples[key]
            samples.append(value)
            if len(samples) > self.SAMPLE_RING:
                del samples[: len(samples) - self.SAMPLE_RING]

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "samples": {},
            }
            for k, v in self.samples.items():
                if not v:
                    continue
                sv = sorted(v)
                out["samples"][k] = {
                    "count": len(v),
                    "sum": sum(v),
                    "min": sv[0],
                    "max": sv[-1],
                    "mean": sum(v) / len(v),
                    # The tail is the number that matters for lock
                    # waits and per-entry decode cost; the mean hides
                    # it.
                    "p50": _percentile(sv, 0.50),
                    "p95": _percentile(sv, 0.95),
                    "p99": _percentile(sv, 0.99),
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.samples.clear()


class StatsdSink:
    """Minimal StatsD UDP emitter (engine.go:55-63 equivalent)."""

    def __init__(self, host: str, port: int, prefix: str = ""):
        self.addr = (host, port)
        self.prefix = prefix
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._closed = False

    def _send(self, payload: str) -> None:
        if self._closed:
            return
        try:
            self._sock.sendto(payload.encode("ascii"), self.addr)
        except OSError:
            pass  # metrics must never take down the pipeline

    def incr_counter(self, key: str, value: float) -> None:
        self._send(f"{self.prefix}{key}:{value}|c")

    def set_gauge(self, key: str, value: float) -> None:
        self._send(f"{self.prefix}{key}:{value}|g")

    def add_sample(self, key: str, value: float) -> None:
        self._send(f"{self.prefix}{key}:{value * 1000:.3f}|ms")

    def close(self) -> None:
        """Release the UDP socket; emits become no-ops. Called when
        the sink is replaced via ``set_sink`` and at interpreter
        exit."""
        if not self._closed:
            self._closed = True
            try:
                self._sock.close()
            except OSError:
                pass


# -- global sink (go-metrics style) -------------------------------------

_sink: InMemSink = InMemSink()
_fanout: list = []


def set_sink(sink, *extra) -> None:
    """Install the global sink. Snapshot-capable sinks become the
    primary; snapshot-less ones (StatsD) are demoted to fanout behind
    a fresh ``InMemSink`` so ``get_sink().snapshot()`` always works.
    Replaced sinks that own resources (``close()``) are closed —
    except ones that remain installed (the save/restore pattern swaps
    InMemSinks, which own nothing)."""
    global _sink, _fanout
    old = [_sink, *_fanout]
    if hasattr(sink, "snapshot"):
        _sink = sink
        _fanout = list(extra)
    else:
        _sink = InMemSink()
        _fanout = [sink, *extra]
    current = [_sink, *_fanout]
    for s in old:
        if s not in current and hasattr(s, "close"):
            try:
                s.close()
            except Exception:
                pass


def get_sink() -> InMemSink:
    """The primary (always snapshot-capable) sink."""
    return _sink


def get_fanout() -> list:
    return list(_fanout)


@atexit.register
def _close_sinks_at_exit() -> None:
    for s in (_sink, *_fanout):
        if hasattr(s, "close"):
            try:
                s.close()
            except Exception:
                pass


def _key(parts: tuple[str, ...]) -> str:
    return ".".join(parts)


def incr_counter(*parts: str, value: float = 1.0) -> None:
    _sink.incr_counter(_key(parts), value)
    for s in _fanout:
        s.incr_counter(_key(parts), value)


def set_gauge(*parts: str, value: float) -> None:
    _sink.set_gauge(_key(parts), value)
    for s in _fanout:
        s.set_gauge(_key(parts), value)


def add_sample(*parts: str, value: float) -> None:
    _sink.add_sample(_key(parts), value)
    for s in _fanout:
        s.add_sample(_key(parts), value)


@contextmanager
def measure(*parts: str):
    """MeasureSince equivalent: time a block into a sample metric."""
    start = time.perf_counter()
    try:
        yield
    finally:
        add_sample(*parts, value=time.perf_counter() - start)


class MetricsDumper:
    """Periodic dump of in-mem metrics to stderr on a background thread
    (telemetry/telemetry.go:37-87). ``on_snapshot`` (if given) receives
    every dumped snapshot — the flight recorder's feed."""

    def __init__(self, sink: InMemSink, period_s: float, out=None,
                 on_snapshot=None):
        self.sink = sink
        self.period_s = period_s
        self.out = out if out is not None else sys.stderr
        self.on_snapshot = on_snapshot
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="metrics-dumper", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            self.dump()

    def dump(self) -> None:
        snap = self.sink.snapshot()
        if self.on_snapshot is not None:
            try:
                self.on_snapshot(snap)
            except Exception:
                pass  # a recorder failure must not kill the dumper
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        lines = [f"[{ts}] metrics:"]
        for k, v in sorted(snap["gauges"].items()):
            lines.append(f"  [G] {k}: {v}")
        for k, v in sorted(snap["counters"].items()):
            lines.append(f"  [C] {k}: {v}")
        for k, s in sorted(snap["samples"].items()):
            lines.append(
                f"  [S] {k}: count={s['count']} mean={s['mean']:.6f}s "
                f"p50={s['p50']:.6f}s p95={s['p95']:.6f}s "
                f"p99={s['p99']:.6f}s min={s['min']:.6f}s "
                f"max={s['max']:.6f}s"
            )
        try:
            print("\n".join(lines), file=self.out, flush=True)
        except (ValueError, OSError):
            # The sink stream can already be closed when a dump races
            # interpreter (or pytest capture) teardown — losing one
            # periodic stats dump there is fine; crashing the dumper
            # thread with an unraisable exception is not.
            pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
