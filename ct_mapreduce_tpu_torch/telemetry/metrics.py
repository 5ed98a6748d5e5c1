"""Metrics: the in-memory half of ``ct_mapreduce_tpu.telemetry.metrics``.

A global-sink API in the style the reference emits through
(armon/go-metrics — counters, gauges and timing samples with dotted key
paths, reference telemetry/telemetry.go:24-87). Metric names match the
JAX package's, so a dashboard keyed on them reads either package. The
StatsD sink and the stderr dumper are not ported yet.
"""

from __future__ import annotations

import math
import threading
import time
from collections import defaultdict
from contextlib import contextmanager


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
            out = {"counters": dict(self.counters),
                   "gauges": dict(self.gauges), "samples": {}}
            for k, v in self.samples.items():
                if not v:
                    continue
                sv = sorted(v)
                out["samples"][k] = {
                    "count": len(v), "sum": sum(v), "min": sv[0],
                    "max": sv[-1], "mean": sum(v) / len(v),
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


_sink: InMemSink = InMemSink()


def set_sink(sink: InMemSink) -> None:
    """Install the global sink (tests swap in a fresh one)."""
    global _sink
    _sink = sink


def get_sink() -> InMemSink:
    return _sink


def _key(parts: tuple[str, ...]) -> str:
    return ".".join(parts)


def incr_counter(*parts: str, value: float = 1.0) -> None:
    _sink.incr_counter(_key(parts), value)


def set_gauge(*parts: str, value: float) -> None:
    _sink.set_gauge(_key(parts), value)


def add_sample(*parts: str, value: float) -> None:
    _sink.add_sample(_key(parts), value)


@contextmanager
def measure(*parts: str):
    """MeasureSince equivalent: time a block into a sample metric."""
    start = time.perf_counter()
    try:
        yield
    finally:
        add_sample(*parts, value=time.perf_counter() - start)
