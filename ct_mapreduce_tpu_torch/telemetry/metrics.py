"""Metrics: the counter/gauge half of ``ct_mapreduce_tpu.telemetry.metrics``.

A global-sink API in the style the reference emits through
(armon/go-metrics — counters and gauges with dotted key paths, reference
telemetry/telemetry.go:24-87). Metric names match the JAX package's,
so a dashboard keyed on them reads either package. Spans, samples and
the StatsD/stderr emitters are not ported yet.
"""

from __future__ import annotations

import threading
from collections import defaultdict


class InMemSink:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}

    def incr_counter(self, key: str, value: float) -> None:
        with self._lock:
            self.counters[key] += value

    def set_gauge(self, key: str, value: float) -> None:
        with self._lock:
            self.gauges[key] = value

    def snapshot(self) -> dict:
        with self._lock:
            return {"counters": dict(self.counters),
                    "gauges": dict(self.gauges)}

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()


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
