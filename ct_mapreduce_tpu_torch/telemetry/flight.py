"""Crash flight recorder: post-mortem artifacts for wedged or dying
runs.

A deep-pipelined ingest engine that crashes (or gets SIGTERM'd by an
orchestrator) loses exactly the evidence needed to debug it: which
stage stalled, what the queue depths were, what the last chunks did.
The recorder keeps two rings in memory —

- the span tracer's event ring (:mod:`ct_mapreduce_tpu_torch.telemetry.trace`),
- the last N metric snapshots (fed by ``MetricsDumper`` ticks and by
  explicit :func:`record_snapshot` calls)

— and on demand (unhandled exception, SIGTERM/SIGUSR1, or the overlap
pipeline latching a stage failure) dumps both plus a fresh metric
snapshot to a timestamped JSON file. Dumping is best-effort and
re-entrant-safe: a recorder failure must never mask the crash it is
documenting.

Install points: ``cmd/ct_fetch.py`` installs at startup and dumps from
its own signal handlers / main-loop except clause (leaving no global
hooks behind on return), ``engine.prepare_telemetry`` feeds dumper
snapshots into the ring, and ``ingest/overlap.py`` dumps when a stage
failure latches (``OverlapError``). The optional ``signals=True`` /
``excepthook=True`` hooks are for long-lived embedders without their
own handlers. Everything is a no-op until :func:`install` runs, so
library users and tests see no files unless they opt in.

A copy of ``ct_mapreduce_tpu.telemetry.flight``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Optional

from ct_mapreduce_tpu_torch.telemetry import metrics as _metrics
from ct_mapreduce_tpu_torch.telemetry import trace as _trace

DEFAULT_SNAPSHOTS = 16


class FlightRecorder:
    def __init__(self, dir_path: str, max_snapshots: int = DEFAULT_SNAPSHOTS):
        self.dir = dir_path
        self._snaps: deque = deque(maxlen=max(1, int(max_snapshots)))
        self._lock = threading.Lock()
        self.dumps: list[str] = []  # paths written, oldest first

    def record_snapshot(self, snap: Optional[dict] = None) -> None:
        if snap is None:
            sink = _metrics.get_sink()
            take = getattr(sink, "snapshot", None)
            if take is None:
                return
            try:
                snap = take()
            except Exception:
                return
        self._snaps.append({"time": time.time(), "metrics": snap})

    def dump(self, reason: str) -> Optional[str]:
        """Write one post-mortem file; returns its path (None on any
        failure — never raises)."""
        try:
            ts = time.strftime("%Y%m%dT%H%M%S")
            path = os.path.join(
                self.dir, f"ctmr-flight-{ts}-{os.getpid()}.json")
            with self._lock:
                # A second dump in the same second (e.g. excepthook
                # after an overlap latch) appends a suffix, not a
                # clobber.
                if path in self.dumps:
                    path = os.path.join(
                        self.dir,
                        f"ctmr-flight-{ts}-{os.getpid()}-{len(self.dumps)}"
                        ".json")
                current = None
                sink = _metrics.get_sink()
                take = getattr(sink, "snapshot", None)
                if take is not None:
                    try:
                        current = take()
                    except Exception:
                        current = None
                doc = {
                    "reason": str(reason)[:2000],
                    "time": time.time(),
                    "pid": os.getpid(),
                    "trace_events": _trace.snapshot_events(),
                    "metric_snapshots": list(self._snaps),
                    "current_metrics": current,
                }
                # Registered extension sections (e.g. the lock
                # witness, analysis/witness.py): best-effort, a
                # provider failure must not lose the dump.
                for name, provider in list(_sections.items()):
                    try:
                        doc[name] = provider()
                    except Exception:
                        doc[name] = {"error": "section provider failed"}
                os.makedirs(self.dir, exist_ok=True)
                with open(path, "w") as fh:
                    json.dump(doc, fh)
                self.dumps.append(path)
            return path
        except Exception:
            return None


# -- module-level recorder (no-op until installed) ----------------------

_recorder: Optional[FlightRecorder] = None
_prev_excepthook = None
_prev_signals: dict[int, object] = {}

# Extension sections merged into every dump: name -> zero-arg provider
# returning a JSON-serializable value. The lock witness registers
# "lock_witness" here; others may follow.
_sections: dict[str, object] = {}


def register_section(name: str, provider) -> None:
    _sections[name] = provider


def unregister_section(name: str) -> None:
    _sections.pop(name, None)


def get_recorder() -> Optional[FlightRecorder]:
    return _recorder


def installed() -> bool:
    return _recorder is not None


def record_snapshot(snap: Optional[dict] = None) -> None:
    r = _recorder
    if r is not None:
        r.record_snapshot(snap)


def dump(reason: str) -> Optional[str]:
    r = _recorder
    return r.dump(reason) if r is not None else None


def _excepthook(exc_type, exc, tb):
    dump(f"unhandled exception: {exc_type.__name__}: {exc}")
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def _signal_handler(signum, frame):
    dump(f"signal {signum}")
    prev = _prev_signals.get(signum)
    if callable(prev):
        prev(signum, frame)
    elif prev == signal.SIG_DFL and signum == signal.SIGTERM:
        # Propagate the default fatal disposition after dumping.
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)
    # SIGUSR1 with no previous Python handler: dump-only, keep running
    # (the default action would kill the process we just documented).


def install(dir_path: Optional[str] = None,
            max_snapshots: int = DEFAULT_SNAPSHOTS,
            signals: bool = True,
            excepthook: bool = True) -> FlightRecorder:
    """Create the process-wide recorder (idempotent on the recorder;
    hooks install once). ``dir_path`` defaults to ``CTMR_FLIGHT_DIR``
    or the current directory."""
    global _recorder, _prev_excepthook
    if dir_path is None:
        dir_path = os.environ.get("CTMR_FLIGHT_DIR", "") or "."
    if _recorder is None:
        _recorder = FlightRecorder(dir_path, max_snapshots=max_snapshots)
    else:
        _recorder.dir = dir_path
    if excepthook and _prev_excepthook is None:
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
    if signals:
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            if sig in _prev_signals:
                continue
            try:
                _prev_signals[sig] = signal.getsignal(sig)
                signal.signal(sig, _signal_handler)
            except (ValueError, OSError):  # non-main thread / platform
                _prev_signals.pop(sig, None)
    return _recorder


def uninstall() -> None:
    """Remove the recorder and restore hooks (test hygiene)."""
    global _recorder, _prev_excepthook
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
    for sig, prev in list(_prev_signals.items()):
        try:
            signal.signal(sig, prev)
        except (ValueError, OSError, TypeError):
            pass
    _prev_signals.clear()
    _recorder = None
