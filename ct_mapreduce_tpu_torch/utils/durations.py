"""Go-style duration strings ("15m", "125ms", "2h45m") ↔ seconds.

The reference's config directives take Go time.ParseDuration strings
(reference config/config.go:191-199, e.g. savePeriod "15m",
outputRefreshPeriod "125ms"); we accept the same syntax.

A copy of ``ct_mapreduce_tpu.utils.durations``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import re

_UNITS = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
}

_TOKEN = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")


def parse_duration(s: str) -> float:
    """Parse a Go duration string to seconds. Raises ValueError on junk."""
    s = s.strip()
    if not s:
        raise ValueError("empty duration")
    neg = s.startswith("-")
    if neg or s.startswith("+"):
        s = s[1:]
    if s == "0":
        return 0.0
    total = 0.0
    pos = 0
    for m in _TOKEN.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration {s!r}")
        total += float(m.group(1)) * _UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"invalid duration {s!r}")
    return -total if neg else total


def format_duration(seconds: float) -> str:
    """Render seconds as a compact Go-style duration string."""
    if seconds == 0:
        return "0s"
    neg = seconds < 0
    seconds = abs(seconds)
    parts = []
    for unit, size in (("h", 3600.0), ("m", 60.0)):
        if seconds >= size:
            n = int(seconds // size)
            parts.append(f"{n}{unit}")
            seconds -= n * size
    if seconds >= 1:
        s = f"{seconds:.9f}".rstrip("0").rstrip(".")
        parts.append(f"{s}s")
    elif seconds > 0:
        ms = seconds * 1000
        s = f"{ms:.6f}".rstrip("0").rstrip(".")
        parts.append(f"{s}ms")
    elif not parts:
        parts.append("0s")
    return ("-" if neg else "") + "".join(parts)
