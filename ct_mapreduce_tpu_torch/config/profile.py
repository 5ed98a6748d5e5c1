"""platformProfile: tuned knobs as data files, one loader for every
subsystem's knobs (a copy of ``ct_mapreduce_tpu.config.profile``).

Every knob resolves through the same four-layer ladder:

    explicit (config directive / kwarg)
      > CTMR_* env var
        > platform profile (this module)
          > built-in default

A profile is a JSON file named by the ``CTMR_PLATFORM_PROFILE`` env var
(the ``platformProfile`` directive comes with the CLI slice):

.. code-block:: json

    {"version": 1,
     "knobs": {"staging": {"chunksPerDispatch": 8, "stagingDepth": 3},
               "ckpt":    {"checkpointMode": "ck02"}}}

Knob names inside a section are the directive spellings. Unknown
sections and knobs are ignored; an unreadable profile warns once and
resolves as if absent.

Where this copy departs from the JAX module: the ``"fingerprint"`` a
profile may carry is matched against this host's identity as PyTorch
sees it (:func:`current_fingerprint`: ``torch_backend``, the CUDA
device name and count, host cores) instead of ``jax.devices()``. A
profile written by the JAX package's tuner carries ``jax_backend`` and
a TPU ``device_kind``; its ``device_kind`` never equals a CUDA device
name, so such a profile is rejected here (warned once) and every knob
falls to its env var and default. The loader tolerates and ignores a
``"provenance"`` block, as the JAX one does.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass
from typing import Any, Callable, Optional

PROFILE_VERSION = 1

# Loaded profiles cache by path; a failed load caches the failure so
# the warning prints once per path, not once per knob.
_cache: dict[str, Optional[dict]] = {}


_active_path: Optional[str] = None


def set_active_profile(path: Optional[str]) -> None:
    """Pin the active profile path (ct-fetch calls this with the
    ``platformProfile`` directive before building any subsystem).
    ``None``/empty falls back to the CTMR_PLATFORM_PROFILE env."""
    global _active_path
    _active_path = path or None


def active_profile_path() -> str:
    return _active_path or os.environ.get("CTMR_PLATFORM_PROFILE", "")


def current_fingerprint() -> dict:
    """This host's platform identity, the key a tuned profile is
    matched against: the torch backend (``cuda`` or ``cpu``), the first
    CUDA device's name, the CUDA device count and the host cores.
    Reading it initialises no device memory."""
    import torch

    fp: dict = {"host_cores": os.cpu_count() or 1}
    if torch.cuda.is_available():
        fp["torch_backend"] = "cuda"
        fp["device_kind"] = torch.cuda.get_device_name(0)
        fp["device_count"] = torch.cuda.device_count()
    else:
        fp["torch_backend"] = "cpu"
        fp["device_kind"] = "cpu"
        fp["device_count"] = 0
    return fp


def fingerprint_matches(profile_fp: dict,
                        current_fp: Optional[dict] = None) -> bool:
    """True when the profile's fingerprint agrees with this host on
    every key BOTH sides carry. An empty/absent fingerprint matches
    everything."""
    if not isinstance(profile_fp, dict) or not profile_fp:
        return True
    cur = current_fingerprint() if current_fp is None else current_fp
    return all(profile_fp[k] == cur[k] for k in profile_fp if k in cur)


def load_profile(path: str) -> Optional[dict]:
    """Parse + validate one profile file; None (with a one-time
    warning) when unreadable or measured on another platform — a bad
    profile never kills a run."""
    cached = _cache.get(path, False)
    if cached is not False:
        return cached
    prof: Optional[dict] = None
    try:
        with open(path) as fh:
            data = json.load(fh)
        if not isinstance(data, dict) or not isinstance(
                data.get("knobs", {}), dict):
            raise ValueError("profile must be a JSON object with a "
                             "'knobs' object")
        if data.get("version", PROFILE_VERSION) != PROFILE_VERSION:
            raise ValueError(f"unsupported profile version "
                             f"{data.get('version')!r}")
        fp = data.get("fingerprint")
        if fp is not None and not isinstance(fp, dict):
            raise ValueError("'fingerprint' must be a JSON object")
        if fp and not fingerprint_matches(fp):
            raise ValueError(
                f"platform fingerprint mismatch: profile measured on "
                f"{fp!r}, this host is {current_fingerprint()!r}")
        prov = data.get("provenance")
        if prov is not None and not isinstance(prov, dict):
            raise ValueError("'provenance' must be a JSON object")
        prof = data
    except (OSError, ValueError) as err:
        print(f"platformProfile ignored ({path}): {err}", file=sys.stderr)
    _cache[path] = prof
    return prof


def profile_value(section: str, name: str) -> Any:
    """The active profile's value for one knob, or None."""
    path = active_profile_path()
    if not path:
        return None
    prof = load_profile(path)
    if not prof:
        return None
    sec = prof.get("knobs", {}).get(section)
    if not isinstance(sec, dict):
        return None
    return sec.get(name)


# -- the knob engine ------------------------------------------------------


def _default_is_set(v: Any) -> bool:
    return v is not None


@dataclass(frozen=True)
class Knob:
    """One tunable: its directive-spelled name, env var, default, and
    the per-layer semantics that differ knob to knob."""

    name: str
    env: str = ""
    default: Any = None
    # env string -> typed value; raising means "unparseable, ignored".
    parse: Callable[[str], Any] = int
    # Explicit/profile values count only when is_set says so (e.g. 0 =
    # unset for positive-int knobs).
    is_set: Callable[[Any], bool] = _default_is_set
    # Parsed env values get their own test when the env layer's unset
    # convention differs (None = same as is_set).
    env_is_set: Optional[Callable[[Any], bool]] = None
    # Final clamp/normalization applied to whichever layer won.
    post: Optional[Callable[[Any], Any]] = None


def _resolve_knob(section: str, knob: Knob, explicit: dict) -> Any:
    """One knob through the four-layer ladder (before ``post``)."""
    ev = explicit.get(knob.name)
    if ev is not None and knob.is_set(ev):
        return ev
    if knob.env:
        raw = os.environ.get(knob.env, "")
        if raw:
            try:
                parsed = knob.parse(raw)
            except (TypeError, ValueError):
                parsed = None
            test = knob.env_is_set or knob.is_set
            if parsed is not None and test(parsed):
                return parsed
    pv = profile_value(section, knob.name)
    if pv is not None and knob.is_set(pv):
        return pv
    return knob.default


def resolve_section(section: str, knobs: tuple, explicit: dict) -> dict:
    """Run the four-layer ladder for every knob of one section.
    ``explicit`` maps knob names to directive/kwarg values (typed)."""
    out = {}
    for knob in knobs:
        value = _resolve_knob(section, knob, explicit)
        if knob.post is not None:
            value = knob.post(value)
        out[knob.name] = value
    return out


def pos_int(v: Any) -> bool:
    """Positive-int knobs: 0 (and below) means "unset"."""
    try:
        return int(v) > 0
    except (TypeError, ValueError):
        return False


def nonneg_int(v: Any) -> bool:
    """Sentinel-int knobs: -1 means "unset", 0 is a real value."""
    try:
        return int(v) >= 0
    except (TypeError, ValueError):
        return False


def nonzero_int(v: Any) -> bool:
    """Knobs where negative values are meaningful (e.g. -1 disables a
    cache): only exactly 0 means "unset"."""
    try:
        return int(v) != 0
    except (TypeError, ValueError):
        return False


def nonempty_str(v: Any) -> bool:
    return isinstance(v, str) and bool(v)


def pos_float(v: Any) -> bool:
    try:
        return float(v) > 0
    except (TypeError, ValueError):
        return False


def parse_bool_lenient(raw: str) -> bool:
    """The serve-plane convention: anything but an explicit false
    spelling is true."""
    return raw.strip().lower() not in ("0", "f", "false")


def parse_bool_strict(raw: str) -> bool:
    """The emit-style convention: only explicit true spellings are
    true."""
    return raw.strip().lower() in ("1", "t", "true")


def any_set(_v: Any) -> bool:
    """env_is_set for bool knobs: a present, parseable env var always
    decides (False included)."""
    return True
