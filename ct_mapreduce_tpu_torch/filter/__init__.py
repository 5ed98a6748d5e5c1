"""Filter emission: crlite-style compact revocation-filter artifacts
compiled from the aggregation state (port of ``ct_mapreduce_tpu.filter``).

- :mod:`~ct_mapreduce_tpu_torch.filter.cascade` — the Bloom
  filter-cascade primitive (exact membership over the observed
  universe; layers scattered by K5 on the card, or in a NumPy lane).
- :mod:`~ct_mapreduce_tpu_torch.filter.stream` and
  :mod:`~ct_mapreduce_tpu_torch.filter.fused` — streamed canonical keys
  (K1) and the fused multi-group layer rounds.
- :mod:`~ct_mapreduce_tpu_torch.filter.artifact` — canonical keys, the
  versioned on-disk formats ``CTMRFL01``/``CTMRFL02`` (byte for byte the
  JAX package's), and the builders over live aggregators and merged
  checkpoints.

``resolve_filter`` is the config surface: ``emitFilter`` /
``filterPath`` / ``filterFpRate`` directives with ``CTMR_EMIT_FILTER``
/ ``CTMR_FILTER_PATH`` / ``CTMR_FILTER_FP_RATE`` env equivalents.
"""

from __future__ import annotations

from typing import NamedTuple

from ct_mapreduce_tpu_torch.config import profile as platprofile
from ct_mapreduce_tpu_torch.filter.artifact import (  # noqa: F401
    DEFAULT_FP_RATE,
    FORMAT_FL01,
    FORMAT_FL02,
    FilterArtifact,
    build_artifact,
    build_artifact_from_sources,
    build_from_aggregator,
    build_from_merged,
    canonical_keys,
    default_format,
    normalize_format,
    read_artifact,
    write_artifact,
)
from ct_mapreduce_tpu_torch.filter.cache import (  # noqa: F401
    GroupBuildCache,
    content_token,
)
from ct_mapreduce_tpu_torch.filter.cascade import (  # noqa: F401
    BloomLayer,
    FilterCascade,
)
from ct_mapreduce_tpu_torch.filter.spill import SpillCaptureRing  # noqa: F401
from ct_mapreduce_tpu_torch.filter.stream import (  # noqa: F401
    ListGroupSource,
    PackedGroupSource,
)


_FILTER_KNOBS = (
    platprofile.Knob("emitFilter", "CTMR_EMIT_FILTER", False,
                     parse=platprofile.parse_bool_strict,
                     env_is_set=platprofile.any_set, post=bool),
    platprofile.Knob("filterPath", "CTMR_FILTER_PATH", "",
                     parse=str, is_set=platprofile.nonempty_str),
    platprofile.Knob("filterFpRate", "CTMR_FILTER_FP_RATE",
                     DEFAULT_FP_RATE, parse=float,
                     is_set=platprofile.pos_float,
                     post=lambda v: float(v)),
    # Round 19 — scaled builds: capture spill ring + streamed/fused
    # build shapes. 0/empty = built-in defaults (spill off).
    platprofile.Knob("filterCaptureSpillDir", "CTMR_FILTER_SPILL_DIR",
                     "", parse=str, is_set=platprofile.nonempty_str),
    platprofile.Knob("filterCaptureSpillMB", "CTMR_FILTER_SPILL_MB",
                     256, parse=int, is_set=platprofile.pos_int,
                     post=int),
    platprofile.Knob("filterStreamChunk", "CTMR_FILTER_STREAM_CHUNK",
                     0, parse=int, is_set=platprofile.pos_int,
                     post=int),
    platprofile.Knob("filterFusedLanes", "CTMR_FILTER_FUSED_LANES",
                     0, parse=int, is_set=platprofile.pos_int,
                     post=int),
    # Round 20 — artifact format: fl02 (per-group universes,
    # decoupled deltas, incremental rebuilds) is the default;
    # fl01 is the compatibility path. normalize_format raises on
    # junk, so a bad env value is ignored by the ladder and a bad
    # explicit/profile value fails loudly.
    platprofile.Knob("filterFormat", "CTMR_FILTER_FORMAT",
                     FORMAT_FL02, parse=normalize_format,
                     is_set=platprofile.nonempty_str,
                     post=normalize_format),
)


class FilterKnobs(NamedTuple):
    emit: bool
    path: str
    fp_rate: float
    spill_dir: str
    spill_mb: int
    stream_chunk: int  # 0 = stream.DEFAULT_STREAM_CHUNK
    fused_lanes: int  # 0 = fused.DEFAULT_MAX_LANES
    fmt: str = FORMAT_FL02  # artifact format ("fl01" | "fl02")


def resolve_filter(emit=None, path: str = "", fp_rate: float = 0.0,
                   state_path: str = "", spill_dir: str = "",
                   spill_mb: int = 0, stream_chunk: int = 0,
                   fused_lanes: int = 0, fmt: str = "") -> FilterKnobs:
    """Resolve the filter knobs through the shared platformProfile
    ladder (config/profile.py): explicit value (config directive /
    kwarg) > ``CTMR_EMIT_FILTER`` / ``CTMR_FILTER_PATH`` /
    ``CTMR_FILTER_FP_RATE`` / ``CTMR_FILTER_SPILL_DIR`` /
    ``CTMR_FILTER_SPILL_MB`` / ``CTMR_FILTER_STREAM_CHUNK`` /
    ``CTMR_FILTER_FUSED_LANES`` env > profile ``knobs.filter`` >
    defaults (off; ``<aggStatePath>.filter``; 0.01 target FP rate;
    spill off with a 256 MB memory tier; built-in stream/fused
    shapes; ``filterFormat`` / ``CTMR_FILTER_FORMAT`` → fl02).
    Unparseable env values are ignored, matching the config layer's
    tolerance."""
    r = platprofile.resolve_section("filter", _FILTER_KNOBS, {
        "emitFilter": emit,
        "filterPath": path or "",
        "filterFpRate": float(fp_rate or 0.0),
        "filterCaptureSpillDir": spill_dir or "",
        "filterCaptureSpillMB": int(spill_mb or 0),
        "filterStreamChunk": int(stream_chunk or 0),
        "filterFusedLanes": int(fused_lanes or 0),
        "filterFormat": fmt or "",
    })
    p = r["filterPath"]
    if not p and state_path:
        p = state_path + ".filter"
    return FilterKnobs(
        emit=r["emitFilter"], path=p, fp_rate=r["filterFpRate"],
        spill_dir=r["filterCaptureSpillDir"],
        spill_mb=r["filterCaptureSpillMB"],
        stream_chunk=r["filterStreamChunk"],
        fused_lanes=r["filterFusedLanes"],
        fmt=r["filterFormat"])


__all__ = [
    "DEFAULT_FP_RATE",
    "FORMAT_FL01",
    "FORMAT_FL02",
    "BloomLayer",
    "FilterArtifact",
    "FilterCascade",
    "FilterKnobs",
    "GroupBuildCache",
    "ListGroupSource",
    "PackedGroupSource",
    "SpillCaptureRing",
    "build_artifact",
    "build_artifact_from_sources",
    "build_from_aggregator",
    "build_from_merged",
    "canonical_keys",
    "content_token",
    "default_format",
    "normalize_format",
    "read_artifact",
    "resolve_filter",
    "write_artifact",
]
