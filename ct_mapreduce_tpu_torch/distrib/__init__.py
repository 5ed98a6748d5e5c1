"""Filter distribution plane (a port of ``ct_mapreduce_tpu.distrib``):
epoch deltas, upstream container encodings, and the CDN-grade store the
serve plane's ``/filter*`` routes publish from. Host code over the
port's :mod:`..filter` artifacts; every byte it writes equals the JAX
package's for the same artifacts.

- :mod:`ct_mapreduce_tpu_torch.distrib.delta` — the ``CTMRDL01``/``CTMRDL02``
  stash/diff artifact between consecutive epochs' ``CTMRFL01``/``CTMRFL02``
  bytes, the chain
  manifest, and the replay that is byte-identical to the full build.
- :mod:`ct_mapreduce_tpu_torch.distrib.container` — clubcard/mlbf-style
  container encodings emitted alongside the native format.
- :mod:`ct_mapreduce_tpu_torch.distrib.publish` — the per-worker
  :class:`FilterDistributor`: bounded epoch history, delta links with
  mandatory full-snapshot anchors, strong ETags, pre-compressed wire
  variants.

``resolve_distrib`` is the config surface: ``distribHistory`` /
``maxDeltaChain`` directives with ``CTMR_DISTRIB_HISTORY`` /
``CTMR_MAX_DELTA_CHAIN`` env equivalents, resolved through the
platformProfile ladder (``knobs.distrib``).
"""

from __future__ import annotations

from ct_mapreduce_tpu_torch.config import profile as platprofile
from ct_mapreduce_tpu_torch.distrib.container import (  # noqa: F401
    CONTAINER_KINDS,
    ContainerError,
    decode_container,
    encode_container,
)
from ct_mapreduce_tpu_torch.distrib.delta import (  # noqa: F401
    DEFAULT_MAX_CHAIN,
    ChainManifest,
    DeltaError,
    apply_chain,
    apply_delta,
    compute_delta,
    split_bundle,
)
from ct_mapreduce_tpu_torch.distrib.publish import (  # noqa: F401
    DEFAULT_HISTORY,
    FilterDistributor,
    negotiate_encoding,
    zstd_available,
)

_DISTRIB_KNOBS = (
    platprofile.Knob("distribHistory", "CTMR_DISTRIB_HISTORY",
                     DEFAULT_HISTORY, parse=int,
                     is_set=platprofile.pos_int,
                     post=lambda v: max(2, int(v))),
    platprofile.Knob("maxDeltaChain", "CTMR_MAX_DELTA_CHAIN",
                     DEFAULT_MAX_CHAIN, parse=int,
                     is_set=platprofile.pos_int,
                     post=lambda v: max(1, int(v))),
)


def resolve_distrib(history: int = 0,
                    max_chain: int = 0) -> tuple[int, int]:
    """Resolve the distribution knobs through the shared ladder:
    explicit value (config directive / kwarg) >
    ``CTMR_DISTRIB_HISTORY`` / ``CTMR_MAX_DELTA_CHAIN`` env >
    platformProfile ``knobs.distrib`` > defaults (8 epochs held; 4
    delta links before a mandatory full-snapshot anchor)."""
    r = platprofile.resolve_section("distrib", _DISTRIB_KNOBS, {
        "distribHistory": int(history or 0),
        "maxDeltaChain": int(max_chain or 0),
    })
    return r["distribHistory"], r["maxDeltaChain"]


__all__ = [
    "CONTAINER_KINDS",
    "DEFAULT_HISTORY",
    "DEFAULT_MAX_CHAIN",
    "ChainManifest",
    "ContainerError",
    "DeltaError",
    "FilterDistributor",
    "apply_chain",
    "apply_delta",
    "compute_delta",
    "decode_container",
    "encode_container",
    "negotiate_encoding",
    "resolve_distrib",
    "split_bundle",
    "zstd_available",
]
