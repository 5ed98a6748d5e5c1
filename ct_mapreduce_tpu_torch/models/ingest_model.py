"""The port's entry point: config → aggregator → ingest → drain.

The counterpart of ``ct_mapreduce_tpu.models.ingest_model`` on one
device. Packed leaf rows take one of two lanes:

- the walker lane, the default (``preparsedIngest = false``): rows go
  to the device, where the walker kernel parses them, then the filters,
  the fingerprint kernel, the bucket-table insert and the per-issuer
  counts; the host folds the packed per-lane outputs;
- the pre-parsed lane (``preparsedIngest = true``): the native decoder
  extracts the fields on the host and the device step is fingerprint +
  insert + counts only.

Both give the same ``drain()``: what storage-statistics prints.
"""

from __future__ import annotations

from datetime import datetime, timezone

import numpy as np

from ct_mapreduce_tpu_torch.agg.aggregator import (
    AggregateSnapshot, IngestResult, TorchAggregator)
from ct_mapreduce_tpu_torch.config import CTConfig
from ct_mapreduce_tpu_torch.native import leafpack


def build_aggregator(config: CTConfig, mesh=None,
                     device=None) -> TorchAggregator:
    """Single-device aggregator from config, on CUDA unless ``device``
    names another."""
    if mesh is not None or config.mesh_shape:
        raise NotImplementedError(
            "more than one device is not ported yet (ROADMAP.md, queue 1, "
            "multi-GPU)")
    now = (
        datetime.fromtimestamp(0, tz=timezone.utc)
        if config.log_expired_entries
        else None
    )
    return TorchAggregator(
        capacity=1 << config.table_bits,
        batch_size=config.batch_size,
        cn_prefixes=tuple(config.issuer_cn_filters()),
        now=now,
        grow_at=config.table_grow_at,
        max_capacity=1 << config.table_max_bits,
        device=device,
    )


class IngestModel:
    """Aggregator lifecycle, as one object."""

    def __init__(self, aggregator: TorchAggregator, preparsed: bool = False):
        self.aggregator = aggregator
        self.preparsed = preparsed

    @classmethod
    def from_config(cls, config: CTConfig, mesh=None,
                    device=None) -> "IngestModel":
        return cls(build_aggregator(config, mesh=mesh, device=device),
                   preparsed=config.preparsed_ingest)

    def ingest(self, entries: list[tuple[bytes, bytes]]) -> IngestResult:
        """(leaf_der, issuer_der) pairs through the walker lane."""
        return self.aggregator.ingest(entries)

    def ingest_packed(self, data: np.ndarray, length: np.ndarray,
                      issuer_idx: np.ndarray,
                      valid: np.ndarray) -> IngestResult:
        """One batch of packed leaf rows (``uint8[n, pad]`` DER, its
        ``int32[n]`` lengths, registry indices and validity) through the
        lane the config chose."""
        if not self.preparsed:
            return self.aggregator.ingest_packed(data, length, issuer_idx,
                                                 valid)
        sidecar = leafpack.extract_sidecars(data, length)
        if sidecar is None:
            raise RuntimeError(
                "the native sidecar decoder could not be built (no C++ "
                "compiler); the pre-parsed lane needs it")
        return self.aggregator.ingest_preparsed(
            sidecar, issuer_idx, valid, data, length)

    def drain(self) -> AggregateSnapshot:
        return self.aggregator.drain()
