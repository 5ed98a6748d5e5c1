"""The port's entry point: config → aggregator → ingest → drain → save.

The counterpart of ``ct_mapreduce_tpu.models.ingest_model`` on one
device. Packed leaf rows take one of two lanes:

- the walker lane, the default (``preparsedIngest = false``): rows go
  to the device, where the walker kernel parses them, then the filters,
  the fingerprint kernel, the bucket-table insert and the per-issuer
  counts; the host folds the packed per-lane outputs;
- the pre-parsed lane (``preparsedIngest = true``): the native decoder
  extracts the fields on the host and the device step is fingerprint +
  insert + counts only.

Both give the same ``drain()``: what storage-statistics prints. With
``aggStatePath`` set, ``from_config`` restores the checkpoint there
when it exists and ``save()`` writes one (ck01 or a ck02 chain, per
``checkpointMode``); the files are the JAX package's format.
"""

from __future__ import annotations

import os
from datetime import datetime, timezone

import numpy as np

from ct_mapreduce_tpu_torch.agg.aggregator import (
    AggregateSnapshot, IngestResult, TorchAggregator)
from ct_mapreduce_tpu_torch.config import CTConfig
from ct_mapreduce_tpu_torch.native import leafpack


def build_aggregator(config: CTConfig, mesh=None,
                     device=None) -> TorchAggregator:
    """Single-device aggregator from config, on CUDA unless ``device``
    names another. The checkpoint knobs are pinned from the config's
    directives (unset ones resolve through env and defaults)."""
    if mesh is not None or config.mesh_shape:
        raise NotImplementedError(
            "more than one device is not ported yet (ROADMAP.md, queue 1, "
            "multi-GPU)")
    now = (
        datetime.fromtimestamp(0, tz=timezone.utc)
        if config.log_expired_entries
        else None
    )
    agg = TorchAggregator(
        capacity=1 << config.table_bits,
        batch_size=config.batch_size,
        cn_prefixes=tuple(config.issuer_cn_filters()),
        now=now,
        grow_at=config.table_grow_at,
        max_capacity=1 << config.table_max_bits,
        device=device,
    )
    agg.configure_checkpointing(
        mode=config.checkpoint_mode, max_chain=config.ckpt_max_chain,
        segment_budget_mb=config.ckpt_segment_budget_mb)
    return agg


class IngestModel:
    """Aggregator + checkpoint lifecycle, as one object."""

    def __init__(self, aggregator: TorchAggregator, preparsed: bool = False,
                 state_path: str = ""):
        self.aggregator = aggregator
        self.preparsed = preparsed
        self.state_path = state_path

    @classmethod
    def from_config(cls, config: CTConfig, mesh=None,
                    device=None) -> "IngestModel":
        agg = build_aggregator(config, mesh=mesh, device=device)
        model = cls(agg, preparsed=config.preparsed_ingest,
                    state_path=config.agg_state_path)
        if model.state_path and os.path.exists(model.state_path):
            agg.load_checkpoint(model.state_path)
        return model

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

    def save(self) -> None:
        if self.state_path:
            self.aggregator.save_checkpoint(self.state_path)
