"""The port's entry point: config → aggregator → ingest → drain → save.

The counterpart of ``ct_mapreduce_tpu.models.ingest_model``: a
:class:`TorchAggregator` on one device, or a ``ShardedAggregator`` over
a mesh of several (``meshShape``, or a ``mesh`` the caller builds with
``parallel.make_mesh``). Packed leaf rows take one of two lanes:

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

import math
import os
from datetime import datetime, timezone

import numpy as np

from ct_mapreduce_tpu_torch.agg.aggregator import (
    AggregateSnapshot, IngestResult, TorchAggregator)
from ct_mapreduce_tpu_torch.config import CTConfig
from ct_mapreduce_tpu_torch.native import leafpack
from ct_mapreduce_tpu_torch.parallel.mesh import (
    make_mesh, parse_mesh_shape, visible_devices)


def mesh_devices(config: CTConfig, device=None) -> int:
    """The devices ``meshShape`` asks for, as the JAX package resolves
    it: the fixed size of the shape, or with an empty shape (or a
    ``-1`` wildcard) every visible device. On the CPU (``device="cpu"``)
    one device is visible."""
    spec = parse_mesh_shape(config.mesh_shape)
    if -1 not in spec.axis_sizes:
        return spec.fixed_size
    return math.prod(spec.resolve(len(visible_devices(device))))


def build_aggregator(config: CTConfig, mesh=None,
                     device=None) -> TorchAggregator:
    """The aggregator from config, on CUDA unless ``device`` names
    another: a mesh of more than one device (``mesh``, or ``meshShape``
    over the visible devices) gets a :class:`ShardedAggregator`, a
    multi-axis mesh flattened to ``shard``; otherwise one device. The
    checkpoint knobs are pinned from the config's directives (unset ones
    resolve through env and defaults)."""
    now = (
        datetime.fromtimestamp(0, tz=timezone.utc)
        if config.log_expired_entries
        else None
    )
    common = dict(
        capacity=1 << config.table_bits,
        batch_size=config.batch_size,
        cn_prefixes=tuple(config.issuer_cn_filters()),
        now=now,
        grow_at=config.table_grow_at,
        max_capacity=1 << config.table_max_bits,
    )
    if mesh is None and mesh_devices(config, device) > 1:
        mesh = make_mesh(config.mesh_shape, visible_devices(device))
    if mesh is not None and mesh.size > 1:
        from ct_mapreduce_tpu_torch.agg.sharded import AXIS, mesh_capacity
        from ct_mapreduce_tpu_torch.agg.sharded_agg import ShardedAggregator

        # The dedup's table and batch sharding is 1-D: a multi-axis mesh
        # ("data:4,expert:2") is flattened over the same devices.
        if len(mesh.axis_names) != 1:
            mesh = mesh.flatten(AXIS)
        n = mesh.size
        # Capacity UP to a power-of-two unit a shard, the batch up to a
        # multiple of the mesh size.
        agg = ShardedAggregator(mesh, **{
            **common, "capacity": mesh_capacity(n, common["capacity"]),
            "batch_size": -(-common["batch_size"] // n) * n})
    else:
        if mesh is not None:  # a mesh of one device names it
            device = mesh.devices.flat[0]
        agg = TorchAggregator(**common, device=device)
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
