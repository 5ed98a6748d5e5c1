"""Carry aggregation state between the JAX package and the port.

Both packages hold the dedup table in the same layout — bucket rows of
24 slots x 5 words with the fill count in word 120 — and name issuers
by the same id strings, so state moves as plain NumPy arrays and JSON:
``np.asarray(jax_aggregator.table.rows)`` and
``IssuerRegistry.to_json()`` on one side, the functions below on the
other.
"""

from __future__ import annotations

import numpy as np
import torch

from ct_mapreduce_tpu_torch.agg.aggregator import IssuerRegistry
from ct_mapreduce_tpu_torch.device import resolve_device
from ct_mapreduce_tpu_torch.ops import buckettable


def table_from_numpy(rows: np.ndarray, count: int,
                     device=None) -> buckettable.BucketTable:
    """The port's table from ``uint32[n_buckets, 128]`` bucket rows and
    the occupied-slot count. The fill word is recomputed from slot
    occupancy, so rows built on the host need not carry it."""
    rows = np.asarray(rows)
    if rows.dtype != np.uint32 or rows.ndim != 2 \
            or rows.shape[1] != buckettable.ROW_WORDS:
        raise ValueError(
            f"want uint32[n_buckets, {buckettable.ROW_WORDS}] rows, got "
            f"{rows.dtype}{list(rows.shape)}")
    nb = rows.shape[0]
    if nb < 1 or nb & (nb - 1):
        raise ValueError(f"bucket count {nb} is not a power of two")
    rows = rows.copy()
    buckettable.fill_counts_np(rows)
    dev = resolve_device(device)
    return buckettable.BucketTable(
        rows=torch.from_numpy(rows.view(np.int32)).to(dev),
        count=torch.tensor(int(count), dtype=torch.int64, device=dev),
    )


def table_to_numpy(table: buckettable.BucketTable) -> tuple[np.ndarray, int]:
    """``(rows uint32[n_buckets, 128], count)`` on the host."""
    return buckettable.host_rows(table).copy(), int(table.count)


def registry_from_json(raw: str) -> IssuerRegistry:
    """Registry from the JAX package's ``IssuerRegistry.to_json()``."""
    return IssuerRegistry.from_json(raw)


def registry_to_json(registry: IssuerRegistry) -> str:
    """Byte-compatible with the JAX package's ``IssuerRegistry.to_json``."""
    return registry.to_json()
