"""Merging per-worker fleet aggregates into one reduce view (a copy of
``ct_mapreduce_tpu.agg.merge``).

A multi-worker ingest fleet leaves one aggregate checkpoint per worker.
Each worker's own :meth:`drain` already resolves its internal
host/device dedup overlap, so the fleet-level merge is the reduce-side
union over those drained snapshots: per-(issuer, expDate) serial
counts sum, per-issuer CRL/DN metadata and host-lane serial bytes
set-union, verify verdict counts sum, and the workers' filter captures
set-union into ``filter_serials``, the seed of the merged filter
artifact (``filter/artifact.py::build_from_merged``).

Honest limit (as in the JAX package): a certificate cross-logged into
two logs owned by different workers counts once per owning worker.

Where this copy departs from the JAX module: each checkpoint is read
through :class:`SnapshotReader`, a ``TorchAggregator`` on the CPU,
named explicitly, instead of the JAX package's
``HostSnapshotAggregator``. A report needs no card, so the CPU here is
the reader's chosen device, not a fallback. The reader takes the
snapshots that class takes (either layout, ck02 chains on a bucket
table) and refuses the two it refuses.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ct_mapreduce_tpu_torch.agg.aggregator import (
    AggregateSnapshot,
    IssuerRegistry,
    TorchAggregator,
)
from ct_mapreduce_tpu_torch.ops import buckettable


class SnapshotReader(TorchAggregator):
    """A CPU aggregator that reads checkpoints for a report and refuses
    what the JAX package's ``HostSnapshotAggregator`` refuses: re-hashing
    a topology-mismatched snapshot into an open-layout table, and
    replaying a ck02 chain onto an open-layout base."""

    def __init__(self) -> None:
        super().__init__(capacity=1 << 10, device="cpu")

    def _bulk_reinsert(self, keys: np.ndarray, meta: np.ndarray) -> int:
        if not isinstance(self.table, buckettable.BucketTable):
            raise RuntimeError(
                "host-only restore of a topology-mismatched open-layout "
                "snapshot is not supported; restore through a device "
                "aggregator (TorchAggregator) instead")
        return super()._bulk_reinsert(keys, meta)

    def _chain_insert(self, keys: np.ndarray, meta: np.ndarray) -> int:
        if not isinstance(self.table, buckettable.BucketTable):
            raise RuntimeError(
                "host-only chain replay needs the bucket layout; "
                "restore through TorchAggregator")
        return super()._chain_insert(keys, meta)


def expand_state_paths(spec: str) -> list[str]:
    """``aggStatePath`` → concrete snapshot paths: comma-separated
    entries, each optionally a glob (``agg.w*.npz``). Non-glob entries
    pass through even when absent (the caller reports the miss); glob
    entries expand to what exists, sorted."""
    paths: list[str] = []
    for part in (p.strip() for p in spec.split(",")):
        if not part:
            continue
        if any(ch in part for ch in "*?["):
            paths.extend(sorted(glob.glob(part)))
        else:
            paths.append(part)
    return paths


def merge_snapshots(snaps) -> AggregateSnapshot:
    """Reduce-side union of drained per-worker snapshots: counter sum
    + metadata set-union, folded in sorted order so the merged dicts'
    order is a function of their content."""
    counts: dict[tuple[str, str], int] = {}
    crls: dict[str, set[str]] = {}
    dns: dict[str, set[str]] = {}
    verified: dict[str, int] = {}
    failed: dict[str, int] = {}
    for snap in snaps:
        for key, n in sorted(snap.counts.items()):
            counts[key] = counts.get(key, 0) + n
        for iss, urls in sorted(snap.crls.items()):
            crls.setdefault(iss, set()).update(urls)
        for iss, names in sorted(snap.dns.items()):
            dns.setdefault(iss, set()).update(names)
        for iss, n in sorted(snap.verified.items()):
            verified[iss] = verified.get(iss, 0) + n
        for iss, n in sorted(snap.failed.items()):
            failed[iss] = failed.get(iss, 0) + n
    return AggregateSnapshot(
        counts=counts, crls=crls, dns=dns, total=sum(counts.values()),
        verified=verified, failed=failed)


class MergedAggregate:
    """A fleet's worth of worker checkpoints through the surface
    ``storage-statistics`` reads from a single aggregator: ``drain()``
    (the merged snapshot), ``registry`` (union issuer indexing) and
    ``host_serials`` (worker-local indices remapped into it, serial
    byte-sets unioned), plus the merged filter capture
    (``filter_serials``) and the checkpoints that had none
    (``capture_missing``)."""

    def __init__(self) -> None:
        self.registry = IssuerRegistry()
        self.host_serials: dict[tuple[int, int], set[bytes]] = {}
        # The union of the workers' filter captures, remapped to the
        # merged issuer indexing.
        self.filter_serials: dict[tuple[int, int], set[bytes]] = {}
        # Checkpoints folded without a capture: a filter built over them
        # would silently miss their device-lane serials, so the builder
        # refuses unless told otherwise.
        self.capture_missing: list[str] = []
        self._snapshots: list[AggregateSnapshot] = []
        self.worker_paths: list[str] = []

    def fold_checkpoint(self, path: str) -> None:
        """Load one worker's checkpoint on the CPU, drain it through the
        worker's own exact fold path, and union the results in."""
        agg = SnapshotReader()
        agg.load_checkpoint(path)
        self._snapshots.append(agg.drain())
        self.worker_paths.append(path)
        remap = {
            idx: self.registry.assign_issuer(agg.registry.issuer_at(idx))
            for idx in range(len(agg.registry))
        }
        for (idx, eh), serials in sorted(agg.host_serials.items()):
            key = (remap[idx], eh)
            self.host_serials.setdefault(key, set()).update(serials)
        if agg.filter_capture is None:
            self.capture_missing.append(path)
        else:
            for (idx, eh), serials in sorted(agg.filter_capture.items()):
                key = (remap[idx], eh)
                self.filter_serials.setdefault(key, set()).update(serials)

    def drain(self) -> AggregateSnapshot:
        return merge_snapshots(self._snapshots)


def load_checkpoints(paths) -> MergedAggregate:
    """Fold every worker checkpoint into one merged view."""
    merged = MergedAggregate()
    for path in paths:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        merged.fold_checkpoint(path)
    return merged
