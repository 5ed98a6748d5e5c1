"""The device reduce state and its exact host fallback lane (port of
``ct_mapreduce_tpu.agg.aggregator`` for one device).

:class:`TorchAggregator` replaces the Redis-resident reduce state of
the reference (serial dedup sets, per-issuer CRL/DN sets, reference
storage/knowncertificates.go, storage/issuermetadata.go) with:

- a device-resident dedup table, in the bucket layout
  (:mod:`..ops.buckettable`, the default) or the open-addressing one
  (:mod:`..ops.hashtable`, ``CTMR_TABLE=open``), driven by the walker
  step or the pre-parsed step (:mod:`..ops.pipeline`),
- a host-side issuer registry mapping SHA-256(SPKI) identities to the
  dense indices the device ops use,
- host-side CRL/DN string sets fed by the walker's (or the sidecar's)
  byte windows,
- an **exact host lane** for every lane the device cannot take exactly
  (walker reject / oversized serial / meta range / boundary hour /
  undecidable CN prefix / probe overflow), preserving the reference's
  per-entry tolerance contract (reference cmd/ct-fetch/ct-fetch.go:
  206-225).

Exactness across the two dedup domains rests on the same cross-domain
guards as the JAX package: the host lane probes device membership
before counting (`_device_known_flags`), the device fold checks the
host sets on unknown lanes (`_consume_out`, `_fold_preparsed`), and
`drain()` subtracts the host∩device overlap in one batched probe.

Checkpoints are the JAX package's, file for file: a ck01 ``.npz``
base (``_write_npz``: the same field names, dtypes and sorted JSON) and
CTMRCK02 delta segments (:mod:`.ckpt`), so either package loads the
other's. The fold paths feed the same dirty log (``_ckpt_record_row``,
``_ckpt_record_host``), and the same events poison it (a serial-less
fold, a grow, the segment budget), after which the next save writes a
full base. Table rows leave the card in one copy under ``_table_lock``.

Filter capture (``enable_filter_capture``) keeps every first-seen
serial's bytes per (issuer index, exp hour), at the same four fold
sites as the JAX package (the walker fold ``_consume_out``, which staged
envelopes also go through, the pre-parsed fold ``_fold_preparsed``, the
host lane ``_host_dedup`` and ck02 segment replay), rides ck01 files as
``filter_keys``/``filter_vals``/``filter_hashes`` and ck02 segments as
``captureTokens``, and compiles into a filter artifact after every save
(``configure_filter_emission``, :mod:`..filter`).

The signature-verification lane (:mod:`..verify.lane`) folds its
verdicts into the per-issuer ``verify_verified`` / ``verify_failed``
vectors (:meth:`TorchAggregator.grow_verify_totals` widens them), which
ride the checkpoints.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Optional
from urllib.parse import urlparse

import numpy as np
import torch

from ct_mapreduce_tpu_torch.agg import ckpt
from ct_mapreduce_tpu_torch.core import der as hostder
from ct_mapreduce_tpu_torch.core import packing
from ct_mapreduce_tpu_torch.core.types import ExpDate, Issuer
from ct_mapreduce_tpu_torch.device import resolve_device
from ct_mapreduce_tpu_torch.filter.cache import content_token, serial_hash
from ct_mapreduce_tpu_torch.filter.spill import SpillCaptureRing
from ct_mapreduce_tpu_torch.ops import buckettable, hashtable, pipeline
from ct_mapreduce_tpu_torch.telemetry import trace
from ct_mapreduce_tpu_torch.telemetry.metrics import incr_counter, set_gauge

#: Longest issuer-CN prefix head the device-side filter compares (the
#: JAX walker's fixed window, ``der_kernel.MAX_FIXED_WINDOW_BYTES``);
#: lanes matching only the head of a longer prefix take the host lane.
MAX_FIXED_WINDOW_BYTES = 61


class IssuerRegistry:
    """Dense issuer indexing for device ops.

    Maps issuer certificates (by raw DER, cached) to small integer
    indices; index → :class:`Issuer` (base64url(SHA-256(SPKI)),
    reference storage/types.go:104-141) for drains and reports.
    """

    def __init__(self) -> None:
        self._by_der: dict[bytes, int] = {}
        self._by_issuer_id: dict[str, int] = {}
        self._issuers: list[Issuer] = []
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._issuers)

    def get_or_assign(self, issuer_der: bytes) -> int:
        with self._lock:
            idx = self._by_der.get(issuer_der)
            if idx is not None:
                return idx
            fields = hostder.parse_cert(issuer_der)
            issuer = Issuer.from_spki(fields.spki)
            iid = issuer.id()
            idx = self._by_issuer_id.get(iid)
            if idx is None:
                # Indices are unbounded: only the device meta word packs
                # the issuer in META_ISSUER_BITS; lanes with larger
                # indices take the exact host lane.
                idx = len(self._issuers)
                self._issuers.append(issuer)
                self._by_issuer_id[iid] = idx
            self._by_der[issuer_der] = idx
            return idx

    def assign_issuer(self, issuer: Issuer) -> int:
        """Index for an already-constructed :class:`Issuer` identity (no
        DER in hand: chain replay, merging checkpoints)."""
        with self._lock:
            iid = issuer.id()
            idx = self._by_issuer_id.get(iid)
            if idx is None:
                idx = len(self._issuers)
                self._issuers.append(issuer)
                self._by_issuer_id[iid] = idx
            return idx

    def index_of_issuer_id(self, issuer_id: str) -> Optional[int]:
        return self._by_issuer_id.get(issuer_id)

    def ids_from(self, start: int) -> list[str]:
        """Issuer-id strings for indices >= ``start``, in index order —
        the registry's append-only suffix since a shadow length was
        taken (CTMRCK02 segment diffs)."""
        with self._lock:
            return [iss.id() for iss in self._issuers[start:]]

    def issuer_at(self, idx: int) -> Issuer:
        return self._issuers[idx]

    def to_json(self) -> str:
        return json.dumps([iss.id() for iss in self._issuers])

    @classmethod
    def from_json(cls, raw: str) -> "IssuerRegistry":
        reg = cls()
        for iid in json.loads(raw):
            idx = len(reg._issuers)
            reg._issuers.append(Issuer.from_string(iid))
            reg._by_issuer_id[iid] = idx
        return reg


@dataclass
class IngestResult:
    """Per-batch outcome, aligned with the input entry order."""

    was_unknown: np.ndarray  # bool[n]
    filtered: np.ndarray  # bool[n] — CA / expired / CN filter
    exp_hours: np.ndarray  # int32[n] (0 where filtered/unparseable)
    serials: list[Optional[bytes]]  # raw serial bytes per entry
    issuer_idx: np.ndarray  # int32[n]
    host_lane_count: int = 0


@dataclass
class _PreparsedPlan:
    """Host-evaluated routing for one pre-parsed submit: every filter
    and device-exactness predicate, computed from the sidecar. The
    device sees only ``insertable``; everything else folds host-side
    at complete() time."""

    sidecar: object  # leafpack.Sidecar
    issuer_idx: np.ndarray  # int32[n]
    valid: np.ndarray  # bool[n]
    f_ca: np.ndarray  # bool[n]
    f_expired: np.ndarray
    f_cn: np.ndarray
    passed: np.ndarray
    insertable: np.ndarray
    static_host_lane: np.ndarray  # host-lane lanes known before insert
    serial_bytes: np.ndarray  # uint8[n, MAX_SERIAL_BYTES]
    host_rows: np.ndarray  # uint8[n, pad]
    length: np.ndarray  # int32[n]
    n: int
    chunk: int  # device chunk width (batch_size)
    flag_cap: int


class _Pending:
    """A submitted ingest whose device work is queued on the stream;
    ``complete()`` reads the results back and folds them. Completion is
    FIFO and claimed before the fold, so a fold that raises is never
    re-applied; every fold holds the aggregator's fold lock.

    ``row_buf`` is free for the caller: the ingest sink hangs the pinned
    host buffer the rows were copied from on it, and gives the buffer
    back to its pool after ``complete()``."""

    def __init__(self, agg: "TorchAggregator", res: IngestResult) -> None:
        self._agg = agg
        self._res = res
        self._done = False
        self._lock = threading.Lock()
        self.row_buf = None

    def _fold(self) -> None:
        raise NotImplementedError

    def complete(self) -> IngestResult:
        with self._lock:
            if self._done:
                return self._res
            self._done = True
            agg = self._agg
            with trace.span("device.fold", cat="device"), agg._fold_lock:
                with contextlib.suppress(ValueError):
                    agg._outstanding.remove(self)
                agg._inflight_lanes = max(
                    0, agg._inflight_lanes - len(self._res.was_unknown))
                self._fold()
                incr_counter("aggregator", "batches")
            return self._res


class PendingIngest(_Pending):
    """The blocking half of :meth:`TorchAggregator.ingest_packed_submit`:
    every chunk's walker step is queued; ``complete()`` reads each
    chunk's packed outputs back, folds them and runs the exact host
    lane. ``host_data`` holds the rows on the host by global position."""

    def __init__(self, agg: "TorchAggregator", chunks, res: IngestResult,
                 host_data: np.ndarray, length: np.ndarray) -> None:
        super().__init__(agg, res)
        self._chunks = chunks  # [(batch, device_pos, lanes, out)]
        self._data = host_data
        self._length = length

    def _fold(self) -> None:
        agg, res = self._agg, self._res
        host_lane_total = 0
        for batch, device_pos, lanes, out in self._chunks:
            host_pos = agg._consume_out(batch, out, device_pos, res, lanes,
                                        host_rows=self._data)
            host_lane_total += agg._host_lanes(
                host_pos,
                lambda pos: self._data[pos, : self._length[pos]].tobytes(),
                res)
        agg.metrics["host_lane"] += host_lane_total
        res.host_lane_count = host_lane_total


class PendingPreparsed(_Pending):
    """The blocking half of :meth:`TorchAggregator.ingest_preparsed_submit`:
    ``complete()`` reads the step's one packed array back and folds it."""

    def __init__(self, agg: "TorchAggregator", out, plan: _PreparsedPlan,
                 res: IngestResult) -> None:
        super().__init__(agg, res)
        self._out = out  # pipeline.PreparsedStepOut
        self._plan = plan

    def _fold(self) -> None:
        self._agg._fold_preparsed(self._out, self._plan, self._res)


class _NpStagedChunkOut:
    """One chunk's slice of a staged envelope's readback, already on the
    host: ``packed`` is one int32[7, B] row of the envelope's [K, 7, B]
    (:func:`pipeline.pack_lane_words` layout), ``serials`` its
    uint8[B, 46] serial windows (None when serials are not wanted) and
    ``issuer_unknown_counts`` the counts it contributes.
    ``_consume_out`` folds it through the same code as a walker step."""

    def __init__(self, packed: np.ndarray, serials: Optional[np.ndarray],
                 issuer_unknown_counts: np.ndarray) -> None:
        self.packed = packed
        self.serials = serials
        self.issuer_unknown_counts = issuer_unknown_counts


class PendingStaged(_Pending):
    """The blocking half of :meth:`TorchAggregator.ingest_staged_submit`:
    one K-chunk walker envelope. ``complete()`` reads the envelope's
    packed [K, 7, B] array, its summed issuer counts and (only when
    serials are wanted) its serial windows back in one copy each, then
    folds the K chunks through ``_consume_out`` and ``_host_lanes``."""

    def __init__(self, agg: "TorchAggregator", out, chunks,
                 res: IngestResult, chunk_width: int) -> None:
        super().__init__(agg, res)
        self._out = out  # pipeline.StagedStepOut
        self._chunks = chunks  # [(batch, device_pos, lanes)]
        self._chunk_width = int(chunk_width)  # pos = k * width + lane

    def _fold(self) -> None:
        agg, res = self._agg, self._res
        P = self._out.packed.cpu().numpy()  # the one packed read
        counts = self._out.issuer_unknown_counts.cpu().numpy()
        serials = (self._out.serials.cpu().numpy() if agg.want_serials
                   else None)
        nothing = np.zeros((0,), np.int32)
        host_lane_total = 0
        for k, (batch, device_pos, lanes) in enumerate(self._chunks):
            # The counts are summed over the envelope on the device; the
            # first chunk's fold adds them (the totals are plain sums).
            out_k = _NpStagedChunkOut(
                P[k], serials[k] if serials is not None else None,
                counts if k == 0 else nothing)
            host_pos = agg._consume_out(batch, out_k, device_pos, res, lanes)
            host_lane_total += agg._host_lanes(
                host_pos,
                lambda pos, _b=batch, _k=k: _b.data[
                    pos - _k * self._chunk_width,
                    : _b.length[pos - _k * self._chunk_width]].tobytes(),
                res)
        agg.metrics["host_lane"] += host_lane_total
        res.host_lane_count = host_lane_total


@dataclass
class AggregateSnapshot:
    """Drained reduce state — the material of storage-statistics."""

    counts: dict[tuple[str, str], int]  # (issuerID, expDateID) → serials
    crls: dict[str, set[str]]  # issuerID → CRL DP URLs
    dns: dict[str, set[str]]  # issuerID → issuer DN strings
    total: int = 0
    # Per-issuer signature-verification verdicts; empty while the verify
    # lane is off.
    verified: dict[str, int] = field(default_factory=dict)
    failed: dict[str, int] = field(default_factory=dict)

    def issuers(self) -> list[str]:
        out = {iss for iss, _ in self.counts}
        out.update(self.crls)
        out.update(self.dns)
        return sorted(out)


def ckpt_state_digest(agg: "TorchAggregator") -> str:
    """Canonical SHA-256 over the complete restorable aggregate state
    (sorted table rows, fill, registry, counters, host and metadata
    sets): the restore-parity oracle, a copy of the JAX package's
    ``tune.harness.ckpt_state_digest``, equal for equal state in either
    package."""
    with agg._table_lock:
        keys, meta = agg._drain_table()
    rows = np.concatenate(
        [keys.astype(np.uint32), meta.astype(np.uint32).reshape(-1, 1)],
        axis=1)
    order = np.lexsort(rows.T[::-1])
    h = hashlib.sha256()
    h.update(rows[order].tobytes())
    h.update(str(int(agg._table_fill)).encode())
    h.update(agg.registry.to_json().encode())
    h.update(np.trim_zeros(agg.issuer_totals, "b").tobytes())
    h.update(np.trim_zeros(agg.verify_verified, "b").tobytes())
    h.update(np.trim_zeros(agg.verify_failed, "b").tobytes())
    for (i, e), ss in sorted(agg.host_serials.items()):
        h.update(f"h{i},{e};".encode())
        for sb in sorted(ss):
            h.update(sb)
    for i, urls in sorted(agg.crl_sets.items()):
        h.update(f"c{i};".encode())
        for u in sorted(urls):
            h.update(u.encode())
    for i, dns in sorted(agg.dn_sets.items()):
        h.update(f"d{i};".encode())
        for dn in sorted(dns):
            h.update(dn.encode())
    tokens = agg.capture_content_hashes()
    if tokens is not None:
        for (i, e), v in sorted(tokens.items()):
            h.update(f"t{i},{e},{v:032x};".encode())
    return h.hexdigest()


class TorchAggregator:
    def __init__(
        self,
        capacity: int = 1 << 22,
        batch_size: int = 4096,
        base_hour: int = packing.DEFAULT_BASE_HOUR,
        cn_prefixes: tuple[str, ...] = (),
        max_probes: int = 32,
        now: Optional[datetime] = None,
        grow_at: float = 0.55,
        max_capacity: int = 1 << 28,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        # Serializes host-state fold-ins (the pendings' folds,
        # _consume_out, _host_lanes) across threads.
        self._fold_lock = threading.Lock()
        # Guards self.table swaps against concurrent reads (a checkpoint
        # save or a membership probe from another thread). Lock order
        # where both are held: _fold_lock, then _table_lock.
        self._table_lock = threading.RLock()
        # Serializes whole checkpoint writes.
        self._save_lock = threading.Lock()
        # The ceiling rounds DOWN to a capacity the active layout can
        # build, so maybe_grow's at-ceiling guard fires instead of
        # rebuilding at the same size on every batch.
        self.max_capacity = self._layout_capacity_floor(max_capacity)
        self.table = self._make_table(capacity)
        # Bucket tables round capacity up to whole buckets; load-factor
        # arithmetic uses the real slot count.
        self.capacity = self.table.capacity
        self.batch_size = batch_size
        self.base_hour = base_hour
        self.max_probes = max_probes
        # Load-factor policy: when the (estimated) fill would exceed
        # grow_at × capacity, the table grows-and-rehashes to the next
        # power of two (up to max_capacity; past the cap, probe
        # overflow spills lanes to the exact host lane). grow_at <= 0
        # disables growth.
        self.grow_at = grow_at
        # Host-side running fill estimate: device inserts folded in at
        # complete() time plus lanes in flight (an upper bound). The
        # exact fill is read only when the estimate trips the threshold.
        self._table_fill = 0
        self._inflight_lanes = 0
        self.registry = IssuerRegistry()
        self._fixed_now = now
        # Host-exact lane state: (issuer_idx, exp_hour) → serial bytes.
        self.host_serials: dict[tuple[int, int], set[bytes]] = {}
        # Per-issuer metadata (strings stay host-side).
        self.crl_sets: dict[int, set[str]] = {}
        self.dn_sets: dict[int, set[str]] = {}
        self._crl_raw_seen: set[tuple[int, bytes]] = set()
        self._dn_raw_seen: set[tuple[int, bytes]] = set()
        # Device-side per-issuer unknown totals (running).
        self.issuer_totals = np.zeros((packing.MAX_ISSUERS,), np.int64)
        # Per-issuer embedded-SCT verdict counts, folded by the verify
        # lane (verify/lane.py); checkpoints carry them.
        self.verify_verified = np.zeros((packing.MAX_ISSUERS,), np.int64)
        self.verify_failed = np.zeros((packing.MAX_ISSUERS,), np.int64)
        # Submitted-but-not-completed ingests of every lane (FIFO).
        self._outstanding: list[_Pending] = []
        # False until the first device step: lets the host lane skip
        # cross-domain membership probes for host-only usage.
        self._device_written = False
        # Set False by a caller that never needs per-entry serial bytes.
        self.want_serials = True
        # Filter capture: every first-seen serial's BYTES per
        # (issuer_idx, exp_hour), the material of a filter artifact (the
        # table keeps only fingerprints). None = off: no cost, and
        # checkpoints without the capture fields.
        self.filter_capture: Optional[dict[tuple[int, int],
                                           set[bytes]]] = None
        # Exact per-group XOR content hashes of the dict capture (the
        # CTMRFL02 dirty-group tokens), kept with the capture; None when
        # capture is off, the spill ring owns them, or exactness was
        # lost. A None only costs a token recomputation.
        self.filter_capture_hashes: Optional[dict[tuple[int, int],
                                                  int]] = None
        # Filter emission after each save (configure_filter_emission):
        # an empty path writes no artifact.
        self.emit_filter_path = ""
        self.filter_fp_rate = 0.01
        self.filter_fmt = ""  # "" = the CTMR_FILTER_FORMAT default
        self.filter_stream_chunk = 0  # 0 = stream.DEFAULT_STREAM_CHUNK
        self.filter_fused_lanes = 0  # 0 = fused.DEFAULT_MAX_LANES
        # Clean groups' cascades carry over between emissions (fl02).
        self._filter_build_cache = None
        # Serializes emissions, which run outside _save_lock (the build
        # cache is not thread-safe).
        self._emit_lock = threading.Lock()
        self.set_cn_prefixes(cn_prefixes)
        self.metrics: dict[str, int] = {
            "inserted": 0, "known": 0, "filtered_ca": 0, "filtered_expired": 0,
            "filtered_cn": 0, "host_lane": 0, "parse_errors": 0, "overflow": 0,
            "dispatch_spill": 0,
        }
        # Incremental checkpoints (CTMRCK02, agg/ckpt.py): the per-tick
        # dirty log the fold paths append to under _fold_lock, armed
        # only after a save/load established a durable base at
        # _ckpt_path. Any event that breaks O(churn) replay (a grow, a
        # serial-less fold, a recorded/inserted mismatch, the segment
        # budget) poisons the log, and the next save writes a full base.
        self._ckpt_knobs = None
        self._ckpt_track = False
        self._ckpt_dirty_lost = False
        self._ckpt_rows: list[tuple[int, int, bytes]] = []
        self._ckpt_host_adds: list[tuple[int, int, bytes]] = []
        self._ckpt_row_bytes = 0
        self._ckpt_dev_inserted = 0
        self._ckpt_path = ""
        self._ckpt_base_sha = ""
        self._ckpt_tip_token = ""
        self._ckpt_chain_len = 0
        # Copies of the small O(issuers) structures at the last durable
        # tick, diffed against at the next segment save.
        self._ckpt_shadow: Optional[dict] = None

    # -- table state -----------------------------------------------------
    @staticmethod
    def _layout_capacity_floor(cap: int) -> int:
        """Largest capacity <= ``cap`` the active layout can build:
        24·2^k slots for bucket tables, a power of two for open ones
        (growth doubles from either, so the floored ceiling stays
        reachable)."""
        if pipeline.table_layout() == "bucket":
            return buckettable.bucket_count(cap, cap) * buckettable.SLOTS
        if cap & (cap - 1):
            cap = 1 << (cap.bit_length() - 1)
        return cap

    def _make_table(self, capacity: int):
        if pipeline.table_layout() == "bucket":
            return buckettable.make_table(
                capacity, max_capacity=self.max_capacity, device=self.device)
        return hashtable.make_table(capacity, device=self.device)

    def _drain_table(self) -> tuple[np.ndarray, np.ndarray]:
        if isinstance(self.table, hashtable.TableState):
            return hashtable.drain_np(self.table)
        return buckettable.drain_np(self.table)

    def _device_contains(self, fps: np.ndarray) -> np.ndarray:
        """bool[n]: are these uint32[n, 4] fingerprints in the table?"""
        if fps.shape[0] == 0:
            return np.zeros((0,), bool)
        keys = torch.from_numpy(
            np.ascontiguousarray(fps, np.uint32).view(np.int32)).to(
                self.device)
        with self._table_lock:
            return pipeline.table_contains(
                self.table, keys, max_probes=self.max_probes).cpu().numpy()

    # -- load-factor policy ---------------------------------------------
    def _table_fill_exact(self) -> int:
        """Occupied-slot count, synced from the device."""
        with self._table_lock:
            return int(self.table.count)

    def _bulk_reinsert(self, keys: np.ndarray, meta: np.ndarray) -> int:
        """Re-hash drained rows into the (fresh) table in chunks of up to
        2^16 lanes, as the JAX package's ``_reinsert_chunks`` does (so
        the rebuilt rows are the same bytes); returns the number of rows
        that overflowed their probe chains."""
        n = len(keys)
        if n == 0:
            return 0
        chunk = min(1 << 16, max(1, n))
        n_chunks = -(-n // chunk)
        pad = n_chunks * chunk - n
        k = torch.from_numpy(np.pad(keys, ((0, pad), (0, 0))).view(
            np.int32)).to(self.device).view(n_chunks, chunk, 4)
        m = torch.from_numpy(np.pad(meta, (0, pad)).view(np.int32)).to(
            self.device).view(n_chunks, chunk)
        v = torch.from_numpy(np.pad(np.ones((n,), bool), (0, pad))).to(
            self.device).view(n_chunks, chunk)
        ovf = torch.zeros((), dtype=torch.int64, device=self.device)
        with self._table_lock:
            for i in range(n_chunks):
                self.table, _wu, o = pipeline.table_insert(
                    self.table, k[i], m[i], v[i], max_probes=self.max_probes)
                ovf += o.sum()
        return int(ovf)

    def _grow_target(self, need: int) -> int:
        target = self.capacity
        while need > self.grow_at * target:
            target *= 2
        return min(target, self.max_capacity)

    def maybe_grow(self, incoming: int = 0) -> None:
        """Grow-and-rehash when the upper-bound fill estimate (folded
        inserts + in-flight lanes + the batch about to be submitted)
        crosses ``grow_at`` × capacity. Host arithmetic on the common
        path; the exact device count is read only when it trips."""
        if self.grow_at <= 0 or self.capacity >= self.max_capacity:
            return
        upper = self._table_fill + self._inflight_lanes + incoming
        if upper <= self.grow_at * self.capacity:
            return
        self.complete_outstanding()  # grow must not strand submits
        exact = self._table_fill_exact()
        self._table_fill = exact
        target = self._grow_target(exact + incoming)
        if target > self.capacity:
            self.grow(target)

    def grow(self, new_capacity: int) -> None:
        """Rebuild the table at ``new_capacity`` and re-hash every
        occupied row (home buckets and hop chains depend on capacity).

        Crash-safe: the old table is held until the reinsert succeeds.
        A reinsert that probe-overflows retries at double capacity up
        to the ceiling; if it still overflows, the ORIGINAL table is
        restored and the error raised."""
        self.complete_outstanding()
        t0 = time.perf_counter()
        # The table lock only after the completes above (fold → table is
        # the lock order).
        with self._table_lock:
            keys, meta = self._drain_table()
            old_capacity = self.capacity
            saved = self.table
            cap = new_capacity
            while True:
                self.table = self._make_table(cap)
                actual = self.table.capacity
                overflow = self._bulk_reinsert(keys, meta)
                if not overflow:
                    break
                if cap >= self.max_capacity:
                    self.table = saved
                    raise RuntimeError(
                        f"table grow overflowed {overflow} rows even at "
                        f"the max capacity {cap}; original table restored "
                        "(pathological key distribution)"
                    )
                cap = min(cap * 2, self.max_capacity)
            self.capacity = actual
        self._table_fill = len(keys)
        # A rehash changes the table's capacity: a delta chain replayed
        # onto the pre-grow base would restore the old capacity, so the
        # next checkpoint must anchor.
        self._ckpt_mark_dirty_lost("table grow")
        incr_counter("aggregator", "table_grow")
        set_gauge("aggregator", "table_load",
                  value=self._table_fill / self.capacity)
        print(
            f"table grown {old_capacity} → {self.capacity} slots "
            f"({len(keys)} rows re-hashed in "
            f"{time.perf_counter() - t0:.2f}s)",
            file=sys.stderr,
        )

    # -- config ----------------------------------------------------------
    def set_cn_prefixes(self, prefixes: tuple[str, ...]) -> None:
        self.cn_prefixes = tuple(prefixes)
        encoded = [p.encode("utf-8") for p in prefixes]
        # Window sized to the longest prefix, capped at the walker's
        # fixed window. Longer prefixes are compared on their head;
        # head-matching lanes route to the exact host lane.
        cap = MAX_FIXED_WINDOW_BYTES
        k = max(1, min(cap, max((len(b) for b in encoded), default=1)))
        arr = np.zeros((len(prefixes), k), np.uint8)
        lens = np.zeros((len(prefixes), 2), np.int32)
        for i, b in enumerate(encoded):
            head = b[:k]
            arr[i, : len(head)] = np.frombuffer(head, np.uint8)
            lens[i] = (len(head), len(b))
        self._prefix_arr, self._prefix_lens = arr, lens
        self._prefix_dev = torch.from_numpy(arr).to(self.device)
        self._prefix_lens_dev = torch.from_numpy(lens).to(self.device)

    def _now_hour(self) -> int:
        now = self._fixed_now or datetime.now(timezone.utc)
        return int(now.timestamp()) // 3600

    def grow_verify_totals(self, max_idx: int) -> None:
        """Ensure the verify vectors cover issuer index ``max_idx``
        (registry indices are unbounded; only the device meta word caps
        at MAX_ISSUERS). Caller holds the fold lock."""
        if max_idx < self.verify_verified.shape[0]:
            return
        size = max(max_idx + 1, 2 * self.verify_verified.shape[0])
        for name in ("verify_verified", "verify_failed"):
            grown = np.zeros((size,), np.int64)
            old = getattr(self, name)
            grown[: old.shape[0]] = old
            setattr(self, name, grown)

    def verify_counts(self) -> dict[str, tuple[int, int]]:
        """issuerID → (verified, failed), nonzero rows only."""
        out: dict[str, tuple[int, int]] = {}
        nz = np.nonzero(self.verify_verified | self.verify_failed)[0]
        for i in nz:
            i = int(i)
            if i < len(self.registry):
                out[self.registry.issuer_at(i).id()] = (
                    int(self.verify_verified[i]), int(self.verify_failed[i]))
        return out

    # -- incremental checkpoints (CTMRCK02, agg/ckpt.py) -----------------
    # -- filter capture ------------------------------------------------
    def enable_filter_capture(self, spill_dir: str = "",
                              spill_mem_bytes: int = 0) -> None:
        """Start keeping first-seen serial bytes per (issuer_idx,
        exp_hour) for filter compilation. Seeds from the host-lane sets
        (their bytes survive checkpoints); device-lane serials ingested
        before this are fingerprints only and cannot be recovered, which
        is said once on stderr. Forces ``want_serials``.

        With ``spill_dir`` (``filterCaptureSpillDir``) the capture is a
        :class:`SpillCaptureRing`: its memory bounded by
        ``spill_mem_bytes``, the rest spilled to segment files, its
        ``items()`` the dict's. An existing dict capture (a restored
        checkpoint) is folded into the ring."""
        if spill_dir and not isinstance(self.filter_capture,
                                        SpillCaptureRing):
            ring = SpillCaptureRing(spill_dir, mem_bytes=spill_mem_bytes)
            seed = (self.filter_capture if self.filter_capture is not None
                    else self.host_serials)
            for key, serials in sorted(seed.items()):
                ring.update(key, sorted(serials))
            self.filter_capture = ring
            # The ring keeps its own content hashes from here on.
            self.filter_capture_hashes = None
        if self.filter_capture is None:
            self.filter_capture = {
                key: set(serials)
                for key, serials in self.host_serials.items()}
            self.filter_capture_hashes = {
                key: content_token(serials)[1]
                for key, serials in self.filter_capture.items()}
            if self._device_written and self._table_fill_exact() > 0:
                print("filter capture enabled on a warm table: device-lane "
                      "serials ingested before this point are fingerprints "
                      "only and will be missing from emitted filters",
                      file=sys.stderr)
        self.want_serials = True
        # Segments carry capture additions only: the seeding above is
        # out of band, so the next save must write a full base.
        self._ckpt_mark_dirty_lost("capture reconfigured")

    def configure_filter_emission(self, path: str, fp_rate: float = 0.01,
                                  spill_dir: str = "",
                                  spill_mem_bytes: int = 0, fmt: str = "",
                                  stream_chunk: int = 0,
                                  fused_lanes: int = 0) -> None:
        """Write a filter artifact to ``path`` after every checkpoint
        save, compiled from the capture at the target FP rate on this
        aggregator's device. ``fmt`` picks the format ("" → the
        CTMR_FILTER_FORMAT default); ``stream_chunk`` and
        ``fused_lanes`` shape the build (0 = defaults) and change no
        bytes."""
        self.emit_filter_path = path
        if fp_rate > 0:
            self.filter_fp_rate = float(fp_rate)
        self.filter_fmt = fmt or ""
        self.filter_stream_chunk = int(stream_chunk or 0)
        self.filter_fused_lanes = int(fused_lanes or 0)
        self.enable_filter_capture(spill_dir=spill_dir,
                                   spill_mem_bytes=spill_mem_bytes)

    def _capture_serial(self, issuer_idx: int, exp_hour: int,
                        serial: bytes) -> None:
        """Record one first-seen serial (the fold paths call this under
        the fold lock; set semantics absorb cross-domain repeats)."""
        cap = self.filter_capture
        if cap is None:
            return
        if isinstance(cap, SpillCaptureRing):
            cap.add((issuer_idx, exp_hour), serial)
            return
        key = (issuer_idx, exp_hour)
        s = cap.setdefault(key, set())
        if serial not in s:
            s.add(serial)
            h = self.filter_capture_hashes
            if h is not None:
                h[key] = h.get(key, 0) ^ serial_hash(serial)

    def capture_content_hashes(self) -> Optional[dict]:
        """Exact per-(issuer_idx, expHour) XOR content hashes of the
        capture, or None when there are none (capture off, a spilled
        ring, a restore that lost them). Callers hold the fold lock."""
        cap = self.filter_capture
        if cap is None:
            return None
        if isinstance(cap, SpillCaptureRing):
            return cap.content_hashes()
        if self.filter_capture_hashes is None:
            return None
        return dict(self.filter_capture_hashes)

    def _emit_filter(self) -> None:
        """Compile the capture into the artifact (:mod:`..filter`) and
        write it atomically beside the checkpoint. A failed emission
        must not poison the checkpoint that already landed: it is
        counted as ``filter.emit_error`` and reported, and the next save
        retries."""
        from ct_mapreduce_tpu_torch.filter import artifact as fartifact
        from ct_mapreduce_tpu_torch.filter.cache import GroupBuildCache

        try:
            if self._filter_build_cache is None:
                self._filter_build_cache = GroupBuildCache()
            art = fartifact.build_from_aggregator(
                self, fp_rate=self.filter_fp_rate,
                fmt=self.filter_fmt or None,
                cache=self._filter_build_cache,
                stream_chunk=self.filter_stream_chunk,
                fused_lanes=self.filter_fused_lanes)
            fartifact.write_artifact(self.emit_filter_path, art.to_bytes())
        except Exception as err:
            incr_counter("filter", "emit_error")
            print(f"filter emission failed ({self.emit_filter_path}): "
                  f"{type(err).__name__}: {err}", file=sys.stderr)

    def configure_checkpointing(self, mode: str = "", max_chain: int = 0,
                                segment_budget_mb: int = 0) -> None:
        """Pin the checkpoint knobs (the ``checkpointMode`` /
        ``ckptMaxChain`` / ``ckptSegmentBudgetMB`` directives). Unset
        values fall through the knob ladder (CTMR_* env > platform
        profile > default), which also applies lazily at the first
        save when this is never called."""
        self._ckpt_knobs = ckpt.resolve_ckpt(
            mode=mode, max_chain=max_chain,
            segment_budget_mb=segment_budget_mb)

    def _ckpt_resolved(self) -> "ckpt.CkptKnobs":
        if self._ckpt_knobs is None:
            self._ckpt_knobs = ckpt.resolve_ckpt()
        return self._ckpt_knobs

    def _ckpt_record_row(self, issuer_idx: int, exp_hour: int,
                         serial: bytes) -> None:
        """Dirty-log one device-table insert (fold paths, under the
        fold lock). No-op until a save or load arms tracking."""
        if not self._ckpt_track or self._ckpt_dirty_lost:
            return
        self._ckpt_rows.append((issuer_idx, exp_hour, serial))
        self._ckpt_note_bytes(len(serial))

    def _ckpt_record_host(self, issuer_idx: int, exp_hour: int,
                          serial: bytes) -> None:
        """Dirty-log one host-lane first-seen serial (under the fold
        lock; _host_dedup already deduplicated it)."""
        if not self._ckpt_track or self._ckpt_dirty_lost:
            return
        self._ckpt_host_adds.append((issuer_idx, exp_hour, serial))
        self._ckpt_note_bytes(len(serial))

    def _ckpt_note_bytes(self, serial_len: int) -> None:
        self._ckpt_row_bytes += serial_len + ckpt.REC.size
        budget = self._ckpt_resolved().segment_budget_mb << 20
        if self._ckpt_row_bytes > budget:
            # A tick whose churn rivals the corpus gains nothing from a
            # delta; cap the log so memory stays bounded.
            self._ckpt_mark_dirty_lost("segment budget exceeded")

    def _ckpt_note_inserted(self, n: int) -> None:
        if self._ckpt_track and not self._ckpt_dirty_lost:
            self._ckpt_dev_inserted += n

    def _ckpt_mark_dirty_lost(self, why: str) -> None:
        """Poison the dirty log: the next save anchors (full base).
        Recording stops and the log drops at once."""
        if not self._ckpt_track or self._ckpt_dirty_lost:
            return
        self._ckpt_dirty_lost = True
        self._ckpt_clear_log()
        incr_counter("ckpt", "dirty_lost")
        print(f"checkpoint dirty log dropped ({why}): next save "
              "writes a full base", file=sys.stderr)

    def _ckpt_clear_log(self) -> None:
        self._ckpt_rows = []
        self._ckpt_host_adds = []
        self._ckpt_row_bytes = 0
        self._ckpt_dev_inserted = 0

    def _ckpt_take_shadow(self) -> dict:
        """Copies of the small O(issuers) structures at a durable tick.
        Caller holds the fold lock (or is otherwise quiesced)."""
        return {
            "registry_len": len(self.registry),
            "issuer_totals": self.issuer_totals.copy(),
            "verify_verified": self.verify_verified.copy(),
            "verify_failed": self.verify_failed.copy(),
            "crl": {i: set(v) for i, v in sorted(self.crl_sets.items())},
            "dn": {i: set(v) for i, v in sorted(self.dn_sets.items())},
        }

    def _ckpt_arm(self, path: str, base_sha: str, tip_token: str,
                  chain_len: int) -> None:
        """Arm dirty tracking against a durable tick at ``path``."""
        self._ckpt_path = path
        self._ckpt_base_sha = base_sha
        self._ckpt_tip_token = tip_token
        self._ckpt_chain_len = chain_len
        self._ckpt_track = True
        self._ckpt_dirty_lost = False
        self._ckpt_clear_log()
        self._ckpt_shadow = self._ckpt_take_shadow()
        set_gauge("ckpt", "chain_length", value=float(chain_len))

    # -- ingest ----------------------------------------------------------
    def complete_outstanding(self) -> None:
        """Fold every un-completed submit into host state (FIFO). Any
        reader of aggregate state calls this first. Whoever loses a race
        for a pending with another completer no-ops."""
        while True:
            try:
                pending = self._outstanding[0]
            except IndexError:
                return
            pending.complete()

    def ingest(self, entries: list[tuple[bytes, bytes]]) -> IngestResult:
        """Process (leaf_der, issuer_der) pairs through the walker lane;
        any count, chunked to the device batch size. Leaves longer than
        the largest length bucket take the exact host lane."""
        n = len(entries)
        res = IngestResult(
            was_unknown=np.zeros((n,), bool),
            filtered=np.zeros((n,), bool),
            exp_hours=np.zeros((n,), np.int32),
            serials=[None] * n,
            issuer_idx=np.zeros((n,), np.int32),
        )
        for i, (_, issuer_der) in enumerate(entries):
            res.issuer_idx[i] = self.registry.get_or_assign(issuer_der)

        max_len = packing.LENGTH_BUCKETS[-1]
        host_lane_total = 0
        for start in range(0, n, self.batch_size):
            chunk = entries[start : start + self.batch_size]
            device_entries, device_pos, host_pos = [], [], []
            for j, (der, _) in enumerate(chunk):
                if len(der) <= max_len:
                    device_entries.append((der, int(res.issuer_idx[start + j])))
                    device_pos.append(start + j)
                else:
                    host_pos.append(start + j)
            if device_entries:
                self.maybe_grow(incoming=len(device_entries))
            # The fold lock after maybe_grow: a grow completes the
            # outstanding pendings, whose folds take the same lock.
            with self._fold_lock:
                if device_entries:
                    batch = packing.pack_entries(
                        device_entries, batch_size=self.batch_size)
                    out = self._device_step_packed(batch)
                    host_pos += self._consume_out(
                        batch, out, np.asarray(device_pos, np.int64), res,
                        np.arange(len(device_pos), dtype=np.int64))
                host_lane_total += self._host_lanes(
                    host_pos, lambda pos: entries[pos][0], res)
        self.metrics["host_lane"] += host_lane_total
        res.host_lane_count = host_lane_total
        incr_counter("aggregator", "batches")
        return res

    def ingest_packed(self, data: np.ndarray, length: np.ndarray,
                      issuer_idx: np.ndarray,
                      valid: np.ndarray) -> IngestResult:
        """Packed rows (``uint8[n, pad]`` DER, ``int32[n]`` lengths,
        registry indices, validity) through the walker lane: submit +
        complete."""
        return self.ingest_packed_submit(data, length, issuer_idx,
                                         valid).complete()

    def ingest_packed_submit(self, data, length: np.ndarray,
                             issuer_idx: np.ndarray, valid: np.ndarray,
                             host_data: Optional[np.ndarray] = None
                             ) -> PendingIngest:
        """Queue the walker steps for a packed batch without reading
        anything back: each chunk of ``batch_size`` rows is stepped;
        ``complete()`` reads the results.

        ``data`` is ``uint8[n, L]`` NumPy rows, or a tensor whose copy to
        the device the caller has already queued (the sink ships it from
        pinned memory). Pass the NumPy rows as ``host_data`` then: the
        host lane and the metadata windows slice them, so no rows are
        read back from the device."""
        n = int(data.shape[0])
        if host_data is None:
            if not isinstance(data, np.ndarray):
                raise ValueError(
                    "host_data is required when data is a tensor")
            host_data = data
        length = np.asarray(length, np.int32)
        valid = np.asarray(valid, bool)
        self.maybe_grow(incoming=n)
        self._inflight_lanes += n
        res = IngestResult(
            was_unknown=np.zeros((n,), bool),
            filtered=np.zeros((n,), bool),
            exp_hours=np.zeros((n,), np.int32),
            serials=[None] * n,
            issuer_idx=np.asarray(issuer_idx, np.int32).copy(),
        )
        chunks = []
        b = self.batch_size
        for start in range(0, n, b):
            end = min(start + b, n)
            m = end - start
            if m == b:
                rows = data[start:end]
            elif isinstance(data, np.ndarray):  # pad the tail chunk
                rows = np.zeros((b, data.shape[1]), np.uint8)
                rows[:m] = data[start:end]
            else:  # pad the tail chunk where the rows already are
                rows = data.new_zeros((b, data.shape[1]))
                rows[:m] = data[start:end]

            def pad(a, dtype):
                out = np.zeros((b,), dtype)
                out[:m] = a[start:end]
                return out

            batch = packing.PackedBatch(
                rows, pad(length, np.int32), pad(res.issuer_idx, np.int32),
                pad(valid, bool))
            lanes = np.nonzero(valid[start:end])[0].astype(np.int64)
            out = self._device_step_packed(batch)
            chunks.append((batch, lanes + start, lanes, out))
        pending = PendingIngest(self, chunks, res, host_data, length)
        self._outstanding.append(pending)
        return pending

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        """A NumPy array or a tensor on this aggregator's device (a
        tensor already there is returned as it is)."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, non_blocking=True)
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            self.device)

    def _device_step_packed(self, batch: packing.PackedBatch):
        """Queue one walker step on the table's device."""
        self._device_written = True
        with trace.span("device.step", cat="device"), self._table_lock:
            self.table, out = pipeline.ingest_core(
                self.table, self._to_device(batch.data, np.uint8),
                self._to_device(batch.length, np.int32),
                self._to_device(batch.issuer_idx, np.int32),
                self._to_device(batch.valid, bool), self._now_hour(),
                self.base_hour, self._prefix_dev, self._prefix_lens_dev,
                max_probes=self.max_probes)
        return out

    # -- staged device queue (K-chunk walker envelope) -------------------
    def ingest_staged_submit(
        self,
        data,  # uint8[K, B, L]: a tensor (its copy queued) or NumPy
        length: np.ndarray,  # int32[K, B]
        issuer_idx: np.ndarray,  # int32[K, B]
        valid: np.ndarray,  # bool[K, B]
        host_chunks: list[np.ndarray],  # per REAL chunk: uint8[n_k, L]
    ) -> PendingStaged:
        """Queue ONE K-chunk walker envelope
        (:func:`~ct_mapreduce_tpu_torch.ops.pipeline.staged_core`)
        without reading anything back. Chunk ``k``'s lanes land at
        result positions ``k * B + lane``; chunks past
        ``len(host_chunks)`` are all-invalid padding (the staging ring
        flushed early). ``host_chunks`` are the caller's own host rows,
        kept for host-lane slices and metadata windows: the staging
        buffer ``data`` came from is recycled, so it is not read after
        this call."""
        k_chunks, b = length.shape
        n = k_chunks * b
        valid = np.asarray(valid, bool)
        length = np.asarray(length, np.int32)
        issuer_idx = np.asarray(issuer_idx, np.int32)
        # The growth estimate counts the REAL chunks' lanes, not the
        # all-invalid padding of a partial ring (counting K x B lanes
        # grew tables 4x early in the JAX package).
        self.maybe_grow(incoming=sum(int(c.shape[0]) for c in host_chunks))
        self._inflight_lanes += n
        res = IngestResult(
            was_unknown=np.zeros((n,), bool),
            filtered=np.zeros((n,), bool),
            exp_hours=np.zeros((n,), np.int32),
            serials=[None] * n,
            issuer_idx=issuer_idx.reshape(n).copy(),
        )
        chunks = []
        for k, rows in enumerate(host_chunks):
            n_k = int(rows.shape[0])
            batch = packing.PackedBatch(
                rows, length[k, :n_k], issuer_idx[k, :n_k], valid[k, :n_k])
            lanes = np.nonzero(valid[k])[0].astype(np.int64)
            chunks.append((batch, lanes + k * b, lanes))
        out = self._device_step_staged(data, length, issuer_idx, valid)
        pending = PendingStaged(self, out, chunks, res, chunk_width=b)
        self._outstanding.append(pending)
        return pending

    def _device_step_staged(self, data, length, issuer_idx, valid):
        self._device_written = True
        with trace.span("device.step_staged", cat="device",
                        chunks=int(length.shape[0])), self._table_lock:
            self.table, out = pipeline.staged_core(
                self.table, self._to_device(data, np.uint8),
                self._to_device(length, np.int32),
                self._to_device(issuer_idx, np.int32),
                self._to_device(valid, bool), self._now_hour(),
                self.base_hour, self._prefix_dev, self._prefix_lens_dev,
                max_probes=self.max_probes)
        return out

    def _consume_out(self, batch: packing.PackedBatch, out, device_pos,
                     res: IngestResult, lanes, host_rows=None) -> list[int]:
        """Read one walker step's outputs back (ONE packed int32[7, B]
        copy, plus the counts and, when serials are wanted, the serial
        window) and fold them into ``res`` at the global positions
        ``device_pos`` (chunk lanes ``lanes``). ``host_rows`` is the
        host copy of the rows by global position, used for metadata
        windows instead of the batch. ``out`` is a walker step's
        :class:`~ct_mapreduce_tpu_torch.ops.pipeline.StepOut` or a
        staged chunk's host-side :class:`_NpStagedChunkOut`. Returns
        the positions that must take the exact host lane. Caller holds
        the fold lock."""
        if isinstance(out, _NpStagedChunkOut):
            P = out.packed
            counts = np.asarray(out.issuer_unknown_counts, np.int64)
            serials_of = lambda: out.serials  # noqa: E731
        else:
            # The one per-lane readback.
            P = pipeline.pack_lane_words(out).cpu().numpy()
            counts = out.issuer_unknown_counts.cpu().numpy().astype(np.int64)
            serials_of = lambda: out.serials.cpu().numpy()  # noqa: E731
        flags = P[0]
        hl = (flags & 1) != 0
        wu = ((flags >> 1) & 1) != 0
        f_ca = ((flags >> 2) & 1) != 0
        f_exp = ((flags >> 3) & 1) != 0
        f_cn = ((flags >> 4) & 1) != 0
        ovf = ((flags >> 5) & 1) != 0
        nah, slen = P[1], P[2]
        dp_off, dp_len, in_off, in_len = P[3], P[4], P[5], P[6]
        f_any = f_ca | f_exp | f_cn
        self.metrics["filtered_ca"] += int(f_ca.sum())
        self.metrics["filtered_expired"] += int(f_exp.sum())
        self.metrics["filtered_cn"] += int(f_cn.sum())
        # Bit 6 is set only by the sharded step: its routing-cap spills.
        self.metrics["dispatch_spill"] += int(((flags >> 6) & 1).sum())
        self.metrics["overflow"] += int(ovf.sum())
        self.issuer_totals[: counts.shape[0]] += counts

        # True table-fill delta, taken before the cross-encoding guard
        # below flips any was_unknown lane for reporting.
        dev_inserted = int(wu.sum())
        pos_arr = np.asarray(device_pos, np.int64)
        lanes = np.asarray(lanes, np.int64)
        hl_l = hl[lanes]
        host_pos = [int(p) for p in pos_arr[hl_l]]
        okm = ~hl_l
        f_l = f_any[lanes]
        res.filtered[pos_arr[okm]] = f_l[okm]
        keep = okm & ~f_l
        kp, kl = pos_arr[keep], lanes[keep]
        res.exp_hours[kp] = nah[kl]
        if self.want_serials:
            sarr = serials_of()
            for p_, l_ in zip(kp, kl):
                sb = sarr[l_, : slen[l_]].tobytes()
                res.serials[p_] = sb
                if wu[l_]:
                    key = (int(batch.issuer_idx[l_]), int(nah[l_]))
                    # Dirty-log the row before the guard: the device
                    # inserted this key whether or not the guard flips
                    # the report, and segments mirror table slots.
                    self._ckpt_record_row(key[0], key[1], sb)
                    if sb in self.host_serials.get(key, ()):
                        # Cross-encoding guard (module docstring).
                        wu[l_] = False
                        self.issuer_totals[int(batch.issuer_idx[l_])] -= 1
                    else:
                        res.was_unknown[p_] = True
                        self._capture_serial(key[0], key[1], sb)
        else:
            res.was_unknown[kp[wu[kl]]] = True
            if dev_inserted:
                # No serial bytes: these inserts cannot be dirty-logged,
                # so the next checkpoint must anchor.
                self._ckpt_mark_dirty_lost("serial-less fold")
        ksel = np.nonzero(res.was_unknown[pos_arr])[0]
        if ksel.size:
            if host_rows is not None:
                rows2d, row_sel = host_rows, pos_arr[ksel]
                issuers = res.issuer_idx[pos_arr[ksel]]
            else:
                rows2d, row_sel = np.asarray(batch.data), lanes[ksel]
                issuers = np.asarray(batch.issuer_idx)[lanes[ksel]]
            lsel = lanes[ksel]
            self._accumulate_metadata_lanes(
                rows2d, row_sel, issuers,
                dp_off[lsel], dp_len[lsel], in_off[lsel], in_len[lsel])
        dev_unknown = int(wu.sum())
        dev_known = len(pos_arr) - int(hl.sum()) - dev_unknown
        self.metrics["inserted"] += dev_unknown
        self.metrics["known"] += max(dev_known, 0)
        self._table_fill += dev_inserted
        self._ckpt_note_inserted(dev_inserted)
        set_gauge("aggregator", "table_load",
                  value=self._table_fill / self.capacity)
        return host_pos

    def ingest_preparsed(self, sidecar, issuer_idx, valid, host_rows,
                         length) -> IngestResult:
        """Synchronous form of the pre-parsed lane: submit + complete."""
        return self.ingest_preparsed_submit(
            sidecar, issuer_idx, valid, host_rows, length).complete()

    def ingest_preparsed_submit(
        self,
        sidecar,
        issuer_idx: np.ndarray,
        valid: np.ndarray,
        host_rows: np.ndarray,
        length: np.ndarray,
    ) -> PendingPreparsed:
        """Queue the device step for host-extracted sidecars
        (:class:`ct_mapreduce_tpu_torch.native.leafpack.Sidecar`).

        Filter and device-exactness predicates are evaluated HERE, with
        the arithmetic of the JAX walker lane's ``local_lanes``; they
        are pure functions of the sidecar, so the device step is only
        fingerprint + insert + counts on compact inputs. ``valid`` lanes
        whose sidecar ``ok`` is 0 take the exact host lane."""
        n = int(len(valid))
        valid = np.asarray(valid, bool)
        issuer_idx = np.asarray(issuer_idx, np.int32).copy()
        ok = sidecar.ok.astype(bool) & valid
        nah = sidecar.not_after_hour
        now_hour = np.int32(self._now_hour())

        # Reference filter precedence (reference cmd/ct-fetch/
        # ct-fetch.go:44-70): CA, then expired, then issuer CN.
        f_ca = ok & sidecar.is_ca.astype(bool)
        f_expired = ok & ~f_ca & (nah < now_hour)
        if self.cn_prefixes:
            cn_hit, cn_undec0 = self._cn_verdict_np(
                host_rows, sidecar.cn_off, sidecar.cn_len)
            cn_undec = ok & ~f_ca & ~f_expired & ~cn_hit & cn_undec0
            f_cn = ok & ~f_ca & ~f_expired & ~cn_hit & ~cn_undec
        else:
            f_cn = cn_undec = np.zeros_like(ok)
        passed = ok & ~f_ca & ~f_expired & ~f_cn

        # Device-exactness gate. A cert expiring WITHIN the current hour
        # also goes to the exact host lane: the device compares hour
        # buckets, the reference compares instants.
        hour_off = nah.astype(np.int64) - self.base_hour
        meta_ok = (hour_off >= 0) & (hour_off < packing.META_HOUR_SPAN)
        idx_ok = (issuer_idx >= 0) & (issuer_idx < packing.MAX_ISSUERS)
        boundary_hour = nah == now_hour
        fits = sidecar.serial_len <= packing.MAX_SERIAL_BYTES
        device_exact = fits & meta_ok & idx_ok & ~boundary_hour & ~cn_undec
        insertable = passed & device_exact
        static_host_lane = (valid & ~ok) | (passed & ~device_exact)

        # Serial content window, host-gathered: bytes past serial_len
        # are zero; lanes whose serial exceeds the window are not
        # insertable.
        s = packing.MAX_SERIAL_BYTES
        serial_bytes = np.zeros((n, s), np.uint8)
        if n:
            cols = sidecar.serial_off[:, None].astype(np.int64) + np.arange(s)
            oob = cols >= host_rows.shape[1]
            np.clip(cols, 0, host_rows.shape[1] - 1, out=cols)
            win = host_rows[np.arange(n)[:, None], cols]
            mask = (np.arange(s)[None, :] < sidecar.serial_len[:, None]) & ~oob
            serial_bytes = np.where(mask, win, 0).astype(np.uint8)

        self.maybe_grow(incoming=n)
        self._inflight_lanes += n
        res = IngestResult(
            was_unknown=np.zeros((n,), bool),
            filtered=np.zeros((n,), bool),
            exp_hours=np.zeros((n,), np.int32),
            serials=[None] * n,
            issuer_idx=issuer_idx,
        )

        # Stack into [K, B] chunks of the configured batch width.
        b = min(self.batch_size, max(n, 1))
        k_chunks = max(1, -(-n // b))
        pad = k_chunks * b - n

        def stk(a, dtype):
            a = np.asarray(a, dtype)
            if pad:
                a = np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))
            return a.reshape((k_chunks, b) + a.shape[1:])

        flag_cap = min(pipeline.N_PREPARSED_FLAG_CAP, max(64, b // 64),
                       max(b, 1))
        out = self._device_step_preparsed(
            stk(serial_bytes, np.uint8), stk(sidecar.serial_len, np.int32),
            stk(nah, np.int32), stk(issuer_idx, np.int32),
            stk(insertable, bool), flag_cap,
        )
        plan = _PreparsedPlan(
            sidecar=sidecar, issuer_idx=issuer_idx, valid=valid, f_ca=f_ca,
            f_expired=f_expired, f_cn=f_cn, passed=passed,
            insertable=insertable, static_host_lane=static_host_lane,
            serial_bytes=serial_bytes, host_rows=host_rows,
            length=np.asarray(length, np.int32), n=n, chunk=b,
            flag_cap=flag_cap,
        )
        pending = PendingPreparsed(self, out, plan, res)
        self._outstanding.append(pending)
        return pending

    def _cn_verdict_np(self, rows: np.ndarray, cn_off: np.ndarray,
                       cn_len: np.ndarray):
        """The walker lane's CN-prefix verdict on the host — same
        K-byte window, same truncated-prefix "undecidable" routing, so
        this lane spills exactly the lanes the walker lane spills."""
        prefixes, lens = self._prefix_arr, self._prefix_lens
        k = prefixes.shape[1]
        n = rows.shape[0]
        cols = cn_off[:, None].astype(np.int64) + np.arange(k)
        oob = cols >= rows.shape[1]
        np.clip(cols, 0, rows.shape[1] - 1, out=cols)
        window = rows[np.arange(n)[:, None], cols].astype(np.int64)
        inside = (np.arange(k)[None, :] < cn_len[:, None]) & ~oob
        window = np.where(inside, window, 0)
        dev_lens, true_lens = lens[:, 0], lens[:, 1]
        eq = window[:, None, :] == prefixes[None, :, :]
        care = np.arange(k)[None, None, :] < dev_lens[None, :, None]
        full = np.all(eq | ~care, axis=-1)
        truncated = (true_lens > dev_lens)[None, :]
        hit = np.any(
            full & (cn_len[:, None] >= dev_lens[None, :]) & ~truncated,
            axis=-1)
        undec = np.any(
            full & (cn_len[:, None] >= true_lens[None, :]) & truncated,
            axis=-1)
        return hit, undec

    def _device_step_preparsed(self, serials, serial_len, nah, issuer_idx,
                               insertable, flag_cap: int):
        self._device_written = True
        dev = self._to_device
        with trace.span("device.step_preparsed", cat="device"), \
                self._table_lock:
            self.table, out = pipeline.preparsed_core(
                self.table, dev(serials), dev(serial_len), dev(nah),
                dev(issuer_idx), dev(insertable), self.base_hour,
                max_probes=self.max_probes, flag_cap=flag_cap,
            )
        return out

    def _fold_preparsed(self, out, plan: _PreparsedPlan,
                        res: IngestResult) -> None:
        """ONE packed device-to-host read, then the host-side fold."""
        n, b, cap = plan.n, plan.chunk, plan.flag_cap
        nb = -(-b // 32)
        sc = plan.sidecar
        P = out.packed.cpu().numpy()  # the one readback
        k_chunks = P.shape[0]
        # Flag traffic (per-chunk counts + compacted overflow ids) and
        # total readback, counted apart.
        incr_counter("ingest", "d2h_flag_bytes",
                     value=float(4 * (2 + cap) * k_chunks))
        incr_counter("ingest", "d2h_readback_bytes", value=float(P.nbytes))

        wu = np.zeros((n,), bool)
        ovf = np.zeros((n,), bool)
        dev_inserted = 0
        counts = np.zeros((P.shape[1] - 2 - nb - cap,), np.int64)
        spill_bits = None
        for k in range(k_chunks):
            row = P[k]
            lo, hi = k * b, min((k + 1) * b, n)
            dev_inserted += int(row[0])
            ovf_count = int(row[1])
            bits = row[2:2 + nb].view(np.uint32)
            lanes = (
                (bits[:, None] >> np.arange(32, dtype=np.uint32)) & 1
            ).astype(bool).reshape(-1)[: hi - lo]
            wu[lo:hi] = lanes
            if ovf_count:
                if ovf_count <= cap:
                    ids = row[2 + nb:2 + nb + ovf_count]
                    ids = ids[ids < (hi - lo)]
                    ovf[lo + ids] = True
                else:
                    # Compacted-flag spill: fall back to the full
                    # overflow bitmask (a second, rare readback).
                    if spill_bits is None:
                        spill_bits = out.overflow_bits.cpu().numpy().view(
                            np.uint32)
                        incr_counter("ingest", "d2h_flag_bytes",
                                     value=float(spill_bits.nbytes))
                        incr_counter("ingest", "flag_cap_spill")
                    obits = spill_bits[k]
                    ovf[lo:hi] = (
                        (obits[:, None] >> np.arange(32, dtype=np.uint32))
                        & 1
                    ).astype(bool).reshape(-1)[: hi - lo]
            counts += row[2 + nb + cap:].astype(np.int64)

        f_any = plan.f_ca | plan.f_expired | plan.f_cn
        self.metrics["filtered_ca"] += int(plan.f_ca.sum())
        self.metrics["filtered_expired"] += int(plan.f_expired.sum())
        self.metrics["filtered_cn"] += int(plan.f_cn.sum())
        self.metrics["overflow"] += int(ovf.sum())
        self.issuer_totals[: counts.shape[0]] += counts

        hl = plan.static_host_lane | ovf
        keep = plan.passed & ~hl  # == valid & ~hl & ~filtered
        res.filtered[~hl] = f_any[~hl]
        res.exp_hours[keep] = sc.not_after_hour[keep]
        if self.want_serials:
            for p_ in np.nonzero(keep)[0]:
                sb = plan.serial_bytes[p_, : sc.serial_len[p_]].tobytes()
                res.serials[p_] = sb
                if wu[p_]:
                    key = (int(plan.issuer_idx[p_]),
                           int(sc.not_after_hour[p_]))
                    # Dirty-log before the guard (see _consume_out).
                    self._ckpt_record_row(key[0], key[1], sb)
                    if sb in self.host_serials.get(key, ()):
                        # Cross-encoding guard (module docstring).
                        wu[p_] = False
                        self.issuer_totals[int(plan.issuer_idx[p_])] -= 1
                    else:
                        res.was_unknown[p_] = True
                        self._capture_serial(key[0], key[1], sb)
        else:
            res.was_unknown[wu] = True
            if dev_inserted:
                self._ckpt_mark_dirty_lost("serial-less fold")
        ksel = np.nonzero(res.was_unknown[:n])[0]
        if ksel.size:
            self._accumulate_metadata_lanes(
                plan.host_rows, ksel, plan.issuer_idx[ksel],
                sc.crldp_off[ksel], sc.crldp_len[ksel],
                sc.issuer_off[ksel], sc.issuer_len[ksel],
            )
        n_valid = int(plan.valid.sum())
        dev_unknown = int(wu.sum())
        dev_known = n_valid - int(hl.sum()) - dev_unknown
        self.metrics["inserted"] += dev_unknown
        self.metrics["known"] += max(dev_known, 0)
        self._table_fill += dev_inserted
        self._ckpt_note_inserted(dev_inserted)
        set_gauge("aggregator", "table_load",
                  value=self._table_fill / self.capacity)

        host_pos = [int(p) for p in np.nonzero(hl)[0]]
        host_lane_total = self._host_lanes(
            host_pos,
            lambda pos: plan.host_rows[pos, : plan.length[pos]].tobytes(),
            res,
        )
        self.metrics["host_lane"] += host_lane_total
        res.host_lane_count = host_lane_total

    def _host_lanes(self, host_pos, der_of, res) -> int:
        """Exact host path for flagged lanes, with ONE batched
        device-membership probe for the cross-domain guard."""
        staged = []  # (pos, fields, eh) — lanes that reached dedup
        for pos in host_pos:
            fields, x = self._host_filter(der_of(pos), int(res.issuer_idx[pos]))
            if fields is None:
                u, f, eh, sb = x
                res.was_unknown[pos], res.filtered[pos] = u, f
                res.exp_hours[pos], res.serials[pos] = eh, sb
            else:
                staged.append((pos, fields, x))
        flags = self._device_known_flags(
            [(int(res.issuer_idx[pos]), eh, fields.serial)
             for pos, fields, eh in staged]
        )
        for (pos, fields, eh), dk in zip(staged, flags):
            u, f, eh2, sb = self._host_dedup(
                fields, int(res.issuer_idx[pos]), eh, device_known=dk
            )
            res.was_unknown[pos], res.filtered[pos] = u, f
            res.exp_hours[pos], res.serials[pos] = eh2, sb
        return len(host_pos)

    def _accumulate_metadata_lanes(self, rows2d, row_sel, issuers,
                                   dp_off, dp_len, in_off, in_len):
        """CRL/DN accumulation for device-unknown lanes, keyed by raw
        byte windows so each distinct encoding is parsed once (work is
        reduced to UNIQUE windows first, so the Python cost is
        O(#distinct issuers/CRL encodings), not O(batch))."""
        if row_sel.size == 0:
            return

        def rep_windows(o, ln):
            """Representative index (into the selection) per unique
            (issuer, window bytes)."""
            width = int(ln.max(initial=0))
            if width == 0:
                return np.zeros((0,), np.int64)
            k = row_sel.shape[0]
            cols = o[:, None] + np.arange(width, dtype=o.dtype)[None, :]
            cols = np.clip(cols, 0, rows2d.shape[1] - 1)
            wins = rows2d[row_sel[:, None], cols]
            wins[np.arange(width)[None, :] >= ln[:, None]] = 0
            tag8 = np.empty((k, width + 6), np.uint8)
            tag8[:, 0:4] = (
                issuers.astype(np.uint32).view(np.uint8).reshape(k, 4))
            tag8[:, 4:6] = ln.astype(np.uint16).view(np.uint8).reshape(k, 2)
            tag8[:, 6:] = wins
            v = np.ascontiguousarray(tag8).view(
                np.dtype((np.void, tag8.shape[1])))
            _, first = np.unique(v.ravel(), return_index=True)
            return first

        for i in rep_windows(in_off, in_len):
            idx = int(issuers[i])
            raw_name = rows2d[
                row_sel[i], in_off[i] : in_off[i] + in_len[i]].tobytes()
            if (idx, raw_name) not in self._dn_raw_seen:
                self._dn_raw_seen.add((idx, raw_name))
                try:
                    rdns, _ = hostder.parse_name(raw_name, 0)
                    dn = hostder.render_dn(rdns)
                    self.dn_sets.setdefault(idx, set()).add(dn)
                except Exception:
                    pass  # an unparseable Name adds no DN
        for i in rep_windows(dp_off, dp_len):
            if dp_len[i] <= 0:
                continue
            idx = int(issuers[i])
            raw_dp = rows2d[
                row_sel[i], dp_off[i] : dp_off[i] + dp_len[i]].tobytes()
            if (idx, raw_dp) not in self._crl_raw_seen:
                self._crl_raw_seen.add((idx, raw_dp))
                try:
                    urls = hostder._parse_crldp(raw_dp, 0)
                except Exception:
                    urls = []
                self._add_crls(idx, urls)

    def _add_crls(self, issuer_idx: int, urls: list[str]) -> None:
        """http/https only; ldap silently dropped
        (reference storage/issuermetadata.go:48-73)."""
        for u in urls:
            try:
                parsed = urlparse(u.strip())
            except ValueError:
                continue
            if parsed.scheme in ("http", "https"):
                self.crl_sets.setdefault(issuer_idx, set()).add(parsed.geturl())

    def _host_filter(self, der: bytes, issuer_idx: int):
        """Tolerant host parse + reference filters. Returns
        ``(fields, exp_hour)`` when the lane reaches dedup, else
        ``(None, (was_unknown, filtered, exp_hour, serial))``."""
        try:
            fields = hostder.parse_cert(der)
        except Exception:
            self.metrics["parse_errors"] += 1
            return None, (False, False, 0, None)
        if fields.is_ca:
            self.metrics["filtered_ca"] += 1
            return None, (False, True, 0, None)
        eh = fields.not_after_unix_hour
        # Exact instant compare, like the reference's NotAfter.Before(now)
        # (reference cmd/ct-fetch/ct-fetch.go:52-55).
        now = self._fixed_now or datetime.now(timezone.utc)
        if fields.not_after < now:
            self.metrics["filtered_expired"] += 1
            return None, (False, True, 0, None)
        if self.cn_prefixes and not any(
            fields.issuer_cn.startswith(p) for p in self.cn_prefixes
        ):
            self.metrics["filtered_cn"] += 1
            return None, (False, True, 0, None)
        return fields, eh

    def _device_known_flags(self, items) -> list[bool]:
        """Cross-domain guard: a serial already counted in the DEVICE
        table must not count again in the host domain. One batched
        membership probe for the whole chunk, no mutation.

        items: [(issuer_idx, exp_hour, serial_bytes)] → bool per item.
        """
        flags = [False] * len(items)
        if not self._device_written:
            return flags
        cand, fps = [], []
        for j, (issuer_idx, eh, serial) in enumerate(items):
            if (
                len(serial) <= packing.MAX_SERIAL_BYTES
                and 0 <= issuer_idx < packing.MAX_ISSUERS
                and 0 <= eh - self.base_hour < packing.META_HOUR_SPAN
            ):
                cand.append(j)
                fps.append(packing.fingerprint_host(issuer_idx, eh, serial))
        if fps:
            known = self._device_contains(np.array(fps, np.uint32))
            for j, k in zip(cand, known):
                flags[j] = bool(k)
        return flags

    def _host_dedup(self, fields, issuer_idx: int, eh: int,
                    device_known: bool = False):
        """Host-set dedup + metadata accumulation for a filtered lane."""
        key = (issuer_idx, eh)
        bucket = self.host_serials.setdefault(key, set())
        if fields.serial in bucket or device_known:
            self.metrics["known"] += 1
            return False, False, eh, fields.serial
        bucket.add(fields.serial)
        self._ckpt_record_host(issuer_idx, eh, fields.serial)
        self._capture_serial(issuer_idx, eh, fields.serial)
        self.metrics["inserted"] += 1
        if issuer_idx >= self.issuer_totals.shape[0]:
            # Registry-overflow issuers (idx >= MAX_ISSUERS) only ever
            # count here; grow the per-issuer totals to fit them.
            grown = np.zeros(
                (max(issuer_idx + 1, 2 * self.issuer_totals.shape[0]),),
                np.int64)
            grown[: self.issuer_totals.shape[0]] = self.issuer_totals
            self.issuer_totals = grown
        self.issuer_totals[issuer_idx] += 1
        self.dn_sets.setdefault(issuer_idx, set()).add(fields.issuer_dn)
        self._add_crls(issuer_idx, fields.crl_distribution_points)
        return True, False, eh, fields.serial

    # -- drain / report --------------------------------------------------
    def drain(self) -> AggregateSnapshot:
        """Pull device state to the host and merge with the host lane —
        the data storage-statistics prints (reference
        cmd/storage-statistics/storage-statistics.go:28-99)."""
        self.complete_outstanding()
        with self._table_lock:
            _, meta = self._drain_table()
        counts: dict[tuple[str, str], int] = {}
        if meta.size:
            uniq, cnt = np.unique(meta, return_counts=True)
            for m, c in zip(uniq, cnt):
                idx, eh = packing.unpack_meta(int(m), self.base_hour)
                key = self._count_key(idx, eh)
                counts[key] = counts.get(key, 0) + int(c)
        # Host-lane serials that ALSO landed in the device table would
        # double count; one batched membership probe finds the overlap,
        # and overlapping serials count device-side only.
        items = [
            (idx, eh, sb)
            for (idx, eh), serials in self.host_serials.items()
            for sb in serials
        ]
        overlap: dict[tuple[int, int], int] = {}
        for (idx, eh, _sb), dup in zip(items, self._device_known_flags(items)):
            if dup:
                overlap[(idx, eh)] = overlap.get((idx, eh), 0) + 1
        for (idx, eh), serials in self.host_serials.items():
            n = len(serials) - overlap.get((idx, eh), 0)
            if n <= 0:
                continue
            key = self._count_key(idx, eh)
            counts[key] = counts.get(key, 0) + n
        crls = {
            self.registry.issuer_at(i).id(): set(s) for i, s in self.crl_sets.items()
        }
        dns = {
            self.registry.issuer_at(i).id(): set(s) for i, s in self.dn_sets.items()
        }
        vc = self.verify_counts()
        return AggregateSnapshot(
            counts=counts, crls=crls, dns=dns, total=sum(counts.values()),
            verified={k: v for k, (v, _) in vc.items() if v},
            failed={k: f for k, (_, f) in vc.items() if f})

    def _count_key(self, issuer_idx: int, exp_hour: int) -> tuple[str, str]:
        return (
            self.registry.issuer_at(issuer_idx).id(),
            ExpDate.from_unix_hour(exp_hour).id(),
        )

    # -- checkpoint ------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Durable aggregate state at ``path`` (the log cursor is
        checkpointed separately, reference storage/types.go:25-42).

        Two modes (the ``checkpointMode`` knob, agg/ckpt.py):

        - ``ck01``: every save is the full ``.npz`` snapshot.
        - ``ck02`` (default): the first save (and any save after the
          dirty log was poisoned, or after ``ckptMaxChain`` segments)
          writes a full base; every other save appends one O(churn)
          CTMRCK02 delta segment and updates the chain manifest.

        Every file lands via temp + fsync + ``os.replace``; segments
        land before the manifest that names them."""
        with self._save_lock:
            self.complete_outstanding()
            knobs = self._ckpt_resolved()
            wrote_segment = False
            compacting = False
            if (knobs.mode == ckpt.MODE_INCREMENTAL and self._ckpt_track
                    and not self._ckpt_dirty_lost
                    and path == self._ckpt_path):
                if self._ckpt_chain_len >= knobs.max_chain:
                    compacting = True  # mandatory anchor
                else:
                    man = self._ckpt_manifest_for_extend(path, knobs)
                    if man is not None:
                        wrote_segment = self._save_segment(path, man)
            if not wrote_segment:
                self._save_full(path, knobs, compacting=compacting)
        # Emission runs outside the save lock (the checkpoint above is
        # already durable): a long build must not block the next save.
        # _emit_lock still serializes overlapping emissions.
        if self.emit_filter_path:
            with self._emit_lock:
                self._emit_filter()

    def _save_full(self, path: str, knobs, compacting: bool = False) -> None:
        """One full ck01 base snapshot (+ a fresh manifest in ck02
        mode). Caller holds the save lock."""
        # Snapshot the host items AND cut the dirty generation under the
        # fold lock: rows folded after this cut stay in the (new) log —
        # they may also land in the .npz, which is safe because segment
        # replay is insert-if-absent and set union.
        with self._fold_lock:
            host_items = sorted(
                (idx, eh, b";".join(s.hex().encode() for s in sorted(serials)))
                for (idx, eh), serials in self.host_serials.items())
            self._ckpt_shadow = self._ckpt_take_shadow()
            self._ckpt_clear_log()
            self._ckpt_track = knobs.mode == ckpt.MODE_INCREMENTAL
            self._ckpt_dirty_lost = False
        directory = os.path.dirname(os.path.abspath(path))
        fd, tmp_path = tempfile.mkstemp(
            prefix=os.path.basename(path) + ".tmp.", dir=directory)
        try:
            with os.fdopen(fd, "wb") as fh:
                self._write_npz(fh, host_items)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp_path, path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp_path)
            # Rows folded before the cut exist nowhere durable now.
            self._ckpt_mark_dirty_lost("base save failed")
            raise
        incr_counter("ckpt", "full_saves")
        if knobs.mode == ckpt.MODE_INCREMENTAL:
            ckpt.kill_point("base-post-rename")
            base_sha = ckpt.file_sha256(path)
            ckpt.write_manifest(path, {
                "format": ckpt.FORMAT, "baseSha256": base_sha,
                "maxChain": knobs.max_chain, "chain": []})
            ckpt.cleanup_segments(path)
            self._ckpt_path = path
            self._ckpt_base_sha = base_sha
            self._ckpt_tip_token = base_sha
            self._ckpt_chain_len = 0
            set_gauge("ckpt", "chain_length", value=0.0)
            if compacting:
                incr_counter("ckpt", "compactions")
        else:
            # A stale manifest of an earlier ck02 run must never pair
            # with this fresh base.
            with contextlib.suppress(OSError):
                os.unlink(ckpt.manifest_path(path))
            self._ckpt_track = False

    def _ckpt_manifest_for_extend(self, path: str, knobs):
        """The on-disk manifest this save may append to, or None when
        the durable tip is not the one in memory (the caller anchors)."""
        try:
            man = ckpt.read_manifest(path)
        except ckpt.CkptError:
            return None
        if man is None:
            # A plain ck01 base this aggregator loaded or wrote can grow
            # a chain, provided the bytes on disk are that base.
            if self._ckpt_chain_len:
                return None
            if (not os.path.exists(path)
                    or ckpt.file_sha256(path) != self._ckpt_base_sha):
                return None
            return {"format": ckpt.FORMAT, "baseSha256": self._ckpt_base_sha,
                    "maxChain": knobs.max_chain, "chain": []}
        if man.get("baseSha256") != self._ckpt_base_sha:
            return None
        chain = man.get("chain", [])
        try:
            disk_tip = (chain[-1].get("targetSha256") if chain
                        else man.get("baseSha256"))
        except AttributeError:
            return None
        if (disk_tip != self._ckpt_tip_token
                or len(chain) != self._ckpt_chain_len):
            return None
        return man

    def _save_segment(self, path: str, man: dict) -> bool:
        """Append one CTMRCK02 delta segment for this tick and update the
        manifest. False when the dirty log fails its self-check (the
        caller anchors instead). Caller holds the save lock."""
        with self._fold_lock:
            rows = self._ckpt_rows
            host_adds = self._ckpt_host_adds
            if len(rows) != self._ckpt_dev_inserted:
                self._ckpt_mark_dirty_lost(
                    f"recorded {len(rows)} rows, device inserted "
                    f"{self._ckpt_dev_inserted}")
                return False
            blob = self._ckpt_segment_blob(rows, host_adds)
            shadow = self._ckpt_take_shadow()
            self._ckpt_clear_log()
        if not rows and not host_adds and not self._ckpt_blob_nonempty(blob):
            # Nothing churned since the last durable tick.
            self._ckpt_shadow = shadow
            return True
        seq = self._ckpt_chain_len + 1
        data, header = ckpt.encode_segment(
            seq, self._ckpt_tip_token, rows, host_adds, blob)
        try:
            ckpt.write_segment(path, seq, data)
            man = dict(man)
            man["chain"] = list(man.get("chain", [])) + [{
                "seq": seq,
                "file": os.path.basename(ckpt.segment_path(path, seq)),
                "targetSha256": header["targetSha256"],
                "payloadSha256": header["payloadSha256"],
                "bytes": len(data),
                "rows": len(rows) + len(host_adds),
            }]
            ckpt.write_manifest(path, man)
        except BaseException:
            # The log was already cut; its rows exist nowhere durable.
            self._ckpt_mark_dirty_lost("segment write failed")
            raise
        self._ckpt_tip_token = header["targetSha256"]
        self._ckpt_chain_len = seq
        self._ckpt_shadow = shadow
        incr_counter("ckpt", "segments_written")
        incr_counter("ckpt", "segment_bytes", value=float(len(data)))
        incr_counter("ckpt", "dirty_rows",
                     value=float(len(rows) + len(host_adds)))
        set_gauge("ckpt", "chain_length", value=float(seq))
        return True

    def _ckpt_segment_blob(self, rows, host_adds) -> dict:
        """The non-row diffs of this tick against the last durable
        shadow. Caller holds the fold lock (countAfter is cut at the
        same instant as the dirty log)."""
        sh = self._ckpt_shadow or {
            "registry_len": 0,
            "issuer_totals": np.zeros((0,), np.int64),
            "verify_verified": np.zeros((0,), np.int64),
            "verify_failed": np.zeros((0,), np.int64),
            "crl": {}, "dn": {},
        }

        def vec_diff(cur, old):
            padded = np.zeros((cur.shape[0],), np.int64)
            padded[: old.shape[0]] = old
            nz = np.nonzero(cur != padded)[0]
            return {"len": int(cur.shape[0]),
                    "set": [[int(i), int(cur[i])] for i in nz]}

        def set_adds(cur, old):
            out = []
            for i, v in sorted(cur.items()):
                fresh = v - old.get(i, set())
                if fresh:
                    out.append([int(i), sorted(fresh)])
            return out

        blob = {
            "baseHour": int(self.base_hour),
            "countAfter": int(self._table_fill),
            "registryAdds": self.registry.ids_from(sh["registry_len"]),
            "issuerTotals": vec_diff(self.issuer_totals, sh["issuer_totals"]),
            "verifyVerified": vec_diff(self.verify_verified,
                                       sh["verify_verified"]),
            "verifyFailed": vec_diff(self.verify_failed, sh["verify_failed"]),
            "crlAdds": set_adds(self.crl_sets, sh["crl"]),
            "dnAdds": set_adds(self.dn_sets, sh["dn"]),
        }
        tokens = self.capture_content_hashes()
        if tokens is not None:
            # The content tokens of the groups this tick dirtied: a
            # restore checks its replayed capture against them.
            dirty = sorted({(int(i), int(e)) for i, e, _ in rows}
                           | {(int(i), int(e)) for i, e, _ in host_adds})
            blob["captureTokens"] = [
                [i, e, format(tokens.get((i, e), 0), "032x")]
                for i, e in dirty]
        return blob

    @staticmethod
    def _ckpt_blob_nonempty(blob: dict) -> bool:
        return bool(blob["registryAdds"] or blob["issuerTotals"]["set"]
                    or blob["verifyVerified"]["set"]
                    or blob["verifyFailed"]["set"]
                    or blob["crlAdds"] or blob["dnAdds"])

    def _write_npz(self, fh, host_items) -> None:
        """The ck01 ``.npz``: field for field, dtype for dtype, the JAX
        package's, so its loader reads this file unchanged. The table
        leaves the device in ONE copy under the table lock, as a
        host-owned array (on the CPU ``.numpy()`` is a view of the live
        rows, which the next step changes)."""
        with self._table_lock:
            layout, rows, count = self._table_snapshot()
        slots = (rows if layout == "open"
                 else rows[:, : buckettable.SLOTS * 5].reshape(-1, 5))
        extra = {}
        if self.filter_capture is not None:
            # The capture rides the checkpoint only when it is on (a
            # capture-off file has none of these fields). The host
            # lane's hex-joined encoding; sorted keys and serials.
            f_items = sorted(
                (idx, eh, b";".join(s.hex().encode() for s in sorted(ss)))
                for (idx, eh), ss in self.filter_capture.items())
            extra["filter_keys"] = np.array(
                [(i, e) for i, e, _ in f_items], dtype=np.int64
            ).reshape(-1, 2)
            extra["filter_vals"] = np.array(
                [v for _, _, v in f_items], dtype=object)
            # Exact content hashes, row-aligned with filter_keys, when
            # the capture has them (a restore then needs no rehash).
            hashes = self.capture_content_hashes()
            if hashes is not None:
                extra["filter_hashes"] = np.array(
                    [format(hashes.get((i, e), 0), "032x").encode()
                     for i, e, _ in f_items], dtype=object)
        np.savez_compressed(
            fh,
            layout=np.array(layout),
            n_shards=np.int64(self._topology_shards()),
            keys=slots[:, :4],
            meta=slots[:, 4],
            count=count,
            registry=np.frombuffer(self.registry.to_json().encode(),
                                   dtype=np.uint8),
            base_hour=np.int64(self.base_hour),
            issuer_totals=self.issuer_totals,
            verify_verified=self.verify_verified,
            verify_failed=self.verify_failed,
            host_keys=np.array([(i, e) for i, e, _ in host_items],
                               dtype=np.int64).reshape(-1, 2),
            host_vals=np.array([v for _, _, v in host_items], dtype=object),
            # Sorted keys: the bytes must not depend on fold order.
            crl_sets=np.frombuffer(json.dumps(
                {str(k): sorted(v) for k, v in sorted(self.crl_sets.items())}
            ).encode(), dtype=np.uint8),
            dn_sets=np.frombuffer(json.dumps(
                {str(k): sorted(v) for k, v in sorted(self.dn_sets.items())}
            ).encode(), dtype=np.uint8),
            allow_pickle=True,
            **extra,
        )

    def _topology_shards(self) -> int:
        """Shards the table's slot positions are addressed over (the
        ``n_shards`` field of a ck01 file)."""
        return 1

    def _table_snapshot(self) -> tuple[str, np.ndarray, np.ndarray]:
        """``(layout, rows, count)`` of the table for a ck01 file: its
        rows as a host-owned ``uint32`` copy, taken in ONE copy (on the
        CPU ``.numpy()`` is a view of the live rows, which the next step
        changes), and its occupied-slot count. Caller holds the table
        lock."""
        layout = ("open" if isinstance(self.table, hashtable.TableState)
                  else "bucket")
        rows = np.array(self.table.rows.cpu().numpy().view(np.uint32),
                        copy=True)
        return layout, rows, np.asarray(np.int32(int(self.table.count)))

    def _restore_table(self, keys: np.ndarray, meta: np.ndarray,
                       count: np.ndarray, layout: str,
                       ckpt_shards: int) -> None:
        """Rebuild the table on this aggregator's device from checkpoint
        (keys, meta) slots, in the snapshot's ``layout`` whatever
        ``CTMR_TABLE`` says (slot positions mean something only in the
        structure that wrote them). A snapshot of a sharded writer
        addresses its slots by shard, so its rows re-hash through the
        reinsert path, into the active layout, instead of being copied
        by position."""
        with self._table_lock:
            if ckpt_shards != 1:
                occ = keys.any(axis=-1)
                self.table = self._make_table(max(int(keys.shape[0]), 1))
                self.capacity = self.table.capacity
                overflow = self._bulk_reinsert(keys[occ], meta[occ])
                if overflow:
                    raise RuntimeError(
                        f"checkpoint restore overflowed {overflow} rows "
                        f"re-hashing a {ckpt_shards}-shard snapshot; "
                        f"increase tableBits (capacity {self.capacity})")
                self._table_fill = int(occ.sum())
                return
            total = torch.tensor(int(np.asarray(count).sum()),
                                 dtype=torch.int64, device=self.device)
            slots = buckettable.fuse_rows_np(keys, meta)
            if layout != "bucket":
                self.table = hashtable.TableState(
                    rows=torch.from_numpy(slots.view(np.int32)).to(self.device),
                    count=total)
                self.capacity = int(keys.shape[0])
                return
            nb = slots.shape[0] // buckettable.SLOTS
            rows = np.zeros((nb, buckettable.ROW_WORDS), np.uint32)
            rows[:, : buckettable.SLOTS * 5] = slots.reshape(nb, -1)
            # The insert trusts the cached fill word; positional
            # snapshots need not carry it.
            buckettable.fill_counts_np(rows)
            self.table = buckettable.BucketTable(
                rows=torch.from_numpy(rows.view(np.int32)).to(self.device),
                count=total)
            self.capacity = nb * buckettable.SLOTS

    def load_checkpoint(self, path: str) -> None:
        """Restore from ``path``: the base ``.npz`` plus whatever
        CTMRCK02 chain its manifest names. ``resolve_chain`` validates
        every link before anything is applied, so a torn tick loads as
        the previous durable state, never a partial one."""
        chain = ckpt.resolve_chain(path)
        self._load_base(path)
        for header, dev_rows, host_rows, blob in chain.segments:
            self._ckpt_replay_segment(header, dev_rows, host_rows, blob)
        if chain.segments:
            incr_counter("ckpt", "restore_segments",
                         value=float(len(chain.segments)))
        self._ckpt_arm(path, chain.base_sha, chain.tip_token,
                       len(chain.segments))

    def _load_base(self, path: str) -> None:
        with np.load(path, allow_pickle=True) as z:
            # `layout` is absent in snapshots older than the bucket table
            # (open), `n_shards` in those older than the sharded writer
            # (1). Checked before any state changes: formats the port
            # does not read yet are refused, never half-loaded.
            layout = str(z["layout"]) if "layout" in z else "open"
            ckpt_shards = int(z["n_shards"]) if "n_shards" in z else 1
            count = np.asarray(z["count"])
            self._restore_table(np.asarray(z["keys"]), np.asarray(z["meta"]),
                                count, layout, ckpt_shards)
            self._device_written = bool(count.sum() > 0)
            self._table_fill = int(count.sum())
            self._inflight_lanes = 0
            self.base_hour = int(z["base_hour"])
            self.registry = IssuerRegistry.from_json(
                z["registry"].tobytes().decode())
            self.issuer_totals = z["issuer_totals"].copy()
            for name in ("verify_verified", "verify_failed"):
                setattr(self, name,
                        z[name].copy() if name in z
                        else np.zeros((packing.MAX_ISSUERS,), np.int64))
            self.host_serials = {}
            for (idx, eh), vals in zip(z["host_keys"], z["host_vals"]):
                self.host_serials[(int(idx), int(eh))] = {
                    bytes.fromhex(h.decode()) for h in vals.split(b";") if h}
            self.crl_sets = {
                int(k): set(v) for k, v in
                json.loads(z["crl_sets"].tobytes().decode()).items()}
            self.dn_sets = {
                int(k): set(v) for k, v in
                json.loads(z["dn_sets"].tobytes().decode()).items()}
            # A file without the capture fields turns capture off; a
            # later enable_filter_capture() re-seeds from the host sets.
            self.filter_capture = None
            self.filter_capture_hashes = None
            if "filter_keys" in z:
                fkeys = z["filter_keys"].reshape(-1, 2)
                cap: dict[tuple[int, int], set[bytes]] = {}
                for (idx, eh), blob in zip(fkeys, z["filter_vals"]):
                    cap[(int(idx), int(eh))] = {
                        bytes.fromhex(h.decode())
                        for h in blob.split(b";") if h}
                self.filter_capture = cap
                if "filter_hashes" in z:
                    self.filter_capture_hashes = {
                        (int(idx), int(eh)): int(hx.decode(), 16)
                        for (idx, eh), hx in zip(fkeys, z["filter_hashes"])}
                else:
                    # The restored dict is the whole capture: recomputing
                    # regains exact tracking for the rest of the run.
                    self.filter_capture_hashes = {
                        key: content_token(serials)[1]
                        for key, serials in cap.items()}
                self.want_serials = True

    def _ckpt_replay_segment(self, header, dev_rows, host_rows,
                             blob) -> None:
        """Apply one decoded delta segment on top of the current state
        (the base or earlier segments)."""
        base_hour = int(blob.get("baseHour", self.base_hour))
        if base_hour != self.base_hour:
            raise ckpt.CkptError(
                f"segment baseHour {base_hour} != base {self.base_hour}")
        # Registry first: replayed rows may name issuers the base
        # predates.
        for iid in blob.get("registryAdds", []):
            self.registry.assign_issuer(Issuer.from_string(iid))
        if dev_rows:
            n = len(dev_rows)
            idx = np.array([r[0] for r in dev_rows], np.int64)
            eh = np.array([r[1] for r in dev_rows], np.int64)
            slen = np.array([len(r[2]) for r in dev_rows], np.int32)
            sarr = np.zeros((n, packing.MAX_SERIAL_BYTES), np.uint8)
            for i, (_, _, sb) in enumerate(dev_rows):
                sarr[i, : len(sb)] = np.frombuffer(sb, np.uint8)
            keys = packing.fingerprints_np(idx, eh, sarr, slen)
            off = eh - self.base_hour
            if (off < 0).any() or (off >= packing.META_HOUR_SPAN).any():
                raise ckpt.CkptError("segment exp hour outside meta span")
            meta = ((idx << packing.META_HOUR_BITS) | off).astype(np.uint32)
            overflow = self._chain_insert(keys, meta)
            if overflow:
                raise ckpt.CkptError(
                    f"segment replay overflowed {overflow} rows "
                    f"(base capacity {self.capacity})")
            self._device_written = True
        for i_, e_, sb in dev_rows:
            self._capture_serial(int(i_), int(e_), sb)
        for i_, e_, sb in host_rows:
            key = (int(i_), int(e_))
            self.host_serials.setdefault(key, set()).add(sb)
            self._capture_serial(key[0], key[1], sb)
        for name, attr in (("issuerTotals", "issuer_totals"),
                           ("verifyVerified", "verify_verified"),
                           ("verifyFailed", "verify_failed")):
            self._ckpt_apply_vec(attr, blob.get(name))
        for i, urls in blob.get("crlAdds", []):
            self.crl_sets.setdefault(int(i), set()).update(urls)
        for i, names in blob.get("dnAdds", []):
            self.dn_sets.setdefault(int(i), set()).update(names)
        # Self-checks: the replayed table holds exactly the row count the
        # writer saw at this tick, and the capture groups hash to the
        # writer's content tokens.
        self._table_fill = self._table_fill_exact()
        want = blob.get("countAfter")
        if want is not None and int(want) != self._table_fill:
            raise ckpt.CkptError(
                f"segment replay count {self._table_fill} != "
                f"recorded {want}")
        tokens = self.capture_content_hashes()
        if tokens is not None:
            for i, e, hx in blob.get("captureTokens", []):
                got = format(tokens.get((int(i), int(e)), 0), "032x")
                if got != hx:
                    raise ckpt.CkptError(
                        f"capture content token mismatch for group "
                        f"({i}, {e}) after replay")

    def _chain_insert(self, keys: np.ndarray, meta: np.ndarray) -> int:
        """Insert chain-replayed rows into the CURRENT table. The insert
        is insert-if-absent, so replay is idempotent against rows the
        base already holds (a fold racing a base save may land in
        both)."""
        return self._bulk_reinsert(keys, meta)

    def _ckpt_apply_vec(self, attr: str, spec) -> None:
        """Apply one {len, set: [[idx, value], ...]} vector diff:
        absolute values at changed indices, so replay in chain order
        converges however many segments touch an index."""
        if not spec:
            return
        vec = getattr(self, attr)
        m = int(spec.get("len", vec.shape[0]))
        if m > vec.shape[0]:
            grown = np.zeros((m,), np.int64)
            grown[: vec.shape[0]] = vec
            vec = grown
        for i, v in spec.get("set", []):
            vec[int(i)] = int(v)
        setattr(self, attr, vec)
