"""The device reduce state and its exact host fallback lane (port of
``ct_mapreduce_tpu.agg.aggregator`` for one device).

:class:`TorchAggregator` replaces the Redis-resident reduce state of
the reference (serial dedup sets, per-issuer CRL/DN sets, reference
storage/knowncertificates.go, storage/issuermetadata.go) with:

- a device-resident bucket dedup table (:mod:`..ops.buckettable`)
  driven by the walker step or the pre-parsed step
  (:mod:`..ops.pipeline`),
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

Left out so far: the staged multi-chunk walker lane, checkpoints,
filter capture, signature verification and the ingest sink's overlap
threads.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Optional
from urllib.parse import urlparse

import numpy as np
import torch

from ct_mapreduce_tpu_torch.core import der as hostder
from ct_mapreduce_tpu_torch.core import packing
from ct_mapreduce_tpu_torch.core.types import ExpDate, Issuer
from ct_mapreduce_tpu_torch.device import resolve_device
from ct_mapreduce_tpu_torch.ops import buckettable, pipeline
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
    ``complete()`` reads the results back and folds them. Completion
    is FIFO and claimed before the fold, so a fold that raises is never
    re-applied."""

    def __init__(self, agg: "TorchAggregator", res: IngestResult) -> None:
        self._agg = agg
        self._res = res
        self._done = False

    def _fold(self) -> None:
        raise NotImplementedError

    def complete(self) -> IngestResult:
        if self._done:
            return self._res
        self._done = True
        agg = self._agg
        if self in agg._outstanding:
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
    lane."""

    def __init__(self, agg: "TorchAggregator", chunks, res: IngestResult,
                 data: np.ndarray, length: np.ndarray) -> None:
        super().__init__(agg, res)
        self._chunks = chunks  # [(batch, device_pos, lanes, out)]
        self._data = data
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


@dataclass
class AggregateSnapshot:
    """Drained reduce state — the material of storage-statistics."""

    counts: dict[tuple[str, str], int]  # (issuerID, expDateID) → serials
    crls: dict[str, set[str]]  # issuerID → CRL DP URLs
    dns: dict[str, set[str]]  # issuerID → issuer DN strings
    total: int = 0


def _pack_out(out: pipeline.StepOut) -> torch.Tensor:
    """A walker step's small per-lane outputs as ONE int32[7, B] tensor,
    so the host pays one device-to-host copy for them: row 0 the flag
    word (host_lane | was_unknown<<1 | filtered_ca<<2 |
    filtered_expired<<3 | filtered_cn<<4 | probe_overflow<<5), rows 1-6
    not_after_hour, serial_len, crldp_off, crldp_len, issuer_name_off,
    issuer_name_len (the JAX aggregator's layout)."""
    flags = torch.zeros_like(out.not_after_hour)
    for bit, f in enumerate((out.host_lane, out.was_unknown,
                             out.filtered_ca, out.filtered_expired,
                             out.filtered_cn, out.probe_overflow)):
        flags |= f.to(torch.int32) << bit
    return torch.stack([flags, out.not_after_hour, out.serial_len,
                        out.crldp_off, out.crldp_len, out.issuer_name_off,
                        out.issuer_name_len], dim=0)


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
        # The ceiling rounds DOWN to a capacity the bucket layout can
        # build (24·2^k slots), so maybe_grow's at-ceiling guard fires
        # instead of rebuilding at the same size on every batch.
        self.max_capacity = (buckettable.bucket_count(
            max_capacity, max_capacity) * buckettable.SLOTS)
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
        # Submitted-but-not-completed ingests of both lanes (FIFO).
        self._outstanding: list[_Pending] = []
        # False until the first device step: lets the host lane skip
        # cross-domain membership probes for host-only usage.
        self._device_written = False
        # Set False by a caller that never needs per-entry serial bytes.
        self.want_serials = True
        self.set_cn_prefixes(cn_prefixes)
        self.metrics: dict[str, int] = {
            "inserted": 0, "known": 0, "filtered_ca": 0, "filtered_expired": 0,
            "filtered_cn": 0, "host_lane": 0, "parse_errors": 0, "overflow": 0,
            "dispatch_spill": 0,
        }

    # -- table state -----------------------------------------------------
    def _make_table(self, capacity: int) -> buckettable.BucketTable:
        return buckettable.make_table(
            capacity, max_capacity=self.max_capacity, device=self.device)

    def _drain_table(self) -> tuple[np.ndarray, np.ndarray]:
        return buckettable.drain_np(self.table)

    def _device_contains(self, fps: np.ndarray) -> np.ndarray:
        """bool[n]: are these uint32[n, 4] fingerprints in the table?"""
        if fps.shape[0] == 0:
            return np.zeros((0,), bool)
        keys = torch.from_numpy(
            np.ascontiguousarray(fps, np.uint32).view(np.int32)).to(
                self.device)
        return buckettable.contains(
            self.table, keys, max_probes=self.max_probes).cpu().numpy()

    # -- load-factor policy ---------------------------------------------
    def _table_fill_exact(self) -> int:
        """Occupied-slot count, synced from the device."""
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

    # -- ingest ----------------------------------------------------------
    def complete_outstanding(self) -> None:
        """Fold every un-completed submit into host state (FIFO). Any
        reader of aggregate state calls this first."""
        while self._outstanding:
            self._outstanding[0].complete()

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

    def ingest_packed_submit(self, data: np.ndarray, length: np.ndarray,
                             issuer_idx: np.ndarray,
                             valid: np.ndarray) -> PendingIngest:
        """Queue the walker steps for a packed batch without reading
        anything back: each chunk of ``batch_size`` rows is copied to
        the device and stepped; ``complete()`` reads the results."""
        n = int(data.shape[0])
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
                batch = packing.PackedBatch(
                    data[start:end], length[start:end],
                    res.issuer_idx[start:end], valid[start:end])
            else:  # pad the tail chunk to the batch width
                def pad(a, dtype):
                    out = np.zeros((b,) + a.shape[1:], dtype)
                    out[:m] = a[start:end]
                    return out
                batch = packing.PackedBatch(
                    pad(data, np.uint8), pad(length, np.int32),
                    pad(res.issuer_idx, np.int32), pad(valid, bool))
            lanes = np.nonzero(valid[start:end])[0].astype(np.int64)
            out = self._device_step_packed(batch)
            chunks.append((batch, lanes + start, lanes, out))
        pending = PendingIngest(self, chunks, res, data, length)
        self._outstanding.append(pending)
        return pending

    def _device_step_packed(self, batch: packing.PackedBatch):
        """Queue one walker step on the table's device."""
        self._device_written = True

        def dev(a, dtype) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                self.device)

        self.table, out = pipeline.ingest_core(
            self.table, dev(batch.data, np.uint8),
            dev(batch.length, np.int32), dev(batch.issuer_idx, np.int32),
            dev(batch.valid, bool), self._now_hour(), self.base_hour,
            self._prefix_dev, self._prefix_lens_dev,
            max_probes=self.max_probes)
        return out

    def _consume_out(self, batch: packing.PackedBatch, out, device_pos,
                     res: IngestResult, lanes, host_rows=None) -> list[int]:
        """Read one walker step's outputs back (ONE packed int32[7, B]
        copy, plus the counts and, when serials are wanted, the serial
        window) and fold them into ``res`` at the global positions
        ``device_pos`` (chunk lanes ``lanes``). ``host_rows`` is the
        host copy of the rows by global position, used for metadata
        windows instead of the batch. Returns the positions that must
        take the exact host lane."""
        P = _pack_out(out).cpu().numpy()  # the one per-lane readback
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
        self.metrics["overflow"] += int(ovf.sum())
        counts = out.issuer_unknown_counts.cpu().numpy().astype(np.int64)
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
            sarr = out.serials.cpu().numpy()
            for p_, l_ in zip(kp, kl):
                sb = sarr[l_, : slen[l_]].tobytes()
                res.serials[p_] = sb
                if wu[l_]:
                    key = (int(batch.issuer_idx[l_]), int(nah[l_]))
                    if sb in self.host_serials.get(key, ()):
                        # Cross-encoding guard (module docstring).
                        wu[l_] = False
                        self.issuer_totals[int(batch.issuer_idx[l_])] -= 1
                    else:
                        res.was_unknown[p_] = True
        else:
            res.was_unknown[kp[wu[kl]]] = True
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

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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
                    if sb in self.host_serials.get(key, ()):
                        # Cross-encoding guard (module docstring).
                        wu[p_] = False
                        self.issuer_totals[int(plan.issuer_idx[p_])] -= 1
                    else:
                        res.was_unknown[p_] = True
        else:
            res.was_unknown[wu] = True
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
        return AggregateSnapshot(
            counts=counts, crls=crls, dns=dns, total=sum(counts.values()))

    def _count_key(self, issuer_idx: int, exp_hour: int) -> tuple[str, str]:
        return (
            self.registry.issuer_at(issuer_idx).id(),
            ExpDate.from_unix_hour(exp_hour).id(),
        )
