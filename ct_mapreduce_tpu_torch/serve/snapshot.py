"""Snapshot isolation for the query plane: epoch-pinned read views (port
of ``ct_mapreduce_tpu.serve.snapshot``).

Queries must not race ingest: the aggregator's table rows change in
place on every insert, and its host-lane sets mutate under the fold
lock. So the query plane reads an **immutable epoch-pinned view**:
:func:`capture_view` takes the aggregator's fold lock, then its table
lock (the global order, ``TorchAggregator.__init__``), copies the
table rows in one copy, and freezes the host-lane serial sets. Every
query against that view is lock-free and sees one consistent epoch.

Consistency contract: any serial whose ingest was **acked** (its
``complete()`` returned) before the view was captured reads as known,
and a serial never fed cannot read known (membership is exact; the
128-bit fingerprint's collision odds are the ones the dedup accepts).
Staleness is a bound, not an accident: :class:`SnapshotManager`
refreshes a view older than ``max_staleness_s``, and every response
carries the view's epoch and age.

:class:`ReplicaPool` keeps N views **pinned on the device** (made on a
background refresh thread) and serves them round-robin, refreshing
them one at a time, so a capture never stalls the serving path and
``contains`` runs as tensor ops on the pinned copy.

Where this port departs from the JAX module:

* A device view of an aggregator on CUDA is pinned by a copy on the
  card itself, made under the locks, so no capture crosses PCIe; its
  host mirror (``rows``) is copied off the card only if something
  reads it. Views pin onto the aggregator's own ``torch.device``.
* The host fallback is kept only where the view lives on the CPU (the
  reference's contract: a failed pin degrades to the host mirror and
  counts ``serve.device_fallback``). A CUDA view falls back only when
  the card is out of memory at pin time; any other fault there is
  raised, so the batch fails with a 5xx instead of being answered
  silently on the host.
* A sharded view (``n_shards > 1``, a ``ShardedAggregator``'s global
  row view) routes each fingerprint to its home shard's row block with
  the ingest's routing hash. In a ``ReplicaPool`` each block is pinned
  on its own shard's device (on the card: a copy of the shard's rows
  made there); a device view with no pool targets pins the global rows
  on the aggregator's device and probes them with
  ``agg.sharded._contains_global*``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from ct_mapreduce_tpu_torch.agg import sharded
from ct_mapreduce_tpu_torch.core import packing
from ct_mapreduce_tpu_torch.ops import buckettable, hashtable, pipeline
from ct_mapreduce_tpu_torch.telemetry import trace
from ct_mapreduce_tpu_torch.telemetry.metrics import (
    incr_counter,
    measure,
    set_gauge,
)

def _place(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 host rows → an int32 bit-pattern copy on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(rows).view(np.int32)).to(
        device, copy=True)


def _concrete(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` → ``cuda:<current>``),
    so a view's target compares equal to the device its copy lands on."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _pow2_width(n: int) -> int:
    """Probe batches pad to a power of two, at least 16 (the JAX
    module's bound on compiled shapes; the answers do not depend on
    it)."""
    return max(16, 1 << max(0, (n - 1).bit_length()))


class TableView:
    """One immutable epoch of aggregator state, query-ready.

    ``rows`` is the host copy of the dedup table (``uint32[n_buckets,
    128]`` bucket rows or ``uint32[capacity, 5]`` open-layout rows, per
    ``layout``); a view captured straight onto the card is given
    ``dev_rows`` (the int32 bit pattern) instead, and copies ``rows``
    off the card on first read. ``host_serials`` maps ``(issuer_idx, exp_hour)`` to a
    frozen set of exact-lane serial bytes. Membership is the union of
    the two domains, mirroring the aggregator's own cross-domain
    guards.
    """

    def __init__(
        self,
        epoch: int,
        rows: Optional[np.ndarray],
        layout: str,
        n_shards: int,
        max_probes: int,
        base_hour: int,
        host_serials: dict,
        issuer_totals: np.ndarray,
        crl_counts: dict,
        dn_counts: dict,
        registry,
        table_fill: int,
        capacity: int,
        device: bool = False,
        devices: Optional[list] = None,
        created_wall: Optional[float] = None,
        verify_counts: Optional[dict] = None,
        home_device: Optional[torch.device] = None,
        dev_rows: Optional[torch.Tensor] = None,
        dev_blocks: Optional[list] = None,
    ) -> None:
        given = [x is not None for x in (rows, dev_rows, dev_blocks)]
        if sum(given) != 1:
            raise ValueError("a view needs exactly one of rows, dev_rows, "
                             "dev_blocks")
        if dev_blocks is not None and len(dev_blocks) != n_shards:
            raise ValueError(f"{len(dev_blocks)} blocks for {n_shards} "
                             "shards")
        self.epoch = epoch
        self._rows = rows
        self._rows_lock = threading.Lock()
        if rows is not None:
            self.n_rows = int(rows.shape[0])
        elif dev_rows is not None:
            self.n_rows = int(dev_rows.shape[0])
        else:
            self.n_rows = sum(int(b.shape[0]) for b in dev_blocks)
        self.layout = layout
        self.n_shards = n_shards
        self.max_probes = max_probes
        self.base_hour = base_hour
        self.host_serials = host_serials
        self.issuer_totals = issuer_totals
        self.crl_counts = crl_counts
        self.dn_counts = dn_counts
        self.registry = registry
        self.table_fill = table_fill
        self.capacity = capacity
        # issuerID → (verified, failed) embedded-SCT verdicts as of this
        # epoch; empty while the verify lane is off.
        self.verify_counts = verify_counts or {}
        # Anchored at capture START: any ingest acked before this
        # instant had released the fold lock before the capture took
        # it, so the surfaced staleness errs larger, never smaller.
        self.created_wall = (time.time() if created_wall is None
                             else created_wall)
        self._device = bool(device)
        self._devices = devices  # explicit placement targets (pool mode)
        # Where a pin lands without explicit targets: the aggregator's
        # device.
        self._home_device = (torch.device("cpu") if home_device is None
                             else _concrete(home_device))
        self._dev_rows: Optional[torch.Tensor] = dev_rows  # pinned copy
        # A sharded pool's pinned per-shard row blocks, in shard order.
        self._dev_blocks: Optional[list] = dev_blocks
        self.replica_ix = None  # pool slot this view serves from

    @property
    def rows(self) -> np.ndarray:
        """The host mirror (the global row view of a sharded one), copied
        off the card on first read when the view was captured there."""
        if self._rows is None:
            with self._rows_lock:
                if self._rows is None:
                    dev = ([self._dev_rows] if self._dev_rows is not None
                           else self._dev_blocks)
                    self._rows = torch.cat([d.cpu() for d in dev]).numpy(
                        ).view(np.uint32)
        return self._rows

    def age_s(self) -> float:
        return max(0.0, time.time() - self.created_wall)

    def _target(self) -> torch.device:
        """Where a pin lands: the explicit target, else the home."""
        return _concrete(self._devices[0]) if self._devices \
            else self._home_device

    @property
    def pinned_device(self) -> Optional[torch.device]:
        """The device of the pinned copy (of shard 0's block in a
        sharded pool), or None while unpinned."""
        devs = self.pinned_devices
        return devs[0] if devs else None

    @property
    def pinned_devices(self) -> list:
        """The device of each pinned copy: one for the whole rows, one a
        shard for a sharded pool's blocks; empty while unpinned."""
        if self._dev_blocks is not None:
            return [b.device for b in self._dev_blocks]
        return [] if self._dev_rows is None else [self._dev_rows.device]

    def _block(self, s: int) -> np.ndarray:
        """Shard ``s``'s contiguous row block of the host mirror."""
        block = self.n_rows // self.n_shards
        return self.rows[s * block: (s + 1) * block]

    def pin(self) -> "TableView":
        """Copy the rows to the device NOW, on the caller's (refresh)
        thread, so the serving path never pays the copy. In a sharded
        pool each shard's row block goes to its own shard's device, so
        no device holds the global rows. A failure to pin flips the view
        to the host mirror for good (the next epoch's capture tries the
        device again), counted by ``serve.device_fallback``: any failure
        for a CPU target, only running out of memory for a CUDA one. Any
        other CUDA fault is raised."""
        if not self._device or self.pinned_devices:
            return self
        sharded_pool = self.n_shards > 1 and bool(self._devices)
        devs = ([_concrete(self._devices[s % len(self._devices)])
                 for s in range(self.n_shards)] if sharded_pool
                else [self._target()])
        try:
            if sharded_pool:
                self._dev_blocks = [_place(self._block(s), d)
                                    for s, d in enumerate(devs)]
            else:
                self._dev_rows = _place(self.rows, devs[0])
        except Exception as err:
            if any(d.type != "cpu" for d in devs) and not isinstance(
                    err, torch.cuda.OutOfMemoryError):
                raise
            incr_counter("serve", "device_fallback")
            self._device = False
            self._dev_rows = None
            self._dev_blocks = None
        return self

    # -- membership ------------------------------------------------------
    def contains_fps(self, fps: np.ndarray) -> np.ndarray:
        """bool[n] membership of fingerprint rows ``uint32[n, 4]`` against
        the pinned table: host NumPy by default; ``device`` views pin one
        device copy and probe it with the layout's ``contains`` on
        power-of-two padded batches."""
        n = int(len(fps))
        if n == 0 or self.n_rows == 0:
            return np.zeros((n,), bool)
        fps = np.asarray(fps, np.uint32).reshape(n, 4)
        if self._device:
            return self._contains_device(fps)
        with trace.span("serve.contains_host", cat="serve", lanes=n):
            return self._contains_host(fps)

    def _contains_host(self, fps: np.ndarray) -> np.ndarray:
        contains_np = (buckettable.contains_np if self.layout == "bucket"
                       else hashtable.contains_np)
        if self.n_shards == 1:
            return contains_np(self.rows, fps, max_probes=self.max_probes)
        # Sharded: home shard from the routing hash, then the layout's
        # probe inside that shard's row block, the addressing the
        # sharded insert placed the key by (one probe a shard present).
        dest = sharded.shard_of_np(fps, self.n_shards)
        out = np.zeros((fps.shape[0],), bool)
        for s in np.unique(dest):
            sel = dest == s
            out[sel] = contains_np(self._block(int(s)), fps[sel],
                                   max_probes=self.max_probes)
        return out

    def _contains_device(self, fps: np.ndarray) -> np.ndarray:
        if not self.pinned_devices:
            # Pinned once per view: queries never touch the live table.
            self.pin()
            if not self._device:
                return self._contains_host(fps)
        try:
            with trace.span("serve.contains_device", cat="serve",
                            lanes=int(fps.shape[0])):
                return self._contains_device_pinned(fps)
        except Exception:
            if any(d.type != "cpu" for d in self.pinned_devices):
                raise  # a CUDA fault fails the batch, never the host
            # A CPU pinned copy that stops answering degrades to the
            # host mirror instead of failing the batch, as in the JAX
            # package; the next epoch retries the device.
            incr_counter("serve", "device_fallback")
            self._device = False
            self._dev_rows = None
            self._dev_blocks = None
            return self._contains_host(fps)

    def _state(self, rows: torch.Tensor):
        """A probe state over pinned ``rows`` in the view's layout."""
        zero = torch.zeros((), dtype=torch.int64, device=rows.device)
        return (buckettable.BucketTable(rows, zero)
                if self.layout == "bucket"
                else hashtable.TableState(rows, zero))

    def _contains_device_pinned(self, fps: np.ndarray) -> np.ndarray:
        if self._dev_blocks is not None:
            # Shard-routed: home shard on the host (the ingest's routing
            # hash), then the layout's probe against that shard's block
            # on that shard's device.
            dest = sharded.shard_of_np(fps, self.n_shards)
            out = np.zeros((fps.shape[0],), bool)
            for s in np.unique(dest):
                sel = dest == s
                out[sel] = self._probe_state(
                    self._state(self._dev_blocks[int(s)]), fps[sel])
            return out
        if self.n_shards > 1:
            n = fps.shape[0]
            width = _pow2_width(n)
            if width != n:
                fps = np.pad(fps, ((0, width - n), (0, 0)))
            fn = (sharded._contains_global_bucket if self.layout == "bucket"
                  else sharded._contains_global)
            found = fn(self._dev_rows, _place(fps, self._dev_rows.device),
                       self.n_shards, self.max_probes)
            return found.cpu().numpy()[:n]
        return self._probe_state(self._state(self._dev_rows), fps)

    def _probe_state(self, state, fps: np.ndarray) -> np.ndarray:
        """The layout's ``contains`` against one pinned probe state,
        padded to a power of two (min 16) as the aggregator's
        ``_device_contains`` is in the JAX package; the keys go to the
        state's device."""
        n = fps.shape[0]
        width = _pow2_width(n)
        if width != n:
            fps = np.pad(fps, ((0, width - n), (0, 0)))
        keys = _place(fps, state.rows.device)
        found = pipeline.table_contains(state, keys,
                                        max_probes=self.max_probes)
        return found.cpu().numpy()[:n]

    def lookup(self, items: list) -> np.ndarray:
        """Batch membership: ``items`` is a list of ``(issuer_idx,
        exp_hour, serial_bytes)`` (``issuer_idx`` may be ``-1`` for an
        issuer the registry has never seen). Returns bool[n]: known in
        EITHER dedup domain.

        Device-eligible lanes (serial fits the fingerprint window,
        issuer/hour in meta range: the predicates that routed them to
        the device at ingest) probe the pinned table through the host
        fingerprint; every lane also checks the frozen host-lane set,
        because overflow and boundary routing let the domains overlap.
        """
        n = len(items)
        out = np.zeros((n,), bool)
        if n == 0:
            return out
        idx = np.fromiter((it[0] for it in items), np.int64, n)
        eh = np.fromiter((it[1] for it in items), np.int64, n)
        slen = np.fromiter((len(it[2]) for it in items), np.int64, n)
        eligible = (
            (idx >= 0)
            & (idx < packing.MAX_ISSUERS)
            & (slen <= packing.MAX_SERIAL_BYTES)
            & (eh - self.base_hour >= 0)
            & (eh - self.base_hour < packing.META_HOUR_SPAN)
        )
        sel = np.nonzero(eligible)[0]
        if sel.size:
            serials = np.zeros((sel.size, packing.MAX_SERIAL_BYTES), np.uint8)
            for j, p in enumerate(sel):
                sb = items[p][2]
                serials[j, : len(sb)] = np.frombuffer(sb, np.uint8)
            fps = packing.fingerprints_np(
                idx[sel], eh[sel], serials, slen[sel])
            out[sel] = self.contains_fps(fps)
        if self.host_serials:
            for p in range(n):
                if not out[p]:
                    bucket = self.host_serials.get((int(idx[p]), int(eh[p])))
                    if bucket is not None and items[p][2] in bucket:
                        out[p] = True
        return out

    # -- metadata --------------------------------------------------------
    def issuer_meta(self, issuer_id: str) -> Optional[dict]:
        """Per-issuer metadata as of this epoch, or None when the
        registry has never seen the issuer."""
        idx = self.registry.index_of_issuer_id(issuer_id)
        if idx is None:
            return None
        total = (int(self.issuer_totals[idx])
                 if idx < self.issuer_totals.shape[0] else 0)
        meta = {
            "issuer": issuer_id,
            "unknown_total": total,
            "crls": int(self.crl_counts.get(idx, 0)),
            "dns": int(self.dn_counts.get(idx, 0)),
        }
        vc = self.verify_counts.get(issuer_id)
        if vc is not None:
            meta["verified"], meta["failed"] = int(vc[0]), int(vc[1])
        return meta


def capture_view(agg, epoch: int, device: bool = False,
                 devices: Optional[list] = None) -> TableView:
    """Pin one epoch of ``agg`` (a ``TorchAggregator`` or a
    ``ShardedAggregator``, on any device) into an immutable
    :class:`TableView`.

    Lock order is fold → table, as for every other cross-state reader
    (``grow``, ``drain``): the fold lock freezes the host-lane sets,
    the table lock keeps an insert or a grow from changing the rows
    mid-copy. A device view whose target is the aggregator's own CUDA
    device is pinned by one copy on the card; otherwise the rows leave
    the device in one copy (forced on the CPU, since the live rows
    change in place). A sharded aggregator's view is its global row view;
    when each shard's pool target is that shard's own card, each shard's
    rows are copied on its card (the pinned blocks), else the global
    rows leave the devices in one copy a shard."""
    dedup = getattr(agg, "dedup", None)
    home = _concrete(agg.device)
    target = _concrete(devices[0]) if devices else home
    on_card = device and home.type == "cuda" and target == home
    rows = dev_rows = dev_blocks = None
    n_shards = 1
    t0 = time.time()
    with agg._fold_lock:
        with agg._table_lock:
            if dedup is not None:
                layout, n_shards = dedup.layout, dedup.n_shards
                shard_devs = [_concrete(d) for d in dedup.devices]
                if (device and devices and all(d.type == "cuda"
                                               for d in shard_devs)
                        and [_concrete(devices[s % len(devices)])
                             for s in range(n_shards)] == shard_devs):
                    try:
                        dev_blocks = [dedup.tables[s].rows.clone()
                                      for s in range(n_shards)]
                    except torch.cuda.OutOfMemoryError:
                        incr_counter("serve", "device_fallback")
                        device = False
                if dev_blocks is None:
                    rows = dedup.host_rows()
            else:
                layout = ("open"
                          if isinstance(agg.table, hashtable.TableState)
                          else "bucket")
            if on_card and dedup is None:
                try:
                    dev_rows = agg.table.rows.clone()
                except torch.cuda.OutOfMemoryError:
                    incr_counter("serve", "device_fallback")
                    device = False
            if dedup is None and dev_rows is None:
                rows = agg.table.rows.to("cpu", copy=True).numpy().view(
                    np.uint32)
            capacity = agg.capacity
        host_serials = {k: frozenset(v)
                        for k, v in agg.host_serials.items() if v}
        issuer_totals = agg.issuer_totals.copy()
        crl_counts = {i: len(s) for i, s in agg.crl_sets.items()}
        dn_counts = {i: len(s) for i, s in agg.dn_sets.items()}
        verify_counts = agg.verify_counts()
        table_fill = agg._table_fill
    return TableView(
        epoch=epoch, rows=rows, layout=layout, n_shards=n_shards,
        max_probes=agg.max_probes, base_hour=agg.base_hour,
        host_serials=host_serials, issuer_totals=issuer_totals,
        crl_counts=crl_counts, dn_counts=dn_counts, registry=agg.registry,
        table_fill=table_fill,
        capacity=capacity,
        device=device,
        devices=devices,
        created_wall=t0,
        verify_counts=verify_counts,
        home_device=home,
        dev_rows=dev_rows,
        dev_blocks=dev_blocks,
    )


class SnapshotManager:
    """Bounded-staleness view cache: ``view()`` returns the current
    epoch, refreshing (at most one capture in flight; concurrent
    requesters coalesce on the lock) once the view is older than
    ``max_staleness_s``. ``refresh()`` forces a new epoch."""

    def __init__(self, agg, max_staleness_s: float = 1.0,
                 device: bool = False) -> None:
        self._agg = agg
        self.max_staleness_s = float(max_staleness_s)
        self._device = bool(device)
        self._lock = threading.Lock()
        self._view: Optional[TableView] = None
        self._epoch = 0
        self._refreshing = False

    @property
    def refresh_in_flight(self) -> bool:
        """True while a capture runs: readers that raced past the
        staleness check get the previous view meanwhile, so staleness
        can exceed the bound for a capture's length; this flag and the
        ``serve.snapshot_age_s`` gauge make that window visible."""
        return self._refreshing

    def view(self) -> TableView:
        v = self._view
        if v is not None and v.age_s() <= self.max_staleness_s:
            set_gauge("serve", "snapshot_age_s", value=v.age_s())
            return v
        with self._lock:
            v = self._view  # a concurrent refresher may have won
            if v is not None and v.age_s() <= self.max_staleness_s:
                return v
            return self._refresh_locked()

    def refresh(self) -> TableView:
        with self._lock:
            return self._refresh_locked()

    def _refresh_locked(self) -> TableView:
        self._epoch += 1
        self._refreshing = True
        try:
            with trace.span("serve.snapshot", cat="serve",
                            epoch=self._epoch), \
                    measure("serve", "snapshot_capture_s"):
                v = capture_view(self._agg, self._epoch,
                                 device=self._device)
        finally:
            self._refreshing = False
        self._view = v
        incr_counter("serve", "snapshot_refresh")
        set_gauge("serve", "snapshot_epoch", value=float(self._epoch))
        set_gauge("serve", "snapshot_age_s", value=v.age_s())
        return v

    def stats(self) -> dict:
        v = self._view
        return {
            "snapshot_epoch": v.epoch if v else 0,
            "snapshot_age_s": round(v.age_s(), 6) if v else None,
            "refresh_in_flight": self._refreshing,
        }


class ReplicaPool:
    """N epoch-pinned device views serving round-robin with STAGGERED
    refresh, so serving and ingest do not share a core.

    Every replica is a full, individually consistent :class:`TableView`
    pinned on the device at capture time (``pin()`` runs on the refresh
    thread, never the serving path). ``view()`` hands out replicas
    round-robin; when the STALEST replica outlives ``max_staleness_s``
    (or the pool is not yet full), one background capture swaps that
    single replica to a fresh epoch, so at most one capture contends
    with ingest at any moment.

    Mixed epochs across replicas are part of the contract: a batch is
    answered by one replica and carries its epoch and age, and
    membership is monotone, so an older replica can only under-report
    within the staleness it surfaces. ``floor_epoch()`` (the minimum
    live epoch) is the validity horizon of the hot-serial cache.

    ``device=False`` serves every replica from the host mirror; a pin
    that fails on a CPU target, or runs out of memory on a CUDA one,
    does the same for one view, counted by ``serve.device_fallback``."""

    def __init__(self, agg, n_replicas: int = 2,
                 max_staleness_s: float = 1.0, device: bool = True,
                 devices: Optional[list] = None) -> None:
        self._agg = agg
        self.n_replicas = max(1, int(n_replicas))
        self.max_staleness_s = float(max_staleness_s)
        self._device = bool(device)
        self._devices = devices
        self._lock = threading.Lock()  # replica list + counters
        self._refresh_lock = threading.Lock()  # one capture at a time
        self._replicas: list[TableView] = []
        self._rr = 0
        self._epoch = 0
        self._refreshing = False

    @property
    def refresh_in_flight(self) -> bool:
        return self._refreshing

    def _resolve_devices(self) -> Optional[list]:
        """The pool's placement targets: each shard's own device for a
        sharded aggregator (shard ``s``'s block on ``devices[s]``), else
        the aggregator's device."""
        if self._devices is None and self._device:
            dedup = getattr(self._agg, "dedup", None)
            self._devices = ([_concrete(d) for d in dedup.devices]
                             if dedup is not None
                             else [_concrete(self._agg.device)])
        return self._devices or None

    def _capture(self) -> TableView:
        with self._lock:
            self._epoch += 1
            epoch = self._epoch
        with trace.span("serve.snapshot", cat="serve", epoch=epoch), \
                measure("serve", "replica_swap_s"):
            v = capture_view(self._agg, epoch, device=self._device,
                             devices=self._resolve_devices())
            v.pin()  # the copy runs on THIS thread, not the serving path
        return v

    def _adopt(self, v: TableView) -> None:
        with self._lock:
            if len(self._replicas) < self.n_replicas:
                v.replica_ix = len(self._replicas)
                self._replicas.append(v)
            else:
                stale = min(range(len(self._replicas)),
                            key=lambda i: self._replicas[i].epoch)
                v.replica_ix = stale
                self._replicas[stale] = v
            n = len(self._replicas)
        incr_counter("serve", "replica_refresh")
        set_gauge("serve", "replicas", value=float(n))
        set_gauge("serve", "snapshot_epoch", value=float(v.epoch))

    def _refresh_holding_lock(self) -> TableView:
        self._refreshing = True
        try:
            v = self._capture()
            self._adopt(v)
            return v
        finally:
            self._refreshing = False

    def refresh(self) -> TableView:
        """Force one staggered swap NOW (synchronous): capture and pin a
        new epoch and replace the stalest replica (or fill an empty
        slot). Serving continues on the other replicas meanwhile."""
        with self._refresh_lock:
            return self._refresh_holding_lock()

    def warm(self) -> "ReplicaPool":
        """Fill every pool slot synchronously (set-up, so a timed window
        never includes a capture)."""
        while True:
            with self._lock:
                if len(self._replicas) >= self.n_replicas:
                    return self
            self.refresh()

    def view(self) -> TableView:
        """One replica, round-robin; starts a background staggered swap
        when the stalest replica is past the staleness bound. Only the
        very first call (empty pool) captures synchronously."""
        with self._lock:
            reps = list(self._replicas)
            if reps:
                self._rr = (self._rr + 1) % len(reps)
                v = reps[self._rr]
        if not reps:
            with self._refresh_lock:
                with self._lock:
                    if self._replicas:  # lost the first-capture race
                        return self._replicas[0]
                return self._refresh_holding_lock()
        due = (len(reps) < self.n_replicas
               or max(r.age_s() for r in reps) > self.max_staleness_s)
        if due and not self._refreshing:
            self._refresh_async()
        set_gauge("serve", "snapshot_age_s", value=v.age_s())
        return v

    def _refresh_async(self) -> None:
        if not self._refresh_lock.acquire(blocking=False):
            return  # a capture is already in flight
        self._refreshing = True

        def run() -> None:
            try:
                v = self._capture()
                self._adopt(v)
            finally:
                self._refreshing = False
                self._refresh_lock.release()

        threading.Thread(target=run, name="serve-replica-refresh",
                         daemon=True).start()

    def floor_epoch(self) -> int:
        """Minimum epoch across live replicas: the oldest answer the
        round-robin could legally serve, and the hot-serial cache's
        validity horizon."""
        with self._lock:
            return min((r.epoch for r in self._replicas), default=0)

    def stats(self) -> dict:
        with self._lock:
            reps = list(self._replicas)
            refreshing = self._refreshing
        ages = [round(r.age_s(), 6) for r in reps]
        return {
            "replicas": len(reps),
            "replica_target": self.n_replicas,
            "replica_epochs": [r.epoch for r in reps],
            "replica_ages_s": ages,
            "replica_device": [bool(r._device) for r in reps],
            "snapshot_epoch": max((r.epoch for r in reps), default=0),
            "snapshot_age_s": min(ages) if ages else None,
            "refresh_in_flight": refreshing,
        }
