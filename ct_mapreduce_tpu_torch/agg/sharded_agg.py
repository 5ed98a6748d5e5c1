"""Exact-parity aggregator over the mesh-sharded dedup (port of
``ct_mapreduce_tpu.agg.sharded_agg``).

:class:`ShardedAggregator` is :class:`TorchAggregator` with its table
swapped for a :class:`~ct_mapreduce_tpu_torch.agg.sharded.ShardedDedup`
(``self.table``, also named ``self.dedup`` as in the JAX package):
batches shard along the batch axis, keys route to their home table
shard, the per-issuer counts come back summed, while the exact host
lane, issuer registry, CRL/DN accumulation, drain and checkpoint
contract stay the single-device aggregator's. One process drives every
shard of its mesh; a mesh across processes is for
:class:`ShardedDedup` alone (see ``__init__``).
"""

from __future__ import annotations

from datetime import datetime
from typing import Optional

import numpy as np
import torch

from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
from ct_mapreduce_tpu_torch.agg.sharded import (
    ShardedDedup,
    mesh_capacity,
    shard_of_np,
)
from ct_mapreduce_tpu_torch.core import packing
from ct_mapreduce_tpu_torch.ops import pipeline
from ct_mapreduce_tpu_torch.telemetry import trace


def _pack_bits_np(flags: np.ndarray, nb: int) -> np.ndarray:
    """bool[B] → uint32[nb] bitmask (bit i of word w = lane w*32+i): the
    host mirror of ``pipeline._pack_bits``."""
    b = flags.shape[0]
    padded = np.pad(flags.astype(bool), (0, nb * 32 - b)).reshape(nb, 32)
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))[None, :]
    return np.where(padded, weights, 0).sum(axis=1).astype(np.uint32)


def _unpack_bits_np(words: np.ndarray, n: int) -> np.ndarray:
    """uint32[..., nb] bitmask → bool[..., n] lanes."""
    bits = (words[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.astype(bool).reshape(words.shape[:-1] + (-1,))[..., :n]


class _ShardedPreparsedOut:
    """Readback adapter: the sharded pre-parsed step's per-SHARD compact
    outputs, reassembled on first read into the per-CHUNK
    ``PreparsedStepOut`` layout ``TorchAggregator._fold_preparsed``
    reads (``packed`` and ``overflow_bits``, as tensors on the host).
    Nothing is read back before the fold, so the submit half stays
    asynchronous, as on one device."""

    def __init__(self, packed_s: dict, ovf_bits_s: dict, counts,
                 slot_of_orig: np.ndarray, c: int, k_chunks: int,
                 chunk: int, flag_cap: int, device_cap: int,
                 num_issuers: int) -> None:
        self._packed_s = packed_s      # {shard: int32[2 + nbC + dcap]}
        self._ovf_bits_s = ovf_bits_s  # {shard: int32[nbC]}
        self._counts = counts          # int32[num_issuers]
        self._slot = slot_of_orig      # int64[n] original lane → slot
        self._c = c
        self._k = k_chunks
        self._b = chunk
        self._cap = flag_cap           # per-chunk cap of the fold layout
        self._dev_cap = device_cap     # per-shard cap of the device rows
        self._num_issuers = num_issuers
        self._built = None

    def _build(self):
        if self._built is not None:
            return self._built
        shards = sorted(self._packed_s)
        P = torch.stack([self._packed_s[s].cpu() for s in shards]).numpy()
        counts = self._counts.cpu().numpy().astype(np.int32)
        n_shards = P.shape[0]
        c, cap, dcap = self._c, self._cap, self._dev_cap
        nb_c = -(-c // 32)
        wu_slots = _unpack_bits_np(
            P[:, 2:2 + nb_c].view(np.uint32), c).reshape(-1)
        ovf_slots = np.zeros((n_shards * c,), bool)
        for s in range(n_shards):
            oc = int(P[s, 1])
            if oc == 0:
                continue
            if oc <= dcap:
                ids = P[s, 2 + nb_c:2 + nb_c + oc]
                ids = ids[ids < c]
                ovf_slots[s * c + ids] = True
            else:
                # Compacted-flag spill on this shard: its full overflow
                # bitmask (one more read).
                bits = self._ovf_bits_s[shards[s]].cpu().numpy().view(
                    np.uint32)
                ovf_slots[s * c:(s + 1) * c] = _unpack_bits_np(bits, c)
        # Back to lane order, then into the [K, B]-chunked packed rows
        # the shared fold reads.
        wu = wu_slots[self._slot]
        ovf = ovf_slots[self._slot]
        k, b, nb = self._k, self._b, -(-self._b // 32)
        width = 2 + nb + cap + self._num_issuers
        packed = np.zeros((k, width), np.int32)
        over_bits = np.zeros((k, nb), np.uint32)
        for kk in range(k):
            w = wu[kk * b:(kk + 1) * b]
            o = ovf[kk * b:(kk + 1) * b]
            packed[kk, 0] = int(w.sum())
            oc = int(o.sum())
            packed[kk, 1] = oc
            packed[kk, 2:2 + nb] = _pack_bits_np(w, nb).view(np.int32)
            ids = np.full((cap,), b, np.int32)
            if 0 < oc <= cap:
                ids[:oc] = np.nonzero(o)[0][:cap]
            packed[kk, 2 + nb:2 + nb + cap] = ids
            over_bits[kk] = _pack_bits_np(o, nb)
        # The summed per-issuer counts ride one chunk row (the fold sums
        # the count region over the chunk rows).
        packed[0, 2 + nb + cap:] = counts[:self._num_issuers]
        self._built = (torch.from_numpy(packed),
                       torch.from_numpy(over_bits.view(np.int32)))
        return self._built

    @property
    def packed(self) -> torch.Tensor:
        return self._build()[0]

    @property
    def overflow_bits(self) -> torch.Tensor:
        return self._build()[1]


class ShardedAggregator(TorchAggregator):
    def __init__(
        self,
        mesh,
        capacity: int = 1 << 22,
        batch_size: int = 4096,
        base_hour: int = packing.DEFAULT_BASE_HOUR,
        cn_prefixes: tuple[str, ...] = (),
        max_probes: int = 32,
        now: Optional[datetime] = None,
        dispatch_factor: float = 2.0,
        grow_at: float = 0.55,
        max_capacity: int = 1 << 28,
    ) -> None:
        n = mesh.size
        if batch_size % n:
            raise ValueError(
                f"batch_size {batch_size} must divide over {n} devices")
        if len(set(mesh.ranks.reshape(-1).tolist())) > 1:
            # A step over such a mesh returns only this rank's lanes,
            # and growth would have to run in lockstep on every rank: an
            # aggregator folds whole batches, so it takes a mesh of one
            # process (ShardedDedup takes the global one).
            raise ValueError(
                "ShardedAggregator drives a mesh of one process; a mesh "
                "across processes is for ShardedDedup")
        self.mesh = mesh
        self.dispatch_factor = dispatch_factor
        # _make_table runs inside TorchAggregator.__init__ and reads these.
        self.base_hour = base_hour
        self.max_probes = max_probes
        super().__init__(
            capacity=mesh_capacity(n, capacity),
            batch_size=batch_size,
            base_hour=base_hour,
            cn_prefixes=cn_prefixes,
            max_probes=max_probes,
            now=now,
            grow_at=grow_at,
            max_capacity=max_capacity,
            device=mesh.devices.flat[0],
        )

    @property
    def dedup(self) -> ShardedDedup:
        return self.table

    # -- hooks -----------------------------------------------------------
    def _layout_capacity_floor(self, cap: int) -> int:
        """Largest mesh-buildable capacity ≤ ``cap``: shards get
        power-of-two units, so halve the per-shard unit until the
        mesh-rounded total fits under the configured ceiling."""
        n = self.mesh.size
        target = cap
        while target >= n:
            reach = mesh_capacity(n, target)
            if reach <= cap:
                return reach
            target //= 2
        return mesh_capacity(n, 1)

    def _make_table(self, capacity: int) -> ShardedDedup:
        return ShardedDedup(
            self.mesh, capacity=mesh_capacity(self.mesh.size, capacity),
            base_hour=self.base_hour, max_probes=self.max_probes,
            dispatch_factor=self.dispatch_factor)

    def _topology_shards(self) -> int:
        return self.mesh.size

    def _drain_table(self) -> tuple[np.ndarray, np.ndarray]:
        return self.table.drain_np()

    def _device_contains(self, fps: np.ndarray) -> np.ndarray:
        with self._table_lock:
            return self.table.contains_np(fps)

    def _table_fill_exact(self) -> int:
        with self._table_lock:
            return self.table.total_count()

    def _bulk_reinsert(self, keys: np.ndarray, meta: np.ndarray) -> int:
        with self._table_lock:
            return self.table.bulk_insert_np(keys, meta)

    def _table_snapshot(self):
        # The global row view and per-shard counts: the JAX package's
        # sharded ck01 fields, so either package re-hashes them into
        # its own topology on load.
        return self.table.layout, self.table.host_rows(), self.table.counts()

    def _device_step_packed(self, batch: packing.PackedBatch):
        self._device_written = True
        with trace.span("mesh.step", cat="device",
                        shards=int(self.mesh.size)), self._table_lock:
            self.table.base_hour = self.base_hour
            return self.table.step(
                batch.data, batch.length, batch.issuer_idx, batch.valid,
                now_hour=self._now_hour(), cn_prefixes=self._prefix_arr,
                cn_prefix_lens=self._prefix_lens)

    def _device_step_staged(self, data, length, issuer_idx, valid):
        """The staged envelope over the mesh: its K chunks as K sharded
        steps in order, packed as ``pipeline.staged_core`` packs them,
        so the envelope folds as on one device."""
        self._device_written = True
        k_chunks, b = length.shape
        dev = self.device
        packed = torch.zeros((k_chunks, 7, b), dtype=torch.int32, device=dev)
        serials = torch.zeros((k_chunks, b, packing.MAX_SERIAL_BYTES),
                              dtype=torch.uint8, device=dev)
        counts = torch.zeros((packing.MAX_ISSUERS,), dtype=torch.int32,
                             device=dev)
        with trace.span("mesh.step_staged", cat="device", chunks=int(k_chunks),
                        shards=int(self.mesh.size)), self._table_lock:
            self.table.base_hour = self.base_hour
            for k in range(k_chunks):
                out = self.table.step(
                    data[k], length[k], issuer_idx[k], valid[k],
                    now_hour=self._now_hour(), cn_prefixes=self._prefix_arr,
                    cn_prefix_lens=self._prefix_lens)
                packed[k] = pipeline.pack_lane_words(out)
                serials[k] = out.serials
                counts += out.issuer_unknown_counts
        return pipeline.StagedStepOut(packed=packed,
                                      issuer_unknown_counts=counts,
                                      serials=serials)

    def _device_step_preparsed(self, serials, serial_len, nah, issuer_idx,
                               insertable, flag_cap: int):
        """The pre-parsed lane over the mesh, routed on the host.

        The walker path routes on the device (dispatch + exchange)
        because fingerprints exist only after the device parse. The
        pre-parsed lane's fingerprints come from the sidecar's fields on
        the host, so each lane's home shard is known before anything
        ships: lanes stable-sort by home shard into per-shard ranges
        (padded to a shared power-of-two width C) and each shard's step
        is fingerprint + insert + counts, with no exchange. The stable
        sort keeps lane order within a shard, so duplicates resolve
        first-wins as on one device."""
        self._device_written = True
        k, b = np.asarray(serial_len).shape
        n = k * b
        ns = self.mesh.size

        def flat(a, dtype):
            a = np.asarray(a, dtype)
            return np.ascontiguousarray(a.reshape((n,) + a.shape[2:]))

        ser = flat(serials, np.uint8)
        slen = flat(serial_len, np.int32)
        nh = flat(nah, np.int32)
        ii = flat(issuer_idx, np.int32)
        ins = flat(insertable, bool)

        fps = packing.fingerprints_np(ii, nh, ser, slen)
        dest = shard_of_np(fps, ns)
        perm = np.argsort(dest, kind="stable")
        per_shard = np.bincount(dest, minlength=ns)
        c = max(8, int(per_shard.max()))
        c = 1 << (c - 1).bit_length()  # a power of two: few shapes
        starts = np.zeros((ns + 1,), np.int64)
        starts[1:] = np.cumsum(per_shard)
        dsort = dest[perm].astype(np.int64)
        slot_sorted = dsort * c + (np.arange(n) - starts[dsort])
        slot_of_orig = np.empty((n,), np.int64)
        slot_of_orig[perm] = slot_sorted

        def route(a):
            out = np.zeros((ns * c,) + a.shape[1:], a.dtype)
            out[slot_sorted] = a[perm]
            return out

        cap = min(int(flag_cap), c)
        with trace.span("mesh.step_preparsed", cat="device",
                        shards=int(ns)), self._table_lock:
            self.table.base_hour = self.base_hour
            packed_s, ovf_bits_s, counts = self.table.step_preparsed(
                route(ser), route(slen), route(nh), route(ii),
                route(ins), flag_cap=cap)
        return _ShardedPreparsedOut(
            packed_s, ovf_bits_s, counts, slot_of_orig,
            c=c, k_chunks=k, chunk=b, flag_cap=int(flag_cap),
            device_cap=cap, num_issuers=packing.MAX_ISSUERS)

    # -- checkpoint ------------------------------------------------------
    def _restore_table(self, keys, meta, count, layout: str,
                       ckpt_shards: int) -> None:
        """Restore by REINSERTION, not a row copy: a checkpoint may come
        from another topology (one device, another mesh size) or layout,
        and a key's home shard, bucket and probe chain depend on both;
        re-hashing every occupied row is always right."""
        occ = keys.any(axis=-1)
        with self._table_lock:
            target = max(self.table.capacity, int(keys.shape[0]))
            self.table = self._make_table(target)
            overflow = self.table.bulk_insert_np(keys[occ], meta[occ])
            if overflow:
                raise RuntimeError(
                    f"checkpoint restore overflowed {overflow} rows; "
                    f"increase tableBits (capacity {self.table.capacity})")
            self.capacity = self.table.capacity
