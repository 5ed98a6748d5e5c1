"""Multi-device sharded dedup: the distributed reduce over a device mesh
(port of ``ct_mapreduce_tpu.agg.sharded``).

The dedup table is **sharded by key across the mesh** and batches are
**sharded along the batch axis**, with an exchange in between, as in the
JAX package:

1. Each device parses, filters and fingerprints the lanes of the shards
   it holds (``pipeline.local_lanes``: the walker kernel K3 and the
   fingerprint kernel K1 on a card), once for all of them.
2. Each fingerprint's *home shard* is a hash of the key; lanes go to
   their home through a fixed-capacity dispatch (``_dispatch``, the MoE
   token-dispatch pattern) and an all-to-all exchange.
3. Every shard runs insert-if-absent (``pipeline.table_insert``: the
   bucket insert K2, or the open insert K8 with ``CTMR_TABLE=open``)
   against its own table; keys of one shard never touch another.
4. Verdicts ride the inverse exchange home and scatter back to lane
   order; the per-issuer counts are summed over the shards.

Dispatch capacity is ``min(b_loc, max(8, factor × b_loc / n))`` a
(source, destination) pair; lanes past a full slot are flagged
(``dispatch_dropped``) and take the exact host lane, as probe overflow
does, so the counts never depend on capacity tuning.

Steps 2-4 are K7. The JAX package runs them under ``shard_map`` with
``all_to_all`` and ``psum``; here, within a process, the all-to-all is
a copy between the shards' tensors and the sum a sum of tensors; across
processes (a mesh whose ``ranks`` differ) they are
``torch.distributed.all_to_all_single`` and ``all_reduce`` (NCCL on
cards of their own, else gloo through host memory). The JAX package's
donated buffers are in-place updates of each shard's table tensors.

A mesh may name one device several times: the shards are then separate
tables on that device (the tests' eight shards on one CPU, four shards
on one card). A mesh spanning processes must list each rank's shards
contiguously, every rank as many; a step then returns the outputs of
the lanes of this rank's shards.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ct_mapreduce_tpu_torch.core import packing
from ct_mapreduce_tpu_torch.ops import buckettable, hashtable, pipeline
from ct_mapreduce_tpu_torch.ops.buckettable import M32

AXIS = "shard"
_MIX = 0x85EBCA6B
# Payload words a routed lane carries: 4 fingerprint words, the meta word
# (issuer index in its high bits) and a valid word (1 on a placed lane).
PAYLOAD_WORDS = 6


def mesh_capacity(n_shards: int, capacity: int,
                  layout: str | None = None) -> int:
    """Smallest capacity ≥ ``capacity`` that divides over ``n_shards``
    with a power-of-two per-shard unit (slots for the open layout,
    buckets for the bucket layout: the hash mask requirement)."""
    if (layout or pipeline.table_layout()) == "bucket":
        per_slots = max(1, -(-capacity // n_shards))
        nb_loc = 1 << max(
            0, (per_slots + buckettable.SLOTS - 1) // buckettable.SLOTS - 1
        ).bit_length()
        return n_shards * nb_loc * buckettable.SLOTS
    per = max(1, -(-capacity // n_shards))  # ceil
    return n_shards * (1 << (per - 1).bit_length())


class ShardedStepOut(NamedTuple):
    was_unknown: torch.Tensor  # bool[B]
    host_lane: torch.Tensor  # bool[B] (parse/serial/meta/probe/dispatch)
    filtered_ca: torch.Tensor  # bool[B]
    filtered_expired: torch.Tensor  # bool[B]
    filtered_cn: torch.Tensor  # bool[B]
    not_after_hour: torch.Tensor  # int32[B]
    serials: torch.Tensor  # uint8[B, MAX_SERIAL_BYTES]
    serial_len: torch.Tensor  # int32[B]
    issuer_unknown_counts: torch.Tensor  # int32[num_issuers], mesh-wide
    has_crldp: torch.Tensor
    crldp_off: torch.Tensor
    crldp_len: torch.Tensor
    issuer_name_off: torch.Tensor
    issuer_name_len: torch.Tensor
    probe_overflow: torch.Tensor  # bool[B]: the shard insert exhausted
    # its probe chain (exact host lane; the `overflow` metric)
    dispatch_dropped: torch.Tensor  # bool[B]: spilled past the
    # per-(src, dst) routing cap (exact host lane; `dispatch_spill`)


def shard_of_np(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Host mirror of :func:`_shard_of` (uint32 wraparound arithmetic):
    home shard per fingerprint row ``uint32[n, 4]``."""
    k = np.asarray(keys).astype(np.uint32)
    h = k[:, 2] ^ (k[:, 3] * np.uint32(_MIX))
    return (h % np.uint32(n_shards)).astype(np.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32), split at 16
    bits so no int64 product overflows."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * (c & 0xFFFF)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _shard_of(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Home shard of each fingerprint (int32[B, 4] uint32 bits): words
    2 and 3, independent of the slot hash's words 0 and 1, so routing
    does not correlate with probing inside a shard. Routing hashes the
    whole fingerprint, so a hot issuer still spreads evenly. int64[B]."""
    k2 = keys[:, 2].to(torch.int64) & M32
    k3 = keys[:, 3].to(torch.int64) & M32
    return (k2 ^ _mul32(k3, _MIX)) % n_shards


def _contains_global_bucket(table_rows: torch.Tensor, keys: torch.Tensor,
                            n_shards: int, max_probes: int) -> torch.Tensor:
    """Membership over the globally viewed bucket-sharded table
    (``int32[n_shards * nb_loc, 128]``): shard-of-key addressing, then
    the bucket-hop probe of ``buckettable.contains`` inside the shard's
    row block. bool[B]."""
    nb_loc = table_rows.shape[0] // n_shards
    keys = buckettable._desentinel(keys)
    base = _shard_of(keys, n_shards) * nb_loc
    return buckettable.contains_rows(table_rows, keys, nb_loc, max_probes,
                                     row_base=base)


def _contains_global(table_rows: torch.Tensor, keys: torch.Tensor,
                     n_shards: int, max_probes: int) -> torch.Tensor:
    """Membership over the globally viewed open-layout sharded table
    (``int32[capacity, 5]``): shard-of-key addressing, then the windowed
    triangular probe of ``hashtable.contains`` inside the shard's slot
    block. bool[B]."""
    cap_loc = table_rows.shape[0] // n_shards
    dev = table_rows.device
    keys = hashtable._desentinel(keys)
    base = _shard_of(keys, n_shards) * cap_loc
    home = hashtable._home_slot(keys, cap_loc)
    b = keys.shape[0]
    w = min(hashtable.PROBE_WIDTH, max_probes)
    r = torch.zeros((b,), dtype=torch.int64, device=dev)
    found = torch.zeros((b,), dtype=torch.bool, device=dev)
    open_ = torch.ones((b,), dtype=torch.bool, device=dev)
    while bool(open_.any()):
        _slots, match_j, empty_j = hashtable._probe_window(
            table_rows, keys, home, r, w, max_probes, cap_loc,
            slot_base=base)
        before_empty = torch.cumsum(empty_j.to(torch.int32), dim=-1) == 0
        found |= open_ & (match_j & before_empty).any(dim=-1)
        still = open_ & ~(match_j | empty_j).any(dim=-1)
        r = torch.where(still, r + w, r)
        open_ = still & (r < max_probes)
    return found


def _dispatch(payload: torch.Tensor, dest: torch.Tensor,
              active: torch.Tensor, n_shards: int, cap: int):
    """Route lanes to destination shards with a fixed capacity each.

    payload ``[B, W]``, dest ``[B]`` (any int dtype), active bool[B].
    Returns ``(send [n_shards, cap, W], send_valid bool[n_shards, cap],
    slot_of_lane int64[B] (-1: dropped), rank int64[B])``, the rank of a
    lane being its position among the active lanes of its destination,
    in lane order. Narrow meshes take one cumsum per shard, wide ones
    (over 32 shards) a stable sort; both give the same ranks."""
    b = dest.shape[0]
    dev = dest.device
    dest_eff = torch.where(active, dest.to(torch.int64), n_shards)
    if n_shards <= 32:
        rank = torch.zeros((b,), dtype=torch.int64, device=dev)
        for d in range(n_shards):  # dummy-bin lanes never need a rank
            m = dest_eff == d
            rank = torch.where(m, torch.cumsum(m, 0) - 1, rank)
    else:
        order = torch.sort(dest_eff, stable=True).indices
        d_sorted = dest_eff[order]
        is_start = torch.ones((b,), dtype=torch.bool, device=dev)
        is_start[1:] = d_sorted[1:] != d_sorted[:-1]
        pos = torch.arange(b, dtype=torch.int64, device=dev)
        group_start = torch.cummax(torch.where(is_start, pos, 0), 0).values
        rank = torch.empty((b,), dtype=torch.int64, device=dev)
        rank[order] = pos - group_start
    fits = active & (rank < cap)
    flat = torch.where(fits, dest_eff * cap + rank, n_shards * cap)
    width = payload.shape[1]
    # One spare row takes every dropped lane's write.
    send = payload.new_zeros((n_shards * cap + 1, width))
    send[flat] = payload
    send_valid = torch.zeros((n_shards * cap + 1,), dtype=torch.bool,
                             device=dev)
    send_valid[flat] = fits
    return (send[:-1].view(n_shards, cap, width),
            send_valid[:-1].view(n_shards, cap),
            torch.where(fits, flat, -1), rank)


class _Exchange:
    """The all-to-all and the sum of a mesh, for this process's shards.

    ``all_to_all({s: [n, cap, W]})`` returns ``{d: [n, cap, W]}`` with
    ``out[d][s] = blocks[s][d]``, each on shard ``d``'s device. Inside a
    process it is a copy between tensors; across processes one
    ``all_to_all_single`` of ``[P, L, L, cap, W]`` (P ranks of L shards),
    through host memory under gloo."""

    def __init__(self, mesh, local: list[int]) -> None:
        self.mesh = mesh
        self.devices = list(mesh.devices.flat)
        self.local = local
        ranks = mesh.ranks.reshape(-1)
        self.multi = len(set(ranks.tolist())) > 1
        self.home = self.devices[local[0]]
        self.staged = False
        if self.multi:
            if not dist.is_initialized():
                raise RuntimeError(
                    "a mesh across processes needs the process group "
                    "(parallel.distributed.initialize_multihost)")
            n_ranks = int(ranks.max()) + 1
            per = mesh.size // n_ranks
            want = np.repeat(np.arange(n_ranks), per)
            if mesh.size % n_ranks or not np.array_equal(ranks, want):
                raise ValueError(
                    "a mesh across processes lists each rank's shards "
                    "contiguously, every rank as many")
            self.n_ranks, self.per = n_ranks, per
            self.staged = dist.get_backend() != "nccl"

    def where(self) -> str:
        """How shards exchange: within this process, over the card
        (NCCL) or through host memory (gloo)."""
        if not self.multi:
            return "in-process copies"
        return ("gloo through host memory" if self.staged
                else "NCCL over the cards")

    def all_to_all(self, blocks: dict[int, torch.Tensor]) \
            -> dict[int, torch.Tensor]:
        n = self.mesh.size
        if not self.multi:
            return {d: torch.stack([blocks[s][d].to(self.devices[d])
                                    for s in range(n)])
                    for d in self.local}
        p, per = self.n_ranks, self.per
        t = torch.stack([blocks[s].to(self.home) for s in self.local])
        cap, w = t.shape[2], t.shape[3]
        send = t.view(per, p, per, cap, w).transpose(0, 1).contiguous()
        if self.staged:
            send = send.cpu()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        recv = recv.to(self.home)
        return {d: recv[:, :, j].reshape(n, cap, w).to(self.devices[d])
                for j, d in enumerate(self.local)}

    def sum(self, parts: list[torch.Tensor]) -> torch.Tensor:
        total = parts[0].to(self.home).clone()
        for x in parts[1:]:
            total += x.to(self.home)
        if self.multi:
            buf = total.cpu() if self.staged else total
            dist.all_reduce(buf)
            total = buf.to(self.home)
        return total

    def gather_rows(self, rows: list[torch.Tensor]) -> torch.Tensor:
        """Every shard's rows, in shard order, on the host (all ranks'
        under a process group)."""
        local = torch.cat([r.cpu() for r in rows])
        if not self.multi:
            return local
        buf = local if self.staged else local.to(self.home)
        out = [torch.empty_like(buf) for _ in range(self.n_ranks)]
        dist.all_gather(out, buf)
        return torch.cat([o.cpu() for o in out])


class ShardedDedup:
    """Mesh-wide dedup state and the sharded steps.

    Table shard ``s`` (a ``BucketTable`` or a ``hashtable.TableState``)
    lives on ``mesh.devices.flat[s]``; a batch's lanes
    ``[s * b_loc, (s + 1) * b_loc)`` start on shard ``s``. One instance
    a process: a mesh across processes holds this rank's shards here."""

    def __init__(self, mesh, capacity: int,
                 base_hour: int = packing.DEFAULT_BASE_HOUR,
                 num_issuers: int = packing.MAX_ISSUERS,
                 max_probes: int = 32, dispatch_factor: float = 2.0) -> None:
        if len(mesh.axis_names) != 1:
            raise ValueError(
                f"ShardedDedup needs a 1-D mesh, got axes {mesh.axis_names}; "
                "flatten the mesh first (models.build_aggregator does this)")
        from ct_mapreduce_tpu_torch.parallel import distributed

        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_shards = mesh.size
        self.layout = pipeline.table_layout()
        if capacity % self.n_shards:
            raise ValueError("capacity must divide evenly across the mesh")
        per_shard = capacity // self.n_shards
        me = distributed.rank()
        self.local = [s for s, r in enumerate(mesh.ranks.reshape(-1))
                      if r == me]
        if not self.local:
            raise ValueError(f"rank {me} holds no shard of {mesh}")
        self._x = _Exchange(mesh, self.local)
        self.devices = list(mesh.devices.flat)
        self.home = self._x.home
        if self.layout == "bucket":
            # The home-bucket mask works on each shard's own buckets, so
            # the per-shard BUCKET count is a power of two, rounded up
            # (capacity is a floor, as in buckettable.make_table).
            nb_loc = 1 << max(
                0, (per_shard + buckettable.SLOTS - 1) // buckettable.SLOTS
                - 1).bit_length()
            capacity = self.n_shards * nb_loc * buckettable.SLOTS
            make = lambda dev: buckettable.BucketTable(  # noqa: E731
                torch.zeros((nb_loc, buckettable.ROW_WORDS),
                            dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
        else:
            if per_shard & (per_shard - 1):
                raise ValueError("per-shard capacity must be a power of two")
            make = lambda dev: hashtable.TableState(  # noqa: E731
                torch.zeros((per_shard, hashtable.ROW_WORDS),
                            dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
        self.tables = {s: make(self.devices[s]) for s in self.local}
        self.capacity = capacity
        self.base_hour = base_hour
        self.num_issuers = num_issuers
        self.max_probes = max_probes
        self.dispatch_factor = dispatch_factor
        # Runs of consecutive local shards on one device: stage 1 runs
        # once a run, over all of its shards' lanes.
        self._runs: list[list[int]] = []
        for s in self.local:
            if self._runs and self.devices[self._runs[-1][-1]] == \
                    self.devices[s] and self._runs[-1][-1] == s - 1:
                self._runs[-1].append(s)
            else:
                self._runs.append([s])

    # -- views -----------------------------------------------------------
    def exchange_route(self) -> str:
        return self._x.where()

    def dispatch_cap(self, b: int) -> int:
        """Per-(src, dst) dispatch quota for a batch of ``b`` lanes: the
        expected ``b_loc / n`` with headroom, floored so tiny batches
        keep full capacity (no spurious host-lane spills in tests)."""
        n = self.n_shards
        if b % n:
            raise ValueError(f"batch size {b} must divide over {n} shards")
        b_loc = b // n
        return min(b_loc, max(8, int(self.dispatch_factor * b_loc / n)))

    def host_rows(self) -> np.ndarray:
        """The global row view (every shard's rows in shard order) as
        ``uint32`` on the host: ``[n_shards * nb_loc, 128]`` bucket rows
        or ``[capacity, 5]`` open rows, the JAX package's sharded
        ``rows``."""
        return self._x.gather_rows(
            [self.tables[s].rows for s in self.local]).numpy().view(np.uint32)

    def clone_tables(self) -> dict:
        """Copies of this process's shard tables (for a replayed step)."""
        return {s: type(t)(t.rows.clone(), t.count.clone())
                for s, t in self.tables.items()}

    # -- the walker step -------------------------------------------------
    def k7(self, lanes: dict, cap: int, tables: Optional[dict] = None):
        """Dispatch, exchange, shard insert and return (K7) for this
        process's source shards. ``lanes[s] = (fps int32[b_loc, 4],
        meta int32[b_loc], insertable bool[b_loc])`` on shard ``s``'s
        device. Updates ``tables`` (by default the dedup's own) in
        place; returns ``({s: (was_unknown, probe_overflow,
        dispatch_dropped)}, counts int32[num_issuers])``."""
        tables = self.tables if tables is None else tables
        n = self.n_shards
        sends, slots = {}, {}
        for s, (fps, meta, insertable) in lanes.items():
            payload = torch.cat([fps, meta[:, None],
                                 torch.ones_like(meta)[:, None]], dim=1)
            send, _valid, slots[s], _ = _dispatch(
                payload, _shard_of(fps, n), insertable, n, cap)
            sends[s] = send
        recv = self._x.all_to_all(sends)
        backs, counts = {}, []
        for d in self.local:
            rk = recv[d].reshape(n * cap, PAYLOAD_WORDS)
            rmeta = rk[:, 4]
            tables[d], r_unknown, r_overflow = pipeline.table_insert(
                tables[d], rk[:, :4].contiguous(), rmeta.contiguous(),
                rk[:, 5] != 0, max_probes=self.max_probes)
            r_issuer = (rmeta.to(torch.int64) & M32) >> packing.META_HOUR_BITS
            counts.append(pipeline._issuer_counts(r_issuer, r_unknown,
                                                  self.num_issuers))
            backs[d] = (r_unknown.to(torch.int32)
                        | (r_overflow.to(torch.int32) << 1)).view(n, cap, 1)
        home = self._x.all_to_all(backs)
        total = self._x.sum(counts).to(torch.int32)
        out = {}
        for s in lanes:
            slot = slots[s]
            sent = slot >= 0
            res = home[s].reshape(n * cap)[torch.where(sent, slot, 0)]
            out[s] = (sent & ((res & 1) != 0), sent & ((res & 2) != 0),
                      lanes[s][2] & ~sent)
        return out, total

    def step(self, data, length, issuer_idx, valid, now_hour: int,
             cn_prefixes=None, cn_prefix_lens=None) -> ShardedStepOut:
        """One walker step over a batch of ``B = n_shards * b_loc`` lanes
        (NumPy arrays or tensors). The outputs are on this process's
        first shard's device, for the lanes of its shards."""
        if cn_prefixes is None:
            cn_prefixes = np.zeros((0, 32), np.uint8)
            cn_prefix_lens = np.zeros((0, 2), np.int32)
        b = int(data.shape[0])
        n = self.n_shards
        cap = self.dispatch_cap(b)
        b_loc = b // n

        def to(a, dev, dtype=None):
            if isinstance(a, torch.Tensor):
                return a.to(dev, non_blocking=True)
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        per_run, lanes = [], {}
        for run in self._runs:
            dev = self.devices[run[0]]
            lo, hi = run[0] * b_loc, (run[-1] + 1) * b_loc
            v = to(valid[lo:hi], dev, bool)
            ll = pipeline.local_lanes(
                to(data[lo:hi], dev, np.uint8), to(length[lo:hi], dev,
                                                   np.int32),
                to(issuer_idx[lo:hi], dev, np.int32), v, int(now_hour),
                self.base_hour, to(cn_prefixes, dev, np.uint8),
                to(cn_prefix_lens, dev, np.int32), self.num_issuers)
            per_run.append((run, v, ll))
            for j, s in enumerate(run):
                sl = slice(j * b_loc, (j + 1) * b_loc)
                lanes[s] = (ll.fps[sl], ll.meta[sl], ll.insertable[sl])
        res, counts = self.k7(lanes, cap)
        parts = []
        for run, v, ll in per_run:
            wu, ovf, dropped = (torch.cat([res[s][i] for s in run])
                                for i in range(3))
            p = ll.parsed
            host_lane = ((v & ~p.ok) | (ll.passed & ~ll.device_exact)
                         | dropped | ovf)
            parts.append(ShardedStepOut(
                was_unknown=wu, host_lane=host_lane,
                filtered_ca=ll.filtered_ca,
                filtered_expired=ll.filtered_expired,
                filtered_cn=ll.filtered_cn, not_after_hour=p.not_after_hour,
                serials=ll.serials, serial_len=p.serial_len,
                issuer_unknown_counts=counts, has_crldp=p.has_crldp,
                crldp_off=p.crldp_off, crldp_len=p.crldp_len,
                issuer_name_off=p.issuer_off, issuer_name_len=p.issuer_len,
                probe_overflow=ovf, dispatch_dropped=dropped))
        if len(parts) == 1:
            return parts[0]
        return ShardedStepOut(*(
            counts if name == "issuer_unknown_counts"
            else torch.cat([getattr(o, name).to(self.home) for o in parts])
            for name in ShardedStepOut._fields))

    # -- the pre-parsed step ---------------------------------------------
    def step_preparsed(self, serials, serial_len, not_after_hour,
                       issuer_idx, insertable, flag_cap: int):
        """Walker-free sharded step over HOST-ROUTED lanes: slot
        ``s * C + j`` belongs to shard ``s`` (the caller routed each lane
        to ``shard_of_np(fingerprints_np(...))`` and padded every
        shard's range to C with insertable=False slots). No exchange:
        fingerprint + insert + counts on each shard, the counts summed.
        Returns ``({s: packed int32[2 + nb + flag_cap]}, {s: overflow
        bits int32[nb]}, counts int32[num_issuers])``: per shard
        ``[inserted, overflow count, was-unknown bitmask, sorted
        overflow slot ids (C = none)]``."""
        c = int(serial_len.shape[0]) // self.n_shards
        nb = -(-c // 32)
        packed, ovf_bits, counts = {}, {}, []
        for s in self.local:
            dev = self.devices[s]
            sl = slice(s * c, (s + 1) * c)

            def part(a, dtype):
                return torch.from_numpy(np.ascontiguousarray(
                    a[sl], dtype)).to(dev)

            ii = part(issuer_idx, np.int32)
            nah = part(not_after_hour, np.int32)
            fps = pipeline.fingerprints(ii, nah, part(serials, np.uint8),
                                        part(serial_len, np.int32))
            meta = pipeline._meta_word(ii, nah.to(torch.int64)
                                       - self.base_hour)
            self.tables[s], wu, ovf = pipeline.table_insert(
                self.tables[s], fps, meta, part(insertable, bool),
                max_probes=self.max_probes)
            counts.append(pipeline._issuer_counts(ii, wu, self.num_issuers))
            iota = torch.arange(c, dtype=torch.int64, device=dev)
            ovf_idx = torch.sort(torch.where(ovf, iota, c)).values[:flag_cap]
            if flag_cap > c:
                ovf_idx = torch.cat([ovf_idx,
                                     ovf_idx.new_full((flag_cap - c,), c)])
            packed[s] = torch.cat([
                torch.stack([wu.sum(), ovf.sum()]).to(torch.int32),
                pipeline._pack_bits(wu, nb), ovf_idx.to(torch.int32)])
            ovf_bits[s] = pipeline._pack_bits(ovf, nb)
        return packed, ovf_bits, self._x.sum(counts).to(torch.int32)

    # -- bulk insert, membership, drain ----------------------------------
    def bulk_insert_np(self, keys_np: np.ndarray, meta_np: np.ndarray,
                       chunk: int = 65536) -> int:
        """Reinsert pre-hashed (fingerprint, meta) rows, the topology-
        independent restore path: rows route to their home shard on the
        host, then insert shard by shard in chunks of ``chunk``, as the
        JAX package's does (so the rows land the same). Returns the
        number of rows that overflowed probing."""
        n = self.n_shards
        if keys_np.size == 0:
            return 0
        keys_np = np.asarray(keys_np, np.uint32)
        meta_np = np.asarray(meta_np, np.uint32)
        dest = shard_of_np(keys_np, n).astype(np.int64)
        per_shard = {s: np.flatnonzero(dest == s) for s in range(n)}
        max_len = max(idx.size for idx in per_shard.values())
        overflowed = []
        for start in range(0, max_len, chunk):
            width = min(chunk, max_len - start)
            for s in self.local:
                sl = per_shard[s][start: start + width]
                k = np.zeros((width, 4), np.uint32)
                m = np.zeros((width,), np.uint32)
                v = np.zeros((width,), bool)
                k[: sl.size] = keys_np[sl]
                m[: sl.size] = meta_np[sl]
                v[: sl.size] = True
                dev = self.devices[s]
                self.tables[s], _wu, ovf = pipeline.table_insert(
                    self.tables[s], torch.from_numpy(k.view(np.int32)).to(dev),
                    torch.from_numpy(m.view(np.int32)).to(dev),
                    torch.from_numpy(v).to(dev), max_probes=self.max_probes)
                overflowed.append(ovf.sum().to(self.home))
        return int(self._x.sum([torch.stack(overflowed).sum()]))

    def total_count(self) -> int:
        return int(self._x.sum([t.count for t in self.tables.values()]))

    def counts(self) -> np.ndarray:
        """Per-shard occupied slots, ``int32[n_shards]`` (the JAX
        package's sharded ``count``)."""
        local = torch.stack([self.tables[s].count for s in self.local])
        return self._x.gather_rows([local]).numpy().astype(np.int32)

    def contains_np(self, fps_np: np.ndarray) -> np.ndarray:
        """Batched membership, with the insert's addressing: home shard
        by :func:`_shard_of`, then the layout's probe in that shard's
        table (this process's shards; a lane homed elsewhere reads
        False)."""
        n_keys = int(fps_np.shape[0])
        if n_keys == 0:
            return np.zeros((0,), bool)
        fps_np = np.ascontiguousarray(fps_np, np.uint32)
        dest = shard_of_np(fps_np, self.n_shards)
        out = np.zeros((n_keys,), bool)
        for s in self.local:
            sel = np.flatnonzero(dest == s)
            if sel.size:
                keys = torch.from_numpy(fps_np[sel].view(np.int32)).to(
                    self.devices[s])
                out[sel] = pipeline.table_contains(
                    self.tables[s], keys,
                    max_probes=self.max_probes).cpu().numpy()
        return out

    def drain_np(self) -> tuple[np.ndarray, np.ndarray]:
        """(keys uint32[N, 4], meta uint32[N]) of every occupied slot, in
        global slot order."""
        rows = self.host_rows()
        if self.layout == "bucket":
            rows = rows[:, : buckettable.SLOTS * 5].reshape(-1, 5)
        occ = rows[:, :4].any(axis=-1)
        return rows[occ, :4], rows[occ, 4]
