"""Bucketized dedup set: sort-based insert-if-absent over 24-slot rows
(port of ``ct_mapreduce_tpu.ops.buckettable``, bit for bit).

The table is an array of BUCKETS, ``rows: int32[n_buckets, 128]``
holding the uint32 bit patterns of the JAX package's
``uint32[n_buckets, 128]``: 24 slots x 5 words (4 fingerprint words +
meta), filled contiguously, word 120 caching the fill count. Keeping
the bits in ``int32`` (not ``int64``) keeps the table at its JAX size;
only equality tests and the fill word ever read row words.

An insert runs rounds until every lane resolves: lanes sort by
(bucket, key words, lane), so same-bucket lanes are adjacent and
same-key lanes adjacent with the batch-order-first one leading; each
bucket's first pending lane merges up to ``WINDOW`` new keys from the
lanes after it into the row and commits it; a lane whose bucket is
full hops to the next bucket, up to ``max_probes`` hops, then
overflows to the exact host lane (reference cmd/ct-fetch/ct-fetch.go:
206-225, tolerate-and-redirect).

Everything here is plain PyTorch tensor code; a hand-written insert
kernel is later work. Three places where a literal port would lose
byte identity with the JAX rows:

- the sort compares key words UNSIGNED (``lax.sort`` on uint32); the
  words are re-encoded into three ``int64`` composite keys whose
  signed order equals that lexicographic unsigned order, and sorted
  with stable sorts, last key first;
- the home-bucket hash multiplies a 32-bit word by ``0x9E3779B9``
  mod 2^32; the product is split so no ``int64`` product overflows;
- JAX commits rows by scattering every lane and dropping the
  sentinel ones (``mode="drop"``); here only the writing heads' rows
  are composed and committed, with one ``index_copy_``.

``insert`` updates ``rows`` IN PLACE (where the JAX version donates
the buffer) and returns the table with its new count.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ct_mapreduce_tpu_torch.device import resolve_device

SLOTS = 24  # slots per bucket (24 * 5 = 120 of 128 row words)
ROW_WORDS = 128
#: Spare row word caching the bucket's occupied-slot count. Every code
#: path that builds rows outside ``insert`` must keep it consistent —
#: ``fill_counts_np`` recomputes it from occupancy.
FILL_WORD = 120
M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _window_from_env() -> int:
    raw = os.environ.get("CTMR_BUCKET_WINDOW", "6")
    try:
        w = int(raw)
        if not 1 <= w <= 32:
            raise ValueError
    except ValueError:
        warnings.warn(
            f"ignoring CTMR_BUCKET_WINDOW={raw!r} (want 1..32); using 6",
            stacklevel=2)
        return 6
    return w


#: New keys merged per bucket per round (adjacent-lane look-ahead).
WINDOW = _window_from_env()


class BucketTable(NamedTuple):
    """Dedup-set state on the device.

    ``rows[b]`` is bucket ``b``: 24 slots x (4 fingerprint words + meta
    word) as uint32 bit patterns; all-zero KEY words mark an empty
    slot (meta 0 is legal data).
    """

    rows: torch.Tensor  # int32[n_buckets, 128]
    count: torch.Tensor  # int64[]; occupied slots

    @property
    def n_buckets(self) -> int:
        return self.rows.shape[0]

    @property
    def capacity(self) -> int:
        return self.rows.shape[0] * SLOTS


def bucket_count(capacity: int, max_capacity: int | None = None) -> int:
    """Power-of-two bucket count for ≥ ``capacity`` slots. When the
    rounded-up slot count would exceed ``max_capacity`` (rows are 512 B
    each, so a silent 2x round-up can double device memory past the
    configured bound), rounds DOWN instead."""
    if capacity < 1:
        raise ValueError(f"capacity must be positive, got {capacity}")
    nb = 1 << max(0, (capacity + SLOTS - 1) // SLOTS - 1).bit_length()
    if max_capacity is not None and nb * SLOTS > max_capacity:
        while nb > 1 and nb * SLOTS > max_capacity:
            nb >>= 1
    return nb


def make_table(capacity: int, max_capacity: int | None = None,
               device=None) -> BucketTable:
    """Table with at least ``capacity`` slots (n_buckets rounds up to a
    power of two; real capacity is ``table.capacity``) on ``device``
    (CUDA unless given)."""
    dev = resolve_device(device)
    n_buckets = bucket_count(capacity, max_capacity)
    return BucketTable(
        rows=torch.zeros((n_buckets, ROW_WORDS), dtype=torch.int32,
                         device=dev),
        count=torch.zeros((), dtype=torch.int64, device=dev),
    )


def _desentinel(keys: torch.Tensor) -> torch.Tensor:
    """Remap the (2^-128-unlikely) all-zero fingerprint to (0, 0, 0, 1),
    since all-zero key words mark an empty slot."""
    is_zero = (keys == 0).all(dim=1)
    out = keys.clone()
    out[:, 3] = torch.where(is_zero, 1, keys[:, 3])
    return out


def _home_bucket(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """``(k0 ^ (k1 * 0x9E3779B9 mod 2^32)) & (n_buckets - 1)`` as int64.

    The product is split at 16 bits so no int64 product overflows."""
    k0 = keys[:, 0].to(torch.int64) & M32
    k1 = keys[:, 1].to(torch.int64) & M32
    lo = (k1 & 0xFFFF) * _GOLDEN
    hi = (((k1 >> 16) * (_GOLDEN & 0xFFFF)) & 0xFFFF) << 16
    return (k0 ^ ((lo + hi) & M32)) & (n_buckets - 1)


def _prev(a: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([a.new_full((1,), fill), a[:-1]])


def _shift_up(a: torch.Tensor, j: int, fill) -> torch.Tensor:
    """a[i + j] with ``fill`` past the end (j >= 0)."""
    n = a.shape[0]
    if j == 0:
        return a
    if j >= n:
        return torch.full_like(a, fill)
    return torch.cat([a[j:], a.new_full((j,), fill)])


def _sort_order(h, k0, k1, k2, k3, ln) -> torch.Tensor:
    """Permutation sorting lanes by (h, k0, k1, k2, k3, ln) with key
    words compared unsigned — ``lax.sort(..., num_keys=6)``'s order.

    Three int64 composites whose signed order is that lexicographic
    order: (h, k0), (k1, k2) with k1's sign bit flipped, (k3, ln).
    ``ln`` is unique, so the order is total; the passes are stable so
    each refines the previous one (last key first)."""
    u = lambda k: k.to(torch.int64) & M32  # noqa: E731
    key_a = h * (1 << 32) + u(k0)  # h <= 2^23
    key_b = (k1 ^ -(1 << 31)).to(torch.int64) * (1 << 32) + u(k2)
    key_c = u(k3) * (1 << 25) + ln  # ln < 2^25
    perm = torch.sort(key_c, stable=True).indices
    perm = perm[torch.sort(key_b[perm], stable=True).indices]
    return perm[torch.sort(key_a[perm], stable=True).indices]


def insert(state: BucketTable, keys: torch.Tensor, meta: torch.Tensor,
           valid: torch.Tensor, max_probes: int = 32):
    """Batch insert-if-absent (same contract as the JAX ``insert``).

    keys: int32[B, 4] and meta: int32[B] (uint32 bit patterns), valid:
    bool[B], all on the table's device. Returns
    ``(table, was_unknown bool[B], overflowed bool[B])``: ``was_unknown``
    is true for the first lane (in batch order) of each genuinely-new
    key; ``overflowed`` lanes must take the exact host lane.
    ``max_probes`` bounds bucket HOPS. ``state.rows`` is updated in
    place.
    """
    rows = state.rows
    nb = rows.shape[0]
    b = keys.shape[0]
    if b > 1 << 25:
        # The segment broadcast packs (sorted position, window count)
        # as idx * 64 + w, and the sort packs the lane id in 25 bits.
        raise ValueError(
            f"insert batch width {b} exceeds 2^25 lanes; split the batch")
    if keys.dtype != torch.int32 or meta.dtype != torch.int32:
        raise TypeError("keys and meta must be int32 (uint32 bit patterns)")
    dev = rows.device
    if b == 0:
        empty = torch.zeros((0,), dtype=torch.bool, device=dev)
        return state, empty, empty
    keys = _desentinel(keys)
    sentinel = nb  # resolved lanes sort past every bucket
    h = torch.where(valid, _home_bucket(keys, nb), sentinel)
    k0, k1, k2, k3 = (keys[:, i].contiguous() for i in range(4))
    mt = meta
    ln = torch.arange(b, dtype=torch.int64, device=dev)
    idx = ln  # position index in sorted order
    flags = torch.zeros((b,), dtype=torch.int64, device=dev)
    # flags: bit0 known (seen before), bit1 inserted, bit2 overflow,
    # bits 8.. hop count.
    K_KNOWN, K_INS, K_OVF, HOP_1 = 1, 2, 4, 256

    # Each round commits >= 1 new key per active bucket, so only
    # window retries and hops consume rounds; a few extra rounds absorb
    # window-limited retries before the overflow contract applies.
    max_rounds = max_probes + 16
    rounds = 0
    while rounds < max_rounds and bool((h < sentinel).any()):
        perm = _sort_order(h, k0, k1, k2, k3, ln)
        h, k0, k1, k2, k3, ln, mt, flags = (
            a[perm] for a in (h, k0, k1, k2, k3, ln, mt, flags))
        pend = h < sentinel

        # One gather per lane: the whole bucket.
        row = rows[torch.clamp(h, max=nb - 1)]  # [B, 128]
        kw = row[:, : SLOTS * 5].view(b, SLOTS, 5)[:, :, :4]
        fill = (kw != 0).any(dim=2).sum(dim=1)  # occupancy scan
        kk = torch.stack([k0, k1, k2, k3], dim=1)
        in_row = pend & (kw == kk[:, None, :]).all(dim=2).any(dim=1)

        # Segment structure over the sorted order.
        bucket_head = pend & (h != _prev(h, -1))
        key_diff = ((k0 != _prev(k0, 0)) | (k1 != _prev(k1, 0))
                    | (k2 != _prev(k2, 0)) | (k3 != _prev(k3, 0)))
        key_head = pend & (bucket_head | key_diff)
        dup_lane = pend & ~key_head  # same key as an earlier lane
        new_head = key_head & ~in_row

        # Rank among new heads within the bucket segment.
        x = new_head.to(torch.int64)
        c = torch.cumsum(x, dim=0)
        base = torch.cummax(torch.where(bucket_head, c - x, -1), dim=0).values
        r = c - x - base

        # New keys in each head's WINDOW-lane look-ahead, broadcast down
        # the segment with (head position, count) through one cummax.
        same_seg_w = torch.zeros((b,), dtype=torch.int64, device=dev)
        for j in range(WINDOW):
            same_seg_w += (_shift_up(new_head, j, False)
                           & (_shift_up(h, j, sentinel) == h))
        enc = torch.where(bucket_head,
                          idx * 64 + torch.clamp(same_seg_w, max=63), -1)
        cm = torch.cummax(enc, dim=0).values
        bs = torch.div(cm, 64, rounding_mode="floor")  # my head's position
        w_seg = torch.remainder(cm, 64)  # new keys in the head's window
        pos = idx - bs

        space = SLOTS - fill
        merged = new_head & (pos < WINDOW) & (r < space)
        full_after = w_seg >= space  # bucket leaves this round full

        # Compose and commit the merged rows of the writing heads:
        # candidate j of head i is lane i + j when it merged into i's
        # segment; merged keys hold consecutive ranks, so slot
        # fill + r is theirs alone.
        write = bucket_head & (w_seg > 0) & (space > 0)
        wi = torch.nonzero(write).squeeze(1)
        if wi.numel():
            outrow = row[wi]
            fill_w = fill[wi]
            for j in range(WINDOW):
                cand = torch.clamp(wi + j, max=b - 1)
                ok = (wi + j < b) & merged[cand] & (bs[cand] == wi)
                col0 = torch.clamp(fill_w + r[cand], 0, SLOTS - 1) * 5
                for i, word in enumerate((k0, k1, k2, k3, mt)):
                    col = (col0 + i)[:, None]
                    cur = outrow.gather(1, col)
                    outrow.scatter_(
                        1, col, torch.where(ok[:, None], word[cand][:, None],
                                            cur))
            new_fill = fill_w + torch.minimum(w_seg[wi], space[wi])
            outrow[:, FILL_WORD] = new_fill.to(torch.int32)
            rows.index_copy_(0, h[wi], outrow)

        # Resolve lanes. Duplicate lanes resolve as known even when
        # their key head is still pending: the head (or, on overflow,
        # the exact host lane) accounts for the single fresh insert.
        flags = torch.where(pend & (in_row | dup_lane), flags | K_KNOWN, flags)
        flags = torch.where(merged, flags | K_INS, flags)
        still = pend & ~(in_row | dup_lane | merged)
        hop = still & full_after
        flags = torch.where(hop, flags + HOP_1, flags)
        ovf_now = hop & ((flags >> 8) >= max_probes)
        h = torch.where(still & ~ovf_now,
                        torch.where(hop, (h + 1) & (nb - 1), h), sentinel)
        flags = torch.where(ovf_now, flags | K_OVF, flags)
        rounds += 1

    # Lanes still pending after the round budget overflow too; then
    # scatter the outcome back to lane order.
    res_sorted = flags | torch.where(h < sentinel, K_OVF, 0)
    res = torch.empty_like(res_sorted)
    res[ln] = res_sorted
    was_unknown = (res & K_INS) != 0
    overflowed = (res & K_OVF) != 0
    count = state.count + was_unknown.sum()
    return BucketTable(rows, count), was_unknown, overflowed


def contains(state: BucketTable, keys: torch.Tensor,
             max_probes: int = 32) -> torch.Tensor:
    """Batch membership query: bool[B]. One bucket gather resolves a
    lane unless the bucket is full-without-match (then it hops, like
    the insert's bucket-granular open addressing)."""
    return contains_rows(state.rows, keys, state.rows.shape[0], max_probes)


def contains_rows(rows: torch.Tensor, keys: torch.Tensor, nb: int,
                  max_probes: int = 32,
                  row_base: torch.Tensor | None = None) -> torch.Tensor:
    """The bucket-hop probe of :func:`contains` over a block of ``nb``
    buckets of ``rows`` starting at row ``row_base`` (int64[B], a lane's
    shard's block in a sharded table's global rows; row 0 without it).
    A caller that derives ``row_base`` from the keys passes them through
    ``_desentinel`` first, as this does. bool[B]."""
    b = keys.shape[0]
    keys = _desentinel(keys)
    h = _home_bucket(keys, nb)
    open_ = torch.ones((b,), dtype=torch.bool, device=rows.device)
    found = torch.zeros((b,), dtype=torch.bool, device=rows.device)
    hops = 0
    while hops < max_probes and bool(open_.any()):
        row = rows[h if row_base is None else row_base + h]
        kw = row[:, : SLOTS * 5].view(b, SLOTS, 5)[:, :, :4]
        match = (kw == keys[:, None, :]).all(dim=2).any(dim=1)
        has_empty = row[:, FILL_WORD] < SLOTS
        found |= open_ & match
        open_ = open_ & ~match & ~has_empty
        h = torch.where(open_, (h + 1) & (nb - 1), h)
        hops += 1
    return found


# -- NumPy helpers (copies of the JAX module's host-side functions) ----

def host_rows(state: BucketTable) -> np.ndarray:
    """The table's rows as ``uint32[n_buckets, 128]`` on the host. For a
    table on the CPU this is a view of the live rows, which the next
    insert changes in place: copy it to keep a snapshot."""
    return state.rows.cpu().numpy().view(np.uint32)


def fuse_rows_np(keys: np.ndarray, meta: np.ndarray) -> np.ndarray:
    """uint32[N, 4] keys + uint32[N] meta → fused uint32[N, 5] slots
    (the JAX package's ``hashtable.fuse_rows`` on NumPy arrays)."""
    return np.concatenate(
        [keys.astype(np.uint32), meta.astype(np.uint32)[:, None]], axis=1)


def fill_counts_np(rows_np: np.ndarray) -> np.ndarray:
    """Recompute each bucket's occupied-slot count from key-word
    occupancy and write it into ``FILL_WORD`` in place. Call after any
    host-side row construction so the cached-fill invariant holds."""
    slots = rows_np[:, : SLOTS * 5].reshape(rows_np.shape[0], SLOTS, 5)
    fills = slots[:, :, :4].any(axis=-1).sum(axis=-1).astype(np.uint32)
    rows_np[:, FILL_WORD] = fills
    return fills


def contains_np(rows_np: np.ndarray, keys: np.ndarray,
                max_probes: int = 32) -> np.ndarray:
    """NumPy mirror of :func:`contains` for host-only reads."""
    nb = rows_np.shape[0]
    keys = keys.astype(np.uint32, copy=True).reshape(-1, 4)
    zero = ~keys.any(axis=-1)
    keys[zero, 3] = 1  # _desentinel
    h = ((keys[:, 0] ^ (keys[:, 1] * np.uint32(_GOLDEN)))
         & np.uint32(nb - 1)).astype(np.int64)
    out = np.zeros((keys.shape[0],), bool)
    open_ = np.ones((keys.shape[0],), bool)
    slots = rows_np[:, : SLOTS * 5].reshape(nb, SLOTS, 5)
    for _ in range(max_probes):
        if not open_.any():
            break
        rows = slots[h[open_]]  # [n, SLOTS, 5]
        match = (rows[:, :, :4] == keys[open_][:, None, :]).all(-1).any(-1)
        has_empty = (~rows[:, :, :4].any(-1)).any(-1)
        sub = np.where(open_)[0]
        out[sub[match]] = True
        still = ~match & ~has_empty
        open_[sub[~still]] = False
        h[sub[still]] = (h[sub[still]] + 1) & (nb - 1)
    return out


def drain_np(state: BucketTable) -> tuple[np.ndarray, np.ndarray]:
    """Pull (keys uint32[N, 4], meta uint32[N]) of occupied slots, in
    slot order."""
    slots = host_rows(state)[:, : SLOTS * 5].reshape(-1, 5)
    occ = slots[:, :4].any(axis=-1)
    return slots[occ, :4], slots[occ, 4]


def bulk_insert_np(rows_np: np.ndarray, keys: np.ndarray,
                   meta: np.ndarray, max_probes: int = 32) -> int:
    """Host-side rebuild: insert ``keys`` into ``rows_np`` in place.
    Returns the number of keys that could not be placed within
    ``max_probes`` hops. Callers must pass DEDUPLICATED keys not
    already present in the table — no membership check is performed.
    Maintains the ``FILL_WORD`` cache."""
    nb = rows_np.shape[0]
    keys = keys.astype(np.uint32).reshape(-1, 4)
    meta = meta.astype(np.uint32).reshape(-1)
    zero = ~keys.any(axis=-1)
    if zero.any():
        keys = keys.copy()
        keys[zero, 3] = 1
    h = ((keys[:, 0] ^ (keys[:, 1] * np.uint32(_GOLDEN)))
         & np.uint32(nb - 1)).astype(np.int64)
    slots = rows_np[:, : SLOTS * 5].reshape(nb, SLOTS, 5)
    fill = (slots[:, :, :4].any(axis=-1)).sum(axis=-1).astype(np.int64)
    alive = np.ones(keys.shape[0], bool)
    for _ in range(max_probes):
        if not alive.any():
            break
        sub = np.where(alive)[0]
        order = sub[np.argsort(h[sub], kind="stable")]
        hs = h[order]
        seg_start = np.r_[True, hs[1:] != hs[:-1]]
        seg_idx = np.cumsum(seg_start) - 1
        first = np.where(seg_start)[0]
        rank = np.arange(len(order)) - first[seg_idx]
        slot = fill[hs] + rank
        ok = slot < SLOTS
        tgt = order[ok]
        slots[hs[ok], slot[ok], :4] = keys[tgt]
        slots[hs[ok], slot[ok], 4] = meta[tgt]
        fill += np.bincount(hs[ok], minlength=nb)
        alive[tgt] = False
        h[order[~ok]] = (h[order[~ok]] + 1) & (nb - 1)
    rows_np[:, FILL_WORD] = fill.astype(np.uint32)
    return int(alive.sum())
