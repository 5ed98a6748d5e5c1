"""Open-addressed dedup set: slot-granular triangular probing (port of
``ct_mapreduce_tpu.ops.hashtable``, bit for bit).

The fallback layout (``CTMR_TABLE=open``) beside the default bucket
table of :mod:`.buckettable`, and the layout of checkpoints written
before the bucket table existed. One FUSED row per slot,
``rows: int32[capacity, 5]`` holding the uint32 bit patterns of the JAX
package's ``uint32[capacity, 5]``: 4 fingerprint words and the meta
word. All-zero KEY words mark an empty slot; meta 0 is legal data.

Insert (same contract as the bucket table's): every pending lane looks
at a window of ``PROBE_WIDTH`` consecutive positions of its triangular
probe chain in one gather and resolves at the first position that is
not an occupied mismatch:

- the key is there → known;
- the slot is empty → a scatter-min election on a claim scratch picks
  the lowest lane id among the lanes contending for the slot; the
  winner writes its row, a loser with the winner's key is a
  within-batch duplicate (known), a loser with another key probes on
  past the slot;
- every window position holds another key → the lane probes on past
  the window.

Lanes that exhaust ``max_probes`` chain positions overflow to the exact
host lane. A key always lands at the first empty slot of its chain, so
``contains`` can stop at the first empty slot.

Everything here is plain PyTorch tensor code (K8 in the ROADMAP's
kernel queue is its hand-written version). Where a literal port would
lose byte identity with the JAX rows:

- the home-slot hash multiplies a 32-bit word by ``0x9E3779B9`` mod
  2^32; :func:`.buckettable._home_bucket` splits the product so no
  ``int64`` product overflows;
- JAX scatters with ``mode="drop"`` on an out-of-range sentinel index;
  here the claim scratch has one extra sink row past the last slot,
  and the table write indexes only the winners;
- the election is ``scatter_reduce_(..., "amin")`` on lane ids, which
  does not depend on scatter order, so the winner is the same lane as
  in JAX;
- JAX runs the rounds in a ``lax.while_loop`` capped at
  ``max_probes + 1`` rounds; here a host loop checks ``pending.any()``
  once a round under the same cap.

``insert`` updates ``rows`` IN PLACE (where the JAX version donates the
buffer) and returns the table with its new count.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ct_mapreduce_tpu_torch.device import resolve_device
from ct_mapreduce_tpu_torch.ops.buckettable import _GOLDEN, _home_bucket

ROW_WORDS = 5  # 4 fingerprint words + the meta word
_NO_LANE = 2**31 - 1


def _probe_width_from_env() -> int:
    raw = os.environ.get("CTMR_PROBE_WIDTH", "4")
    try:
        width = int(raw)
        if width < 1:
            raise ValueError
    except ValueError:
        # A malformed value must not break importing the package for
        # paths that never probe; degrade to the default, loudly.
        warnings.warn(
            f"ignoring CTMR_PROBE_WIDTH={raw!r} (want an int >= 1); "
            "using 4", stacklevel=2)
        return 4
    return width


#: Chain positions examined per probe round (one gather).
PROBE_WIDTH = _probe_width_from_env()


class TableState(NamedTuple):
    """Dedup-set state on the device: one fused row per slot."""

    rows: torch.Tensor  # int32[capacity, 5]: fp words 0..3, meta word 4
    count: torch.Tensor  # int64[]; occupied slots

    @property
    def keys(self) -> torch.Tensor:  # int32[capacity, 4] view
        return self.rows[:, :4]

    @property
    def meta(self) -> torch.Tensor:  # int32[capacity] view
        return self.rows[:, 4]

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]


def make_table(capacity: int, device=None) -> TableState:
    """Empty table of ``capacity`` slots (a power of two) on ``device``
    (CUDA unless given)."""
    if capacity < 1 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, got {capacity}")
    dev = resolve_device(device)
    return TableState(
        rows=torch.zeros((capacity, ROW_WORDS), dtype=torch.int32, device=dev),
        count=torch.zeros((), dtype=torch.int64, device=dev),
    )


def fuse_rows(keys: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """int32[N, 4] keys + int32[N] meta → fused int32[N, 5] rows."""
    return torch.cat([keys, meta[:, None]], dim=1)


def _home_slot(keys: torch.Tensor, capacity: int) -> torch.Tensor:
    """Initial probe slot from the fingerprint's first two words."""
    return _home_bucket(keys, capacity)


def _probe_window(rows: torch.Tensor, keys: torch.Tensor,
                  home: torch.Tensor, r: torch.Tensor, w: int,
                  max_probes: int, capacity: int,
                  slot_base: torch.Tensor | None = None):
    """One W-wide window of triangular-chain probes, the shared access
    pattern of :func:`insert` and :func:`contains`. Returns
    ``(slots [B, W], match_j [B, W], empty_j [B, W])`` with positions
    past ``max_probes`` masked out of both match and empty.
    ``slot_base`` (int64[B]) offsets each lane's chain into a block of
    ``capacity`` slots of a larger ``rows`` (a sharded table's global
    view, ``agg/sharded.py``); the returned slots stay block-local."""
    rj = r[:, None] + torch.arange(w, dtype=torch.int64, device=r.device)
    slots = (home[:, None] + (rj * (rj + 1)) // 2) & (capacity - 1)
    in_budget = rj < max_probes
    at = slots if slot_base is None else slots + slot_base[:, None]
    cur = rows[at][..., :4]  # [B, W, 4] key words of each row
    match_j = (cur == keys[:, None, :]).all(dim=-1) & in_budget
    empty_j = (cur == 0).all(dim=-1) & in_budget
    return slots, match_j, empty_j


def _desentinel(keys: torch.Tensor) -> torch.Tensor:
    """Remap the (2^-128-unlikely) all-zero fingerprint to (0, 0, 0, 1),
    since all-zero key words mark an empty slot."""
    is_zero = (keys == 0).all(dim=1)
    out = keys.clone()
    out[:, 3] = torch.where(is_zero, 1, keys[:, 3])
    return out


def insert(state: TableState, keys: torch.Tensor, meta: torch.Tensor,
           valid: torch.Tensor, max_probes: int = 32):
    """Batch insert-if-absent (same contract as the JAX ``insert``).

    keys: int32[B, 4] and meta: int32[B] (uint32 bit patterns), valid:
    bool[B], all on the table's device. Returns
    ``(table, was_unknown bool[B], overflowed bool[B])``: ``was_unknown``
    is true for the lane that claimed a slot (the first lane, in batch
    order, of each new key); ``overflowed`` lanes must take the exact
    host lane. ``state.rows`` is updated in place."""
    if keys.dtype != torch.int32 or meta.dtype != torch.int32:
        raise TypeError("keys and meta must be int32 (uint32 bit patterns)")
    rows = state.rows
    capacity = rows.shape[0]
    dev = rows.device
    b = keys.shape[0]
    keys = _desentinel(keys)
    qrows = fuse_rows(keys, meta)  # [B, 5]: what a winner commits
    home = _home_slot(keys, capacity)
    lane = torch.arange(b, dtype=torch.int64, device=dev)
    w = min(PROBE_WIDTH, max_probes)
    # Every pending lane advances its probe index by >= 1 a round, so
    # max_probes + 1 rounds bound the loop; lanes still pending after
    # it overflow to the exact host lane.
    max_rounds = max_probes + 1
    # Fresh claim scratch per call, with a sink row at index
    # ``capacity`` for lanes that contend for nothing. A slot is
    # contended at most once per call (its winner occupies it), so the
    # scratch needs no reset between rounds.
    claim = torch.full((capacity + 1,), _NO_LANE, dtype=torch.int64,
                       device=dev)
    r = torch.zeros((b,), dtype=torch.int64, device=dev)
    pending = valid.clone()
    inserted = torch.zeros((b,), dtype=torch.bool, device=dev)
    ovf = torch.zeros((b,), dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < max_rounds and bool(pending.any()):
        slots, match_j, empty_j = _probe_window(
            rows, keys, home, r, w, max_probes, capacity)
        stop_j = match_j | empty_j
        any_stop = stop_j.any(dim=-1)
        jstar = torch.argmax(stop_j.to(torch.int8), dim=-1)  # first stop
        match = pending & any_stop & match_j.gather(1, jstar[:, None])[:, 0]
        empty = pending & any_stop & ~match
        slot = slots.gather(1, jstar[:, None])[:, 0]
        # The election at each lane's first empty slot: the lowest
        # contending lane id survives the scatter-min.
        cslot = torch.where(empty, slot, capacity)
        claim.scatter_reduce_(0, cslot, lane, reduce="amin")
        wlane = claim[slot]
        winner = empty & (wlane == lane)
        # Winners hold distinct slots; each commits key and meta at once.
        rows[slot[winner]] = qrows[winner]
        # A loser whose key equals the winner's is a within-batch
        # duplicate; a loser with another key probes on past the slot.
        wkeys = keys[torch.clamp(wlane, 0, b - 1)]
        loser = empty & ~winner
        loser_match = loser & (wkeys == keys).all(dim=-1)
        inserted |= winner
        pending = pending & ~match & ~winner & ~loser_match
        r = torch.where(pending, torch.where(any_stop, r + jstar + 1, r + w), r)
        exhausted = pending & (r >= max_probes)
        ovf |= exhausted
        pending = pending & ~exhausted
        rounds += 1
    overflowed = ovf | pending
    count = state.count + inserted.sum()
    return TableState(rows, count), inserted, overflowed


def contains(state: TableState, keys: torch.Tensor,
             max_probes: int = 32) -> torch.Tensor:
    """Batch membership query (no mutation): bool[B]. A W-wide window of
    chain positions a round, until every lane has met its key or an
    empty slot (usually one round)."""
    rows = state.rows
    capacity = rows.shape[0]
    dev = rows.device
    keys = _desentinel(keys)
    home = _home_slot(keys, capacity)
    b = keys.shape[0]
    w = min(PROBE_WIDTH, max_probes)
    r = torch.zeros((b,), dtype=torch.int64, device=dev)
    found = torch.zeros((b,), dtype=torch.bool, device=dev)
    open_ = torch.ones((b,), dtype=torch.bool, device=dev)
    while bool(open_.any()):
        _slots, match_j, empty_j = _probe_window(
            rows, keys, home, r, w, max_probes, capacity)
        before_empty = torch.cumsum(empty_j.to(torch.int32), dim=-1) == 0
        found |= open_ & (match_j & before_empty).any(dim=-1)
        # A lane stays open only when every in-budget window position
        # held another key (the chain continues past the window).
        still = open_ & ~(match_j | empty_j).any(dim=-1)
        r = torch.where(still, r + w, r)
        open_ = still & (r < max_probes)
    return found


def occupied(state: TableState) -> torch.Tensor:
    """bool[capacity] occupancy mask."""
    return (state.keys != 0).any(dim=-1)


# -- NumPy helpers (copies of the JAX module's host-side functions) ----

def host_rows(state: TableState) -> np.ndarray:
    """The table's rows as ``uint32[capacity, 5]`` on the host. For a
    table on the CPU this is a view of the live rows, which the next
    insert changes in place: copy it to keep a snapshot."""
    return state.rows.cpu().numpy().view(np.uint32)


def contains_np(table_rows: np.ndarray, keys: np.ndarray,
                max_probes: int = 32) -> np.ndarray:
    """NumPy mirror of :func:`contains` (same home slot, triangular
    chain and match-before-first-empty rule) for host-only reads.
    ``table_rows`` may be the fused [capacity, 5] rows or bare
    [capacity, 4] keys; the batch is chunked to bound the
    [chunk, max_probes, 4] gather."""
    capacity = table_rows.shape[0]
    if capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, got {capacity}")
    keys = keys.astype(np.uint32, copy=True).reshape(-1, 4)
    zero = ~keys.any(axis=-1)
    keys[zero, :] = 0
    keys[zero, 3] = 1  # _desentinel
    mask = capacity - 1
    home = (keys[:, 0] ^ (keys[:, 1] * np.uint32(_GOLDEN))).astype(np.int64)
    r = np.arange(max_probes, dtype=np.int64)
    tri = (r * (r + 1)) // 2
    out = np.zeros((keys.shape[0],), bool)
    table_keys = table_rows[:, :4]
    for start in range(0, keys.shape[0], 65536):
        sl = slice(start, start + 65536)
        slots = (home[sl, None] + tri[None, :]) & mask  # [b, P]
        got = table_keys[slots]  # [b, P, 4] key words
        match = (got == keys[sl, None, :]).all(axis=-1)
        empty = ~got.any(axis=-1)
        out[sl] = (match & (np.cumsum(empty, axis=1) == 0)).any(axis=1)
    return out


def drain_np(state: TableState) -> tuple[np.ndarray, np.ndarray]:
    """Pull (keys uint32[N, 4], meta uint32[N]) of occupied slots, in
    slot order."""
    rows = host_rows(state)
    occ = rows[:, :4].any(axis=-1)
    return rows[occ, :4], rows[occ, 4]
