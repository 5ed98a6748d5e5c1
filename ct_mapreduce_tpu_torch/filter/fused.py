"""Fused multi-group cascade builds: one scatter dispatch per
layer-round, not one per (group, layer) (port of
``ct_mapreduce_tpu_torch.filter.fused``).

Building each group's cascade one layer at a time would issue thousands
of tiny scatters whose fixed toll dwarfs their work. This module builds
EVERY group's layer ``ℓ`` in lockstep: the active groups' current key
sets pack into ``[B, 4]`` lane batches with a per-lane group id, and ONE
scatter per batch sets all of them into a concatenated per-group word
arena (per-lane ``m``/``k``/bit offset gathered from group-indexed
parameter vectors). On ``device`` (CUDA unless named) that scatter is
:func:`ops.bloom.bloom_scatter`: the hand-written kernel K5 on the card,
which ORs the bits straight into packed words, or its plain PyTorch
version on the CPU. The false-positive chase re-probes each group's
complement against the same arena in host NumPy (:func:`fused_contains`),
as the JAX package does.

**Byte identity is the contract.** For every group the emitted layers
``(m, k, words)`` equal :meth:`FilterCascade.build`'s exactly:

- sizing sees the same counts (per-group unique-key sets, the
  inc∩exc drop replicated through the global sorted-unique key table
  ``S`` — a group's excluded universe is precisely ``S`` minus its own
  rows);
- scatter positions are the same wrapping-uint32 double-hash math,
  offset into the group's arena slice (offsets are multiples of 32
  bits, so the packed words slice out exactly);
- the chase classifies the same key sets (order within a set is
  immaterial: bitmaps and counts are set-determined), so every deeper
  layer sees the same inputs.

The NumPy lane mirrors the device scatter bit for bit, so
``CTMR_FILTER_DEVICE=0`` builds the same artifact. No wall-clock, no
RNG, no unsorted iteration enters this module.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ct_mapreduce_tpu_torch.device import resolve_device
from ct_mapreduce_tpu_torch.filter.cascade import (
    _GOLD,
    _MIX,
    _pack_words,
    DEVICE_BUILD_MIN,
    MAX_LAYERS,
    BloomLayer,
    FilterCascade,
    device_enabled,
    keys_tensor,
    layer_params,
    words_numpy,
)
from ct_mapreduce_tpu_torch.ops import bloom
from ct_mapreduce_tpu_torch.telemetry import trace

# Lanes per fused scatter dispatch (resolve_filter: filterFusedLanes /
# CTMR_FILTER_FUSED_LANES). Bounds the per-dispatch key gather and the
# keys copied to the card at once.
DEFAULT_MAX_LANES = 1 << 20

# Bits per arena segment. Bounds the (device) word arena AND keeps
# every scatter target inside int32 (offset + position < 2^31);
# a layer-round whose groups want more bits splits into segments.
DEFAULT_MAX_ARENA_BITS = 1 << 30

_INT32_BITS_CEIL = (1 << 31) - 1


@dataclass
class FusedStats:
    """What the fused build actually dispatched — the collapse the
    round-19 acceptance records (per-group equivalent vs fused)."""

    rounds: int = 0
    peak_rss: int = 0  # max sampled RSS at sort/round boundaries
    dispatches: int = 0  # fused scatter batch executions (device or np)
    device_dispatches: int = 0
    layers: int = 0  # per-(group, layer) count == legacy dispatch count
    scatter_lanes: int = 0
    probe_lanes: int = 0
    escalations: int = 0  # stall-escalation layer rebuilds (rare tail)
    groups_per_dispatch: list = field(default_factory=list)

    def mean_groups_per_dispatch(self) -> float:
        if not self.groups_per_dispatch:
            return 0.0
        return float(sum(self.groups_per_dispatch)
                     / len(self.groups_per_dispatch))


def _pow2(n: int, floor: int = 1) -> int:
    return max(floor, 1 << (max(n, 1) - 1).bit_length())


def _rows_hilo(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint32[n, 4] rows → two uint64 sort keys (row order is only a
    canon for run detection; the artifact bytes are set-determined)."""
    r = np.asarray(rows, np.uint32)
    hi = (r[:, 0].astype(np.uint64) << np.uint64(32)) | r[:, 1]
    lo = (r[:, 2].astype(np.uint64) << np.uint64(32)) | r[:, 3]
    return hi, lo


def _unique_idx(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Indices of one representative per distinct (hi, lo) pair."""
    if hi.size == 0:
        return np.zeros((0,), np.int64)
    order = np.lexsort((lo, hi))
    shi, slo = hi[order], lo[order]
    new = np.ones(order.size, bool)
    new[1:] = (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])
    return order[new]


def _scatter_np(arena: np.ndarray, keys: np.ndarray, gid: np.ndarray,
                layer: int, offs: np.ndarray, ms: np.ndarray,
                ks: np.ndarray, kmax: int) -> None:
    """NumPy mirror of the fused scatter (bit-equal by the same
    arithmetic as cascade._probe_np, plus the group offset)."""
    keys = np.asarray(keys, np.uint32)
    lay_gold = np.uint32((layer * int(_GOLD)) & 0xFFFFFFFF)
    lay_mix = np.uint32((layer * int(_MIX)) & 0xFFFFFFFF)
    a = (keys[:, 0] ^ lay_gold) + keys[:, 2]
    b = ((keys[:, 1] ^ lay_mix) + keys[:, 3]) | np.uint32(1)
    i = np.arange(kmax, dtype=np.uint32)
    m = ms[gid].astype(np.uint32)
    pos = (a[:, None] + i[None, :] * b[:, None]) % m[:, None]
    tgt = offs[gid].astype(np.int64)[:, None] + pos.astype(np.int64)
    live = i[None, :] < ks[gid][:, None]
    arena[tgt[live]] = True


def fused_contains(words_all: np.ndarray, idx_chunks: list,
                   S: np.ndarray, layer: int, offs_words: np.ndarray,
                   ms: np.ndarray, ks: np.ndarray) -> list:
    """Probe mixed-group lanes against the round's packed arena in one
    vectorized pass: ``idx_chunks`` is ``[(local_gid, S-index array),
    ...]``; returns per entry the boolean hit vector. Bit-equal to
    per-group :func:`layer_contains` (same probe math; a group's
    32-bit-aligned arena offset shifts whole words)."""
    if not idx_chunks:
        return []
    lanes = np.concatenate([idx for _, idx in idx_chunks])
    gid = np.concatenate(
        [np.full((idx.size,), g, np.int32) for g, idx in idx_chunks])
    keys = S[lanes]
    lay_gold = np.uint32((layer * int(_GOLD)) & 0xFFFFFFFF)
    lay_mix = np.uint32((layer * int(_MIX)) & 0xFFFFFFFF)
    a = (keys[:, 0] ^ lay_gold) + keys[:, 2]
    b = ((keys[:, 1] ^ lay_mix) + keys[:, 3]) | np.uint32(1)
    kmax = int(ks.max()) if ks.size else 1
    m = ms[gid].astype(np.uint32)
    # Arena segments are int32-bounded by construction, so every
    # absolute bit position fits int32 — half the index traffic of
    # int64 on the gather-heavy chase.
    off_bits = (offs_words[gid] * 32).astype(np.int32)
    kk = ks[gid].astype(np.int32)
    w = np.asarray(words_all, np.uint32)
    n = lanes.size
    # Short-circuit probing (see layer_contains): a lane leaves the
    # working set at its first unset bit — bit-identical results,
    # ~1/(1-fill) probes per non-member instead of kmax.
    hit = np.ones((n,), bool)
    alive = np.arange(n, dtype=np.int32)
    for i in range(kmax):
        if alive.size == 0:
            break
        act = alive[kk[alive] > i]
        if act.size == 0:
            break
        pos = (a[act] + np.uint32(i) * b[act]) % m[act]
        abs_pos = off_bits[act] + pos.astype(np.int32)
        ok = ((w[abs_pos >> 5] >> (abs_pos & 31).astype(np.uint32))
              & 1).astype(bool)
        hit[act[~ok]] = False
        alive = act[ok]
    out = []
    pos0 = 0
    for _, idx in idx_chunks:
        out.append(hit[pos0: pos0 + idx.size])
        pos0 += idx.size
    return out


class _GroupState:
    __slots__ = ("inc", "cur_in", "cur_out", "active", "cascade")

    def __init__(self, inc: np.ndarray, fp_rate: float):
        self.inc = inc  # int32 S-indices, the group's unique keys
        self.cur_in = inc
        self.cur_out: Optional[np.ndarray] = None  # None ⇒ complement
        self.active = inc.size > 0
        self.cascade = FilterCascade(fp_rate=float(fp_rate),
                                     n_included=int(inc.size))


def _complement_chunks(U: int, inc: np.ndarray, chunk: int):
    """Stream S-indices NOT in the (sorted) ``inc`` index set — the
    group's excluded universe at layer 0, never materialized whole."""
    for s in range(0, U, chunk):
        e = min(U, s + chunk)
        idx = np.arange(s, e, dtype=np.int64)
        a, b = np.searchsorted(inc, [s, e])
        members = inc[a:b].astype(np.int64)
        if members.size:
            mask = np.ones(e - s, bool)
            mask[members - s] = False
            idx = idx[mask]
        if idx.size:
            yield idx


def build_cascades_fused(
        group_keys: list, fp_rate: float,
        use_device: Optional[bool] = None,
        max_lanes: int = 0,
        max_arena_bits: int = 0,
        consume: bool = False,
        device=None) -> tuple[list, FusedStats]:
    """Build every group's cascade in fused layer-rounds.

    ``group_keys`` is one ``uint32[n_g, 4]`` raw key array per group
    (duplicates tolerated, as in the per-group builder). Returns the
    per-group :class:`FilterCascade` list (same order) plus the
    dispatch statistics. Semantics mirror ``FilterCascade.build(keys_g,
    all_other_keys, fp_rate)`` per group, byte-identically.
    ``consume=True`` lets the builder free each raw key array as soon
    as its unique rows are extracted (the caller's list entries become
    None — the 10⁸-scale RSS lever)."""
    max_lanes = int(max_lanes) or DEFAULT_MAX_LANES
    max_arena_bits = int(max_arena_bits) or DEFAULT_MAX_ARENA_BITS
    G = len(group_keys)
    stats = FusedStats()
    if G == 0:
        return [], stats

    # Global sorted-unique key table S + per-group unique index sets.
    # A group's excluded universe (every OTHER group's keys, minus its
    # own — the inc∩exc drop) is exactly S minus its inc set: every S
    # row outside inc_g belongs to some other group by construction.
    per_group_idx = []
    cat_rows = []
    for g in range(G):
        rows = np.asarray(group_keys[g], np.uint32).reshape(-1, 4)
        if consume:
            # The raw key arrays are not needed once their unique rows
            # are extracted (at 10⁸ serials each copy is corpus-sized).
            group_keys[g] = None
        hi, lo = _rows_hilo(rows)
        cat_rows.append(rows[_unique_idx(hi, lo)])
        del rows
    from ct_mapreduce_tpu_torch.filter.stream import _rss_bytes

    gid_all = np.concatenate(
        [np.full((cat_rows[g].shape[0],), g, np.int32)
         for g in range(G)]) if cat_rows else np.zeros((0,), np.int32)
    all_rows = (np.concatenate(cat_rows) if cat_rows
                else np.zeros((0, 4), np.uint32))
    del cat_rows
    hi, lo = _rows_hilo(all_rows)
    order = np.lexsort((lo, hi))
    # The global sort is the build's RSS high-water mark at scale —
    # sample it where it peaks, not just at round boundaries.
    stats.peak_rss = max(stats.peak_rss, _rss_bytes())
    shi, slo = hi[order], lo[order]
    del hi, lo
    new = np.ones(order.size, bool)
    if order.size:
        new[1:] = (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])
    del shi, slo
    u_of_sorted = np.cumsum(new, dtype=np.int64) - 1
    S = all_rows[order[new]]
    U = int(S.shape[0])
    gid_sorted = gid_all[order]
    del all_rows, gid_all, order, new
    by_group = np.argsort(gid_sorted, kind="stable")
    counts = np.bincount(gid_sorted, minlength=G)
    del gid_sorted
    u_by_group = u_of_sorted[by_group]
    del u_of_sorted, by_group
    pos0 = 0
    for g in range(G):
        per_group_idx.append(
            u_by_group[pos0: pos0 + counts[g]].astype(np.int32))
        pos0 += int(counts[g])
    del u_by_group

    states = [_GroupState(per_group_idx[g], fp_rate) for g in range(G)]
    del per_group_idx
    stats.peak_rss = max(stats.peak_rss, _rss_bytes())

    level = 0
    while True:
        actives = [g for g in range(G)
                   if states[g].active and states[g].cur_in.size > 0]
        if not actives:
            break
        if level >= MAX_LAYERS:
            raise RuntimeError(
                f"filter cascade did not converge in {MAX_LAYERS} "
                "layers (non-disjoint inputs?)")
        p = fp_rate if level == 0 else 0.5
        params = {g: layer_params(int(states[g].cur_in.size), p)
                  for g in actives}
        # Arena segments: greedy by bits, int32-safe by construction.
        segments: list[list[int]] = []
        seg: list[int] = []
        seg_bits = 0
        for g in actives:
            m = params[g][0]
            if m > _INT32_BITS_CEIL:
                raise ValueError(
                    f"layer of {m} bits exceeds the int32 scatter "
                    "range; raise the FP rate or shard the corpus")
            if seg and seg_bits + m > max_arena_bits:
                segments.append(seg)
                seg, seg_bits = [], 0
            seg.append(g)
            seg_bits += m
        if seg:
            segments.append(seg)

        for seg in segments:
            _build_segment(states, seg, params, S, U, level,
                           use_device, max_lanes, stats, device)
        stats.rounds += 1
        stats.peak_rss = max(stats.peak_rss, _rss_bytes())
        level += 1

    return [st.cascade for st in states], stats


def _build_segment(states, seg, params, S, U, level, use_device,
                   max_lanes, stats: FusedStats, device=None) -> None:
    offs = np.zeros((len(seg),), np.int64)
    total = 0
    for j, g in enumerate(seg):
        offs[j] = total
        total += params[g][0]
    ms = np.array([params[g][0] for g in seg], np.int64)
    ks = np.array([params[g][1] for g in seg], np.int64)
    kmax = _pow2(int(ks.max()))
    total_lanes = int(sum(states[g].cur_in.size for g in seg))
    dev = use_device
    if dev is None:
        dev = device_enabled() and total_lanes >= DEVICE_BUILD_MIN

    with trace.span("filter.fused_layer", cat="filter", level=level,
                    groups=len(seg), lanes=total_lanes,
                    bits=total, device=int(bool(dev))):
        # -- fused scatter, chunked to max_lanes per dispatch --------
        chunks = _lane_chunks(states, seg, max_lanes)
        if dev:
            words_all = _scatter_device(chunks, S, offs, ms, ks, level,
                                        total, stats, device)
        else:
            arena = np.zeros((total,), bool)
            for lane_list in chunks:
                keys = np.concatenate([S[idx] for _, idx in lane_list])
                gid = np.concatenate(
                    [np.full((idx.size,), j, np.int32)
                     for j, idx in lane_list])
                _scatter_np(arena, keys, gid, level, offs, ms,
                            ks.astype(np.int64), kmax)
                stats.dispatches += 1
                stats.groups_per_dispatch.append(len(lane_list))
            words_all = _pack_words(arena)
            del arena
        stats.scatter_lanes += total_lanes
        stats.layers += len(seg)

        # -- record layers ------------------------------------------
        for j, g in enumerate(seg):
            w0 = int(offs[j]) // 32
            words = words_all[w0: w0 + int(ms[j]) // 32].copy()
            states[g].cascade.layers.append(
                BloomLayer(m=int(ms[j]), k=int(ks[j]), words=words))

        # -- false-positive chase: the complement re-probes in the
        # same fused mixed-group batches the scatter used ------------
        offs_words = (offs // 32).astype(np.int64)
        collectors: dict[int, list] = {}
        probed_n: dict[int, int] = {}
        pending: list = []
        pending_n = 0

        def flush_probes():
            nonlocal pending, pending_n
            if not pending:
                return
            hits = fused_contains(words_all, pending, S, level,
                                  offs_words, ms, ks)
            for (j, idx), hit in zip(pending, hits):
                collectors[j].append(idx[hit].astype(np.int32))
                probed_n[j] += int(idx.size)
                stats.probe_lanes += int(idx.size)
            pending, pending_n = [], 0

        def out_chunks(st):
            if st.cur_out is None:
                return _complement_chunks(U, st.inc, max_lanes)
            out = st.cur_out
            return (out[s: s + max_lanes]
                    for s in range(0, out.size, max_lanes))

        probing: list[int] = []
        for j, g in enumerate(seg):
            st = states[g]
            if st.cur_out is None and U - st.inc.size == 0:
                st.active = False  # single-group universe: no chase
                st.cur_in = np.zeros((0,), np.int32)
                continue
            if st.cur_out is not None and st.cur_out.size == 0:
                st.active = False  # reference: break after the layer
                st.cur_in = np.zeros((0,), np.int32)
                continue
            probing.append(j)
            collectors[j] = []
            probed_n[j] = 0
            for idx in out_chunks(st):
                pending.append((j, idx))
                pending_n += int(idx.size)
                if pending_n >= max_lanes:
                    flush_probes()
        flush_probes()
        for j in probing:
            st = states[seg[j]]
            hits = collectors[j]
            new_in = (np.concatenate(hits) if hits
                      else np.zeros((0,), np.int32))
            if new_in.size and new_in.size == probed_n[j]:
                # Stall: the group's whole complement false-positived
                # (low-bit twins — cascade.MAX_SIZE_ESCALATIONS). Same
                # deterministic escalation as the reference path: grow
                # THIS group's layer until the twins separate, then
                # replace its arena slice.
                new_in = _escalate_group(st, params[seg[j]], S, U,
                                         level, use_device, max_lanes,
                                         stats, device)
            st.cur_out = st.cur_in
            st.cur_in = new_in


def _escalate_group(st, params_jg, S, U, level, use_device,
                    max_lanes, stats: FusedStats,
                    device=None) -> np.ndarray:
    """Reference-identical stall escalation for one group: double m
    (k recomputed by the shared sizing formula), rebuild the layer
    over the group's cur_in keys, and re-probe its complement until
    not every key hits. Replaces the group's last recorded layer."""
    from ct_mapreduce_tpu_torch.filter.cascade import (
        MAX_SIZE_ESCALATIONS,
        build_layer,
        layer_contains,
        layer_k,
    )

    m, k = params_jg
    cur_keys = S[st.cur_in]
    esc = 0
    while True:
        esc += 1
        if esc > MAX_SIZE_ESCALATIONS:
            raise RuntimeError(
                "filter cascade stalled: complement keys "
                "false-positive at every layer size "
                "(non-disjoint inputs?)")
        m *= 2
        k = layer_k(m, int(st.cur_in.size))
        words = build_layer(cur_keys, m, k, level,
                            use_device=use_device, device=device)
        stats.escalations += 1
        hits = []
        probed = hit_total = 0
        if st.cur_out is None:
            chunk_iter = _complement_chunks(U, st.inc, max_lanes)
        else:
            out = st.cur_out
            chunk_iter = (out[s: s + max_lanes]
                          for s in range(0, out.size, max_lanes))
        for idx in chunk_iter:
            hit = layer_contains(words, m, k, level, S[idx])
            hits.append(idx[hit].astype(np.int32))
            probed += int(idx.size)
            hit_total += int(hit.sum())
            stats.probe_lanes += int(idx.size)
        if hit_total < probed:
            st.cascade.layers[-1] = BloomLayer(m=m, k=k, words=words)
            return (np.concatenate(hits) if hits
                    else np.zeros((0,), np.int32))


def build_cascades_grouped(
        group_keys: list, fp_rate: float,
        use_device: Optional[bool] = None,
        max_lanes: int = 0,
        max_arena_bits: int = 0,
        consume: bool = False,
        device=None) -> tuple[list, FusedStats]:
    """The ``CTMRFL02`` fused build: one Bloom layer per group over
    the group's OWN unique keys (empty excluded universe — per-group
    universes never consult other groups' keys), batched through the
    same arena scatter the cascade rounds use. With no excluded set
    there is no false-positive chase, no deeper layers, and no stall
    escalation: the whole build is one layer-round of scatters.

    Byte-identical per group to ``FilterCascade.build(keys_g,
    <empty>, fp_rate)`` — same unique-count sizing, same probe math,
    same word packing (32-bit-aligned arena offsets slice exactly)."""
    max_lanes = int(max_lanes) or DEFAULT_MAX_LANES
    max_arena_bits = int(max_arena_bits) or DEFAULT_MAX_ARENA_BITS
    G = len(group_keys)
    stats = FusedStats()
    if G == 0:
        return [], stats
    from ct_mapreduce_tpu_torch.filter.stream import _rss_bytes

    uniq: list = []
    for g in range(G):
        rows = np.asarray(group_keys[g], np.uint32).reshape(-1, 4)
        if consume:
            group_keys[g] = None
        hi, lo = _rows_hilo(rows)
        uniq.append(rows[_unique_idx(hi, lo)])
        del rows
    stats.peak_rss = max(stats.peak_rss, _rss_bytes())
    cascades = [FilterCascade(fp_rate=float(fp_rate),
                              n_included=int(uniq[g].shape[0]))
                for g in range(G)]
    actives = [g for g in range(G) if uniq[g].shape[0] > 0]
    if not actives:
        return cascades, stats
    params = {g: layer_params(int(uniq[g].shape[0]), fp_rate)
              for g in actives}
    segments: list[list[int]] = []
    seg: list[int] = []
    seg_bits = 0
    for g in actives:
        m = params[g][0]
        if m > _INT32_BITS_CEIL:
            raise ValueError(
                f"layer of {m} bits exceeds the int32 scatter "
                "range; raise the FP rate or shard the corpus")
        if seg and seg_bits + m > max_arena_bits:
            segments.append(seg)
            seg, seg_bits = [], 0
        seg.append(g)
        seg_bits += m
    if seg:
        segments.append(seg)

    for seg in segments:
        offs = np.zeros((len(seg),), np.int64)
        total = 0
        for j, g in enumerate(seg):
            offs[j] = total
            total += params[g][0]
        ms = np.array([params[g][0] for g in seg], np.int64)
        ks = np.array([params[g][1] for g in seg], np.int64)
        kmax = _pow2(int(ks.max()))
        total_lanes = int(sum(uniq[g].shape[0] for g in seg))
        dev = use_device
        if dev is None:
            dev = device_enabled() and total_lanes >= DEVICE_BUILD_MIN
        with trace.span("filter.fused_layer", cat="filter", level=0,
                        groups=len(seg), lanes=total_lanes,
                        bits=total, device=int(bool(dev))):
            chunks = _row_chunks(uniq, seg, max_lanes)
            if dev:
                words_all = _scatter_device_rows(chunks, offs, ms, ks, 0,
                                                 total, stats, device)
            else:
                arena = np.zeros((total,), bool)
                for lane_list in chunks:
                    keys = np.concatenate(
                        [rows for _, rows in lane_list])
                    gid = np.concatenate(
                        [np.full((rows.shape[0],), j, np.int32)
                         for j, rows in lane_list])
                    _scatter_np(arena, keys, gid, 0, offs, ms,
                                ks.astype(np.int64), kmax)
                    stats.dispatches += 1
                    stats.groups_per_dispatch.append(len(lane_list))
                words_all = _pack_words(arena)
                del arena
            stats.scatter_lanes += total_lanes
            stats.layers += len(seg)
            for j, g in enumerate(seg):
                w0 = int(offs[j]) // 32
                words = words_all[w0: w0 + int(ms[j]) // 32].copy()
                cascades[g].layers.append(
                    BloomLayer(m=int(ms[j]), k=int(ks[j]),
                               words=words))
                uniq[g] = None  # free as soon as the layer is cut
        stats.peak_rss = max(stats.peak_rss, _rss_bytes())
    stats.rounds = 1
    return cascades, stats


def _row_chunks(uniq, seg, max_lanes: int) -> list:
    """Pack the segment's per-group key rows into ≤max_lanes batches:
    ``[[(local_gid, uint32[n,4] row slice), ...], ...]`` — the
    grouped-build analogue of :func:`_lane_chunks` (rows direct, no
    global S table to index into)."""
    chunks = []
    cur: list = []
    cur_n = 0
    for j, g in enumerate(seg):
        rows = uniq[g]
        pos = 0
        while pos < rows.shape[0]:
            take = min(int(rows.shape[0]) - pos, max_lanes - cur_n)
            if take > 0:
                cur.append((j, rows[pos: pos + take]))
                cur_n += take
                pos += take
            if cur_n >= max_lanes:
                chunks.append(cur)
                cur, cur_n = [], 0
    if cur:
        chunks.append(cur)
    return chunks


def _scatter_device_rows(chunks, offs, ms, ks, level, total_bits,
                         stats: FusedStats, device=None) -> np.ndarray:
    """Device lane of the grouped (single-layer) build: the same arena
    scatter as :func:`_scatter_device`, with lane keys taken from row
    slices instead of S-indices."""
    return _device_arena(chunks, lambda rows: rows, offs, ms, ks, level,
                         total_bits, stats, device)


def _lane_chunks(states, seg, max_lanes: int) -> list:
    """Pack the segment's cur_in index sets into ≤max_lanes batches:
    ``[[(local_gid, S-index slice), ...], ...]``."""
    chunks = []
    cur: list = []
    cur_n = 0
    for j, g in enumerate(seg):
        idx = states[g].cur_in
        pos = 0
        while pos < idx.size:
            take = min(int(idx.size) - pos, max_lanes - cur_n)
            if take > 0:
                cur.append((j, idx[pos: pos + take]))
                cur_n += take
                pos += take
            if cur_n >= max_lanes:
                chunks.append(cur)
                cur, cur_n = [], 0
    if cur:
        chunks.append(cur)
    return chunks


def _scatter_device(chunks, S, offs, ms, ks, level, total_bits,
                    stats: FusedStats, device=None) -> np.ndarray:
    """Device lane of a cascade layer round: every chunk's lanes
    (S-index slices) scattered into one word arena on ``device``."""
    return _device_arena(chunks, lambda idx: S[idx], offs, ms, ks, level,
                         total_bits, stats, device)


def _device_arena(chunks, keys_of, offs, ms, ks, level, total_bits,
                  stats: FusedStats, device=None) -> np.ndarray:
    """One word arena of ``total_bits`` (a multiple of 32) on ``device``
    (CUDA unless named), zeroed, then one :func:`ops.bloom.bloom_scatter`
    per chunk of ``[(local_gid, lanes), ...]`` — K5 on the card, its
    plain version on the CPU. Returns the host uint32 words. Lanes are
    never padded: the kernel has no compile shapes to bound."""
    dev = resolve_device(device)
    words = torch.zeros((total_bits // 32,), dtype=torch.int32, device=dev)
    offs_d = torch.from_numpy(np.asarray(offs, np.int64)).to(dev)
    ms_d = torch.from_numpy(np.asarray(ms, np.int32)).to(dev)
    ks_d = torch.from_numpy(np.asarray(ks, np.int32)).to(dev)
    kmax = int(np.max(ks)) if len(ks) else 0
    for lane_list in chunks:
        parts = [keys_of(lanes) for _, lanes in lane_list]
        gid = np.concatenate([np.full((p.shape[0],), j, np.int32)
                              for (j, _), p in zip(lane_list, parts)])
        bloom.bloom_scatter(words, keys_tensor(np.concatenate(parts), dev),
                            torch.from_numpy(gid).to(dev), offs_d, ms_d,
                            ks_d, level, kmax=kmax)
        stats.dispatches += 1
        stats.device_dispatches += 1
        stats.groups_per_dispatch.append(len(lane_list))
    return words_numpy(words)
