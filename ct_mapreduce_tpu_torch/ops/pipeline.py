"""The device ingest steps (port of ``ct_mapreduce_tpu.ops.pipeline``).

The walker step, :func:`ingest_core`, is the default ct-fetch path:
parse DER (the walker kernel K3) → filter (CA / expired / issuer-CN
prefix) → gather serial → fingerprint (the SHA-256 kernel K1) → dedup
insert-if-absent → per-issuer new-serial counts. Lanes the device
cannot take exactly (walker reject, oversized serial, meta range,
boundary hour, undecidable CN prefix, probe overflow) come back in
``host_lane`` for the exact host path.

The pre-parsed step, :func:`preparsed_core`: when the native decoder has already extracted the identity fields on
the host (native/ctmr_native.cpp ``ctmr_extract_sidecars``), the
device step is fingerprint SHA-256 + dedup-table insert + per-issuer
counts on compact per-lane inputs (~59 B a lane). The readback is ONE
packed int32 array per step: a was-unknown bitmask (1 bit a lane),
sorted overflow lane ids (O(flagged), not O(batch)) and the count
vectors, laid out exactly as the JAX package's ``PreparsedStepOut``.

Every filter and routing predicate that does not depend on table state
is evaluated by the HOST (``agg/aggregator.py``
``ingest_preparsed_submit``); only ``insertable`` reaches the device.

The staged envelope, :func:`staged_core`: K walker chunks that the
ingest sink shipped in one copy run as K calls of :func:`ingest_core`
in order, their per-lane outputs packed on the device
(:func:`pack_lane_words`) so the host reads one ``int32[K, 7, B]``
array per envelope.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple

import torch

from ct_mapreduce_tpu_torch.core import packing
from ct_mapreduce_tpu_torch.ops import buckettable, der_kernel, hashtable, sha256

N_PREPARSED_FLAG_CAP = 1024  # default compacted-overflow capacity

#: Dedup fingerprints of the lanes' fields: the hand-written kernel on
#: CUDA tensors, the plain version on CPU tensors.
fingerprints = sha256.sha256_fingerprint64


def table_layout() -> str:
    """Dedup-table layout: ``bucket`` (the default, ops/buckettable.py)
    or ``open`` (slot-granular open addressing, ops/hashtable.py), from
    ``CTMR_TABLE``. An unknown value warns and selects bucket."""
    layout = os.environ.get("CTMR_TABLE", "bucket").strip().lower()
    if layout not in ("bucket", "open"):
        warnings.warn(
            f"ignoring CTMR_TABLE={layout!r} (want bucket|open); "
            "using bucket", stacklevel=2)
        return "bucket"
    return layout


def make_table(capacity: int, layout: str | None = None, device=None):
    """Fresh dedup table in the selected layout, on ``device`` (CUDA
    unless given)."""
    if (layout or table_layout()) == "bucket":
        return buckettable.make_table(capacity, device=device)
    return hashtable.make_table(capacity, device=device)


def table_insert(table, keys, meta, valid, max_probes: int = 32):
    """Insert-if-absent on either dedup-table layout, dispatched on the
    state's type: ``BucketTable`` takes the bucket path,
    ``hashtable.TableState`` the slot-granular probe path."""
    if isinstance(table, hashtable.TableState):
        return hashtable.insert(table, keys, meta, valid,
                                max_probes=max_probes)
    return buckettable.insert(table, keys, meta, valid, max_probes=max_probes)


def table_contains(table, keys, max_probes: int = 32) -> torch.Tensor:
    """Membership on either dedup-table layout: bool[B]."""
    if isinstance(table, hashtable.TableState):
        return hashtable.contains(table, keys, max_probes=max_probes)
    return buckettable.contains(table, keys, max_probes=max_probes)


def _meta_word(issuer_idx: torch.Tensor, hour_off: torch.Tensor) -> torch.Tensor:
    """The dedup meta word as int32 bit patterns: issuer index above
    META_HOUR_BITS (which may set the sign bit), the clipped hour offset
    below."""
    meta = ((issuer_idx.to(torch.int64) * (1 << packing.META_HOUR_BITS)
             | torch.clamp(hour_off, 0, packing.META_HOUR_SPAN - 1))
            & 0xFFFFFFFF)
    return sha256.to_int32_bits(meta)


def _issuer_counts(issuer_idx: torch.Tensor, was_unknown: torch.Tensor,
                   num_issuers: int) -> torch.Tensor:
    """The scatter-add of JAX's ``.at[idx].add(mode="drop")``: a
    negative index counts from the end (NumPy style), and what is still
    out of range after that is dropped. int64[num_issuers]."""
    idx = issuer_idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + num_issuers, idx)
    in_range = (idx >= 0) & (idx < num_issuers)
    counts = torch.zeros((num_issuers,), dtype=torch.int64,
                         device=issuer_idx.device)
    counts.index_add_(0, torch.where(in_range, idx, 0),
                      (was_unknown & in_range).to(torch.int64))
    return counts


# -- the walker step ----------------------------------------------------

class StepOut(NamedTuple):
    was_unknown: torch.Tensor  # bool[B] — device-confirmed first sighting
    host_lane: torch.Tensor  # bool[B] — lane needs the exact host path
    filtered_ca: torch.Tensor  # bool[B]
    filtered_expired: torch.Tensor  # bool[B]
    filtered_cn: torch.Tensor  # bool[B]
    stored: torch.Tensor  # bool[B] — passed filters, device-handled
    not_after_hour: torch.Tensor  # int32[B]
    serials: torch.Tensor  # uint8[B, MAX_SERIAL_BYTES]
    serial_len: torch.Tensor  # int32[B]
    issuer_unknown_counts: torch.Tensor  # int32[num_issuers]
    has_crldp: torch.Tensor  # bool[B]
    crldp_off: torch.Tensor  # int32[B] — CRLDP extnValue window in `data`
    crldp_len: torch.Tensor  # int32[B]
    issuer_name_off: torch.Tensor  # int32[B] — issuer Name TLV window
    issuer_name_len: torch.Tensor  # int32[B]
    probe_overflow: torch.Tensor  # bool[B] — insert exhausted its probe
    # chain (spills to the exact host lane; `overflow` metric)


def _cn_prefix_match(window: torch.Tensor, cn_len: torch.Tensor,
                     prefixes: torch.Tensor, prefix_lens: torch.Tensor):
    """Does the issuer CN start with any configured prefix?

    ``window`` uint8[B, K] holds the K bytes at each lane's CN offset
    (the walker's CN window); ``prefixes`` uint8[P, K] the first K
    bytes of each prefix; ``prefix_lens`` int32[P, 2] the device-
    comparable length (min(len, K)) and the true length. Returns
    ``(hit, undecidable)`` bool[B]: ``undecidable`` matches the K-byte
    head of a LONGER-than-K prefix and is long enough that the tail
    could match, so the exact host lane must decide."""
    k = prefixes.shape[1]
    dev = window.device
    cols = torch.arange(k, device=dev)
    window = torch.where(cols[None, :] < cn_len[:, None], window, 0)
    dev_lens = prefix_lens[:, 0].to(torch.int64)
    true_lens = prefix_lens[:, 1].to(torch.int64)
    eq = window[:, None, :] == prefixes[None, :, :]  # [B, P, K]
    care = cols[None, None, :] < dev_lens[None, :, None]
    full = (eq | ~care).all(dim=-1)  # [B, P]
    truncated = (true_lens > dev_lens)[None, :]
    cl = cn_len.to(torch.int64)[:, None]
    hit = (full & (cl >= dev_lens[None, :]) & ~truncated).any(dim=-1)
    undecidable = (full & (cl >= true_lens[None, :]) & truncated).any(dim=-1)
    return hit, undecidable


class LocalLanes(NamedTuple):
    """Per-lane results of the communication-free ingest stages."""

    parsed: der_kernel.ParsedCerts
    serials: torch.Tensor  # uint8[B, MAX_SERIAL_BYTES]
    filtered_ca: torch.Tensor
    filtered_expired: torch.Tensor
    filtered_cn: torch.Tensor
    passed: torch.Tensor  # survived all filters
    device_exact: torch.Tensor  # serial/meta/issuer fit the device schema
    insertable: torch.Tensor  # passed & device_exact
    fps: torch.Tensor  # int32[B, 4] dedup fingerprints (uint32 bits)
    meta: torch.Tensor  # int32[B] packed (issuer_idx, exp-hour offset)


def local_lanes(data: torch.Tensor, length: torch.Tensor,
                issuer_idx: torch.Tensor, valid: torch.Tensor,
                now_hour: int, base_hour: int, cn_prefixes: torch.Tensor,
                cn_prefix_lens: torch.Tensor,
                num_issuers: int) -> LocalLanes:
    """Parse → filter → fingerprint. One walker launch gives the parsed
    fields, the serial window and the CN window; with no CN prefixes
    configured the RDN scan is skipped."""
    n_prefixes, k = cn_prefixes.shape
    scan = n_prefixes > 0
    w = der_kernel.walk(data, length, scan_issuer_cn=scan,
                        cn_window=k if scan else 0,
                        max_serial_bytes=packing.MAX_SERIAL_BYTES)
    parsed = w.parsed
    ok = parsed.ok & valid

    # Filters, in the reference's precedence order (CA, expired, CN).
    f_ca = ok & parsed.is_ca
    f_expired = ok & ~f_ca & (parsed.not_after_hour < now_hour)
    if scan:
        cn_hit, cn_undec = _cn_prefix_match(
            w.cn_window, parsed.issuer_cn_len, cn_prefixes, cn_prefix_lens)
        # A lane matching only the truncated head of an over-long prefix
        # is not filtered here: it routes to the exact host lane below.
        cn_undec = ok & ~f_ca & ~f_expired & ~cn_hit & cn_undec
        f_cn = ok & ~f_ca & ~f_expired & ~cn_hit & ~cn_undec
    else:
        f_cn = cn_undec = torch.zeros_like(ok)
    passed = ok & ~f_ca & ~f_expired & ~f_cn

    # Device-exactness gate. A cert expiring WITHIN the current hour
    # also takes the exact host lane: the device compares hour buckets,
    # the reference compares instants.
    hour_off = parsed.not_after_hour.to(torch.int64) - base_hour
    meta_ok = (hour_off >= 0) & (hour_off < packing.META_HOUR_SPAN)
    idx_ok = (issuer_idx >= 0) & (issuer_idx < num_issuers)
    boundary_hour = parsed.not_after_hour == now_hour
    device_exact = w.fits & meta_ok & idx_ok & ~boundary_hour & ~cn_undec

    fps = fingerprints(issuer_idx, parsed.not_after_hour, w.serials,
                       parsed.serial_len)
    return LocalLanes(
        parsed=parsed, serials=w.serials, filtered_ca=f_ca,
        filtered_expired=f_expired, filtered_cn=f_cn, passed=passed,
        device_exact=device_exact, insertable=passed & device_exact,
        fps=fps, meta=_meta_word(issuer_idx, hour_off))


def ingest_core(table, data: torch.Tensor, length: torch.Tensor,
                issuer_idx: torch.Tensor, valid: torch.Tensor,
                now_hour: int, base_hour: int, cn_prefixes: torch.Tensor,
                cn_prefix_lens: torch.Tensor,
                num_issuers: int = packing.MAX_ISSUERS,
                max_probes: int = 32):
    """One packed batch end to end on the rows' device.

    ``data`` uint8[B, L], ``length``/``issuer_idx`` int32[B], ``valid``
    bool[B]; ``now_hour`` is "now" for the expiry filter, ``base_hour``
    the meta word's epoch; ``cn_prefixes`` uint8[P, K] and
    ``cn_prefix_lens`` int32[P, 2] (P == 0 disables the CN filter).
    Returns ``(table, StepOut)``."""
    lanes = local_lanes(data, length, issuer_idx, valid, now_hour,
                        base_hour, cn_prefixes, cn_prefix_lens, num_issuers)
    parsed = lanes.parsed
    table, was_unknown, overflowed = table_insert(
        table, lanes.fps, lanes.meta, lanes.insertable, max_probes=max_probes)
    host_lane = ((valid & ~parsed.ok) | (lanes.passed & ~lanes.device_exact)
                 | overflowed)
    counts = _issuer_counts(issuer_idx, was_unknown, num_issuers)
    return table, StepOut(
        was_unknown=was_unknown,
        host_lane=host_lane,
        probe_overflow=overflowed,
        filtered_ca=lanes.filtered_ca,
        filtered_expired=lanes.filtered_expired,
        filtered_cn=lanes.filtered_cn,
        stored=lanes.insertable & ~overflowed,
        not_after_hour=parsed.not_after_hour,
        serials=lanes.serials,
        serial_len=parsed.serial_len,
        issuer_unknown_counts=counts.to(torch.int32),
        has_crldp=parsed.has_crldp,
        crldp_off=parsed.crldp_off,
        crldp_len=parsed.crldp_len,
        issuer_name_off=parsed.issuer_off,
        issuer_name_len=parsed.issuer_len,
    )


# -- the pre-parsed step ------------------------------------------------

class PreparsedStepOut(NamedTuple):
    """Device outputs of the pre-parsed step, readback-oriented."""

    packed: torch.Tensor  # int32[K, 2 + nb + flag_cap + num_issuers] —
    # the ONE array the host reads per step; per chunk row:
    #   [0] unknown_count, [1] overflow_count,
    #   [2 : 2+nb] was-unknown bitmask (bit i of word w = lane w*32+i),
    #   [2+nb : 2+nb+flag_cap] overflow lane ids ascending (B = none),
    #   [2+nb+flag_cap :] per-issuer fresh-insert counts.
    overflow_bits: torch.Tensor  # int32[K, nb] uint32 bits — full
    # overflow bitmask, read ONLY when overflow_count exceeds flag_cap.


def _pack_bits(flags: torch.Tensor, nb: int) -> torch.Tensor:
    """bool[B] → int32[nb] bitmask words (uint32 bits; bit i of word w
    = lane w*32+i)."""
    b = flags.shape[0]
    padded = torch.zeros((nb * 32,), dtype=torch.int64, device=flags.device)
    padded[:b] = flags.to(torch.int64)
    weights = torch.ones((32,), dtype=torch.int64, device=flags.device) << (
        torch.arange(32, dtype=torch.int64, device=flags.device))
    return sha256.to_int32_bits((padded.view(nb, 32) * weights).sum(dim=1))


def preparsed_core(
    table,
    serials: torch.Tensor,  # uint8[K, B, MAX_SERIAL_BYTES]
    serial_len: torch.Tensor,  # int32[K, B]
    not_after_hour: torch.Tensor,  # int32[K, B]
    issuer_idx: torch.Tensor,  # int32[K, B]
    insertable: torch.Tensor,  # bool[K, B] — host-computed gate
    base_hour: int,
    num_issuers: int = packing.MAX_ISSUERS,
    max_probes: int = 32,
    flag_cap: int = N_PREPARSED_FLAG_CAP,
):
    """K resident chunks through fingerprint + insert + counts, in
    order, on the table's device. Returns ``(table, PreparsedStepOut)``."""
    k_chunks, b = serial_len.shape
    dev = serial_len.device
    nb = -(-b // 32)
    width = 2 + nb + flag_cap + num_issuers
    packed = torch.zeros((k_chunks, width), dtype=torch.int32, device=dev)
    ovf_bits = torch.zeros((k_chunks, nb), dtype=torch.int32, device=dev)
    iota = torch.arange(b, dtype=torch.int64, device=dev)
    for k in range(k_chunks):
        ii = issuer_idx[k]
        fps = fingerprints(ii, not_after_hour[k], serials[k], serial_len[k])
        hour_off = not_after_hour[k].to(torch.int64) - base_hour
        table, wu, ovf = table_insert(
            table, fps, _meta_word(ii, hour_off), insertable[k],
            max_probes=max_probes)
        counts = _issuer_counts(ii, wu, num_issuers)
        ovf_idx = torch.sort(torch.where(ovf, iota, b)).values[:flag_cap]
        if flag_cap > b:  # tiny chunks: keep the packed width static
            ovf_idx = torch.cat([ovf_idx, ovf_idx.new_full((flag_cap - b,), b)])
        packed[k, 0] = wu.sum()
        packed[k, 1] = ovf.sum()
        packed[k, 2:2 + nb] = _pack_bits(wu, nb)
        packed[k, 2 + nb:2 + nb + flag_cap] = ovf_idx
        packed[k, 2 + nb + flag_cap:] = counts
        ovf_bits[k] = _pack_bits(ovf, nb)
    return table, PreparsedStepOut(packed=packed, overflow_bits=ovf_bits)


# -- the staged walker envelope -----------------------------------------

class StagedStepOut(NamedTuple):
    """Device outputs of the K-chunk walker envelope."""

    packed: torch.Tensor  # int32[K, 7, B] — per chunk the
    # :func:`pack_lane_words` layout
    issuer_unknown_counts: torch.Tensor  # int32[num_issuers], summed
    # over the K chunks
    serials: torch.Tensor  # uint8[K, B, MAX_SERIAL_BYTES]


def pack_lane_words(out: StepOut) -> torch.Tensor:
    """One walker step's per-lane outputs as ONE int32[7, B] tensor, so
    the host pays one device-to-host copy for them: row 0 the flag word
    (host_lane | was_unknown<<1 | filtered_ca<<2 | filtered_expired<<3 |
    filtered_cn<<4 | probe_overflow<<5, and for a sharded step's
    ``ShardedStepOut`` dispatch_dropped<<6), rows 1-6 not_after_hour,
    serial_len, crldp_off, crldp_len, issuer_name_off, issuer_name_len
    (the JAX package's readback layout)."""
    flags = torch.zeros_like(out.not_after_hour)
    bits = [out.host_lane, out.was_unknown, out.filtered_ca,
            out.filtered_expired, out.filtered_cn, out.probe_overflow]
    if hasattr(out, "dispatch_dropped"):
        bits.append(out.dispatch_dropped)
    for bit, f in enumerate(bits):
        flags |= f.to(torch.int32) << bit
    return torch.stack([flags, out.not_after_hour, out.serial_len,
                        out.crldp_off, out.crldp_len, out.issuer_name_off,
                        out.issuer_name_len], dim=0)


def staged_core(table, data: torch.Tensor, length: torch.Tensor,
                issuer_idx: torch.Tensor, valid: torch.Tensor,
                now_hour: int, base_hour: int, cn_prefixes: torch.Tensor,
                cn_prefix_lens: torch.Tensor,
                num_issuers: int = packing.MAX_ISSUERS,
                max_probes: int = 32):
    """K walker chunks (``data`` uint8[K, B, L], the rest [K, B]) as K
    calls of :func:`ingest_core` in submission order, the table carried
    from one to the next, so an envelope equals K unstaged steps.
    Returns ``(table, StagedStepOut)``."""
    k_chunks, b = length.shape
    dev = length.device
    packed = torch.zeros((k_chunks, 7, b), dtype=torch.int32, device=dev)
    serials = torch.zeros((k_chunks, b, packing.MAX_SERIAL_BYTES),
                          dtype=torch.uint8, device=dev)
    counts = torch.zeros((num_issuers,), dtype=torch.int32, device=dev)
    for k in range(k_chunks):
        table, out = ingest_core(
            table, data[k], length[k], issuer_idx[k], valid[k], now_hour,
            base_hour, cn_prefixes, cn_prefix_lens, num_issuers=num_issuers,
            max_probes=max_probes)
        packed[k] = pack_lane_words(out)
        serials[k] = out.serials
        counts += out.issuer_unknown_counts
    return table, StagedStepOut(packed=packed, issuer_unknown_counts=counts,
                                serials=serials)
