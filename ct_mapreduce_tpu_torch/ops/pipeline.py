"""The pre-parsed device step (port of the pre-parsed half of
``ct_mapreduce_tpu.ops.pipeline``).

When the native decoder has already extracted the identity fields on
the host (native/ctmr_native.cpp ``ctmr_extract_sidecars``), the
device step is fingerprint SHA-256 + dedup-table insert + per-issuer
counts on compact per-lane inputs (~59 B a lane). The readback is ONE
packed int32 array per step: a was-unknown bitmask (1 bit a lane),
sorted overflow lane ids (O(flagged), not O(batch)) and the count
vectors, laid out exactly as the JAX package's ``PreparsedStepOut``.

Every filter and routing predicate that does not depend on table state
is evaluated by the HOST (``agg/aggregator.py``
``ingest_preparsed_submit``); only ``insertable`` reaches the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ct_mapreduce_tpu_torch.core import packing
from ct_mapreduce_tpu_torch.ops import buckettable, sha256

N_PREPARSED_FLAG_CAP = 1024  # default compacted-overflow capacity

#: Dedup fingerprints of the lanes' fields: the hand-written kernel on
#: CUDA tensors, the plain version on CPU tensors.
fingerprints = sha256.sha256_fingerprint64


#: Insert-if-absent on the dedup table (the bucket layout is the only
#: one the port has).
table_insert = buckettable.insert


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
        meta = ((ii.to(torch.int64) * (1 << packing.META_HOUR_BITS)
                 | torch.clamp(hour_off, 0, packing.META_HOUR_SPAN - 1))
                & 0xFFFFFFFF)
        table, wu, ovf = table_insert(
            table, fps, sha256.to_int32_bits(meta), insertable[k],
            max_probes=max_probes)
        # The scatter-add of JAX's ``.at[idx].add(mode="drop")``: a
        # negative index counts from the end (NumPy style), and what is
        # still out of range after that is dropped.
        idx = ii.to(torch.int64)
        idx = torch.where(idx < 0, idx + num_issuers, idx)
        in_range = (idx >= 0) & (idx < num_issuers)
        counts = torch.zeros((num_issuers,), dtype=torch.int64, device=dev)
        counts.index_add_(0, torch.where(in_range, idx, 0),
                          (wu & in_range).to(torch.int64))
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
