"""Batched SHA-256 for the dedup fingerprints (port of
``ct_mapreduce_tpu.ops.sha256``).

Every lane is an independent message. The plain PyTorch version here
carries each 32-bit word in ``int64`` masked with ``0xFFFFFFFF``:
``uint32`` tensors lack ``+``, ``>>``, ``<<`` and ``~`` on the CPU, and
``int32 >>`` is arithmetic. Fingerprints leave as ``int32`` tensors
holding the uint32 bit patterns (``.numpy().view(np.uint32)`` recovers
the JAX package's values).

:func:`sha256_fingerprint64` is the dispatch the ingest step uses: a
CUDA tensor goes to the hand-written kernel
(:mod:`~ct_mapreduce_tpu_torch.ops.sha256_cuda`, which fuses the
message build in front of the compression), a CPU tensor to the plain
version. The JAX counterpart takes the pre-padded ``[B, 16]`` block;
here the block is built inside the kernel, so the dispatch takes the
lane fields instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ct_mapreduce_tpu_torch.core.packing import MAX_SERIAL_BYTES

M32 = 0xFFFFFFFF

# FIPS 180-4 round constants.
_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
    0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
    0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
    0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

_H0 = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

#: 32-bit integer instructions per lane of one fingerprint at the
#: least, on a card with 3-input logic (LOP3), 3-input add (IADD3) and
#: funnel-shift rotation. Shifts and logic must run on the integer ALU
#: pipe: a round has 6 rotations and 4 LOP3 (the two big-sigma XORs,
#: Ch, Maj), a schedule step 6 shifts and 2 LOP3.
INT_PIPE_OPS_PER_LANE = 64 * (6 + 4) + 48 * (6 + 2)
#: Adds, which the compiler may also issue as IMAD on the FMA pipe:
#: 4 a round, 2 a schedule step, 4 final adds for the kept words.
ADD_OPS_PER_LANE = 64 * 4 + 48 * 2 + 4
#: All of them (1380); FIPS 180-4's 2-input operations would be 2292.
#: The kernel's bound is the larger of the ALU-pipe ops over the card's
#: int32 rate and all ops over its instruction issue rate.
OPS_PER_LANE = INT_PIPE_OPS_PER_LANE + ADD_OPS_PER_LANE


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & M32


def sha256_single_block(block: torch.Tensor) -> torch.Tensor:
    """Digest one pre-padded 64-byte block per lane (plain PyTorch).

    block: integer ``[B, 16]`` big-endian message words (int32 bit
    patterns or int64 values; only the low 32 bits are read). Returns
    ``int64[B, 8]`` words in ``[0, 2**32)``.
    """
    blk = block.to(torch.int64) & M32
    w = [blk[:, i] for i in range(16)]
    b = blk.shape[0]
    a, bb, c, d, e, f, g, h = (
        torch.full((b,), v, dtype=torch.int64, device=blk.device)
        for v in _H0)
    for t in range(64):
        wt = w[t % 16]
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g & M32)
        t1 = (h + s1 + ch + _K[t] + wt) & M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & bb) ^ (a & c) ^ (bb & c)
        t2 = s0 + maj
        h, g, f, e, d, c, bb, a = (
            g, f, e, (d + t1) & M32, c, bb, a, (t1 + t2) & M32)
        if t < 48:
            # Rolling schedule: W[t+16] replaces W[t].
            w1, w9, w14 = w[(t + 1) % 16], w[(t + 9) % 16], w[(t + 14) % 16]
            sg0 = _rotr(w1, 7) ^ _rotr(w1, 18) ^ (w1 >> 3)
            sg1 = _rotr(w14, 17) ^ _rotr(w14, 19) ^ (w14 >> 10)
            w[t % 16] = (wt + sg0 + w9 + sg1) & M32
    state = torch.stack([a, bb, c, d, e, f, g, h], dim=1)
    h0 = torch.tensor(_H0, dtype=torch.int64, device=blk.device)
    return (state + h0) & M32


def message_blocks(issuer_idx: torch.Tensor, exp_hour: torch.Tensor,
                   serials: torch.Tensor,
                   serial_len: torch.Tensor) -> torch.Tensor:
    """Fingerprint message, FIPS-padded into one block per lane:
    ``int64[B, 16]`` words. Layout of
    ``ct_mapreduce_tpu.ops.pipeline.fingerprints`` (and of the host
    ``packing.fingerprint_message``): exp hour (4 B big-endian), issuer
    index (4 B), serial length (1 B), serial (46 B), 0x80 right after
    the message, bit length in the last two bytes."""
    b = issuer_idx.shape[0]
    dev = issuer_idx.device
    eh = exp_hour.to(torch.int64) & M32
    ii = issuer_idx.to(torch.int64) & M32
    slen = serial_len.to(torch.int64)
    msg = torch.zeros((b, 64), dtype=torch.int64, device=dev)
    for j, sh in enumerate((24, 16, 8, 0)):
        msg[:, j] = (eh >> sh) & 0xFF
        msg[:, 4 + j] = (ii >> sh) & 0xFF
    msg[:, 8] = slen & 0xFF
    msg[:, 9:9 + MAX_SERIAL_BYTES] = serials.to(torch.int64)
    msg_len = 9 + slen
    pos = torch.arange(64, dtype=torch.int64, device=dev)[None, :]
    msg = torch.where(pos == msg_len[:, None], 0x80, msg)
    bits = (msg_len * 8) & M32
    msg[:, 62] = (bits >> 8) & 0xFF
    msg[:, 63] = bits & 0xFF
    q = msg.view(b, 16, 4)
    return (q[:, :, 0] << 24) | (q[:, :, 1] << 16) | (q[:, :, 2] << 8) | q[:, :, 3]


def to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """``int64`` values in ``[0, 2**32)`` → ``int32`` bit patterns."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def fingerprints_plain(issuer_idx: torch.Tensor, exp_hour: torch.Tensor,
                       serials: torch.Tensor,
                       serial_len: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fingerprint kernel: words 4..7 of
    the digest as ``int32[B, 4]`` bit patterns."""
    digest = sha256_single_block(
        message_blocks(issuer_idx, exp_hour, serials, serial_len))
    return to_int32_bits(digest[:, 4:]).contiguous()


def sha256_fingerprint64(issuer_idx: torch.Tensor, exp_hour: torch.Tensor,
                         serials: torch.Tensor,
                         serial_len: torch.Tensor) -> torch.Tensor:
    """Dedup fingerprints ``int32[B, 4]`` (uint32 bits of digest words
    4..7). Inputs: ``issuer_idx``/``exp_hour``/``serial_len`` int32[B],
    ``serials`` uint8[B, 46] with zeros past each serial's length.

    CUDA tensors launch the hand-written kernel; CPU tensors run the
    plain version. There is no fallback between the two."""
    if serials.device.type == "cuda":
        from ct_mapreduce_tpu_torch.ops import sha256_cuda

        return sha256_cuda.fingerprint64(
            issuer_idx, exp_hour, serials, serial_len)
    if serials.device.type == "cpu":
        return fingerprints_plain(issuer_idx, exp_hour, serials, serial_len)
    raise ValueError(f"no fingerprint path for device {serials.device}")


def pad_message_np(msg: bytes, total_blocks: int | None = None) -> np.ndarray:
    """Host-side FIPS padding: bytes → uint32[N, 16] big-endian words."""
    bitlen = len(msg) * 8
    data = bytearray(msg)
    data.append(0x80)
    while len(data) % 64 != 56:
        data.append(0)
    data += bitlen.to_bytes(8, "big")
    arr = np.frombuffer(bytes(data), dtype=">u4").astype(np.uint32)
    arr = arr.reshape(-1, 16)
    if total_blocks is not None:
        if arr.shape[0] > total_blocks:
            raise ValueError(f"message needs {arr.shape[0]} blocks > {total_blocks}")
        pad = np.zeros((total_blocks - arr.shape[0], 16), dtype=np.uint32)
        arr = np.concatenate([arr, pad], axis=0)
    return arr


def digest_np(state: np.ndarray) -> bytes:
    """uint32[8] state → 32-byte big-endian digest."""
    return np.asarray(state, dtype=">u4").tobytes()
