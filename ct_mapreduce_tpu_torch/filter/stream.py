"""Streamed canonical-key production for filter builds (port of
``ct_mapreduce_tpu.filter.stream``).

Serial corpora flow as *group sources* yielding fixed-size packed
chunks, and canonical keys are computed one chunk at a time through the
fingerprint kernel K1 on ``device`` (CUDA unless named; on the CPU its
plain PyTorch version) or the ``fingerprints_np`` host mirror — only the
``[N, 4]`` key arena (16 bytes/serial) is resident for the whole
corpus.

Two source flavors:

- :class:`ListGroupSource` wraps the ``{(issuer, expHour): serial
  iterable}`` shape with the ``sorted(set(serials))`` semantics (the
  unique count is the group's ``n`` in the artifact header).
- :class:`PackedGroupSource` feeds pre-packed numpy chunks (length
  vector + zero-padded message matrix), so a synthetic or spill-drained
  corpus never mints per-serial Python objects. The provider contract
  is that serials within a group are unique.

Keys are a pure function of (ordinal, expHour, serial): chunk
boundaries, device-vs-host lanes and source flavor change no bytes.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ct_mapreduce_tpu_torch.core import packing
from ct_mapreduce_tpu_torch.telemetry import trace

# Serials per streamed key block. Bounds the transient message matrix
# (chunk × MAX_SERIAL_BYTES bytes); the resolve_filter knob
# filterStreamChunk / CTMR_FILTER_STREAM_CHUNK overrides.
DEFAULT_STREAM_CHUNK = 1 << 16


def oversized_key(ordinal: int, exp_hour: int, serial: bytes) -> np.ndarray:
    """The host-lane key for a serial past MAX_SERIAL_BYTES: a disjoint
    hashlib encoding no conforming fingerprint message can collide with
    (marker byte 0xFF > MAX_SERIAL_BYTES in the length position)."""
    msg = (
        int(exp_hour).to_bytes(4, "big", signed=True)
        + int(ordinal).to_bytes(4, "big")
        + b"\xff"
        + len(serial).to_bytes(4, "big")
        + serial
    )
    digest = hashlib.sha256(msg).digest()
    return np.array(
        [int.from_bytes(digest[16 + 4 * i: 20 + 4 * i], "big")
         for i in range(4)], np.uint32)


def pack_serials(serials: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized ``list[bytes]`` → (lens int64[c], mat uint8[c, MAX])
    for conforming serials (every len ≤ MAX_SERIAL_BYTES)."""
    c = len(serials)
    mat = np.zeros((c, packing.MAX_SERIAL_BYTES), np.uint8)
    if c == 0:
        return np.zeros((0,), np.int64), mat
    lens = np.fromiter((len(s) for s in serials), np.int64, c)
    joined = b"".join(serials)
    if joined:
        buf = np.frombuffer(joined, np.uint8)
        row = np.repeat(np.arange(c), lens)
        offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
        col = np.arange(buf.size) - np.repeat(offs, lens)
        mat[row, col] = buf
    return lens, mat


class GroupSource:
    """One (issuerID, expHour) group's serials as packed chunks.

    ``chunks(chunk_size)`` yields ``(lens, mat, oversized)`` blocks:
    conforming serials as a packed matrix, oversized ones as raw bytes
    (the host-lane path). ``n`` is the group's unique serial count — it
    lands verbatim in the artifact header.

    ``content_token`` (optional, default None) is an opaque value that
    changes whenever the group's serial set changes — the dirty-group
    key of the CTMRFL02 incremental build path (filter/cache.py). None
    means "unknown": the group always rebuilds."""

    issuer: str
    exp_hour: int
    n: int
    content_token = None

    def chunks(self, chunk_size: int) -> Iterator[
            tuple[np.ndarray, np.ndarray, list[bytes]]]:
        raise NotImplementedError


class ListGroupSource(GroupSource):
    """Serial-iterable shape; dedups at construction (sorting keeps the
    walk order deterministic; the bytes are set-determined)."""

    def __init__(self, issuer: str, exp_hour: int,
                 serials: Iterable[bytes], content_token=None):
        self.issuer = issuer
        self.exp_hour = int(exp_hour)
        self._serials = sorted(set(serials))
        self.n = len(self._serials)
        self.content_token = content_token

    def chunks(self, chunk_size: int):
        for start in range(0, self.n, chunk_size):
            block = self._serials[start: start + chunk_size]
            fit = [s for s in block
                   if len(s) <= packing.MAX_SERIAL_BYTES]
            oversized = [s for s in block
                         if len(s) > packing.MAX_SERIAL_BYTES]
            lens, mat = pack_serials(fit)
            yield lens, mat, oversized


class PackedGroupSource(GroupSource):
    """Pre-packed chunk provider: ``provider(chunk_size)`` must yield
    ``(lens, mat, oversized)`` blocks covering exactly ``n`` unique
    serials."""

    def __init__(self, issuer: str, exp_hour: int, n: int, provider,
                 content_token=None):
        self.issuer = issuer
        self.exp_hour = int(exp_hour)
        self.n = int(n)
        self._provider = provider
        self.content_token = content_token

    def chunks(self, chunk_size: int):
        return self._provider(chunk_size)


def _rss_bytes() -> int:
    """Current RSS via /proc (linux; 0 elsewhere). Sampled at chunk
    and round boundaries by the builders — a sampled peak."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * 4096
    except (OSError, ValueError, IndexError):
        return 0


def key_blocks(source: GroupSource, ordinal: int, chunk_size: int,
               use_device: Optional[bool] = None,
               device=None) -> Iterator[np.ndarray]:
    """Stream one group's canonical keys as ``uint32[c, 4]`` blocks.

    Conforming serials hash through the fingerprint kernel K1 on
    ``device`` when the block is large, the ``fingerprints_np`` host
    mirror otherwise; oversized serials take the disjoint hashlib lane.
    Block boundaries change no bytes."""
    from ct_mapreduce_tpu_torch.filter.cascade import (
        DEVICE_BUILD_MIN,
        device_enabled,
    )

    for lens, mat, oversized in source.chunks(chunk_size):
        c = int(lens.shape[0])
        out = np.zeros((c + len(oversized), 4), np.uint32)
        with trace.span("filter.stream_chunk", cat="filter",
                        lanes=c + len(oversized),
                        oversized=len(oversized)):
            if c:
                dev = use_device
                if dev is None:
                    dev = device_enabled() and c >= DEVICE_BUILD_MIN
                ords = np.full((c,), int(ordinal), np.int64)
                ehs = np.full((c,), source.exp_hour, np.int64)
                if dev:
                    out[:c] = _fingerprints_device(ords, ehs, mat, lens,
                                                   device)
                else:
                    out[:c] = packing.fingerprints_np(ords, ehs, mat,
                                                      lens)
            for j, sb in enumerate(oversized):
                out[c + j] = oversized_key(ordinal, source.exp_hour, sb)
        yield out


def _fingerprints_device(ords: np.ndarray, ehs: np.ndarray,
                         mat: np.ndarray, lens: np.ndarray,
                         device=None) -> np.ndarray:
    """Fingerprints of one block on ``device`` (CUDA unless named):
    ``ops.sha256.sha256_fingerprint64``, which launches K1 on CUDA
    tensors and runs its plain version on CPU ones. Returns the
    ``uint32[c, 4]`` words, bit for bit the JAX package's."""
    from ct_mapreduce_tpu_torch.device import resolve_device
    from ct_mapreduce_tpu_torch.ops.sha256 import sha256_fingerprint64

    dev = resolve_device(device)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    fps = sha256_fingerprint64(
        t(ords, np.int32), t(ehs, np.int32), t(mat, np.uint8),
        t(lens, np.int32))
    return fps.cpu().numpy().view(np.uint32)


def collect_keys(source: GroupSource, ordinal: int, chunk_size: int,
                 use_device: Optional[bool] = None,
                 device=None) -> np.ndarray:
    """All of one group's keys as ``uint32[n, 4]`` — streamed through
    :func:`key_blocks` so only the key arena is corpus-sized."""
    out = np.zeros((source.n, 4), np.uint32)
    pos = 0
    for block in key_blocks(source, ordinal, chunk_size, use_device,
                            device):
        out[pos: pos + block.shape[0]] = block
        pos += block.shape[0]
    if pos != source.n:
        raise ValueError(
            f"group source ({source.issuer!r}, {source.exp_hour}) "
            f"yielded {pos} serials, declared n={source.n}")
    return out
