"""The ingest sink: raw get-entries pages into the aggregator (a port of
the sink half of ``ct_mapreduce_tpu.ingest.sync``).

:class:`AggregatorSink` is what ct-fetch feeds: whole get-entries
responses (:class:`RawBatch`) or single decoded entries accumulate to
``flush_size``, are decoded natively into packed rows
(:func:`~ct_mapreduce_tpu_torch.native.leafpack.decode_raw_batch`), and
go to the aggregator through one of three submit paths:

- the walker lane, one chunk a dispatch (``chunksPerDispatch`` 1): the
  rows ship to the device, the step is queued, and up to
  ``deviceQueueDepth`` chunks stay in flight before the oldest is read
  back and folded;
- the staged walker lane (``chunksPerDispatch`` K > 1): K decoded
  chunks stack into one staging buffer, ship in ONE copy and run as ONE
  K-chunk envelope; ``stagingDepth`` envelopes stay in flight;
- the pre-parsed lane: the native decoder extracts the fields on the
  host, no rows ship, and lanes it cannot decide replay through the
  walker lane.

Where this port departs from the JAX module: the rows reach the device
from pinned host memory with one ``.to(device, non_blocking=True)``
instead of ``jax.device_put``.

- Unstaged chunks are decoded straight into buffers of one pool (no
  bounce copy), and a chunk decoded wide whose certificates all fit
  half the width is narrowed in place, so every shipped chunk is one
  contiguous pinned block.
- A staged envelope's buffer (the JAX ring's ``stagingDepth + 2``
  cycled buffers) comes from the same pool.
- Either buffer goes back to the pool when the chunk or envelope that
  shipped from it has been folded. That is safe because the copy, the
  step and the readback are queued on the same CUDA stream, so a
  fold's readback completes only after the copy from that buffer has.
- On a CPU aggregator nothing is pinned (pinned memory needs CUDA) and
  the "copy" is the tensor view itself.
- :func:`build_sink` is ct-fetch's ``build_sink`` without the options
  this slice does not port.

The options this slice does not port raise a ``ValueError`` naming
their ROADMAP item: ``overlap_workers`` (ingest/overlap.py, item 7),
``verify_signatures`` (item 11) and a PEM ``backend`` (the storage
modules of the CLI slice, item 7).
"""

from __future__ import annotations

import base64
import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Protocol

import numpy as np
import torch

from ct_mapreduce_tpu_torch.config import profile as platprofile
from ct_mapreduce_tpu_torch.ingest.leaf import (
    DecodedEntry,
    LeafDecodeError,
    decode_entry,
)
from ct_mapreduce_tpu_torch.native import leafpack
from ct_mapreduce_tpu_torch.telemetry import metrics, trace

_STAGING_KNOBS = (
    platprofile.Knob("chunksPerDispatch", "CTMR_CHUNKS_PER_DISPATCH", 1,
                     parse=int, is_set=platprofile.pos_int,
                     post=lambda v: max(1, int(v))),
    platprofile.Knob("stagingDepth", "CTMR_STAGING_DEPTH", 2,
                     parse=int, is_set=platprofile.pos_int,
                     post=lambda v: max(1, int(v))),
)


def resolve_staging(chunks_per_dispatch: int = 0,
                    staging_depth: int = 0) -> tuple[int, int]:
    """The staged-queue knobs through the platformProfile ladder:
    explicit value > ``CTMR_CHUNKS_PER_DISPATCH`` /
    ``CTMR_STAGING_DEPTH`` env > profile ``knobs.staging`` > defaults
    (K = 1, per-chunk dispatch; depth 2)."""
    r = platprofile.resolve_section("staging", _STAGING_KNOBS, {
        "chunksPerDispatch": int(chunks_per_dispatch or 0),
        "stagingDepth": int(staging_depth or 0),
    })
    return r["chunksPerDispatch"], r["stagingDepth"]


class EntrySink(Protocol):
    def store(self, entry: DecodedEntry, log_url: str) -> None: ...
    def flush(self) -> None: ...


class _PinnedPool:
    """Free list of host row buffers, pinned on a CUDA aggregator. A
    buffer is taken for one unstaged chunk or one staged envelope and
    given back when that chunk or envelope has been folded.

    Every buffer holds ``capacity`` bytes whatever shape it serves (the
    rows are a contiguous view of its head, :func:`_rows_of`), so
    chunks of any length and width share the same buffers. A request
    above the capacity raises it to the next power of two and retires
    the smaller buffers as they come back, so the pool holds no more
    buffers than were in use at once (``live``), and makes new ones
    (``allocated``) only when a request outgrows every earlier one."""

    def __init__(self, pin: bool) -> None:
        self._pin = pin
        self._free: list[torch.Tensor] = []
        self._lock = threading.Lock()
        self.capacity = 0
        self.allocated = 0
        self.live = 0

    def take(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            if nbytes > self.capacity:
                self.capacity = 1 << (nbytes - 1).bit_length()
                self.live -= len(self._free)
                self._free.clear()
            if self._free:
                return self._free.pop()
            self.allocated += 1
            self.live += 1
            capacity = self.capacity
        return torch.empty((capacity,), dtype=torch.uint8,
                           pin_memory=self._pin)

    def give(self, buf: torch.Tensor) -> None:
        with self._lock:
            if buf.numel() < self.capacity:
                self.live -= 1
            else:
                self._free.append(buf)


def _rows_of(buf: torch.Tensor, shape: tuple[int, ...]) -> np.ndarray:
    """The C-contiguous uint8 array of ``shape`` at the head of the
    pool buffer ``buf``."""
    return buf[: math.prod(shape)].view(shape).numpy()


def _narrow_in_place(data: np.ndarray, narrow: int) -> np.ndarray:
    """Keep the first ``narrow`` bytes of each row of the C-contiguous
    ``data`` (wide rows, ``narrow`` at most half their width) in its own
    memory: returns the contiguous ``[n, narrow]`` view of its head.
    Row a moves from a*wide to a*narrow. The rows [a, b) move as one
    block without overlapping their sources while b*narrow <= a*wide,
    and no block writes over a row not yet moved, so blocks that grow
    by wide/narrow do it in O(log n) copies."""
    n, wide = data.shape
    dst = data.reshape(-1)[: n * narrow].reshape(n, narrow)
    a = 1
    while a < n:
        b = min(n, a * wide // narrow)
        dst[a:b] = data[a:b, :narrow]
        a = b
    return dst


class AggregatorSink:
    """Batches entries for the device pipeline.

    A lock serializes dispatch: one device stream exists however many
    store workers feed the sink, and the table is replaced step by
    step."""

    PAD_LEN = 2048  # device row width (certs above it take the host lane)

    def __init__(self, aggregator, flush_size: int = 4096, backend=None,
                 device_queue_depth: int = 2, decode_workers: int = 0,
                 overlap_workers: int = 0, preparsed: Optional[bool] = None,
                 decode_threads: int = 0, chunks_per_dispatch: int = 0,
                 staging_depth: int = 0,
                 verify_signatures: Optional[bool] = None):
        if backend is not None:
            raise ValueError(
                "a PEM backend (certPath) is not ported yet: it comes with "
                "the storage modules of the CLI slice (ROADMAP.md queue 1 "
                "item 7)")
        if int(overlap_workers) > 0:
            raise ValueError(
                "overlapWorkers > 0 (ingest/overlap.py) is not ported yet "
                "(ROADMAP.md queue 1 item 7)")
        if verify_signatures is None:
            verify_signatures = os.environ.get("CTMR_VERIFY", "0") == "1"
        if verify_signatures:
            raise ValueError(
                "verifySignatures: the verify lane is not ported yet "
                "(ROADMAP.md queue 1 item 11)")
        self.aggregator = aggregator
        self.flush_size = flush_size
        self._pending: list[tuple[bytes, bytes]] = []
        self._pending_raw: list[tuple[str, str]] = []
        self._lock = threading.Lock()
        self._dispatch_lock = threading.Lock()  # one device stream
        # Host↔device pipelining: steps are queued without readback and
        # folded once more than `device_queue_depth` are in flight, so
        # the decode of chunk N+1 overlaps the device step of chunk N.
        # Depth 0 = fully synchronous.
        self.device_queue_depth = max(0, int(device_queue_depth))
        self.decode_workers = int(decode_workers) or None
        self.decode_threads = int(decode_threads) or None
        # (pending, buffer to give back after its fold, or None)
        self._inflight: deque = deque()
        # Without a PEM backend the per-entry serial bytes are needed
        # only for the cross-encoding guard; drain() keeps counts exact
        # without them.
        aggregator.want_serials = False
        if preparsed is None:
            preparsed = os.environ.get("CTMR_PREPARSED", "0") == "1"
        self.preparsed = bool(preparsed)
        self.chunks_per_dispatch, self.staging_depth = resolve_staging(
            chunks_per_dispatch, staging_depth)
        self._staging: list[_PreparedChunk] = []  # the ring (FIFO)
        self._row_bufs = _PinnedPool(aggregator.device.type == "cuda")

    def store(self, entry: DecodedEntry, log_url: str) -> None:
        if entry.issuer_der is None:
            metrics.incr_counter("ct-fetch", "noChainError")
            return
        batch: Optional[list[tuple[bytes, bytes]]] = None
        with self._lock:
            self._pending.append((entry.cert_der, entry.issuer_der))
            if len(self._pending) >= self.flush_size:
                batch, self._pending = self._pending, []
        if batch:
            self._dispatch(batch)

    def store_raw_batch(self, raw: "RawBatch") -> None:
        """Accumulate an undecoded get-entries response; decoded and
        dispatched natively in flush-size chunks."""
        pairs = list(zip(raw.leaf_inputs, raw.extra_datas))
        chunk: Optional[list[tuple[str, str]]] = None
        with self._lock:
            self._pending_raw.extend(pairs)
            if len(self._pending_raw) >= self.flush_size:
                chunk, self._pending_raw = self._pending_raw, []
        if chunk:
            self._dispatch_raw(chunk)

    def _dispatch_raw(self, pairs: list[tuple[str, str]]) -> None:
        with trace.span("ingest.decode", cat="ingest", entries=len(pairs)):
            prep = self._prepare_chunk(pairs)
        t_lock = time.monotonic()
        with trace.span("ingest.submit_locked", cat="ingest"), \
                self._dispatch_lock:
            metrics.add_sample("ct-fetch", "dispatchLockWait",
                               value=time.monotonic() - t_lock)
            with metrics.measure("ct-fetch", "storeCertificate"), \
                    trace.span("ingest.submit", cat="ingest"):
                self._inflight.extend(self._submit_chunk(prep))
                self._drain_inflight(self.staging_depth
                                     if self.chunks_per_dispatch > 1
                                     else self.device_queue_depth)

    def _take_rows(self, nbytes: int, chunks: int) -> torch.Tensor:
        """A pool buffer for ``nbytes`` of rows of ``chunks`` chunks. A
        chunk is cut after the page that reaches ``flush_size``, so with
        pages no longer than that it holds fewer than 2 x ``flush_size``
        entries: buffers of that many full-width rows a chunk serve
        every chunk, partial ones too, and grow only for longer pages."""
        return self._row_bufs.take(
            max(nbytes, chunks * 2 * self.flush_size * self.PAD_LEN))

    def _ship(self, rows: np.ndarray) -> torch.Tensor:
        """Queue the copy of the host ``rows`` (a pool buffer's head) to
        the aggregator's device on the current stream."""
        src = torch.from_numpy(rows)
        nbytes = float(rows.nbytes)
        metrics.incr_counter("ingest", "h2d_bytes", value=nbytes)
        if src.is_pinned() and src.is_contiguous():
            metrics.incr_counter("ingest", "h2d_pinned_bytes", value=nbytes)
        with metrics.measure("ct-fetch", "h2dSubmit"):
            return src.to(self.aggregator.device, non_blocking=True)

    def _prepare_chunk(self, pairs: list[tuple[str, str]]) -> "_PreparedChunk":
        """Stage 1 — decode + pack + queue the copy to the device; no
        aggregator state changes beyond the (thread-safe) issuer
        registry."""
        lis = [p[0] for p in pairs]
        eds = [p[1] for p in pairs]
        # Row-width bucketing before the decode: base64 length bounds
        # the decoded leaf_input, so a batch whose every leaf_input fits
        # half the width decodes straight into narrow rows. Precert
        # entries pack their cert from extra_data, so a TOO_LONG status
        # triggers one full-width redecode.
        narrow = self.PAD_LEN // 2
        pad = self.PAD_LEN
        if narrow >= 512:
            max_li_raw = max((len(s) for s in lis), default=0) * 3 // 4
            if max_li_raw + 64 <= narrow:
                pad = narrow
        # Unstaged walker chunks decode straight into a pool buffer,
        # sized for full-width rows so that a redecode reuses it;
        # staged chunks are copied into the envelope's buffer, and the
        # pre-parsed lane ships no rows.
        pooled = not self.preparsed and self.chunks_per_dispatch <= 1
        n = len(pairs)
        buf = self._take_rows(n * self.PAD_LEN, 1) if pooled else None

        def decode(width: int):
            return leafpack.decode_raw_batch(
                lis, eds, width, workers=self.decode_workers,
                threads=self.decode_threads,
                data=None if buf is None else _rows_of(buf, (n, width)))

        t_dec = time.monotonic()
        with metrics.measure("ct-fetch", "decodeBatch"):
            dec = decode(pad)
            if (pad < self.PAD_LEN
                    and bool((dec.status == leafpack.TOO_LONG).any())):
                pad = self.PAD_LEN
                dec = decode(pad)
        if n:
            metrics.set_gauge(
                "ingest", "decode_threads",
                value=float(leafpack.resolve_threads(
                    n, self.decode_threads or self.decode_workers)))
            metrics.add_sample("ingest", "decode_ns_per_entry",
                               value=(time.monotonic() - t_dec) / n * 1e9)
        # A batch decoded wide whose every cert fits half the width
        # ships narrow rows: half the bytes.
        data = dec.data
        if (narrow >= 512 and data.shape[1] > narrow
                and dec.length.max(initial=0) <= narrow):
            data = _narrow_in_place(data, narrow)

        issuer_idx = np.zeros((n,), np.int32)
        oversized: list[tuple[bytes, bytes]] = []
        if dec.issuer_group is None:
            raise ValueError(
                "DecodedBatch producer did not compute issuer groups "
                "(issuer_group/group_issuers are required)")
        # Per-GROUP registry work (a handful of distinct issuers a
        # batch), NumPy for the per-entry mapping.
        gmap = np.full((len(dec.group_issuers) + 1,), -1, np.int32)
        for g, der in enumerate(dec.group_issuers):
            try:
                gmap[g] = self.aggregator.registry.get_or_assign(der)
            except Exception:
                # A malformed issuer DER costs its entries, not the
                # whole chunk (per-entry path parity).
                gmap[g] = -1
        ok = dec.status == leafpack.OK
        mapped = gmap[dec.issuer_group]  # group -1 → the -1 sentinel
        valid = ok & (mapped >= 0)
        issuer_idx[valid] = mapped[valid]
        bad_issuer = int((ok & (mapped < 0)).sum())
        no_chain = int((dec.status == leafpack.NO_CHAIN).sum())
        # Both oversize flavours take the exact per-entry lane.
        too_long = np.nonzero(
            (dec.status == leafpack.TOO_LONG)
            | (dec.status == leafpack.ISSUER_TOO_LONG))[0]
        other_bad = int(
            ((dec.status != leafpack.OK)
             & (dec.status != leafpack.NO_CHAIN)
             & (dec.status != leafpack.TOO_LONG)
             & (dec.status != leafpack.ISSUER_TOO_LONG)).sum())
        if bad_issuer or other_bad:
            metrics.incr_counter("ct-fetch", "parseLeafError",
                                 value=float(bad_issuer + other_bad))
        if no_chain:
            metrics.incr_counter("ct-fetch", "noChainError",
                                 value=float(no_chain))
        for i in too_long:
            try:
                e = decode_entry(int(i), base64.b64decode(lis[i]),
                                 base64.b64decode(eds[i] or ""))
            except LeafDecodeError:
                metrics.incr_counter("ct-fetch", "parseLeafError")
                continue
            if e.issuer_der is None:
                metrics.incr_counter("ct-fetch", "noChainError")
            else:
                oversized.append((e.cert_der, e.issuer_der))

        # Pre-parsed lane: walker-exact sidecars on the host; lanes the
        # extractor cannot decide replay through the walker lane.
        sidecar = None
        walker_fallback: list[tuple[bytes, bytes]] = []
        if self.preparsed:
            sidecar = leafpack.extract_sidecars(
                data, dec.length,
                threads=self.decode_threads or self.decode_workers)
            if sidecar is None:
                raise RuntimeError(
                    "the native sidecar decoder could not be built (no C++ "
                    "compiler); the pre-parsed lane needs it")
            pre_ok = sidecar.ok.astype(bool)
            for i in np.nonzero(valid & ~pre_ok)[0]:
                walker_fallback.append((
                    data[i, : dec.length[i]].tobytes(),
                    dec.group_issuers[int(dec.issuer_group[i])]))
            valid = valid & pre_ok

        # The copy of the rows is queued BEFORE the dispatch lock, so it
        # overlaps the previous chunk's step on the stream.
        rows = data
        if buf is not None and valid.any():
            rows = self._ship(data)
        elif buf is not None:
            self._row_bufs.give(buf)
            buf = None
        return _PreparedChunk(
            data=rows, host_data=data, length=dec.length,
            issuer_idx=issuer_idx, valid=valid, dec=dec,
            oversized=oversized, sidecar=sidecar,
            walker_fallback=walker_fallback, row_buf=buf)

    # -- staged device queue ---------------------------------------------
    def _submit_staged(self, prep: "_PreparedChunk") -> list[tuple]:
        """Staged walker lane: the prepared chunk enters the staging
        ring; every K chunks the ring ships as one envelope. Caller
        holds ``_dispatch_lock``."""
        items: list[tuple] = []
        # Ring chunks share a row width: a mismatch flushes first.
        if self._staging and prep.valid.any() and (
                self._staging[0].host_data.shape[1]
                != prep.host_data.shape[1]):
            items += self._flush_staging_items()
        # Chunks carrying host-exact entries dispatch at once (ring
        # flush → stage → flush again), so the intra-chunk order of the
        # unstaged path (device lanes, fallback, oversized) — and with
        # it the dedup attribution — is kept.
        host_exact = bool(prep.oversized or prep.walker_fallback)
        if host_exact:
            items += self._flush_staging_items()
        if prep.valid.any():
            # The ring as it is after those flushes (each flush starts a
            # new list): the JAX sink appended to the list it read
            # before them, which dropped this chunk (ROADMAP.md queue 3).
            ring = self._staging
            ring.append(prep)
            depth = len(ring)
            metrics.set_gauge("ingest", "staging_ring", value=float(depth))
            if host_exact or depth >= self.chunks_per_dispatch:
                items += self._flush_staging_items()
        self._ingest_host_exact(prep)
        return items

    def _flush_staging_items(self) -> list[tuple]:
        """Dispatch the staging ring as one envelope (no-op on an empty
        ring). Caller holds ``_dispatch_lock``. A partial ring (final
        flush, host-exact chunk, width change) pads the K axis with
        all-invalid chunks."""
        ring, self._staging = self._staging, []
        if not ring:
            return []
        k_env = self.chunks_per_dispatch
        k_real = len(ring)
        b = max(p.host_data.shape[0] for p in ring)
        width = ring[0].host_data.shape[1]
        pool_buf = self._take_rows(k_env * b * width, k_env)
        buf = _rows_of(pool_buf, (k_env, b, width))
        length = np.zeros((k_env, b), np.int32)
        issuer_idx = np.zeros((k_env, b), np.int32)
        valid = np.zeros((k_env, b), bool)
        host_chunks: list[np.ndarray] = []
        for k, p in enumerate(ring):
            n_k = p.host_data.shape[0]
            # Stale rows past n_k (a reused buffer) are harmless: their
            # lanes stay invalid and the fold never reads them.
            buf[k, :n_k] = p.host_data
            length[k, :n_k] = p.length
            issuer_idx[k, :n_k] = p.issuer_idx
            valid[k, :n_k] = p.valid
            host_chunks.append(p.host_data)
        metrics.set_gauge("ingest", "staging_ring", value=0.0)
        metrics.add_sample("ingest", "dispatch_chunks", value=float(k_real))
        with trace.span("ingest.h2d", cat="ingest", chunks=k_real,
                        bytes=int(buf.nbytes)):
            data = self._ship(buf)
        pending = self.aggregator.ingest_staged_submit(
            data, length, issuer_idx, valid, host_chunks)
        return [(pending, pool_buf)]

    def _ingest_host_exact(self, prep: "_PreparedChunk") -> None:
        """The chunk's walker-fallback and oversized entries, through
        the aggregator's synchronous per-entry walker lane, then the
        chunk's insert count."""
        if prep.walker_fallback:
            self.aggregator.ingest(prep.walker_fallback)
        if prep.oversized:
            self.aggregator.ingest(prep.oversized)
        metrics.incr_counter(
            "ct-fetch", "insertCertificate",
            value=float(int(prep.valid.sum()) + len(prep.oversized)
                        + len(prep.walker_fallback)))

    def _submit_chunk(self, prep: "_PreparedChunk") -> list[tuple]:
        """Stage 2 — queue the device step(s) for a prepared chunk.
        Caller holds ``_dispatch_lock``. Returns the new in-flight items
        ``(pending, row buffer or None)``; with ``chunksPerDispatch`` > 1
        a chunk may add none (staged, awaiting ring mates) or one
        covering a whole envelope."""
        if self.chunks_per_dispatch > 1 and prep.sidecar is None:
            return self._submit_staged(prep)
        items: list[tuple] = []
        if prep.valid.any():
            if prep.sidecar is not None:
                pending = self.aggregator.ingest_preparsed_submit(
                    prep.sidecar, prep.issuer_idx, prep.valid,
                    prep.host_data, prep.length)
            else:
                pending = self.aggregator.ingest_packed_submit(
                    prep.data, prep.length, prep.issuer_idx, prep.valid,
                    host_data=prep.host_data)
            items.append((pending, prep.row_buf))
        self._ingest_host_exact(prep)
        return items

    def _drain_inflight(self, keep: int) -> None:
        """Stage 3 — fold submitted device work until at most ``keep``
        items remain in flight, giving each row buffer back after its
        fold. Caller holds ``_dispatch_lock``."""
        while len(self._inflight) > keep:
            pending, buf = self._inflight.popleft()
            with metrics.measure("ct-fetch", "completeBatch"), \
                    trace.span("device.readback", cat="device"):
                pending.complete()
            if buf is not None:
                self._row_bufs.give(buf)

    def flush(self) -> None:
        with self._lock:
            batch, self._pending = self._pending, []
            raw, self._pending_raw = self._pending_raw, []
        if batch:
            self._dispatch(batch)
        if raw:
            self._dispatch_raw(raw)
        t_lock = time.monotonic()
        with self._dispatch_lock:
            metrics.add_sample("ct-fetch", "dispatchLockWait",
                               value=time.monotonic() - t_lock)
            with metrics.measure("ct-fetch", "storeCertificate"):
                # A partial staging ring dispatches at the barrier.
                self._inflight.extend(self._flush_staging_items())
                self._drain_inflight(0)

    def close(self) -> None:
        """Flush everything; the sink stays usable."""
        self.flush()

    def checkpointed_save(self, save_fn) -> None:
        """Flush pending entries, then run ``save_fn`` while holding the
        dispatch lock, so a snapshot never sees a table mid-step:
        aggregate state is durable BEFORE the log cursor advances past
        the entries it holds."""
        self.flush()
        with self._dispatch_lock:
            save_fn()

    def _dispatch(self, batch: list[tuple[bytes, bytes]]) -> None:
        with self._dispatch_lock, \
                metrics.measure("ct-fetch", "storeCertificate"):
            self.aggregator.ingest(batch)
        metrics.incr_counter("ct-fetch", "insertCertificate",
                             value=float(len(batch)))


@dataclass
class _PreparedChunk:
    """One raw chunk decoded, packed and issuer-mapped, its copy to the
    device queued when it ships unstaged: everything the submit stage
    needs, made without changing aggregator state."""

    data: object  # uint8[n, pad] rows: a device tensor (copy queued) or np
    host_data: np.ndarray  # host rows for host-lane slices and metadata
    length: np.ndarray  # int32[n]
    issuer_idx: np.ndarray  # int32[n] registry indices
    valid: np.ndarray  # bool[n]
    dec: object  # the DecodedBatch
    oversized: list  # [(cert_der, issuer_der)] exact-lane entries
    sidecar: object = None  # leafpack.Sidecar — pre-parsed lane active
    walker_fallback: list = field(default_factory=list)  # sidecar-
    # undecidable lanes, replayed through the walker lane
    row_buf: Optional[torch.Tensor] = None  # the pool buffer
    # ``host_data`` lives in, given back after the chunk's fold


@dataclass
class _QueueItem:
    entry: DecodedEntry
    log_url: str


@dataclass
class RawBatch:
    """One get-entries response, undecoded: the sink decodes it
    natively with no per-entry Python."""

    leaf_inputs: list[str]
    extra_datas: list[str]
    start_index: int
    log_url: str

    def __len__(self) -> int:
        return len(self.leaf_inputs)


def build_sink(config, device=None):
    """The ingest model and the sink that feeds it, both from ``config``
    (a ``CTConfig``): ct-fetch's ``build_sink`` for ``backend == "tpu"``
    without the options this slice does not port (a PEM backend,
    overlap workers, the verify lane). Returns ``(sink, model)``."""
    from ct_mapreduce_tpu_torch.models.ingest_model import IngestModel

    model = IngestModel.from_config(config, device=device)
    return AggregatorSink(model.aggregator,
                          flush_size=config.batch_size,
                          device_queue_depth=config.device_queue_depth,
                          decode_workers=config.decode_workers,
                          decode_threads=config.decode_threads,
                          preparsed=config.preparsed_ingest or None,
                          chunks_per_dispatch=config.chunks_per_dispatch,
                          staging_depth=config.staging_depth), model
