"""The ingest runtime: per-log downloaders feeding store workers and the
sink that drives the aggregator (a port of ``ct_mapreduce_tpu.ingest.sync``).

The reference's ``LogSyncEngine`` / ``LogWorker`` / ``insertCTWorker``
machinery (reference cmd/ct-fetch/ct-fetch.go:83-488) on Python
threads and a bounded queue, copied from the JAX package:

- one downloader thread per log URL (ct-fetch.go:527-565), fetching
  ranges of 1000 and decoding leaves (ct-fetch.go:398-488);
- a shared bounded entry queue, capacity 16,384 (ct-fetch.go:132);
- ``num_threads`` store workers draining the queue into a sink
  (ct-fetch.go:140-145,180-246);
- a save ticker checkpointing each log's cursor every ``save_period``
  and at exit (ct-fetch.go:307-312,360-392,472-473);
- graceful stop: signal → downloaders drain → queue drains → workers
  join → final state save (ct-fetch.go:610-620).

Two sinks: :class:`DatabaseSink`, the per-entry host store through
``FilesystemDatabase`` (reference parity), and :class:`AggregatorSink`,
what ct-fetch feeds with ``backend = tpu``: whole get-entries responses
(:class:`RawBatch`) or single decoded entries accumulate to
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

With ``overlapWorkers`` > 0 the decode, submit and fold of those paths
run on the three stages of
:class:`~ct_mapreduce_tpu_torch.ingest.overlap.OverlapIngestPipeline`.
With a PEM backend (``certPath``) every first-seen certificate is
written to the reference's ``<exp>/<issuer>/<serial>`` tree
(:meth:`AggregatorSink._store_pems`), which needs each lane's serial, so
the fold keeps serials then.

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
  shipped from it has been folded, and after the PEMs of its
  first-seen lanes are written from its rows. That is safe because the
  copy, the step and the readback are queued on the same CUDA stream,
  so a fold's readback completes only after the copy from that buffer
  has.
- On a CPU aggregator nothing is pinned (pinned memory needs CUDA) and
  the "copy" is the tensor view itself.
- The staged ring keeps the chunk that follows a ring flush (the JAX
  sink drops it; ROADMAP.md queue 3).

The signature-verification lane (``verify_signatures``, the
``verifySignatures`` directive): each decoded chunk also runs the native
SCT extraction pass, and the sink's :class:`~..verify.lane.
SignatureVerifier` verifies the device-decidable SCTs through the ECDSA
verify K6 (on the aggregator's device) beside the dedup dispatch,
replays RSA and malformed lanes through the host verifier, and folds
the verdicts into the aggregator's per-issuer verified/failed vectors.
Every path (unstaged, staged, overlapped) feeds it at submit time, and
a flush drains it.
"""

from __future__ import annotations

import base64
import contextlib
import math
import os
import queue
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Optional, Protocol

import numpy as np
import torch

from ct_mapreduce_tpu_torch.config import profile as platprofile
from ct_mapreduce_tpu_torch.core import der as hostder
from ct_mapreduce_tpu_torch.core.types import CertificateLog
from ct_mapreduce_tpu_torch.ingest.ctclient import BATCH_SIZE, CTLogClient
from ct_mapreduce_tpu_torch.ingest.leaf import (
    DecodedEntry,
    LeafDecodeError,
    decode_entry,
    decode_json_entry,
    leaf_timestamp_ms as decode_leaf_timestamp,
)
from ct_mapreduce_tpu_torch.native import leafpack
from ct_mapreduce_tpu_torch.telemetry import metrics, trace

ENTRY_QUEUE_CAPACITY = 16384  # ct-fetch.go:132

_STAGING_KNOBS = (
    platprofile.Knob("chunksPerDispatch", "CTMR_CHUNKS_PER_DISPATCH", 1,
                     parse=int, is_set=platprofile.pos_int,
                     post=lambda v: max(1, int(v))),
    platprofile.Knob("stagingDepth", "CTMR_STAGING_DEPTH", 2,
                     parse=int, is_set=platprofile.pos_int,
                     post=lambda v: max(1, int(v))),
)


def _resolve_verify_lazy(flag, keys_path, window=None, qtable_size=0):
    """Import-light wrapper around ``verify.lane.resolve_verify``: the
    verify package (and with it the ECDSA kernels) loads only when the
    lane could be on."""
    if flag is None:
        flag = os.environ.get("CTMR_VERIFY", "0") == "1"
    if not flag:
        return False, "", 0, 0, 0
    from ct_mapreduce_tpu_torch.verify.lane import resolve_verify

    return resolve_verify(True, keys_path, window=window,
                          qtable_size=qtable_size)


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


class DatabaseSink:
    """Per-entry host store: parse → filter → ``database.store``.

    The filter reproduces ``certIsFilteredOut`` (ct-fetch.go:44-70):
    CA certs out, expired out unless ``log_expired_entries``, and when
    CN prefixes are configured, issuers whose CN matches none are out.
    """

    def __init__(
        self,
        database,
        cn_filters: tuple[str, ...] = (),
        log_expired_entries: bool = False,
        now: Optional[datetime] = None,
    ):
        self.database = database
        self.cn_filters = tuple(cn_filters)
        self.log_expired_entries = log_expired_entries
        self._fixed_now = now

    def _filtered_out(self, fields) -> bool:
        if fields.is_ca:
            metrics.incr_counter("ct-fetch", "certIsFilteredOut", "CA")
            return True
        now = self._fixed_now or datetime.now(timezone.utc)
        if not self.log_expired_entries and fields.not_after < now:
            metrics.incr_counter("ct-fetch", "certIsFilteredOut", "expired")
            return True
        if self.cn_filters and not any(
            fields.issuer_cn.startswith(p) for p in self.cn_filters
        ):
            metrics.incr_counter("ct-fetch", "certIsFilteredOut", "cn")
            return True
        return False

    def store(self, entry: DecodedEntry, log_url: str) -> None:
        try:
            with metrics.measure("ct-fetch", "parseCertificate"):
                fields = hostder.parse_cert(entry.cert_der)
        except Exception:
            # Tolerate-and-skip, like ct-fetch.go:206-215.
            metrics.incr_counter("ct-fetch", "parseCertificateError")
            return
        if self._filtered_out(fields):
            return
        if entry.issuer_der is None:
            metrics.incr_counter("ct-fetch", "noChainError")
            return
        with metrics.measure("ct-fetch", "storeCertificate"):
            self.database.store(
                entry.cert_der, entry.issuer_der, log_url, entry.index
            )
        metrics.incr_counter("ct-fetch", "insertCertificate")

    def flush(self) -> None:
        pass


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
                 verify_signatures: Optional[bool] = None,
                 verify_log_keys: Optional[str] = None,
                 verify_precomp_window: Optional[int] = None,
                 verify_qtable_size: int = 0):
        self.aggregator = aggregator
        self.flush_size = flush_size
        # Optional durable backend (certPath): first-seen certs get the
        # same <exp>/<issuer>/<serial> PEM tree + dirty markers the
        # reference writes (filesystemdatabase.go:189-208).
        self.backend = backend
        self._allocated: set[tuple[str, str]] = set()
        self._pem_lock = threading.Lock()  # overlap drains from a thread
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
        self._inflight: deque = deque()  # (pending, der_of)
        # The per-entry serial bytes are needed for the PEM tree and the
        # filter capture; otherwise only the cross-encoding guard reads
        # them, and drain() keeps counts exact without them.
        aggregator.want_serials = (
            backend is not None
            or getattr(aggregator, "filter_capture", None) is not None)
        self.entries_in = 0
        if preparsed is None:
            preparsed = os.environ.get("CTMR_PREPARSED", "0") == "1"
        self.preparsed = bool(preparsed)
        self.chunks_per_dispatch, self.staging_depth = resolve_staging(
            chunks_per_dispatch, staging_depth)
        self._staging: list[_PreparedChunk] = []  # the ring (FIFO)
        self._staging_hw = 0  # high-water occupancy
        self._row_bufs = _PinnedPool(aggregator.device.type == "cuda")
        # Signature-verification lane (`verifySignatures` / CTMR_VERIFY):
        # `verifyPrecompWindow` (0 = the Jacobian ladder) and
        # `verifyQTableSize` (the per-curve Q-table slots) as in the JAX
        # sink; the verdicts fold into the aggregator's per-issuer
        # verified/failed vectors.
        v_on, v_keys, v_batch, v_window, v_qsize = _resolve_verify_lazy(
            verify_signatures, verify_log_keys,
            verify_precomp_window, verify_qtable_size)
        self.verifier = None
        if v_on:
            from ct_mapreduce_tpu_torch.verify.lane import (
                LogKeyRegistry,
                SignatureVerifier,
            )

            keys = (LogKeyRegistry.from_json_file(v_keys) if v_keys
                    else LogKeyRegistry())
            self.verifier = SignatureVerifier(
                aggregator, keys, batch_width=v_batch,
                window=v_window, qtable_size=v_qsize)
        # Overlapped ingest (overlapWorkers > 0): raw chunks route through
        # the three-stage scheduler (decode pool ‖ ordered device submit
        # ‖ bounded fold consumer) over the same decode/submit/complete
        # primitives, so results are the serial path's.
        self.overlap_workers = max(0, int(overlap_workers))
        self._overlap = None
        if self.overlap_workers:
            from ct_mapreduce_tpu_torch.ingest.overlap import (
                OverlapIngestPipeline,
            )

            self._overlap = OverlapIngestPipeline(
                self, decode_workers=self.overlap_workers,
                # In staged mode the drain bound counts ENVELOPES, and
                # stagingDepth is that double-buffer depth.
                queue_depth=(self.staging_depth
                             if self.chunks_per_dispatch > 1
                             else max(1, self.device_queue_depth)))

    def row_buffer_bound(self) -> int:
        """The most pool buffers that can be in use at once. Serially: the
        chunks or envelopes in flight and the one being filled. With the
        overlap pipeline: the prepared window (chunks decoded ahead of
        the submit thread), the drain queue, the item the fold thread
        holds, and the one the submit thread may hold while it waits for
        room in the drain queue."""
        keep = (self.staging_depth if self.chunks_per_dispatch > 1
                else self.device_queue_depth)
        if self._overlap is None:
            return keep + 1
        ovl = self._overlap
        return ovl.queue_depth + ovl._max_prepared + 2

    def store(self, entry: DecodedEntry, log_url: str) -> None:
        if entry.issuer_der is None:
            metrics.incr_counter("ct-fetch", "noChainError")
            return
        batch: Optional[list[tuple[bytes, bytes]]] = None
        with self._lock:
            self._pending.append((entry.cert_der, entry.issuer_der))
            self.entries_in += 1
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
            self.entries_in += len(pairs)
            if len(self._pending_raw) >= self.flush_size:
                chunk, self._pending_raw = self._pending_raw, []
        if chunk:
            self._dispatch_raw(chunk)

    def _dispatch_raw(self, pairs: list[tuple[str, str]]) -> None:
        if self._overlap is not None:
            # Decode on the pipeline's pool, submission on its ordered
            # submit thread, completion on its fold consumer.
            self._overlap.submit_chunk(pairs)
            return
        with trace.span("ingest.decode", cat="ingest", entries=len(pairs)):
            prep = self._prepare_chunk(pairs)
        t_lock = time.monotonic()
        with trace.span("ingest.submit_locked", cat="ingest"), \
                self._dispatch_lock:
            metrics.add_sample("ct-fetch", "dispatchLockWait",
                               value=time.monotonic() - t_lock)
            with metrics.measure("ct-fetch", "storeCertificate"), \
                    trace.span("ingest.submit", cat="ingest"):
                self._dispatch_prepared(prep)

    def _dispatch_prepared(self, prep: "_PreparedChunk") -> None:
        """Queue a prepared chunk's work and fold down to the in-flight
        bound. Caller holds ``_dispatch_lock``."""
        self._queue_items(self._submit_chunk(prep))
        self._drain_inflight(self.staging_depth
                             if self.chunks_per_dispatch > 1
                             else self.device_queue_depth)

    def _queue_items(self, items: list[tuple]) -> None:
        """Pendings go in flight; results (the host-exact lanes, already
        folded) only need their PEMs."""
        for kind, payload, der_of in items:
            if kind == "pending":
                self._inflight.append((payload, der_of))
            else:
                self._store_pems(payload, der_of)

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

        # Signature-verification lane: one more native pass over the
        # packed rows extracts the embedded-SCT tuples. The eligible set
        # is the decoded-OK, issuer-mapped lanes BEFORE the sidecar split
        # below (walker-fallback lanes still carry auditable SCTs);
        # oversized certs never reach packed rows and are not audited.
        scts = None
        verify_eligible = None
        if self.verifier is not None:
            from ct_mapreduce_tpu_torch.verify import sct as sctlib

            # The RFC 6962 digest signs the lane's issuer_key_hash:
            # SHA-256 of the chain issuer's SPKI, once an issuer group;
            # lanes without a mapped issuer hash as all-zero.
            ikh_groups = np.zeros((len(dec.group_issuers) + 1, 32),
                                  np.uint8)
            for g, der in enumerate(dec.group_issuers):
                ikh_groups[g] = np.frombuffer(
                    sctlib.issuer_key_hash_of(der), np.uint8)
            lane_ikh = ikh_groups[np.where(valid, dec.issuer_group, -1)]
            scts = leafpack.extract_scts(
                data, dec.length,
                threads=self.decode_threads or self.decode_workers,
                issuer_key_hash=lane_ikh)
            verify_eligible = valid.copy()

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
            walker_fallback=walker_fallback, row_buf=buf,
            scts=scts, verify_eligible=verify_eligible)

    def _submit_verify(self, prep: "_PreparedChunk") -> None:
        """Route one prepared chunk's SCT lanes into the verify lane.
        Caller holds ``_dispatch_lock`` (the verifier shares the one
        device stream with the dedup dispatch)."""
        if self.verifier is None or prep.scts is None:
            return
        self.verifier.submit_chunk(
            prep.scts, prep.issuer_idx, prep.verify_eligible,
            prep.host_data, prep.length)

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
            self._staging_hw = max(self._staging_hw, depth)
            metrics.set_gauge("ingest", "staging_ring", value=float(depth))
            if host_exact or depth >= self.chunks_per_dispatch:
                items += self._flush_staging_items()
        return items + self._host_exact_items(prep)

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
        pending.row_buf = pool_buf

        def der_of(pos, _ring=ring, _b=b):
            k, j = divmod(pos, _b)
            p = _ring[k]
            return p.host_data[j, : p.length[j]].tobytes()

        return [("pending", pending, der_of)]

    def staging_depths(self) -> dict[str, int]:
        """Staging-ring occupancy, merged into the overlap pipeline's
        ``queue_depths``: a ring pinned below K while the drain is
        saturated is the drain-starvation signature the prepared/drain
        gauges alone cannot show."""
        if self.chunks_per_dispatch <= 1:
            return {}
        return {
            "staging_ring": len(self._staging),
            "staging_ring_capacity": self.chunks_per_dispatch,
            "staging_ring_highwater": self._staging_hw,
        }

    def _host_exact_items(self, prep: "_PreparedChunk") -> list[tuple]:
        """The chunk's walker-fallback and oversized entries, through
        the aggregator's synchronous per-entry walker lane, as folded
        results; then the chunk's insert count."""
        items: list[tuple] = []
        for entries in (prep.walker_fallback, prep.oversized):
            if entries:
                res = self.aggregator.ingest(entries)
                items.append(("result", res,
                              lambda pos, _e=entries: _e[pos][0]))
        metrics.incr_counter(
            "ct-fetch", "insertCertificate",
            value=float(int(prep.valid.sum()) + len(prep.oversized)
                        + len(prep.walker_fallback)))
        return items

    def _submit_chunk(self, prep: "_PreparedChunk") -> list[tuple]:
        """Stage 2 — queue the device step(s) for a prepared chunk.
        Caller holds ``_dispatch_lock``. Returns drain items:
        ``("pending", pending, der_of)``, whose ``complete()`` is stage
        3, and ``("result", IngestResult, der_of)`` (the host-exact
        lanes, already folded), which only need their PEMs. With
        ``chunksPerDispatch`` > 1 a chunk may add no pending (staged,
        awaiting ring mates) or one covering a whole envelope."""
        self._submit_verify(prep)
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
            pending.row_buf = prep.row_buf
            # The rows a PEM is written from: the chunk's host rows (in
            # the pool buffer until the item is complete).
            items.append((
                "pending", pending,
                lambda pos, _d=prep.host_data, _l=prep.length:
                    _d[pos, : _l[pos]].tobytes()))
        return items + self._host_exact_items(prep)

    def _complete_item(self, pending, der_of) -> None:
        """Stage 3 — block on one submitted item's device work, fold it,
        write its PEMs, and only then give its row buffer back."""
        with metrics.measure("ct-fetch", "completeBatch"), \
                trace.span("device.readback", cat="device"):
            res = pending.complete()
        self._store_pems(res, der_of)
        if pending.row_buf is not None:
            buf, pending.row_buf = pending.row_buf, None
            self._row_bufs.give(buf)

    def _drain_inflight(self, keep: int) -> None:
        """Complete submitted device work until at most ``keep`` items
        remain in flight. Caller holds ``_dispatch_lock``."""
        while len(self._inflight) > keep:
            pending, der_of = self._inflight.popleft()
            self._complete_item(pending, der_of)

    def flush(self) -> None:
        with self._lock:
            batch, self._pending = self._pending, []
            raw, self._pending_raw = self._pending_raw, []
        if batch:
            self._dispatch(batch)
        if raw:
            self._dispatch_raw(raw)
        if self._overlap is not None:
            # Barrier through the scheduler: every chunk handed to it is
            # decoded, stepped and folded before flush returns (and any
            # stage failure surfaces here).
            self._overlap.drain_all()
        t_lock = time.monotonic()
        with self._dispatch_lock:
            metrics.add_sample("ct-fetch", "dispatchLockWait",
                               value=time.monotonic() - t_lock)
            with metrics.measure("ct-fetch", "storeCertificate"):
                # A partial staging ring dispatches at the barrier (the
                # overlap path flushed it on its submit thread above).
                self._queue_items(self._flush_staging_items())
                self._drain_inflight(0)
                if self.verifier is not None:
                    # The verify lane's barrier too: the partial batch
                    # launches and every verdict folds.
                    self.verifier.drain()

    def close(self) -> None:
        """Flush, then stop the overlap scheduler's threads (no-op in
        serial mode). The sink stays usable for serial dispatch."""
        try:
            self.flush()
        finally:
            if self._overlap is not None:
                overlap, self._overlap = self._overlap, None
                overlap.close()

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
            result = self.aggregator.ingest(batch)
            self._store_pems(result, lambda pos: batch[pos][0])
        metrics.incr_counter("ct-fetch", "insertCertificate",
                             value=float(len(batch)))

    def _store_pems(self, result, der_of) -> None:
        """Durable PEM tree + dirty markers (parity with
        filesystemdatabase.go:189-208). No-op without a backend.

        PEMs are written for first-seen certs only, but every
        non-filtered entry re-marks its expiry day dirty — the
        reference marks per Store call, known duplicates included
        (filesystemdatabase.go:141-144,204-208); here that collapses
        to once per day per dispatch."""
        if self.backend is None:
            return
        from ct_mapreduce_tpu_torch.core.types import ExpDate, Serial

        reg = self.aggregator.registry
        with self._pem_lock:  # overlap drains + per-entry path may race
            dirty_days: set[str] = set()
            for pos, sb in enumerate(result.serials):
                if sb is None or result.filtered[pos]:
                    continue
                exp = ExpDate.from_unix_hour(int(result.exp_hours[pos]))
                dirty_days.add(exp.date.strftime("%Y-%m-%d"))
                if not result.was_unknown[pos]:
                    continue
                issuer = reg.issuer_at(int(result.issuer_idx[pos]))
                pair = (exp.id(), issuer.id())
                if pair not in self._allocated:
                    self.backend.allocate_exp_date_and_issuer(exp, issuer)
                    self._allocated.add(pair)
                self.backend.store_certificate_pem(
                    Serial(sb), exp, issuer, hostder.der_to_pem(der_of(pos)))
            for day in dirty_days:
                self.backend.mark_dirty(day)


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
    scts: object = None  # verify.sct.SctBatch — verify lane active
    verify_eligible: object = None  # bool[n] — decoded-OK lanes as of
    # extraction time (before the sidecar split)


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


class LogWorker:
    """Download worker for one log (ct-fetch.go:248-488).

    Resolves the resume window on construction: start = saved
    ``MaxEntry`` unless ``offset`` overrides; end = STH tree size - 1,
    clamped by ``limit`` (ct-fetch.go:288-305).
    """

    def __init__(
        self,
        client: CTLogClient,
        database,
        offset: int = 0,
        limit: int = 0,
        pre_save=None,
        state_suffix: str = "",
    ):
        self.client = client
        self.database = database
        self.pre_save = pre_save  # runs before each durable cursor write
        # Fleet stripe mode (ingest/fleet.py::partition_range): workers
        # share one log but own disjoint [offset, offset+limit) index
        # ranges, so each stripe keeps its OWN durable cursor under
        # `<short_url><state_suffix>` (a shared cursor would clobber
        # across workers), and resume takes max(stripe start, saved
        # cursor) with the stripe END fixed, so a warm restart replays
        # only the post-checkpoint tail of its own stripe.
        self.state_suffix = state_suffix
        self.sth = client.get_sth()
        self.log_state: CertificateLog = database.get_log_state(
            client.short_url + state_suffix)
        tree_end = self.sth.tree_size - 1
        if state_suffix:
            self.start_pos = max(offset, self.log_state.max_entry)
            self.end_pos = (min(offset + limit - 1, tree_end)
                            if limit > 0 else tree_end)
        else:
            if offset > 0:
                self.start_pos = offset
            else:
                self.start_pos = self.log_state.max_entry
            if limit > 0:
                self.end_pos = min(self.start_pos + limit - 1, tree_end)
            else:
                self.end_pos = tree_end
        self.position = self.start_pos
        self.last_entry_time: Optional[datetime] = None
        self._publish_lag()
        # External checkpoint trigger: the download loop saves at the
        # next batch boundary when set — same thread as the periodic
        # ticker saves, so no new concurrency.
        self._save_signal = threading.Event()

    def _publish_lag(self) -> None:
        """Ingest-lag gauge: entries between the cursor and the STH tree
        head, keyed per log so multi-log runs expose the worst log."""
        lag = max(0, self.end_pos + 1 - self.position)
        metrics.set_gauge("ingest", "lag_entries", self.client.short_url,
                          value=float(lag))

    def request_save(self) -> None:
        """Ask the download loop to checkpoint (cursor + pre_save
        aggregate snapshot) at its next batch boundary."""
        self._save_signal.set()

    def save_state(self) -> None:
        """Persist the cursor (ct-fetch.go:371-392): dual-written by
        the database facade (cache + backend). ``pre_save`` (e.g. the
        aggregate snapshot) must succeed first — a cursor must never
        durably advance past entries whose aggregation isn't durable."""
        if self.pre_save is not None:
            self.pre_save()
        self.log_state.max_entry = self.position
        if self.last_entry_time is not None:
            self.log_state.last_entry_time = self.last_entry_time
        self.log_state.last_update_time = datetime.now(timezone.utc)
        with metrics.measure("LogWorker", self.client.short_url, "saveState"):
            self.database.save_log_state(self.log_state)

    def run(
        self,
        out: "queue.Queue",
        stop: threading.Event,
        save_period_s: float = 900.0,
        progress=None,
        raw_batches: bool = False,
    ) -> int:
        """Stream ``[start_pos, end_pos]`` into the queue; returns the
        number of entries enqueued. Checkpoints on a ticker and at exit
        (ct-fetch.go:360-368,472-473) — the exit save runs on error
        paths too, like the reference's deferred save (ct-fetch.go:367):
        a transport error mid-range must not discard up to a full save
        period of cursor progress (re-fetch is dedup-safe, but it is
        lost work). With ``raw_batches``, whole get-entries responses
        are enqueued undecoded for the sink's native batch decoder."""
        try:
            enqueued = self._run_loop(
                out, stop, save_period_s, progress, raw_batches
            )
        except BaseException:
            # Best-effort save on the error path: a failing save must
            # not replace the root-cause download error (the engine
            # records what propagates to it).
            try:
                self.save_state()
            except Exception:
                metrics.incr_counter(
                    "LogWorker", self.client.short_url, "saveStateError"
                )
            raise
        self.save_state()
        return enqueued

    def _run_loop(
        self, out, stop, save_period_s, progress, raw_batches
    ) -> int:
        enqueued = 0
        next_save = time.monotonic() + save_period_s
        index = self.position
        while index <= self.end_pos and not stop.is_set():
            batch = self.client.get_raw_entries(
                index, min(index + BATCH_SIZE - 1, self.end_pos)
            )
            if not batch:
                break
            if raw_batches:
                item = RawBatch(
                    leaf_inputs=[r.leaf_input for r in batch],
                    extra_datas=[r.extra_data for r in batch],
                    start_index=batch[0].index,
                    log_url=self.client.log_url,
                )
                submitted = False
                while not stop.is_set():
                    try:
                        out.put(item, timeout=0.25)
                        submitted = True
                        break
                    except queue.Full:
                        continue
                if not submitted:
                    break  # cursor stays put: batch never reached a worker
                enqueued += len(batch)
                index = batch[-1].index + 1
                self.position = index
                # Last DECODABLE timestamp — a garbage final entry must
                # not lose the good entries' timestamps (per-entry-path
                # parity: it updates per decoded entry).
                for raw in reversed(batch):
                    ts = decode_leaf_timestamp(raw.leaf_input)
                    if ts is not None:
                        self.last_entry_time = datetime.fromtimestamp(
                            ts / 1000.0, tz=timezone.utc
                        )
                        break
                self._publish_lag()
                if progress is not None:
                    progress(self.client.short_url, self.position, self.end_pos)
                if (self._save_signal.is_set()
                        or time.monotonic() >= next_save):
                    self._save_signal.clear()
                    self.save_state()
                    next_save = time.monotonic() + save_period_s
                continue
            for raw in batch:
                try:
                    with metrics.measure(
                        "LogWorker", self.client.short_url, "parseLeaf"
                    ):
                        entry = decode_json_entry(
                            raw.index,
                            {"leaf_input": raw.leaf_input,
                             "extra_data": raw.extra_data},
                        )
                except LeafDecodeError:
                    metrics.incr_counter(
                        "LogWorker", self.client.short_url, "parseLeafError"
                    )
                    # Tolerated skip IS durable: the cursor moves past the
                    # bad entry so restarts don't re-fetch it forever.
                    self.position = raw.index + 1
                    continue
                finally:
                    index = raw.index + 1
                self.last_entry_time = datetime.fromtimestamp(
                    entry.timestamp_ms / 1000.0, tz=timezone.utc
                )
                # select{signal | save | submit} (ct-fetch.go:466-480)
                submitted = False
                while not stop.is_set():
                    try:
                        with metrics.measure(
                            "LogWorker", self.client.short_url, "submitToChannel"
                        ):
                            out.put(_QueueItem(entry, self.client.log_url),
                                    timeout=0.25)
                        enqueued += 1
                        submitted = True
                        break
                    except queue.Full:
                        continue
                if not submitted:
                    # Stopped while the queue was full: do NOT advance the
                    # cursor past an entry that never reached a worker —
                    # resume must re-fetch it.
                    break
                self.position = raw.index + 1
                self._publish_lag()
                if progress is not None:
                    progress(self.client.short_url, self.position, self.end_pos)
                if (self._save_signal.is_set()
                        or time.monotonic() >= next_save):
                    self._save_signal.clear()
                    self.save_state()
                    next_save = time.monotonic() + save_period_s
                if stop.is_set():
                    break
        return enqueued


class _AccountingQueue:
    """Facade over the shared entry queue that bumps the engine's
    per-log outstanding watermark on each successful put (the blocking
    semantics are the inner queue's own)."""

    def __init__(self, inner: "queue.Queue", on_put):
        self._inner = inner
        self._on_put = on_put

    def put(self, item, timeout=None) -> None:
        self._inner.put(item, timeout=timeout)
        self._on_put(item)


class LogSyncEngine:
    """Queue + worker-pool runtime (ct-fetch.go:83-178).

    ``start_store_threads`` spawns the consumers; ``sync_log`` spawns
    one downloader thread per URL; ``stop`` + ``join`` replicate the
    WaitGroup shutdown ordering of main() (ct-fetch.go:610-620).
    """

    def __init__(
        self,
        sink: EntrySink,
        database,
        num_threads: int = 1,
        queue_capacity: int = ENTRY_QUEUE_CAPACITY,
        offset: int = 0,
        limit: int = 0,
        save_period_s: float = 900.0,
        checkpoint_hook=None,
        raw_batches: bool = False,
    ):
        self.sink = sink
        self.database = database
        # Runs before each durable cursor write (after the queue drains):
        # with backend = tpu this snapshots the device aggregates so the
        # cursor never outruns durable aggregate state.
        self.checkpoint_hook = checkpoint_hook
        self.num_threads = num_threads
        self.offset = offset
        self.limit = limit
        self.save_period_s = save_period_s
        self.raw_batches = raw_batches
        if raw_batches:
            # Queue items are whole get-entries responses (≤ BATCH_SIZE
            # entries each); keep the same total-entry bound.
            queue_capacity = max(2, queue_capacity // BATCH_SIZE)
        self.entry_queue: "queue.Queue" = queue.Queue(maxsize=queue_capacity)
        self.stop_event = threading.Event()
        self._store_threads: list[threading.Thread] = []
        self._download_threads: list[threading.Thread] = []
        self._last_update_lock = threading.Lock()
        self._last_updates: dict[str, datetime] = {}
        self._progress: dict[str, tuple[int, int]] = {}
        self.errors: list[str] = []
        # Per-log count of entries enqueued but not yet through the sink.
        # A durable cursor save for log L only needs L's own entries
        # stored — waiting on the whole shared queue (entry_queue.join())
        # would let other logs' downloaders starve the save indefinitely.
        self._outstanding: dict[str, int] = {}
        self._outstanding_cond = threading.Condition()
        # Live LogWorkers: registered for the duration of their
        # download, so an out-of-band checkpoint can ask each to save at
        # its next batch boundary.
        self._active_workers: list[LogWorker] = []
        self._active_lock = threading.Lock()

    # -- health surface (ct-fetch.go:567-597) ---------------------------
    def last_updates(self) -> dict[str, datetime]:
        with self._last_update_lock:
            return dict(self._last_updates)

    def progress(self) -> dict[str, tuple[int, int]]:
        with self._last_update_lock:
            return dict(self._progress)

    def _note_progress(self, short_url: str, pos: int, end: int) -> None:
        with self._last_update_lock:
            self._last_updates[short_url] = datetime.now(timezone.utc)
            self._progress[short_url] = (pos, end)

    # -- consumers ------------------------------------------------------
    def _store_worker(self) -> None:
        while True:
            item = self.entry_queue.get()
            try:
                if item is None:
                    return
                try:
                    if isinstance(item, RawBatch):
                        self.sink.store_raw_batch(item)
                    else:
                        self.sink.store(item.entry, item.log_url)
                except Exception as err:
                    # A store failure must not kill the worker — the queue
                    # would back up and stop() would deadlock on join().
                    metrics.incr_counter("ct-fetch", "storeError")
                    where = (
                        f"{item.log_url}@{item.start_index}"
                        if isinstance(item, RawBatch)
                        else f"{item.log_url}@{item.entry.index}"
                    )
                    self.errors.append(f"store {where}: {err}")
            finally:
                self.entry_queue.task_done()
                if item is not None:
                    self._account_stored(item)

    def start_store_threads(self) -> None:
        for i in range(self.num_threads):
            t = threading.Thread(
                target=self._store_worker, name=f"store-{i}", daemon=True
            )
            t.start()
            self._store_threads.append(t)

    def _account_enqueued(self, item) -> None:
        n = len(item) if isinstance(item, RawBatch) else 1
        with self._outstanding_cond:
            self._outstanding[item.log_url] = (
                self._outstanding.get(item.log_url, 0) + n
            )

    def _account_stored(self, item) -> None:
        n = len(item) if isinstance(item, RawBatch) else 1
        with self._outstanding_cond:
            self._outstanding[item.log_url] = (
                self._outstanding.get(item.log_url, 0) - n
            )
            self._outstanding_cond.notify_all()

    def _pre_cursor_save(self, log_url: str) -> None:
        """Make everything log ``log_url``'s cursor covers durable:
        wait until every entry *this log* enqueued has passed through
        the sink (a per-log watermark — the downloader is the one
        waiting, so its count only drains; other logs keep flowing),
        then run the checkpoint hook to flush + snapshot."""
        with self._outstanding_cond:
            self._outstanding_cond.wait_for(
                lambda: self._outstanding.get(log_url, 0) <= 0
            )
        if self.checkpoint_hook is not None:
            self.checkpoint_hook()

    # -- external checkpoint trigger ------------------------------------
    def checkpoint_now(self) -> None:
        """Checkpoint the run's durable state out of band: every live
        downloader saves (cursor + pre_save aggregate snapshot) at its
        next batch boundary; with no downloads in flight the aggregate
        snapshot hook runs directly."""
        with self._active_lock:
            workers = list(self._active_workers)
        for worker in workers:
            worker.request_save()
        if not workers and self.checkpoint_hook is not None:
            self.checkpoint_hook()

    # -- producers ------------------------------------------------------
    def sync_log(self, log_url: str, transport=None,
                 offset: Optional[int] = None,
                 limit: Optional[int] = None,
                 state_suffix: str = "") -> threading.Thread:
        """Start one downloader. ``offset``/``limit`` override the
        engine-wide window (a fleet's entry-range stripes of one log
        pass their own); ``state_suffix`` keys the stripe's durable
        cursor (see :class:`LogWorker`)."""
        eff_offset = self.offset if offset is None else offset
        eff_limit = self.limit if limit is None else limit

        def run() -> None:
            worker = None
            try:
                client = CTLogClient(log_url, transport=transport)
                worker = LogWorker(
                    client, self.database,
                    offset=eff_offset, limit=eff_limit,
                    # Items carry the client's normalized URL, so the
                    # watermark key must match it.
                    pre_save=lambda: self._pre_cursor_save(client.log_url),
                    state_suffix=state_suffix,
                )
                with self._active_lock:
                    self._active_workers.append(worker)
                self._note_progress(client.short_url, worker.position, worker.end_pos)
                worker.run(
                    _AccountingQueue(self.entry_queue, self._account_enqueued),
                    self.stop_event,
                    save_period_s=self.save_period_s,
                    progress=self._note_progress,
                    raw_batches=self.raw_batches,
                )
            except Exception as err:  # log-level failures never kill the run
                metrics.incr_counter("ct-fetch", "syncLogError")
                self.errors.append(f"{log_url}: {err}")
            finally:
                if worker is not None:
                    with self._active_lock:
                        with contextlib.suppress(ValueError):
                            self._active_workers.remove(worker)

        t = threading.Thread(target=run, name=f"sync-{log_url}", daemon=True)
        t.start()
        self._download_threads.append(t)
        return t

    # -- lifecycle ------------------------------------------------------
    def wait_for_downloads(self, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in self._download_threads:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            t.join(remaining)
        # Drop finished threads so runForever rounds don't accumulate
        # (and re-join) an ever-growing history.
        self._download_threads = [t for t in self._download_threads if t.is_alive()]

    def stop(self) -> None:
        """Drain and terminate the store workers (ct-fetch.go:167-171)."""
        self.entry_queue.join()
        for _ in self._store_threads:
            self.entry_queue.put(None)
        for t in self._store_threads:
            t.join()
        self._store_threads.clear()
        self.sink.flush()

    def signal_stop(self) -> None:
        self.stop_event.set()

    def cleanup(self) -> None:
        self.database.cleanup()


def polling_delay(mean_s: float, std_dev_pct: float) -> float:
    """runForever inter-poll sleep: normal around the mean, clamped
    positive (the reference draws from a normal distribution with the
    configured mean/stddev percentage)."""
    return max(1.0, random.gauss(mean_s, mean_s * std_dev_pct / 100.0))


def build_sink(config, device=None, database=None, backend=None):
    """ct-fetch's store path from ``config`` (a ``CTConfig``): with
    ``backend = tpu`` the device pipeline (an :class:`IngestModel` on
    ``device``, CUDA unless named, and the :class:`AggregatorSink` that
    feeds it, with the PEM ``backend`` when ``certPath`` is set), else
    the per-entry :class:`DatabaseSink` over ``database``. Returns
    ``(sink, model)``; ``model`` is None for the database path."""
    if config.backend == "tpu":
        from ct_mapreduce_tpu_torch.models.ingest_model import IngestModel

        model = IngestModel.from_config(config, device=device)
        # certPath keeps the reference's durable PEM tree in device mode
        # too; without it the backend is a no-op and is skipped.
        pem_backend = backend if config.cert_path else None
        return AggregatorSink(model.aggregator,
                              flush_size=config.batch_size,
                              backend=pem_backend,
                              device_queue_depth=config.device_queue_depth,
                              decode_workers=config.decode_workers,
                              decode_threads=config.decode_threads,
                              overlap_workers=config.overlap_workers,
                              preparsed=config.preparsed_ingest or None,
                              chunks_per_dispatch=config.chunks_per_dispatch,
                              staging_depth=config.staging_depth,
                              verify_signatures=(config.verify_signatures
                                                 or None),
                              verify_log_keys=(config.verify_log_keys
                                               or None),
                              verify_precomp_window=(
                                  config.verify_precomp_window
                                  if config.verify_precomp_window >= 0
                                  else None),
                              verify_qtable_size=config.verify_qtable_size,
                              ), model
    if database is None:
        raise ValueError("the database path needs a database "
                         "(engine.get_configured_storage)")
    return DatabaseSink(database,
                        cn_filters=tuple(config.issuer_cn_filters()),
                        log_expired_entries=config.log_expired_entries), None
