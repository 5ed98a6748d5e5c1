"""Recorded-shard audit pipeline: real-wire ``get-entries`` pages
through decode → RFC 6962 TBS-reconstructed verify → aggregate →
filter, with the quarantine lane in front.

The audit corpus is a **recorded shard** (``CTMRAU01``): a gzip JSON
capture of get-entries responses plus the production-schema log list
that verifies them, checked in so the whole audit path replays
deterministically with zero egress. ``--live`` mode substitutes the
existing :class:`~ct_mapreduce_tpu_torch.ingest.ctclient.CTLogClient`
transport for the recorded pages — same pipeline from the first
decode on.

Per distinct page the driver runs a host pre-pass ONCE:

1. decode each entry (:func:`ct_mapreduce_tpu_torch.ingest.leaf.
   decode_json_entry`) to the stored cert + chain issuer;
2. extract SCTs through the native scanner AND the Python mirror and
   diff them (:mod:`ct_mapreduce_tpu_torch.audit.quarantine`): diverging
   lanes are spooled and DROPPED before the pipeline sees them;
3. route each surviving SCT's (log_id, timestamp) against the log
   list — unknown logs, retired logs (verify-but-flag), and
   out-of-shard-interval timestamps are tallied.

Surviving entries then ride the UNMODIFIED production sink
(:class:`~ct_mapreduce_tpu_torch.ingest.sync.AggregatorSink` with
``verifySignatures`` on): native batch decode, device-lane ECDSA with
the per-issuer-group ikh threading, per-issuer verified/failed folds.
Tiling (``tile`` > 1) resubmits the recorded pages with shifted entry
indices so scale runs (1e5 tier-1 / 1e6 tool) exercise the full
decode+verify+aggregate path on every entry; the host pre-pass is
shared across tiles — byte-identical copies cannot diverge
differently, so re-checking them would measure nothing.

The aggregate then feeds every existing surface: ``storage_statistics``
per-issuer ``sctsVerified``/``sctsFailed``, the serve plane's
``/issuer`` meta, and CTMRCK02 checkpoints — the audit subsystem adds
no parallel bookkeeping.

This is a port of ``ct_mapreduce_tpu.audit.driver``: the aggregator is
a :class:`..agg.aggregator.TorchAggregator` on ``device`` (CUDA unless
the caller names another), so the sink's walk, fingerprints and
P-256/P-384 verifies run as K3, K1 and K6 on the card.
"""

from __future__ import annotations

import base64
import gzip
import json
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from ct_mapreduce_tpu_torch.audit import loglist as loglistlib
from ct_mapreduce_tpu_torch.audit import quarantine as quarlib
from ct_mapreduce_tpu_torch.ingest import leaf as leaflib
from ct_mapreduce_tpu_torch.telemetry import metrics
from ct_mapreduce_tpu_torch.verify import sct as sctlib

RECORDED_FORMAT = "CTMRAU01"


def load_recorded(path: str) -> dict:
    """A ``CTMRAU01`` recorded shard: ``{format, log_url, log_list,
    pages: [{start, entries: [{leaf_input, extra_data}]}]}`` —
    gzip-compressed JSON (the container needs nothing beyond the
    stdlib; zstd is deliberately not assumed)."""
    with gzip.open(path, "rt", encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("format") != RECORDED_FORMAT:
        raise ValueError(
            f"unknown recorded-shard format in {path}: "
            f"{doc.get('format')!r}")
    return doc


def write_recorded(path: str, doc: dict) -> None:
    doc = dict(doc, format=RECORDED_FORMAT)
    # mtime=0 + empty FNAME → byte-stable archive for identical
    # content (the checked-in fixture must not churn on regeneration
    # or embed the output path).
    with open(path, "wb") as raw, \
            gzip.GzipFile("", fileobj=raw, mode="wb", mtime=0) as fh:
        fh.write(json.dumps(doc, sort_keys=True).encode())


@dataclass
class PageAnalysis:
    """Host pre-pass result for one distinct page."""

    keep: list  # [(leaf_input_b64, extra_data_b64)] surviving lanes
    quarantined: int = 0
    sct_lanes: int = 0
    no_sct: int = 0
    decode_failed: int = 0
    unknown_log: int = 0
    retired: int = 0
    out_of_interval: int = 0
    per_log: dict = field(default_factory=dict)  # log_id hex -> lanes


@dataclass
class AuditReport:
    entries: int = 0
    pages: int = 0
    tile: int = 1
    quarantined: int = 0
    divergence_measured: bool = False
    sct_lanes: int = 0
    no_sct: int = 0
    decode_failed: int = 0
    unknown_log: int = 0
    retired: int = 0
    out_of_interval: int = 0
    verified: int = 0
    failed: int = 0
    verifier_no_sct: int = 0
    verifier_no_key: int = 0
    device_lanes: int = 0
    host_lanes: int = 0
    per_issuer: dict = field(default_factory=dict)  # id -> (v, f)
    per_log: dict = field(default_factory=dict)
    wall_s: float = 0.0

    def to_json(self) -> dict:
        out = {k: getattr(self, k) for k in (
            "entries", "pages", "tile", "quarantined",
            "divergence_measured", "sct_lanes", "no_sct",
            "decode_failed", "unknown_log", "retired",
            "out_of_interval", "verified", "failed",
            "verifier_no_sct", "verifier_no_key", "device_lanes",
            "host_lanes", "wall_s")}
        out["perIssuer"] = {k: list(v) for k, v in
                            sorted(self.per_issuer.items())}
        out["perLog"] = dict(sorted(self.per_log.items()))
        return out


class AuditDriver:
    """One audit run: a log list, a quarantine spool, and a fresh
    aggregation pipeline (verify lane on)."""

    def __init__(self, log_list: loglistlib.AuditLogList,
                 quarantine_dir: str = "",
                 capacity: int = 1 << 14, batch_size: int = 256,
                 flush_size: int = 256, batch_width: int = 0,
                 chunks_per_dispatch: int = 0,
                 filter_path: str = "", filter_fp: float = 0.01,
                 aggregator=None, sink=None, device=None):
        from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
        from ct_mapreduce_tpu_torch.ingest.sync import AggregatorSink

        self.log_list = log_list
        self.spool = quarlib.QuarantineSpool(quarantine_dir)
        self.aggregator = aggregator or TorchAggregator(
            capacity=capacity, batch_size=batch_size, device=device)
        if filter_path:
            # Arm serial capture BEFORE ingestion (device-lane serials
            # folded earlier are hashes only); the artifact is emitted
            # at checkpoint-save time, same as the production sink.
            self.aggregator.configure_filter_emission(filter_path,
                                                      filter_fp)
        self.sink = sink or AggregatorSink(
            self.aggregator, flush_size=flush_size,
            device_queue_depth=0, verify_signatures=True,
            chunks_per_dispatch=chunks_per_dispatch)
        if batch_width:
            self.sink.verifier.batch_width = batch_width
        for shard in log_list.shards.values():
            self.sink.verifier.keys.register(dict(shard.entry))

    # -- host pre-pass ---------------------------------------------------
    def analyze_page(self, entries: list, start: int = 0,
                     log_url: str = "") -> PageAnalysis:
        """Decode, quarantine-check, and route ONE distinct page."""
        ana = PageAnalysis(keep=[])
        ders: list[bytes] = []
        ikhs: list[bytes] = []
        decoded_rows: list[int] = []
        for i, e in enumerate(entries):
            try:
                dec = leaflib.decode_json_entry(start + i, e)
            except leaflib.LeafDecodeError:
                # Undecodable entries still go to the sink — its native
                # decoder owns the error taxonomy; the pre-pass only
                # tracks that it had nothing to route.
                ana.decode_failed += 1
                ana.keep.append((e["leaf_input"],
                                 e.get("extra_data", "")))
                continue
            ders.append(dec.cert_der)
            ikhs.append(sctlib.issuer_key_hash_of(dec.issuer_der)
                        if dec.issuer_der else sctlib.ZERO_IKH)
            decoded_rows.append(i)
        if ders:
            pad = max(len(d) for d in ders)
            data = np.zeros((len(ders), pad), np.uint8)
            length = np.zeros((len(ders),), np.int32)
            for j, d in enumerate(ders):
                data[j, :len(d)] = np.frombuffer(d, np.uint8)
                length[j] = len(d)
            ikh = np.frombuffer(b"".join(ikhs), np.uint8).reshape(-1, 32)
            chk = quarlib.check_batch(data, length, issuer_key_hash=ikh)
            ana.quarantined = chk.count
            self._last_measured = chk.measured
            ext = sctlib.extract_scts_np(data, length,
                                         issuer_key_hash=ikh)
            for j, i in enumerate(decoded_rows):
                if chk.mask[j]:
                    self.spool.file(
                        ders[j], index=start + i, log_url=log_url,
                        reasons=chk.reasons.get(j, []))
                    continue
                e = entries[i]
                ana.keep.append((e["leaf_input"],
                                 e.get("extra_data", "")))
                if int(ext.ok[j]) == 0:
                    ana.no_sct += 1
                    continue
                ana.sct_lanes += 1
                log_id = bytes(ext.log_id[j])
                ana.per_log[log_id.hex()] = (
                    ana.per_log.get(log_id.hex(), 0) + 1)
                verdict = self.log_list.route(
                    log_id, int(ext.timestamp_ms[j]))
                if not verdict.known:
                    ana.unknown_log += 1
                    metrics.incr_counter("audit", "unknown_log")
                else:
                    if verdict.retired:
                        ana.retired += 1
                        metrics.incr_counter("audit", "retired_sct")
                    if not verdict.in_interval:
                        ana.out_of_interval += 1
                        metrics.incr_counter("audit", "out_of_interval")
        return ana

    # -- full runs -------------------------------------------------------
    def run_pages(self, pages: Iterable[tuple[int, list]],
                  log_url: str = "audit-log", tile: int = 1,
                  ) -> AuditReport:
        """Audit pages ``(start_index, entries)``; each distinct page
        is pre-passed once and submitted ``tile`` times with shifted
        indices."""
        from ct_mapreduce_tpu_torch.ingest.sync import RawBatch

        t0 = time.monotonic()
        rep = AuditReport(tile=tile)
        analyses: list[tuple[int, PageAnalysis]] = []
        self._last_measured = False
        total_span = 0
        for start, entries in pages:
            ana = self.analyze_page(entries, start=start,
                                    log_url=log_url)
            analyses.append((start, ana))
            rep.pages += 1
            total_span = max(total_span, start + len(entries))
            for name in ("quarantined", "sct_lanes", "no_sct",
                         "decode_failed", "unknown_log", "retired",
                         "out_of_interval"):
                setattr(rep, name, getattr(rep, name) + getattr(ana, name))
            for k, v in ana.per_log.items():
                rep.per_log[k] = rep.per_log.get(k, 0) + v
        rep.divergence_measured = self._last_measured
        # The pre-pass tallies cover one tile; scale-out copies behave
        # identically by construction.
        for name in ("sct_lanes", "no_sct", "decode_failed",
                     "unknown_log", "retired", "out_of_interval"):
            setattr(rep, name, getattr(rep, name) * tile)
        rep.per_log = {k: v * tile for k, v in rep.per_log.items()}
        for t in range(tile):
            for start, ana in analyses:
                if not ana.keep:
                    continue
                lis, eds = zip(*ana.keep)
                self.sink.store_raw_batch(RawBatch(
                    list(lis), list(eds),
                    start + t * total_span, log_url))
                rep.entries += len(ana.keep)
        self.sink.flush()
        st = dict(self.sink.verifier.stats)
        rep.verified = int(st.get("verified", 0))
        rep.failed = int(st.get("failed", 0))
        rep.verifier_no_sct = int(st.get("no_sct", 0))
        rep.verifier_no_key = int(st.get("no_key", 0))
        rep.device_lanes = int(st.get("device_lanes", 0))
        rep.host_lanes = int(st.get("host_lanes", 0))
        rep.per_issuer = self.aggregator.verify_counts()
        rep.wall_s = time.monotonic() - t0
        metrics.incr_counter("audit", "entries",
                             value=float(rep.entries))
        metrics.incr_counter("audit", "verified",
                             value=float(rep.verified))
        metrics.incr_counter("audit", "failed",
                             value=float(rep.failed))
        return rep

    def run_recorded(self, path_or_doc, tile: int = 1) -> AuditReport:
        doc = (path_or_doc if isinstance(path_or_doc, dict)
               else load_recorded(path_or_doc))
        pages = [(int(p.get("start", 0)), p["entries"])
                 for p in doc["pages"]]
        return self.run_pages(pages, log_url=doc.get("log_url",
                                                     "recorded-shard"),
                              tile=tile)

    def run_live(self, log_url: str, start: int, end: int,
                 transport=None, page_size: int = 256) -> AuditReport:
        """Fetch ``[start, end]`` through the production transport
        (retry/backoff/window-clamp included) and audit the pages as
        they arrive. ``transport`` is injectable for tests; the
        default is real HTTP."""
        from ct_mapreduce_tpu_torch.ingest.ctclient import CTLogClient

        client = CTLogClient(log_url, transport=transport)

        def fetch():
            idx = start
            while idx <= end:
                got = client.get_raw_entries(
                    idx, min(end, idx + page_size - 1))
                if not got:
                    break
                yield idx, [{"leaf_input": e.leaf_input,
                             "extra_data": e.extra_data} for e in got]
                idx += len(got)

        return self.run_pages(fetch(), log_url=client.short_url)


def load_driver(log_list_path: Optional[str] = None,
                quarantine_dir: Optional[str] = None,
                **kwargs) -> AuditDriver:
    """Driver from resolved knobs: ``auditLogList`` names the log-list
    JSON (required — auditing without trust anchors is meaningless),
    ``auditQuarantineDir`` the spool (optional)."""
    from ct_mapreduce_tpu_torch import audit as auditpkg

    path, qdir = auditpkg.resolve_audit(log_list_path, quarantine_dir)
    if not path:
        raise ValueError(
            "no log list configured: pass auditLogList / set "
            "CTMR_AUDIT_LOG_LIST")
    return AuditDriver(loglistlib.load_log_list(path),
                       quarantine_dir=qdir, **kwargs)
