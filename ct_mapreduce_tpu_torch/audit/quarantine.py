"""Divergence quarantine lane (a port of
``ct_mapreduce_tpu.audit.quarantine``).

The standing differential harness (:mod:`ct_mapreduce_tpu_torch.core.
divergence`) classifies native-vs-mirror disagreement; this module is
the lane that makes disagreement SAFE. Before an audit batch reaches
the verify lane, the native sidecar extractor
(:func:`ct_mapreduce_tpu_torch.native.leafpack.extract_scts`) and the pure
Python mirror (:func:`ct_mapreduce_tpu_torch.verify.sct.extract_scts_np`)
both run over the same rows; any lane where ANY extraction field
differs — the ok verdict, the RFC 6962 digest, log id, timestamp,
signature words, algorithm bytes — is:

1. excluded from the batch handed to the verifier/aggregator (the
   cert cannot alter aggregate counts in either direction), and
2. filed into a durable spool (``auditQuarantineDir``) as DER + a
   JSON sidecar naming the disagreeing fields, so the offending bytes
   survive for the differential harness to reduce.

The exclusion property is the contract: aggregate results must be
IDENTICAL whether the spool is replayed or dropped — quarantine is a
side-channel, never a third verdict. ``audit.quarantined`` counts
every filed lane.

When the native extractor is unavailable there is nothing to
disagree with: the mask is all-false and ``measured`` is False, so
callers can surface "divergence not measured" instead of a vacuous
zero.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ct_mapreduce_tpu_torch.telemetry import metrics

SPOOL_FORMAT = "CTMRQR01"

# SctBatch surface compared lane-wise; a mismatch in any is divergence.
_FIELDS = ("ok", "digest", "log_id", "timestamp_ms", "r", "s",
           "hash_alg", "sig_alg")


@dataclass
class DivergenceCheck:
    """One batch's native-vs-mirror comparison."""

    mask: np.ndarray  # bool[n] — True = lane diverged
    reasons: dict[int, list[str]]  # lane -> disagreeing field names
    measured: bool  # False when the native extractor is absent

    @property
    def count(self) -> int:
        return int(self.mask.sum())


def compare_extractions(native, mirror) -> DivergenceCheck:
    """Lane-wise field diff of two :class:`~ct_mapreduce_tpu_torch.verify.
    sct.SctBatch` extractions of the same rows."""
    n = native.ok.shape[0]
    mask = np.zeros((n,), bool)
    per_field: dict[str, np.ndarray] = {}
    for name in _FIELDS:
        a = np.asarray(getattr(native, name))
        b = np.asarray(getattr(mirror, name))
        diff = (a != b)
        if diff.ndim > 1:
            diff = diff.any(axis=tuple(range(1, diff.ndim)))
        per_field[name] = diff
        mask |= diff
    reasons = {
        int(i): [f for f in _FIELDS if per_field[f][i]]
        for i in np.flatnonzero(mask)
    }
    return DivergenceCheck(mask=mask, reasons=reasons, measured=True)


def check_batch(data: np.ndarray, length: np.ndarray,
                issuer_key_hash: Optional[np.ndarray] = None,
                ) -> DivergenceCheck:
    """Run both extractors over packed rows and diff them. ``data`` is
    uint8[n, pad], ``length`` int32[n], ``issuer_key_hash`` optional
    uint8[n, 32] (the per-lane RFC 6962 ikh both sides must agree
    under)."""
    from ct_mapreduce_tpu_torch.verify import sct as sctlib

    n = data.shape[0]
    try:
        import os as _os

        from ct_mapreduce_tpu_torch.native import leafpack
        from ct_mapreduce_tpu_torch.native import load as load_native

        lib = (None if _os.environ.get("CTMR_NATIVE", "1") == "0"
               else load_native())
        native_ok = lib is not None
    except Exception:
        native_ok = False
    if not native_ok:
        return DivergenceCheck(mask=np.zeros((n,), bool), reasons={},
                               measured=False)
    native = leafpack.extract_scts(data, length,
                                   issuer_key_hash=issuer_key_hash)
    mirror = sctlib.extract_scts_np(data, length,
                                    issuer_key_hash=issuer_key_hash)
    return compare_extractions(native, mirror)


class QuarantineSpool:
    """Durable spool of diverged lanes.

    ``directory`` empty → in-memory only: lanes are still counted and
    excluded, nothing persists (the default posture when
    ``auditQuarantineDir`` is unset). With a directory, each lane is
    written tmp+rename as ``<sha256[:24]>.json`` carrying the DER
    (hex), its provenance, and the disagreeing fields; re-filing the
    same DER bytes overwrites the same name (the spool dedups by
    content, counts count filings)."""

    def __init__(self, directory: str = ""):
        self.directory = directory
        self.count = 0
        self.records: list[dict] = []
        if directory:
            os.makedirs(directory, exist_ok=True)

    def file(self, der: bytes, *, index: int = -1, log_url: str = "",
             reasons: Optional[list[str]] = None) -> dict:
        rec = {
            "format": SPOOL_FORMAT,
            "sha256": hashlib.sha256(der).hexdigest(),
            "index": index,
            "logUrl": log_url,
            "reasons": list(reasons or []),
            "der": der.hex(),
        }
        self.count += 1
        self.records.append(rec)
        metrics.incr_counter("audit", "quarantined")
        if self.directory:
            name = rec["sha256"][:24] + ".json"
            fd, tmp = tempfile.mkstemp(prefix=name + ".tmp.",
                                       dir=self.directory)
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as fh:
                    json.dump(rec, fh, indent=1, sort_keys=True)
                    fh.write("\n")
                os.replace(tmp, os.path.join(self.directory, name))
            except BaseException:
                import contextlib
                with contextlib.suppress(OSError):
                    os.unlink(tmp)
                raise
        return rec

    def replay(self) -> list[dict]:
        """Load every spooled record from disk (or the in-memory list
        when no directory is configured) — the harness's feed and the
        exclusion-property test's evidence."""
        if not self.directory:
            return list(self.records)
        out = []
        for name in sorted(os.listdir(self.directory)):
            if not name.endswith(".json"):
                continue
            with open(os.path.join(self.directory, name),
                      encoding="utf-8") as fh:
                rec = json.load(fh)
            if rec.get("format") != SPOOL_FORMAT:
                raise ValueError(
                    f"unknown quarantine record format in {name}: "
                    f"{rec.get('format')!r}")
            out.append(rec)
        return out

    def replay_ders(self) -> list[bytes]:
        return [bytes.fromhex(r["der"]) for r in self.replay()]
