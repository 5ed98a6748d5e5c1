"""Real-log audit subsystem (a port of ``ct_mapreduce_tpu.audit``).

The reference's whole job is fetching and checking *real* CT logs;
this package turns the port into an auditor:

- :mod:`~ct_mapreduce_tpu_torch.audit.loglist` — the production
  Google/Apple log-list v3 JSON schema loaded into the verify lane's
  :class:`~ct_mapreduce_tpu_torch.verify.lane.LogKeyRegistry`
  (log_id = SHA-256(SPKI) enforced loudly, operator + state +
  temporal-shard intervals carried per entry) with temporal-shard
  routing: an SCT is checked against the shard that was accepting at
  its timestamp.
- :mod:`~ct_mapreduce_tpu_torch.audit.quarantine` — the durable quarantine
  spool: any lane where the native extractor and the
  python mirror disagree on parse or verdict inputs routes here
  instead of the aggregate, so a divergent cert can never silently
  alter counts.
- :mod:`~ct_mapreduce_tpu_torch.audit.driver` — the recorded-shard audit
  pipeline: real-wire ``get-entries`` pages (checked-in compressed
  fixture, or ``--live`` over the existing transport) through
  decode → RFC 6962 TBS-reconstructed verify → aggregate → filter,
  per-issuer verified/failed counts into statistics/serve/checkpoints.
  The sink runs on the aggregator's device: on the card the walker K3,
  the fingerprint K1 and the ECDSA verify K6.

Knobs ride the platformProfile ladder as the ``knobs.audit`` section
(explicit directive > ``CTMR_*`` env > profile > default), consistent
with every other subsystem; ``auditLogList`` and ``auditQuarantineDir``
are the directives.
"""

from __future__ import annotations

from typing import Optional

from ct_mapreduce_tpu_torch.config import profile as platprofile

_AUDIT_KNOBS = (
    # Identity/policy knobs — never swept (tune/registry.py EXCLUDED).
    platprofile.Knob("auditLogList", "CTMR_AUDIT_LOG_LIST", "",
                     parse=str, is_set=platprofile.nonempty_str),
    platprofile.Knob("auditQuarantineDir", "CTMR_AUDIT_QUARANTINE_DIR",
                     "", parse=str, is_set=platprofile.nonempty_str),
)


def resolve_audit(log_list: Optional[str] = None,
                  quarantine_dir: Optional[str] = None,
                  ) -> tuple[str, str]:
    """Resolve the audit knobs through the shared platformProfile
    ladder: explicit value (config directive / kwarg) >
    ``CTMR_AUDIT_LOG_LIST`` / ``CTMR_AUDIT_QUARANTINE_DIR`` env >
    profile ``knobs.audit`` > defaults (no pinned log list; no
    durable quarantine spool — divergent lanes are still excluded
    from aggregates, just not persisted)."""
    r = platprofile.resolve_section("audit", _AUDIT_KNOBS, {
        "auditLogList": log_list or "",
        "auditQuarantineDir": quarantine_dir or "",
    })
    return r["auditLogList"], r["auditQuarantineDir"]
