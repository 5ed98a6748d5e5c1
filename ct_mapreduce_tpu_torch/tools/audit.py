"""ct-audit on the port: the real-log audit pipeline (a port of the JAX
repo's ``tools/audit.py``).

Recorded mode replays a ``CTMRAU01`` shard through decode → RFC 6962
TBS-reconstructed verify → aggregate, with the native/mirror quarantine
lane in front; ``--live`` fetches the range from a log over the
production transport instead. The aggregator and the sink run on the
card (K3, K1 and K6) unless ``-device cpu`` asks for the plain PyTorch
path.

    python -m ct_mapreduce_tpu_torch.tools.audit \\
        --recorded tests/data/recorded_shard.json.gz [--tile 128]
    python -m ct_mapreduce_tpu_torch.tools.audit --live <log url> \\
        --log-list list.json --start 0 --end 9999
    ... --json --quarantine-dir <dir> --emit-filter <path> -device cpu

``--log-list`` (or ``CTMR_AUDIT_LOG_LIST`` / profile ``knobs.audit``)
names a log-list v3 JSON; recorded shards may embed their own, used
when no explicit list is given. Exit 0 on a clean run, 1 when any lane
was quarantined (counts are still correct — quarantined lanes are
excluded — but the divergence needs a human).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None, device=None) -> int:
    """Run the audit. ``device`` (or ``-device``) is where the
    aggregator and the verify lane run; CUDA when neither names one."""
    from ct_mapreduce_tpu_torch.cmd.ct_fetch import _pop_device

    argv = sys.argv[1:] if argv is None else list(argv)
    argv, flag_device = _pop_device(argv)
    device = device or flag_device or None
    ap = argparse.ArgumentParser(
        prog="ct-audit-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--recorded", help="CTMRAU01 recorded-shard path")
    ap.add_argument("--tile", type=int, default=1,
                    help="resubmit the recorded pages N times "
                         "(shifted indices) for scale runs")
    ap.add_argument("--live", metavar="LOG_URL",
                    help="fetch from a live log instead")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=999)
    ap.add_argument("--log-list", default=None,
                    help="log-list v3 JSON path (default: resolved "
                         "auditLogList knob, else the recorded "
                         "shard's embedded list)")
    ap.add_argument("--quarantine-dir", default=None,
                    help="durable divergence spool (default: resolved "
                         "auditQuarantineDir knob; empty = in-memory)")
    ap.add_argument("--flush-size", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--state", default=None,
                    help="save the aggregation checkpoint here after "
                         "the run (statistics/serve load it)")
    ap.add_argument("--emit-filter", default=None, metavar="PATH",
                    help="compile the audited corpus into a filter "
                         "artifact at PATH (written at checkpoint "
                         "time; implies --state PATH.state.npz)")
    ap.add_argument("--filter-fp", type=float, default=0.01)
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    args = ap.parse_args(argv)

    if bool(args.recorded) == bool(args.live):
        ap.error("exactly one of --recorded / --live is required")

    from ct_mapreduce_tpu_torch import audit as auditpkg
    from ct_mapreduce_tpu_torch.audit import driver as drvlib
    from ct_mapreduce_tpu_torch.audit import loglist as loglistlib

    list_path, qdir = auditpkg.resolve_audit(args.log_list,
                                             args.quarantine_dir)
    doc = drvlib.load_recorded(args.recorded) if args.recorded else None
    if list_path:
        log_list = loglistlib.load_log_list(list_path)
    elif doc is not None and doc.get("log_list"):
        log_list = loglistlib.parse_log_list(doc["log_list"])
    else:
        ap.error("no log list: pass --log-list, set "
                 "CTMR_AUDIT_LOG_LIST, or use a recorded shard that "
                 "embeds one")

    drv = drvlib.AuditDriver(
        log_list, quarantine_dir=qdir,
        flush_size=args.flush_size, batch_size=args.batch_size,
        filter_path=args.emit_filter or "",
        filter_fp=args.filter_fp, device=device)
    if args.recorded:
        rep = drv.run_recorded(doc, tile=args.tile)
    else:
        rep = drv.run_live(args.live, args.start, args.end)

    state_path = args.state or (
        args.emit_filter + ".state.npz" if args.emit_filter else None)
    if state_path:
        drv.aggregator.save_checkpoint(state_path)

    if args.json:
        json.dump(rep.to_json(), sys.stdout, indent=1, sort_keys=True)
        print()
    else:
        r = rep
        print(f"audited {r.entries} entries ({r.pages} pages x "
              f"tile {r.tile}) in {r.wall_s:.1f}s")
        print(f"  verified {r.verified}  failed {r.failed}  "
              f"no-sct {r.verifier_no_sct}  no-key {r.verifier_no_key}")
        print(f"  device lanes {r.device_lanes}  host lanes "
              f"{r.host_lanes}")
        print(f"  flagged: retired {r.retired}  out-of-interval "
              f"{r.out_of_interval}  unknown-log {r.unknown_log}")
        div = ("measured" if r.divergence_measured
               else "NOT MEASURED (no native extractor)")
        print(f"  quarantined {r.quarantined} (divergence {div})")
        print("  per-issuer verified/failed:")
        for iss, (v, f) in sorted(rep.per_issuer.items()):
            print(f"    {iss}: {v}/{f}")
    return 1 if rep.quarantined else 0


if __name__ == "__main__":
    sys.exit(main())
