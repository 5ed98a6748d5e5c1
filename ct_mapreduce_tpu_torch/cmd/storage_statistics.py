"""storage-statistics: the reduce-side report (a port of
``ct_mapreduce_tpu.cmd.storage_statistics``).

Reference (reference cmd/storage-statistics/storage-statistics.go:22-100):
enumerate issuers×dates from the cache keyspace, print per-issuer serial
counts, CRL counts, DN counts, overall totals, then per-log checkpoint
states. Verbosity tiers: -v 1 adds per-expDate serial counts, -v 2 adds
the serial list, -v 3 dumps PEMs from the backend. ``-json`` prints the
same numbers as one document.

``backend = tpu`` drains the aggregate checkpoint written by ct-fetch
(``aggStatePath``, ck01 or a ck02 chain, either package's) instead of
walking a Redis keyspace — same report, no per-key round trips. That
report runs on the CPU by design, as the JAX package's does: it reads
the checkpoint through ``TorchAggregator(device="cpu")`` and
``agg/merge.py``, so it needs no card and runs while one is busy or
absent. The CPU here is this report's chosen device, not a fallback.
"""

from __future__ import annotations

import sys
from typing import Optional

from ct_mapreduce_tpu_torch.config import CTConfig
from ct_mapreduce_tpu_torch.engine import get_configured_storage, prepare_telemetry


def _load_tpu_aggregate(config: CTConfig):
    """``aggStatePath`` → an aggregate view, or None when nothing is
    there. One path loads into a CPU aggregator; several (comma list
    and/or glob — a fleet's per-worker ``agg.w*.npz`` checkpoints) fold
    into a :class:`~ct_mapreduce_tpu_torch.agg.merge.MergedAggregate`,
    so one storage-statistics run reports the whole fleet."""
    import os

    from ct_mapreduce_tpu_torch.agg import merge

    paths = merge.expand_state_paths(config.agg_state_path)
    if not paths or any(not os.path.exists(p) for p in paths):
        return None
    if len(paths) == 1:
        agg = merge.SnapshotReader()
        agg.load_checkpoint(paths[0])
        return agg
    return merge.load_checkpoints(paths)


def report_from_tpu_snapshot(config: CTConfig, out, verbosity: int = 0) -> int:
    """Drain path: aggregate snapshot → the same report shape.

    Verbosity parity with the database walk
    (reference cmd/storage-statistics/storage-statistics.go:28-99):
    -v 1 per-expDate counts; -v 2 additionally lists the serials that
    exist host-side — the exact host-lane serials carried in the
    snapshot, plus the PEM-tree filenames when ``certPath`` was set
    (the tree is keyed ``<exp>/<issuer>/<serialID>``,
    reference storage/localdiskbackend.go:194-199); -v 3 dumps
    those PEMs. Device-lane serials live in the dedup table as
    128-bit fingerprints + packed (issuer, hour) meta — count-exact
    but not serial-listable BY DESIGN (SURVEY §7 layer 2c); without a
    certPath tree they are reported as counts only.
    """
    from ct_mapreduce_tpu_torch.core.types import ExpDate, Serial

    # A CPU reader: the report is pure host work, so it allocates no
    # device memory and waits on no card. A multi-path aggStatePath
    # (fleet) folds per-worker checkpoints into one view.
    agg = _load_tpu_aggregate(config)
    if agg is None:
        print(
            f"error: aggStatePath not found: {config.agg_state_path!r} "
            "(run ct-fetch with backend=tpu first)",
            file=out,
        )
        return 1
    snap = agg.drain()

    backend = None
    if config.cert_path:
        from ct_mapreduce_tpu_torch.storage.localdisk import LocalDiskBackend

        backend = LocalDiskBackend(config.cert_path)

    # Regroup (issuer, expdate) → issuer.
    by_issuer: dict[str, dict[str, int]] = {}
    for (iss, exp), count in snap.counts.items():
        by_issuer.setdefault(iss, {})[exp] = count

    # Host-lane serial lists by (issuerID, expDateID): the exact-lane
    # component of each count, listable without any backend. Only built
    # when the verbosity will print it — the default report must not
    # pay an O(n log n) sort over millions of host-lane serials.
    host_lists: dict[tuple[str, str], list] = {}
    if verbosity >= 2:
        for (idx, eh), serials in agg.host_serials.items():
            if not serials:
                continue
            key = (agg.registry.issuer_at(idx).id(),
                   ExpDate.from_unix_hour(eh).id())
            host_lists[key] = sorted((Serial(s) for s in serials),
                                     key=lambda s: s.id())

    def listable_serials(iss: str, exp: str):
        """Serial objects visible host-side for one (issuer, expDate):
        host-lane snapshot serials + PEM-tree entries (deduped)."""
        merged = {s.id(): s for s in host_lists.get((iss, exp), [])}
        if backend is not None:
            idx = agg.registry.index_of_issuer_id(iss)
            if idx is not None:
                exp_date = ExpDate.parse(exp)
                for s in backend.list_serials_for_expiration_date_and_issuer(
                    exp_date, agg.registry.issuer_at(idx)
                ):
                    merged.setdefault(s.id(), s)
        return [merged[k] for k in sorted(merged)]

    total_serials = 0
    total_crls = 0
    for iss in snap.issuers():
        dates = by_issuer.get(iss, {})
        crls = sorted(snap.crls.get(iss, ()))
        dns = sorted(snap.dns.get(iss, ()))
        total_crls += len(crls)
        issuer_serials = sum(dates.values())
        total_serials += issuer_serials
        print(f"Issuer: {iss} ({dns})", file=out)
        idx = agg.registry.index_of_issuer_id(iss) if verbosity >= 2 else None
        for exp in sorted(dates):
            if verbosity >= 1:
                print(f"- {exp} ({dates[exp]} serials)", file=out)
            if verbosity >= 2:
                serial_objs = listable_serials(iss, exp)
                print(f"  Serials: {[s.id() for s in serial_objs]}", file=out)
                if len(serial_objs) < dates[exp]:
                    print(
                        f"  ({dates[exp] - len(serial_objs)} device-lane "
                        "serials are count-only; set certPath during "
                        "ct-fetch to retain listable PEMs)",
                        file=out,
                    )
                if verbosity >= 3:
                    exp_date = ExpDate.parse(exp)
                    for serial in serial_objs:
                        print(
                            f"Certificate serial={{{serial.hex_string()}}} / "
                            f"{{{serial.id()}}}",
                            file=out,
                        )
                        if backend is None or idx is None:
                            continue
                        try:
                            pem = backend.load_certificate_pem(
                                serial, exp_date,
                                agg.registry.issuer_at(idx),
                            )
                            out.write(pem if isinstance(pem, str)
                                      else pem.decode())
                        except Exception as err:
                            print(f"error: {err}", file=out)
        tail = ""
        if iss in snap.verified or iss in snap.failed:
            tail = (f", {snap.verified.get(iss, 0)} scts verified, "
                    f"{snap.failed.get(iss, 0)} scts failed")
        print(
            f" --> {len(dates)} hours, {issuer_serials} serials known, "
            f"{len(crls)} crls known, {len(dns)} issuerDNs known{tail}",
            file=out,
        )
    verify_tail = ""
    if snap.verified or snap.failed:
        verify_tail = (f", {sum(snap.verified.values())} scts verified, "
                       f"{sum(snap.failed.values())} scts failed")
    print(
        f"overall totals: {len(snap.issuers())} issuers, "
        f"{total_serials} serials, {total_crls} crls{verify_tail}",
        file=out,
    )
    # Per-log checkpoint states print in device mode too: ct-fetch
    # dual-writes the cursor through the same database facade
    # regardless of backend, so the walk is identical to database mode
    # (storage-statistics.go:86-98).
    database, _cache, _backend = get_configured_storage(config)
    print_log_status(config, database, out)
    return 0


def print_log_status(config: CTConfig, database, out) -> None:
    """The "Log status:" section, shared by both report paths
    (reference cmd/storage-statistics/storage-statistics.go:86-98).

    Headers print unconditionally; the URL walk is gated on the
    reference's string-length quirk (:86-90).
    """
    from ct_mapreduce_tpu_torch.ingest.ctclient import short_url

    print("", file=out)
    print("Log status:", file=out)
    if config.log_url_list and len(config.log_url_list) > 5:
        for url in config.log_urls():
            state = database.get_log_state(short_url(url))
            print(str(state), file=out)


def _log_status_lines(config: CTConfig, database) -> list[str]:
    """The "Log status:" walk as data (shared by text and JSON modes;
    same string-length gate as the reference, :86-90)."""
    from ct_mapreduce_tpu_torch.ingest.ctclient import short_url

    lines = []
    if config.log_url_list and len(config.log_url_list) > 5:
        for url in config.log_urls():
            lines.append(str(database.get_log_state(short_url(url))))
    return lines


def collect_tpu_report(config: CTConfig) -> Optional[dict]:
    """Machine-readable form of :func:`report_from_tpu_snapshot` —
    the same drain, the same numbers, as a JSON-serializable dict
    (text/JSON parity is pinned by tests/test_cmd.py). Returns None
    when the snapshot is missing (the text path's error case)."""
    agg = _load_tpu_aggregate(config)
    if agg is None:
        return None
    snap = agg.drain()

    by_issuer: dict[str, dict[str, int]] = {}
    for (iss, exp), count in snap.counts.items():
        by_issuer.setdefault(iss, {})[exp] = count

    issuers = []
    total_serials = 0
    total_crls = 0
    for iss in snap.issuers():
        dates = by_issuer.get(iss, {})
        crls = sorted(snap.crls.get(iss, ()))
        dns = sorted(snap.dns.get(iss, ()))
        n = sum(dates.values())
        total_serials += n
        total_crls += len(crls)
        row = {
            "id": iss,
            "dns": dns,
            "crls": crls,
            "serials": n,
            "expDates": {exp: dates[exp] for exp in sorted(dates)},
        }
        if iss in snap.verified or iss in snap.failed:
            row["sctsVerified"] = snap.verified.get(iss, 0)
            row["sctsFailed"] = snap.failed.get(iss, 0)
        issuers.append(row)
    database, _cache, _backend = get_configured_storage(config)
    totals = {
        "issuers": len(issuers),
        "serials": total_serials,
        "crls": total_crls,
    }
    if snap.verified or snap.failed:
        # Verify totals appear only when the lane ran — older
        # consumers (and verifySignatures=off runs) see the exact same
        # document, keeping the text/JSON parity pin byte-stable.
        totals["sctsVerified"] = sum(snap.verified.values())
        totals["sctsFailed"] = sum(snap.failed.values())
    return {
        "issuers": issuers,
        "totals": totals,
        "logStatus": _log_status_lines(config, database),
    }


def collect_database_report(config: CTConfig) -> dict:
    """Machine-readable form of :func:`report_from_database` (cache
    walk), same shape as :func:`collect_tpu_report`."""
    database, _cache, _backend = get_configured_storage(config)
    issuers = []
    total_serials = 0
    total_crls = 0
    for issuer_obj in database.get_issuer_and_dates_from_cache():
        meta = database.get_issuer_metadata(issuer_obj.issuer)
        crls = sorted(meta.crls())
        dns = sorted(meta.issuers())
        exp_counts = {}
        for exp_date in issuer_obj.exp_dates:
            known = database.get_known_certificates(
                exp_date, issuer_obj.issuer)
            exp_counts[exp_date.id()] = known.count()
        n = sum(exp_counts.values())
        total_serials += n
        total_crls += len(crls)
        issuers.append({
            "id": issuer_obj.issuer.id(),
            "dns": dns,
            "crls": crls,
            "serials": n,
            "expDates": {exp: exp_counts[exp] for exp in sorted(exp_counts)},
        })
    return {
        "issuers": issuers,
        "totals": {
            "issuers": len(issuers),
            "serials": total_serials,
            "crls": total_crls,
        },
        "logStatus": _log_status_lines(config, database),
    }


def report_json(config: CTConfig, out) -> int:
    """``--json``: the report as one machine-readable document."""
    import json

    if config.backend == "tpu":
        report = collect_tpu_report(config)
        if report is None:
            print(
                json.dumps({"error": "aggStatePath not found: "
                            f"{config.agg_state_path!r}"}),
                file=out,
            )
            return 1
    else:
        report = collect_database_report(config)
    json.dump(report, out, indent=2)
    print(file=out)
    return 0


def report_from_database(config: CTConfig, out, verbosity: int = 0) -> int:
    """Cache-walk path (reference parity)."""
    database, _cache, backend = get_configured_storage(config)
    issuer_list = database.get_issuer_and_dates_from_cache()

    total_serials = 0
    total_crls = 0
    for issuer_obj in issuer_list:
        meta = database.get_issuer_metadata(issuer_obj.issuer)
        crl_list = meta.crls()
        total_crls += len(crl_list)
        dn_list = meta.issuers()
        count_issuer_serials = 0
        print(f"Issuer: {issuer_obj.issuer.id()} ({sorted(dn_list)})", file=out)
        for exp_date in issuer_obj.exp_dates:
            known = database.get_known_certificates(exp_date, issuer_obj.issuer)
            count = known.count()
            count_issuer_serials += count
            total_serials += count
            if verbosity >= 1:
                print(f"- {exp_date.id()} ({count} serials)", file=out)
            if verbosity >= 2:
                known_list = known.known()
                print(f"  Serials: {[s.id() for s in known_list]}", file=out)
                if verbosity >= 3:
                    for serial in known_list:
                        print(
                            f"Certificate serial={{{serial.hex_string()}}} / "
                            f"{{{serial.id()}}}",
                            file=out,
                        )
                        try:
                            pem = backend.load_certificate_pem(
                                serial, exp_date, issuer_obj.issuer
                            )
                            out.write(pem if isinstance(pem, str)
                                      else pem.decode())
                        except Exception as err:
                            print(f"error: {err}", file=out)
        print(
            f" --> {len(issuer_obj.exp_dates)} hours, "
            f"{count_issuer_serials} serials known, "
            f"{len(crl_list)} crls known, {len(dn_list)} issuerDNs known",
            file=out,
        )
    print(
        f"overall totals: {len(issuer_list)} issuers, {total_serials} serials, "
        f"{total_crls} crls",
        file=out,
    )

    print_log_status(config, database, out)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # -json rides outside CTConfig (an output-format flag, not a
    # directive); strip it before the config parser sees the rest.
    json_mode = any(a in ("-json", "--json") for a in argv)
    argv = [a for a in argv if a not in ("-json", "--json")]
    config = CTConfig.load(argv)
    prepare_telemetry("storage-statistics", config)
    if json_mode:
        return report_json(config, sys.stdout)
    if config.backend == "tpu":
        return report_from_tpu_snapshot(config, sys.stdout, config.verbosity)
    return report_from_database(config, sys.stdout, config.verbosity)


if __name__ == "__main__":
    sys.exit(main())
