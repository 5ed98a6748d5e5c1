"""ct-getcert: fetch one CT entry by index and print its PEM.

Reference: cmd/ct-getcert/ct-getcert.go:16-57 of the reference — flags
-log and -index, GetRawEntries(index, index), tolerate non-fatal parse
issues, PEM to stdout.

When a query plane is running (`queryPort` on ct-fetch), the fetch
routes through its ``/getcert`` proxy instead of hitting the log
directly — the serving plane already holds log credentials and rate
budgets, so edge clients need no log access of their own. Configure
via ``-queryAddr host:port`` or a ``-config`` ini whose ``queryPort``
is set (the plane is assumed local then). An unreachable plane falls
back to the direct transport, loudly.

A port of ``ct_mapreduce_tpu.cmd.ct_getcert`` on the port's log client,
leaf decoder and ``serve.client``.
"""

from __future__ import annotations

import argparse
import sys

from ct_mapreduce_tpu_torch.core.der import der_to_pem
from ct_mapreduce_tpu_torch.ingest.ctclient import CTLogClient
from ct_mapreduce_tpu_torch.ingest.leaf import LeafDecodeError, decode_json_entry


def _query_addr(args) -> str:
    """Resolve the query-plane address: explicit flag first, then the
    config's queryPort (flag precedence mirrors CTConfig layering)."""
    if args.queryAddr:
        return args.queryAddr
    if args.config:
        from ct_mapreduce_tpu_torch.config import CTConfig

        cfg = CTConfig.load(["-config", args.config])
        if cfg.query_port:
            return f"127.0.0.1:{cfg.query_port}"
    return ""


def main(argv: list[str] | None = None, transport=None, out=None) -> int:
    parser = argparse.ArgumentParser(prog="ct-getcert")
    parser.add_argument("-log", "--log", required=True, help="log URL")
    parser.add_argument("-index", "--index", type=int, default=0, help="index")
    parser.add_argument("-queryAddr", "--queryAddr", default="",
                        help="query-plane address (host:port); fetch via "
                        "its /getcert proxy instead of the log")
    parser.add_argument("-config", "--config", default="",
                        help="ini whose queryPort selects a local query "
                        "plane")
    args = parser.parse_args(argv)
    out = out or sys.stdout

    addr = _query_addr(args)
    if addr:
        from ct_mapreduce_tpu_torch.serve.client import QueryClient, QueryError

        try:
            pem = QueryClient(addr).getcert(args.log, args.index)
            out.write(pem)
            return 0
        except QueryError as err:
            # The plane answered: its error is authoritative (the log
            # itself failed or has no such entry) — don't double-fetch.
            print(f"[{args.log}] query plane: {err}", file=sys.stderr)
            return 1
        except OSError as err:
            print(
                f"query plane unreachable at {addr} ({err}); "
                "falling back to direct log fetch",
                file=sys.stderr,
            )

    client = CTLogClient(args.log, transport=transport)
    entries = client.get_raw_entries(args.index, args.index)
    if not entries:
        print(f"[{args.log}] no entry at index {args.index}", file=sys.stderr)
        return 1
    for raw in entries:
        try:
            entry = decode_json_entry(
                raw.index,
                {"leaf_input": raw.leaf_input, "extra_data": raw.extra_data},
            )
        except LeafDecodeError as err:
            print(
                f"Erroneous certificate: log={args.log} index={raw.index} "
                f"err={err}",
                file=sys.stderr,
            )
            continue
        pem = der_to_pem(entry.cert_der)
        out.write(pem.decode() if isinstance(pem, bytes) else pem)
    return 0


if __name__ == "__main__":
    sys.exit(main())
