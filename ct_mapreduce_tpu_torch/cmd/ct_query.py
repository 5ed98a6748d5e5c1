"""ct-query: ask the live query plane whether a serial is known.

The client side of ``serve/server.py`` (``queryPort`` directive on a
running ``ct-fetch``): membership questions, per-issuer metadata, and
plane health, answered in milliseconds against the epoch-pinned view —
no snapshot drain, no Redis walk.

Usage:

    ct-query -addr :9090 -issuer <issuerID> -expDate 2031-06-15-14 \\
             -serial 4d0000002a
    ct-query -addr :9090 -issuerMeta <issuerID>
    ct-query -addr :9090 -health

Exit status: 0 when every queried serial is known (or the metadata /
health request succeeded), 1 when any serial is unknown, 2 on usage or
transport errors — scriptable like ``grep``.

A port of ``ct_mapreduce_tpu.cmd.ct_query`` on the port's ``serve.client``.
"""

from __future__ import annotations

import argparse
import json
import sys

from ct_mapreduce_tpu_torch.serve.client import QueryClient, QueryError


def main(argv: list[str] | None = None, out=None) -> int:
    parser = argparse.ArgumentParser(prog="ct-query")
    parser.add_argument("-addr", "--addr", required=True,
                        help="query plane address (host:port or :port)")
    parser.add_argument("-issuer", "--issuer", default="",
                        help="issuerID (base64url of SHA-256(SPKI))")
    parser.add_argument("-expDate", "--expDate", default="",
                        help="expiration bucket id, e.g. 2031-06-15-14")
    parser.add_argument("-serial", "--serial", action="append", default=[],
                        help="serial content bytes as hex (repeatable)")
    parser.add_argument("-issuerMeta", "--issuerMeta", default="",
                        help="fetch per-issuer metadata instead of querying")
    parser.add_argument("-health", "--health", action="store_true",
                        help="fetch query-plane health instead of querying")
    parser.add_argument("-timeoutMs", "--timeoutMs", type=int, default=0,
                        help="per-request deadline (0 = none)")
    args = parser.parse_args(argv)
    out = out or sys.stdout

    client = QueryClient(args.addr)
    try:
        if args.health:
            print(json.dumps(client.healthz(), indent=2), file=out)
            return 0
        if args.issuerMeta:
            print(json.dumps(client.issuer(args.issuerMeta), indent=2),
                  file=out)
            return 0
        if not (args.issuer and args.expDate and args.serial):
            parser.print_usage(sys.stderr)
            print("error: -issuer, -expDate and -serial are required "
                  "(or use -issuerMeta / -health)", file=sys.stderr)
            return 2
        queries = [{"issuer": args.issuer, "expDate": args.expDate,
                    "serial": s} for s in args.serial]
        resp = client.query(
            queries, timeout_ms=args.timeoutMs or None)
        print(json.dumps(resp, indent=2), file=out)
        return 0 if all(r["known"] for r in resp["results"]) else 1
    except QueryError as err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    except OSError as err:
        print(f"error: query plane unreachable at {client.base_url}: {err}",
              file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
