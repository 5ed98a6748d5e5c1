"""ct-filter: build, inspect and query filter artifacts offline from
aggregate checkpoints (a port of ``ct_mapreduce_tpu.cmd.ct_filter``).

    ct-filter-torch build -state agg.npz[,agg.w*.npz] -out run.filter \\
              [-fpRate 0.01] [-format fl01|fl02] [-allowPartial] \\
              [-device cpu]
    ct-filter-torch inspect -artifact run.filter [-json]
    ct-filter-torch query -artifact run.filter -issuer <issuerID> \\
              -expDate 2031-06-15-14 -serial 4d0000002a [-serial ...]
    ct-filter-torch delta -base e1.filter -target e2.filter \\
              -out e1-e2.delta [-fromEpoch 1 -toEpoch 2]
    ct-filter-torch apply -base e1.filter -delta e1-e2.delta \\
              [-delta ...] -out replayed.filter
    ct-filter-torch container -artifact run.filter -kind mlbf|clubcard \\
              -out run.mlbf

``build`` folds one or many checkpoints (comma list and globs, the
``aggStatePath`` spelling) through the port's merge (:mod:`..agg.merge`)
and compiles the merged capture on the card (K1 and K5), or on the CPU
with ``-device cpu``; a single snapshot and a whole fleet's worth
compile to the same bytes, and to the JAX package's. Checkpoints written
with ``emitFilter`` off carry no serial bytes for their device lanes and
are refused unless ``-allowPartial`` accepts a filter over the capturing
subset. ``-format`` picks ``fl02`` (the default) or ``fl01``.

``delta`` computes the stash/diff between two epochs' artifacts
(``CTMRDL01`` or ``CTMRDL02``, following the endpoints' format; mixed
endpoints are refused); ``apply`` replays one or more delta links
(bundles split automatically) and writes bytes equal to the full build
or exits 2; ``container`` re-encodes an artifact as an ``mlbf`` or
``clubcard`` container. The three are host code (:mod:`..distrib`) and
write the JAX package's bytes.

Exit status: ``build``/``inspect`` 0 on success; ``query`` 0 when every
serial is known, 1 when any is unknown; 2 on usage and format errors.
"""

from __future__ import annotations

import argparse
import json
import sys


def _build(args, out, device) -> int:
    from ct_mapreduce_tpu_torch.agg import merge
    from ct_mapreduce_tpu_torch.filter import build_from_merged, write_artifact

    paths = merge.expand_state_paths(args.state)
    if not paths:
        print(f"error: no checkpoints match {args.state!r}", file=sys.stderr)
        return 2
    try:
        merged = merge.load_checkpoints(paths)
    except FileNotFoundError as err:
        print(f"error: checkpoint not found: {err}", file=sys.stderr)
        return 2
    try:
        art = build_from_merged(merged, fp_rate=args.fpRate,
                                allow_partial=args.allowPartial,
                                fmt=args.format or None, device=device)
    except ValueError as err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    blob = art.to_bytes()
    write_artifact(args.out, blob)
    print(json.dumps({
        "out": args.out,
        "bytes": len(blob),
        "checkpoints": paths,
        "format": art.fmt,
        "serials": art.n_serials,
        "groups": len(art.groups),
        "max_layers": art.max_layers(),
        "bits_per_entry": round(art.bits_per_entry(), 3),
        "fp_rate": art.fp_rate,
    }, indent=2), file=out)
    return 0


def _inspect(args, out) -> int:
    from ct_mapreduce_tpu_torch.filter import read_artifact

    art = read_artifact(args.artifact)
    groups = [
        {
            "issuer": g.issuer,
            "expDate": g.exp_id,
            "serials": g.n,
            "layers": [{"m": lyr.m, "k": lyr.k} for lyr in g.cascade.layers],
            "bits_per_entry": round(g.cascade.bits_per_entry(), 3),
        }
        for _, g in sorted(art.groups.items())
    ]
    body = {
        "format": art.fmt,
        "fp_rate": art.fp_rate,
        "serials": art.n_serials,
        "groups": len(groups),
        "max_layers": art.max_layers(),
        "bits_per_entry": round(art.bits_per_entry(), 3),
    }
    if args.json:
        body["group_detail"] = groups
        print(json.dumps(body, indent=2), file=out)
        return 0
    print(json.dumps(body, indent=2), file=out)
    for g in groups:
        layers = "+".join(str(lyr["m"]) for lyr in g["layers"])
        print(f"{g['issuer']} {g['expDate']}: {g['serials']} serials, "
              f"{len(g['layers'])} layers ({layers} bits)", file=out)
    return 0


def _query(args, out) -> int:
    from ct_mapreduce_tpu_torch.filter import read_artifact

    art = read_artifact(args.artifact)
    try:
        serials = [bytes.fromhex(s) for s in args.serial]
    except ValueError as err:
        print(f"error: serial is not hex: {err}", file=sys.stderr)
        return 2
    all_known = True
    for raw, sb in zip(args.serial, serials):
        known = art.query(args.issuer, args.expDate, sb)
        all_known &= known
        print(json.dumps({"issuer": args.issuer, "expDate": args.expDate,
                          "serial": raw, "known": known}), file=out)
    return 0 if all_known else 1


def _delta(args, out) -> int:
    from ct_mapreduce_tpu_torch.distrib import compute_delta
    from ct_mapreduce_tpu_torch.filter import write_artifact

    with open(args.base, "rb") as fh:
        base = fh.read()
    with open(args.target, "rb") as fh:
        target = fh.read()
    blob = compute_delta(base, target, args.fromEpoch, args.toEpoch)
    write_artifact(args.out, blob)
    print(json.dumps({
        "out": args.out, "bytes": len(blob),
        "fromEpoch": args.fromEpoch, "toEpoch": args.toEpoch,
        "baseBytes": len(base), "targetBytes": len(target),
        "ratio": round(len(blob) / max(1, len(target)), 4),
    }, indent=2), file=out)
    return 0


def _apply(args, out) -> int:
    from ct_mapreduce_tpu_torch.distrib import (
        DeltaError,
        apply_chain,
        split_bundle,
    )
    from ct_mapreduce_tpu_torch.filter import write_artifact

    with open(args.base, "rb") as fh:
        blob = fh.read()
    links = []
    for path in args.delta:
        with open(path, "rb") as fh:
            links.extend(split_bundle(fh.read()))
    try:
        result = apply_chain(blob, links)
    except DeltaError as err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    write_artifact(args.out, result)
    print(json.dumps({"out": args.out, "bytes": len(result),
                      "links": len(links)}, indent=2), file=out)
    return 0


def _container(args, out) -> int:
    from ct_mapreduce_tpu_torch.distrib import encode_container
    from ct_mapreduce_tpu_torch.filter import read_artifact, write_artifact

    art = read_artifact(args.artifact)
    blob = encode_container(art, args.kind)
    write_artifact(args.out, blob)
    print(json.dumps({
        "out": args.out, "kind": args.kind, "bytes": len(blob),
        "serials": art.n_serials, "groups": len(art.groups),
    }, indent=2), file=out)
    return 0


def main(argv: list[str] | None = None, out=None, device=None) -> int:
    """Run ct-filter. ``device`` (or ``-device``, anywhere in ``argv``)
    is where ``build`` runs its kernels; CUDA when neither names one."""
    from ct_mapreduce_tpu_torch.cmd.ct_fetch import _pop_device

    argv = sys.argv[1:] if argv is None else list(argv)
    argv, flag_device = _pop_device(argv)
    device = device or flag_device or None
    parser = argparse.ArgumentParser(prog="ct-filter-torch")
    sub = parser.add_subparsers(dest="cmd")

    b = sub.add_parser("build", help="compile checkpoints → artifact")
    b.add_argument("-state", "--state", required=True,
                   help="checkpoint path(s): comma list, globs ok "
                        "(the aggStatePath spelling)")
    b.add_argument("-out", "--out", required=True,
                   help="artifact output path")
    b.add_argument("-fpRate", "--fpRate", type=float, default=0.01,
                   help="target layer-0 false-positive rate")
    b.add_argument("-allowPartial", "--allowPartial", action="store_true",
                   help="accept checkpoints without a filter capture "
                        "(their device-lane serials will be missing)")
    b.add_argument("-format", "--format", default="",
                   choices=("", "fl01", "fl02"),
                   help="artifact format (default: the "
                        "CTMR_FILTER_FORMAT ladder, fl02)")

    i = sub.add_parser("inspect", help="artifact → structure summary")
    i.add_argument("-artifact", "--artifact", required=True)
    i.add_argument("-json", "--json", action="store_true",
                   help="full per-group detail as JSON")

    q = sub.add_parser("query", help="offline membership question")
    q.add_argument("-artifact", "--artifact", required=True)
    q.add_argument("-issuer", "--issuer", required=True,
                   help="issuerID (base64url of SHA-256(SPKI))")
    q.add_argument("-expDate", "--expDate", required=True,
                   help="expiration bucket id, e.g. 2031-06-15-14")
    q.add_argument("-serial", "--serial", action="append", default=[],
                   help="serial content bytes as hex (repeatable)")

    d = sub.add_parser("delta",
                       help="CTMRDL01/CTMRDL02 diff between epochs "
                            "(magic follows the artifacts' format)")
    d.add_argument("-base", "--base", required=True,
                   help="the from-epoch full artifact")
    d.add_argument("-target", "--target", required=True,
                   help="the to-epoch full artifact")
    d.add_argument("-out", "--out", required=True)
    d.add_argument("-fromEpoch", "--fromEpoch", type=int, default=0)
    d.add_argument("-toEpoch", "--toEpoch", type=int, default=1)

    a = sub.add_parser("apply", help="replay delta link(s) onto a base")
    a.add_argument("-base", "--base", required=True)
    a.add_argument("-delta", "--delta", action="append", default=[],
                   required=True,
                   help="delta link or bundle (repeatable, in order)")
    a.add_argument("-out", "--out", required=True)

    c = sub.add_parser("container",
                       help="re-encode as an upstream container")
    c.add_argument("-artifact", "--artifact", required=True)
    c.add_argument("-kind", "--kind", required=True,
                   choices=("mlbf", "clubcard"))
    c.add_argument("-out", "--out", required=True)

    args = parser.parse_args(argv)
    out = out or sys.stdout
    if args.cmd == "build":
        return _build(args, out, device)
    if args.cmd == "inspect":
        try:
            return _inspect(args, out)
        except (OSError, ValueError) as err:
            print(f"error: {err}", file=sys.stderr)
            return 2
    if args.cmd == "query":
        if not args.serial:
            print("error: at least one -serial is required", file=sys.stderr)
            return 2
        try:
            return _query(args, out)
        except (OSError, ValueError) as err:
            print(f"error: {err}", file=sys.stderr)
            return 2
    if args.cmd in ("delta", "apply", "container"):
        handler = {"delta": _delta, "apply": _apply,
                   "container": _container}[args.cmd]
        try:
            return handler(args, out)
        except (OSError, ValueError) as err:
            print(f"error: {err}", file=sys.stderr)
            return 2
    parser.print_usage(sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
