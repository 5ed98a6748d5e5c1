"""Recorded-shard fixture builder: the deterministic ``CTMRAU01``
corpus checked in at ``tests/data/recorded_shard.json.gz`` (a port of
``ct_mapreduce_tpu.audit.fixture``; both generators emit the same
bytes).

The zero-egress environment cannot capture a live shard, so the
fixture is SYNTHESIZED through the same wire encoders the transport
tests use (:mod:`ct_mapreduce_tpu_torch.ingest.leaf`) and signed by
deterministic log keys published production-style: each signer's
``log_id`` is SHA-256 over its SPKI DER
(:func:`ct_mapreduce_tpu_torch.audit.loglist.adopt_production_id`), and the
embedded log list is the Google/Apple v3 schema byte-for-byte in
shape. What the corpus models per page mix (the shape of a real
usable shard's entries):

- most lanes carry NO embedded SCT (precert-era entries and certs
  logged before issuance — the cheap majority);
- a P-256 ``usable`` temporally-sharded log signs the bulk of the
  verifiable SCTs (a few corrupted — real verify failures);
- a P-384 ``retired`` log's SCTs verify but are flagged;
- an RSA log exercises the host-fallback lane;
- a handful of SCTs cite a log absent from the list (``no_key``) or
  carry timestamps outside the signing shard's interval.

Regenerate with ``python -m ct_mapreduce_tpu_torch.audit.fixture <out.gz>``
— output is byte-stable (sorted JSON, zeroed gzip mtime), so an
unchanged generator reproduces the checked-in bytes exactly.
"""

from __future__ import annotations

import datetime

from ct_mapreduce_tpu_torch.audit import loglist as loglistlib
from ct_mapreduce_tpu_torch.verify import host as vhost
from ct_mapreduce_tpu_torch.verify import sct as sctlib

# One tile of the recorded shard. The mix keeps verifiable-SCT lanes
# a bounded minority so tier-1 scale runs stay inside the ECDSA
# budget (~1k host-side verifies/s on the CI box) while every lane
# class appears with enough mass to assert on.
PAGE_SIZE = 256
N_PAGES = 4
MIX = {
    "p256_valid": 120,
    "p256_corrupt": 16,
    "p384_retired": 24,
    "rsa": 16,
    "unknown_log": 16,
    "out_of_interval": 16,
    # remainder: no embedded SCT
}

INTERVAL = ("2024-01-01T00:00:00Z", "2025-01-01T00:00:00Z")
TS_IN_INTERVAL = 1_710_000_000_000  # 2024-03-09, inside
TS_OUTSIDE = 1_740_000_000_000  # 2025-02-19, past end_exclusive
N_ISSUERS = 8


def fixture_signers() -> dict:
    """The shard's log keys, production-id adopted (log_id =
    SHA-256(SPKI)). ``unknown`` signs real SCTs but is NOT in the
    published list."""
    return {
        "p256": loglistlib.adopt_production_id(
            sctlib.EcSctSigner("audit-shard:p256")),
        "p384": loglistlib.adopt_production_id(
            sctlib.EcSctSigner("audit-shard:p384", vhost.P384)),
        "rsa": loglistlib.adopt_production_id(sctlib.RsaSctSigner()),
        "unknown": loglistlib.adopt_production_id(
            sctlib.EcSctSigner("audit-shard:unlisted")),
    }


def fixture_log_list_doc(signers: dict) -> dict:
    return loglistlib.fixture_log_list([
        {"signer": signers["p256"], "operator": "Audit Fixture Op",
         "description": "audit shard 2024 (p256)",
         "url": "https://audit.ct.example/2024/",
         "interval": INTERVAL},
        {"signer": signers["p384"], "operator": "Audit Fixture Op",
         "description": "audit legacy (p384, retired)",
         "url": "https://audit.ct.example/legacy/",
         "state": "retired",
         "state_timestamp": "2025-06-01T00:00:00Z"},
        {"signer": signers["rsa"], "operator": "Second Fixture Op",
         "description": "audit rsa log",
         "url": "https://audit.ct.example/rsa/"},
    ])


def build_recorded_shard() -> dict:
    """The full CTMRAU01 document (pages + embedded log list)."""
    from ct_mapreduce_tpu_torch.ingest import leaf as leaflib
    from ct_mapreduce_tpu_torch.utils import minicert

    signers = fixture_signers()
    utc = datetime.timezone.utc
    future = datetime.datetime(2031, 6, 15, tzinfo=utc)
    issuers = [
        minicert.make_cert(
            serial=100 + i, issuer_cn=f"Audit Real CA {i:02d}",
            org=f"Audit Org {i % 3}", is_ca=True, not_after=future)
        for i in range(N_ISSUERS)
    ]

    n = PAGE_SIZE * N_PAGES
    kinds = (["p256_valid"] * MIX["p256_valid"]
             + ["p256_corrupt"] * MIX["p256_corrupt"]
             + ["p384_retired"] * MIX["p384_retired"]
             + ["rsa"] * MIX["rsa"]
             + ["unknown_log"] * MIX["unknown_log"]
             + ["out_of_interval"] * MIX["out_of_interval"])
    kinds += ["no_sct"] * (n - len(kinds))
    # Deterministic interleave (no RNG: stride through the classes) so
    # every page carries every lane class.
    stride = 67  # coprime with 1024 — a full permutation
    order = [(i * stride) % n for i in range(n)]
    placed = [kinds[order.index(i)] for i in range(n)]

    import base64

    pages = []
    for p in range(N_PAGES):
        entries = []
        for j in range(PAGE_SIZE):
            idx = p * PAGE_SIZE + j
            kind = placed[idx]
            issuer = issuers[idx % N_ISSUERS]
            base = minicert.make_cert(
                serial=10_000 + idx,
                issuer_cn=f"Audit Real CA {idx % N_ISSUERS:02d}",
                org=f"Audit Org {(idx % N_ISSUERS) % 3}",
                subject_cn=f"entry-{idx}.audit.example", is_ca=False,
                not_after=future)
            ts = TS_IN_INTERVAL + idx
            if kind == "no_sct":
                der = base
            else:
                signer = {
                    "p256_valid": signers["p256"],
                    "p256_corrupt": signers["p256"],
                    "out_of_interval": signers["p256"],
                    "p384_retired": signers["p384"],
                    "rsa": signers["rsa"],
                    "unknown_log": signers["unknown"],
                }[kind]
                if kind == "out_of_interval":
                    ts = TS_OUTSIDE + idx
                der = sctlib.attach_sct(
                    base, signer, ts,
                    corrupt_signature=(kind == "p256_corrupt"),
                    issuer_der=issuer)
            li = leaflib.encode_leaf_input(
                der, timestamp_ms=ts)
            ed = leaflib.encode_extra_data([issuer])
            entries.append({
                "leaf_input": base64.b64encode(li).decode(),
                "extra_data": base64.b64encode(ed).decode(),
            })
        pages.append({"start": p * PAGE_SIZE, "entries": entries})

    return {
        "log_url": "https://audit.ct.example/2024/",
        "description": "synthesized recorded shard (audit fixture)",
        "mix": dict(MIX, no_sct=n - sum(MIX.values())),
        "log_list": fixture_log_list_doc(signers),
        "pages": pages,
    }


def expected_tallies() -> dict:
    """Ground truth per tile, derived from MIX — the oracle the audit
    gate recomputes against."""
    n = PAGE_SIZE * N_PAGES
    sct = sum(MIX.values())
    return {
        "entries": n,
        "sct_lanes": sct,
        "no_sct": n - sct,
        # out_of_interval lanes still verify (the key is right; the
        # routing flag is policy, not cryptography).
        "verified": (MIX["p256_valid"] + MIX["p384_retired"]
                     + MIX["rsa"] + MIX["out_of_interval"]),
        "failed": MIX["p256_corrupt"],
        "no_key": MIX["unknown_log"],
        "device_lanes": (MIX["p256_valid"] + MIX["p256_corrupt"]
                         + MIX["p384_retired"]
                         + MIX["out_of_interval"]),
        "host_lanes": MIX["rsa"],
        "retired": MIX["p384_retired"],
        "out_of_interval": MIX["out_of_interval"],
        "unknown_log": MIX["unknown_log"],
    }


def shard_ders(doc: dict) -> list:
    """Every entry's stored cert DER, decoded through the production
    leaf codec — the real-corpus feed for the differential harness."""
    from ct_mapreduce_tpu_torch.ingest import leaf as leaflib

    ders = []
    for page in doc["pages"]:
        start = int(page.get("start", 0))
        for i, e in enumerate(page["entries"]):
            ders.append(leaflib.decode_json_entry(start + i, e).cert_der)
    return ders


def record_divergence_trend(shard_path: str, trend_path: str,
                            device=None) -> dict:
    """Classify the recorded shard through the parser differential
    harness (the walker on ``device``, CUDA unless named) and append a
    ``real``-corpus run to the trend file at ``trend_path`` (the first
    such run pins ``floorRealAcceptRate``). Both paths are the caller's:
    the JAX package's checked-in trend file is not this module's to
    write."""
    from ct_mapreduce_tpu_torch.audit import driver as drvlib
    from ct_mapreduce_tpu_torch.core import divergence

    doc = drvlib.load_recorded(shard_path)
    report = divergence.classify_corpus(shard_ders(doc), device=device)
    return divergence.record_trend(report, trend_path, corpus="real")


def main(argv=None) -> int:
    import sys

    from ct_mapreduce_tpu_torch.audit import driver as drvlib

    args = list(sys.argv[1:] if argv is None else argv)
    if not args or (args[0] == "--trend" and len(args) != 3):
        print("usage: python -m ct_mapreduce_tpu_torch.audit.fixture "
              "<out.json.gz> | --trend <shard.json.gz> <trend.json>",
              file=sys.stderr)
        return 2
    if args[0] == "--trend":
        doc = record_divergence_trend(args[1], args[2])
        run = doc["runs"][-1]
        print(f"recorded real-corpus run {run['run']}: accept rate "
              f"{run['deviceAcceptRate']} (floor "
              f"{doc.get('floorRealAcceptRate')})")
        return 0
    out = args[0]
    doc = build_recorded_shard()
    drvlib.write_recorded(out, doc)
    n = sum(len(p["entries"]) for p in doc["pages"])
    print(f"wrote {out}: {len(doc['pages'])} pages, {n} entries")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
