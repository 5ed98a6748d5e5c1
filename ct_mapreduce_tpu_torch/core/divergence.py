"""Parser-divergence classification: the standing differential
harness seeded from the mutation fuzzers (a port of
``ct_mapreduce_tpu.core.divergence``, after ParsEval, arxiv 2405.18993).

Three parsers cover the same identity surface in this tree — the
device DER walker (:mod:`ct_mapreduce_tpu_torch.ops.der_kernel`), the native
scalar sidecar extractor (:mod:`ct_mapreduce_tpu_torch.native.leafpack`),
and the strict host parser (:mod:`ct_mapreduce_tpu_torch.core.der`).
``classify_corpus`` runs a byte corpus through all of them and files
every certificate into the divergence buckets the fuzz suites (and a
future adversarial-corpus harness) report on:

- **device-accepts / host-rejects** — the walker's bounded leniency
  (it skips subtrees outside the identity surface, like Go x509's
  non-fatal tolerance). Bounded, never silently wrong: identity bytes
  are validated by the walker itself.
- **host-accepts / device-rejects** — walker strictness; these lanes
  take the exact host lane at ingest, so they cost throughput, not
  correctness.
- **verdict-mismatch** — both parsers accept but an identity-surface
  field differs (serial window, expiry hour, CA flag, SPKI window,
  issuer Name window, issuer-CN bytes, CRLDP presence/URLs). The
  HARD bucket: anything here silently corrupts identity keys and
  must stay at zero.
- **sidecar-undecidable** — the native extractor's ok bit disagrees
  with the walker's (either direction). The pre-parsed lane replays
  such lanes through the walker, so this bucket costs routing, not
  correctness — but drift here is the first sign the two ports have
  diverged.

``publish`` turns a report into the tracked metrics
(``parse.device_accept_rate`` and the ``parse.divergence_*`` counters,
the JAX package's docs/METRICS.md) so a long-running differential
harness trends them.

The device walker here is the port's: :func:`classify_corpus` runs it on
``device`` (K3 on the card, CUDA unless the caller names the CPU, where
the plain walker runs). The module imports ``torch`` lazily, so
``core/`` stays light until a corpus is actually classified.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ct_mapreduce_tpu_torch.telemetry.metrics import incr_counter, set_gauge


@dataclass
class DivergenceReport:
    total: int = 0
    device_accepts: int = 0
    host_accepts: int = 0
    both_accept: int = 0
    device_accept_host_reject: int = 0
    host_accept_device_reject: int = 0
    verdict_mismatch: int = 0
    # -1 = native extractor unavailable (bucket not measured).
    sidecar_undecidable: int = -1
    # Reproduction material for the non-empty hard buckets: one line
    # per offender, capped so a pathological corpus cannot flood.
    details: list[str] = field(default_factory=list)

    @property
    def device_accept_rate(self) -> float:
        return self.device_accepts / max(1, self.total)


def _walker_fields_mismatch(der: bytes, out, i: int, ref) -> str | None:
    """Identity-surface compare for one walker-accepted lane against
    the strict host parse; returns a repro string on mismatch."""
    from ct_mapreduce_tpu_torch.core import der as hostder

    cn_bytes = der[int(out.issuer_cn_off[i]):
                   int(out.issuer_cn_off[i]) + int(out.issuer_cn_len[i])]
    try:  # mirror the host's utf-8-then-latin-1 decode (der.py)
        cn_str = cn_bytes.decode("utf-8")
    except UnicodeDecodeError:
        cn_str = cn_bytes.decode("latin-1")
    if bool(out.has_crldp[i]):
        try:
            dev_urls = hostder._parse_crldp(der, int(out.crldp_off[i]))
        except Exception:
            dev_urls = ["<unparseable>"]
    else:
        dev_urls = []
    if (int(out.serial_off[i]) != ref.serial_off
            or int(out.serial_len[i]) != ref.serial_len
            or int(out.not_after_hour[i]) != ref.not_after_unix_hour
            or bool(out.is_ca[i]) != ref.is_ca
            or int(out.spki_off[i]) != ref.spki_off
            or int(out.spki_len[i]) != ref.spki_len
            or int(out.issuer_off[i]) != ref.issuer_off
            or int(out.issuer_len[i]) != ref.issuer_len
            or cn_str != ref.issuer_cn
            or bool(out.has_crldp[i]) != bool(ref.crl_distribution_points)
            or sorted(dev_urls) != sorted(ref.crl_distribution_points)):
        return (
            f"lane {i} dev=(so={int(out.serial_off[i])} "
            f"sl={int(out.serial_len[i])} "
            f"nah={int(out.not_after_hour[i])} ca={bool(out.is_ca[i])} "
            f"po={int(out.spki_off[i])} pl={int(out.spki_len[i])}) "
            f"host=(so={ref.serial_off} sl={ref.serial_len} "
            f"nah={ref.not_after_unix_hour} ca={ref.is_ca} "
            f"po={ref.spki_off} pl={ref.spki_len}) der={der.hex()}"
        )
    return None


def classify_corpus(ders: list[bytes], pad_to: int = 1024,
                    max_details: int = 20,
                    device=None) -> DivergenceReport:
    """Run every parser over the corpus and fill the buckets. Entries
    longer than ``pad_to`` are the caller's problem (route them to a
    wider bucket first, like the ingest path does). The walker runs on
    ``device``: CUDA (K3) unless the caller names another."""
    import torch

    from ct_mapreduce_tpu_torch.core import der as hostder
    from ct_mapreduce_tpu_torch.device import resolve_device
    from ct_mapreduce_tpu_torch.ops import der_kernel

    dev = resolve_device(device)
    n = len(ders)
    data = np.zeros((n, pad_to), np.uint8)
    length = np.zeros((n,), np.int32)
    for i, d in enumerate(ders):
        data[i, : len(d)] = np.frombuffer(d, np.uint8)
        length[i] = len(d)
    parsed = der_kernel.parse_certs(torch.from_numpy(data).to(dev),
                                    torch.from_numpy(length).to(dev))
    out = type(parsed)(*(f.cpu().numpy() for f in parsed))
    ok = out.ok.astype(bool)

    report = DivergenceReport(total=n)
    report.device_accepts = int(ok.sum())
    for i, der in enumerate(ders):
        try:
            ref = hostder.parse_cert(der)
        except Exception:
            ref = None
        if ref is not None:
            report.host_accepts += 1
        if ok[i] and ref is None:
            report.device_accept_host_reject += 1
        elif not ok[i] and ref is not None:
            report.host_accept_device_reject += 1
        elif ok[i] and ref is not None:
            report.both_accept += 1
            repro = _walker_fields_mismatch(der, out, i, ref)
            if repro is not None:
                report.verdict_mismatch += 1
                if len(report.details) < max_details:
                    report.details.append("MISMATCH " + repro)

    try:
        from ct_mapreduce_tpu_torch.native import leafpack
        from ct_mapreduce_tpu_torch.native import load as load_native

        native_ok = load_native() is not None
    except Exception:
        native_ok = False
    if native_ok:
        sc = leafpack.extract_sidecars(data, length)
        sc_ok = np.asarray(sc.ok).astype(bool)
        report.sidecar_undecidable = int((sc_ok ^ ok).sum())
    return report


# -- grammar-aware structured mutators (ParsEval methodology) ------------
#
# Single-byte XOR fuzz mostly produces garbage both parsers reject in
# the same place; the disagreement-inducing corpora of arxiv
# 2405.18993 are STRUCTURALLY plausible — valid TLV trees with one
# inconsistent length, or a nested element cut short while the outer
# frames still claim the old size. These mutators operate on the
# parsed TLV structure, not on random byte positions.


def iter_tlvs(der: bytes, max_depth: int = 6) -> list[tuple]:
    """Best-effort DER TLV walk: [(tag_off, len_off, header_len,
    content_len, depth)] for every element reachable under well-formed
    headers (single-byte tags; short / 0x81 / 0x82 length forms — the
    forms the identity surface uses). Stops quietly at malformed
    regions: mutants are produced FROM valid certs, so the walk sees
    the full tree there."""
    out: list[tuple] = []

    def walk(off: int, end: int, depth: int) -> None:
        while off + 2 <= end:
            tag = der[off]
            len_off = off + 1
            first = der[len_off]
            if first < 0x80:
                hdr, clen = 2, first
            elif first == 0x81 and len_off + 1 < end:
                hdr, clen = 3, der[len_off + 1]
            elif first == 0x82 and len_off + 2 < end:
                hdr = 4
                clen = (der[len_off + 1] << 8) | der[len_off + 2]
            else:
                return  # indefinite/absurd length form: stop here
            if off + hdr + clen > end:
                return
            out.append((off, len_off, hdr, clen, depth))
            constructed = bool(tag & 0x20)
            if constructed and depth < max_depth and clen:
                walk(off + hdr, off + hdr + clen, depth + 1)
            off += hdr + clen

    walk(0, len(der), 0)
    return out


def mutate_length_field(der: bytes, rng) -> bytes:
    """Length-field surgery: pick one TLV and rewrite its length
    encoding — off-by-one, a random value, or a long↔short form flip
    (which inserts/removes a header byte WITHOUT fixing any outer
    frame's length). The result is a tree whose frames disagree about
    where elements end — the classic parser-divergence shape."""
    tlvs = iter_tlvs(der)
    if not tlvs:
        return der
    b = bytearray(der)
    _, len_off, hdr, clen, _ = tlvs[int(rng.integers(len(tlvs)))]
    mode = int(rng.integers(4))
    if mode == 0:  # off-by-one (either direction)
        delta = 1 if rng.integers(2) else -1
        if hdr == 2:
            b[len_off] = (b[len_off] + delta) % 0x80
        elif hdr == 3:
            b[len_off + 1] = (b[len_off + 1] + delta) % 256
        else:
            b[len_off + 2] = (b[len_off + 2] + delta) % 256
    elif mode == 1:  # random length value, same form
        if hdr == 2:
            b[len_off] = int(rng.integers(0x80))
        else:
            b[len_off + hdr - 2] = int(rng.integers(256))
    elif mode == 2 and hdr == 2:  # short -> long form 0x81 (inserts
        # a byte; outer lengths now lie by one)
        b[len_off:len_off + 1] = bytes([0x81, clen])
    else:  # long -> shorter form (drops a byte), or minimal tweak
        if hdr == 4:
            b[len_off:len_off + 3] = bytes([0x81, min(clen, 255)])
        elif hdr == 3:
            b[len_off:len_off + 2] = bytes([clen & 0x7F])
        else:
            b[len_off] = (b[len_off] ^ 0x01) % 0x80
    return bytes(b)


def mutate_truncate_tlv(der: bytes, rng) -> bytes:
    """Nested-TLV truncation/extension: splice bytes out of (or junk
    into) one NESTED element's content while every enclosing frame
    keeps its original length claim — the inner element is now too
    short (or too long) for the tree around it."""
    tlvs = [t for t in iter_tlvs(der) if t[4] >= 1 and t[3] > 0]
    if not tlvs:
        return der
    off, _, hdr, clen, _ = tlvs[int(rng.integers(len(tlvs)))]
    content = off + hdr
    if rng.integers(2) or clen < 2:  # extend with junk bytes
        k = int(rng.integers(1, 9))
        junk = rng.integers(0, 256, k, dtype=np.uint8).tobytes()
        cut = content + int(rng.integers(clen + 1))
        return der[:cut] + junk + der[cut:]
    # truncate: drop a tail slice of the content
    k = int(rng.integers(1, max(2, clen // 2 + 1)))
    return der[:content + clen - k] + der[content + clen:]


def grammar_mutants(bases: list[bytes], rng, n: int) -> list[bytes]:
    """``n`` structured mutants over ``bases``, half per mutator —
    the corpus shape the standing ParsEval-style campaign feeds
    through :func:`classify_corpus` + :func:`publish`."""
    out = []
    for i in range(n):
        base = bases[int(rng.integers(len(bases)))]
        mut = (mutate_length_field if i % 2 == 0
               else mutate_truncate_tlv)
        out.append(mut(base, rng))
    return out


def publish(report: DivergenceReport) -> None:
    """Emit the tracked metrics for one classified corpus. Counters
    accumulate across corpora; the accept-rate gauge reflects the
    latest corpus (the number dashboards trend across fuzz rounds)."""
    set_gauge("parse", "device_accept_rate",
              value=report.device_accept_rate)
    incr_counter("parse", "divergence_device_accept_host_reject",
                 value=float(report.device_accept_host_reject))
    incr_counter("parse", "divergence_host_accept_device_reject",
                 value=float(report.host_accept_device_reject))
    incr_counter("parse", "divergence_verdict_mismatch",
                 value=float(report.verdict_mismatch))
    if report.sidecar_undecidable >= 0:
        incr_counter("parse", "divergence_sidecar_undecidable",
                     value=float(report.sidecar_undecidable))


# -- trend persistence --------------------------------------------------

TREND_FORMAT = "CTMRDV01"


def record_trend(report: DivergenceReport, path: str,
                 corpus: str = "fuzz") -> dict:
    """Append one classified run's bucket counts to the JSON trend
    file at ``path`` (created if missing) and return the updated
    document. Runs are tagged with their ``corpus``: ``fuzz`` (the
    synthesized mutation corpora) pins ``floorDeviceAcceptRate`` on
    its first run, ``real`` (recorded-shard DER) pins
    ``floorRealAcceptRate`` separately, because a mutation corpus is
    built to be mostly rejected while a real shard should be almost
    entirely accepted — one floor cannot grade both. Later runs only
    append — each floor is a ratchet an operator (or a deliberate
    re-baseline) moves, never a harness run. Written tmp+replace like
    every durable artifact in the tree."""
    import json as _json
    import os as _os
    import tempfile as _tempfile

    doc: dict = {"format": TREND_FORMAT,
                 "floorDeviceAcceptRate": None, "runs": []}
    if _os.path.exists(path):
        with open(path, encoding="utf-8") as fh:
            doc = _json.load(fh)
        if doc.get("format") != TREND_FORMAT:
            raise ValueError(f"unknown trend format in {path}: "
                             f"{doc.get('format')!r}")
    entry = {
        "run": len(doc["runs"]) + 1,
        "corpus": corpus,
        "total": report.total,
        "deviceAccepts": report.device_accepts,
        "hostAccepts": report.host_accepts,
        "bothAccept": report.both_accept,
        "deviceAcceptHostReject": report.device_accept_host_reject,
        "hostAcceptDeviceReject": report.host_accept_device_reject,
        "verdictMismatch": report.verdict_mismatch,
        "sidecarUndecidable": report.sidecar_undecidable,
        "deviceAcceptRate": round(report.device_accept_rate, 6),
    }
    doc["runs"].append(entry)
    floor_key = ("floorRealAcceptRate" if corpus == "real"
                 else "floorDeviceAcceptRate")
    if doc.get(floor_key) is None:
        doc[floor_key] = entry["deviceAcceptRate"]
    fd, tmp = _tempfile.mkstemp(
        prefix=_os.path.basename(path) + ".tmp.",
        dir=_os.path.dirname(_os.path.abspath(path)))
    try:
        with _os.fdopen(fd, "w", encoding="utf-8") as fh:
            _json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
        _os.replace(tmp, path)
    except BaseException:
        import contextlib as _contextlib
        with _contextlib.suppress(OSError):
            _os.unlink(tmp)
        raise
    return doc


def trend_floor(path: str, corpus: str = "fuzz"):
    """The recorded accept-rate floor at ``path`` for the given
    corpus class (``fuzz`` → ``floorDeviceAcceptRate``, ``real`` →
    ``floorRealAcceptRate``), or None when none has been recorded
    yet. The tier-1 gates assert a fresh harness run never drops
    below its class's floor."""
    import json as _json
    import os as _os

    if not _os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fh:
        doc = _json.load(fh)
    if doc.get("format") != TREND_FORMAT:
        raise ValueError(f"unknown trend format in {path}: "
                         f"{doc.get('format')!r}")
    return doc.get("floorRealAcceptRate" if corpus == "real"
                   else "floorDeviceAcceptRate")
