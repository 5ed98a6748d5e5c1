"""The port's audit subsystem (``ct_mapreduce_tpu_torch.audit``,
``core/divergence.py`` and ``tools/audit.py``) against the JAX
package's, on the CPU.

The cases of ``tests/test_audit.py`` run on the port: the production
log-list schema (parsing, temporal intervals, retired, unknown and
mismatched keys), the SPKI codec, the quarantine spool and
``check_batch`` without the native library, the recorded-shard driver
(tallies, tile scaling, the emitted filter, the statistics report, the
serve plane and checkpoints), ``resolve_audit``, the CLI's JSON, the
recorded format's refusal and the checked-in shard against the
generator. The same recorded documents go through the JAX
``AuditDriver`` and the port's (``TorchAggregator(device="cpu")``: the
walker, fingerprint and ECDSA verify run as their plain PyTorch
versions); reports (all but ``wall_s``), per-issuer folds, quarantine
records and emitted filter bytes must be equal. ``classify_corpus`` runs
the shard's DERs plus seeded structured mutants through both packages'
walkers; the reports must be equal field for field.

The KAT is pinned to ``utils/minicert`` fixtures, which build the same
bytes whichever ``tests/certgen.py`` path the installed ``cryptography``
takes. Tolerance: exact bytes and exact counts.
"""

import base64
import dataclasses
import datetime
import gzip
import hashlib
import io
import json
import os

import numpy as np
import pytest

from ct_mapreduce_tpu.audit import driver as jdrvlib
from ct_mapreduce_tpu.audit import loglist as jloglist
from ct_mapreduce_tpu.verify import sct as jsct
from ct_mapreduce_tpu_torch import audit as auditpkg
from ct_mapreduce_tpu_torch.audit import driver as drvlib
from ct_mapreduce_tpu_torch.audit import fixture as fxlib
from ct_mapreduce_tpu_torch.audit import loglist as loglistlib
from ct_mapreduce_tpu_torch.audit import quarantine as quarlib
from ct_mapreduce_tpu_torch.ingest import leaf as leaflib
from ct_mapreduce_tpu_torch.telemetry import metrics as tmetrics
from ct_mapreduce_tpu_torch.utils import minicert
from ct_mapreduce_tpu_torch.verify import host as vhost
from ct_mapreduce_tpu_torch.verify import sct as sctlib

UTC = datetime.timezone.utc
FUTURE = datetime.datetime(2031, 6, 15, tzinfo=UTC)
TS_KAT = 1_710_000_000_000
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SHARD = os.path.join(ROOT, "tests", "data", "recorded_shard.json.gz")
AUDIT_ENV = ("CTMR_AUDIT_LOG_LIST", "CTMR_AUDIT_QUARANTINE_DIR")


def _native_available() -> bool:
    from ct_mapreduce_tpu_torch.native import load

    return os.environ.get("CTMR_NATIVE", "1") != "0" and load() is not None


# -- the KAT -----------------------------------------------------------------


def _kat_materials():
    issuer = minicert.make_cert(serial=1, issuer_cn="KAT CA", is_ca=True,
                                not_after=FUTURE)
    leaf = minicert.make_cert(serial=7, issuer_cn="KAT CA",
                              subject_cn="kat.example", is_ca=False,
                              not_after=FUTURE)
    signer = loglistlib.adopt_production_id(sctlib.EcSctSigner("audit-kat"))
    der = sctlib.attach_sct(leaf, signer, TS_KAT, issuer_der=issuer)
    return issuer, leaf, signer, der


def test_reconstruct_tbs_kat():
    """Known answers for the §3.2 reconstruction and the signing digest
    on minicert fixtures, equal to the JAX package's functions on the
    same bytes."""
    issuer, leaf, _signer, der = _kat_materials()
    assert hashlib.sha256(der).hexdigest() == (
        "14a549cb88a1aa427791b1d71a75a25870ea98afe2f30e9d746fb069274ea937")
    tbs = sctlib.reconstruct_precert_tbs(der)
    assert tbs == jsct.reconstruct_precert_tbs(der)
    assert hashlib.sha256(tbs).hexdigest() == (
        "b6f58ff847075dd82039da60f0cf68a7851b07c812b4360540c08ffb023b2b3b")
    ikh = sctlib.issuer_key_hash_of(issuer)
    assert ikh == jsct.issuer_key_hash_of(issuer)
    assert ikh.hex() == (
        "341cf889d3ac1903dfcc1e45fc8a5c8c79cf31e9a8c04ac57dbb47d0faed4e3f")
    digest = sctlib.sct_digest(der, 0, 0, TS_KAT, b"", ikh)
    assert digest == jsct.sct_digest(der, 0, 0, TS_KAT, b"", ikh)
    assert digest.hex() == (
        "35161b4891187bdb3f5af8874d5ddfc3902dad414d8907007c1fca3b7b03efd3")
    assert tbs == sctlib.reconstruct_precert_tbs(leaf)
    payload = (b"\x00\x00" + TS_KAT.to_bytes(8, "big") + b"\x00\x01" + ikh
               + len(tbs).to_bytes(3, "big") + tbs + b"\x00\x00")
    assert hashlib.sha256(payload).digest() == digest


# -- the log list ----------------------------------------------------------------


def _fixture_list():
    signers = fxlib.fixture_signers()
    doc = fxlib.fixture_log_list_doc(signers)
    return signers, loglistlib.parse_log_list(doc), doc


def test_fixture_log_list_matches_jax():
    """The port's fixture signers publish the JAX package's document,
    and both packages parse it to the same shards and registry."""
    from ct_mapreduce_tpu.audit import fixture as jfx

    signers, ll, doc = _fixture_list()
    assert doc == jfx.fixture_log_list_doc(jfx.fixture_signers())
    jll = jloglist.parse_log_list(doc)
    assert sorted(ll.shards) == sorted(jll.shards)
    for log_id, shard in ll.shards.items():
        j = jll.shards[log_id]
        assert (shard.entry, shard.operator, shard.state,
                shard.interval_start_ms, shard.interval_end_ms) == \
            (j.entry, j.operator, j.state, j.interval_start_ms,
             j.interval_end_ms)
    assert ll.registry().to_json() == jll.registry().to_json()


def test_loglist_parses_production_shape():
    signers, ll, _ = _fixture_list()
    assert len(ll) == 3 and ll.version == "3.99"
    p256 = ll.shards[signers["p256"].log_id]
    assert p256.state == "usable" and p256.operator == "Audit Fixture Op"
    assert p256.entry["alg"] == "p256"
    assert p256.entry["log_id"] == signers["p256"].log_id.hex()
    assert ll.shards[signers["p384"].log_id].state == "retired"
    assert ll.shards[signers["rsa"].log_id].entry["alg"] == "rsa"
    reg = ll.registry()
    for name in ("p256", "p384", "rsa"):
        assert reg.get(signers[name].log_id) is not None
    assert reg.get(signers["unknown"].log_id) is None


@pytest.mark.parametrize("delta_ms, edge, want", [
    (0, 0, True), (-1, 0, False), (-1, 1, True), (0, 1, False)])
def test_loglist_temporal_interval_boundaries(delta_ms, edge, want):
    """Start inclusive, end exclusive, in both packages' routing."""
    signers, ll, doc = _fixture_list()
    jll = jloglist.parse_log_list(doc)
    ts = loglistlib.parse_rfc3339_ms(fxlib.INTERVAL[edge]) + delta_ms
    assert ts == jloglist.parse_rfc3339_ms(fxlib.INTERVAL[edge]) + delta_ms
    log_id = signers["p256"].log_id
    assert ll.shards[log_id].accepts_at(ts) is want
    v, jv = ll.route(log_id, ts), jll.route(log_id, ts)
    assert (v.known, v.in_interval, v.retired, v.state) \
        == (jv.known, jv.in_interval, jv.retired, jv.state) \
        == (True, want, False, "usable")
    assert ll.route(signers["rsa"].log_id, 1 << 62).in_interval


def test_loglist_retired_unknown_and_mismatched_keys():
    signers, ll, doc = _fixture_list()
    v = ll.route(signers["p384"].log_id, fxlib.TS_IN_INTERVAL)
    assert v.known and v.retired and v.state == "retired"
    assert ll.registry().get(signers["p384"].log_id) is not None
    v = ll.route(signers["unknown"].log_id, fxlib.TS_IN_INTERVAL)
    assert not v.known and v.state == ""
    raw = doc["operators"][0]["logs"][0]
    raw["log_id"] = base64.b64encode(
        hashlib.sha256(b"not the key").digest()).decode()
    with pytest.raises(ValueError, match="SHA-256") as port_err:
        loglistlib.parse_log_list(doc)
    with pytest.raises(ValueError) as jax_err:
        jloglist.parse_log_list(doc)
    assert str(port_err.value) == str(jax_err.value)


def test_loglist_rejected_and_pending_skipped(tmp_path):
    signers = [loglistlib.adopt_production_id(sctlib.EcSctSigner(f"audit-{s}"))
               for s in ("rejected", "pending", "readonly")]
    doc = loglistlib.fixture_log_list([
        {"signer": signers[0], "state": "rejected"},
        {"signer": signers[1], "state": "pending"},
        {"signer": signers[2], "state": "readonly"}])
    path = tmp_path / "ll.json"
    path.write_text(json.dumps(doc))
    ll = loglistlib.load_log_list(str(path))
    assert len(ll) == 1 == len(jloglist.load_log_list(str(path)))
    assert ll.route(signers[2].log_id, 0).known
    assert not ll.route(signers[0].log_id, 0).known
    assert not ll.route(signers[1].log_id, 0).known


def test_spki_codec_roundtrip_and_rejection():
    for curve in (vhost.P256, vhost.P384):
        s = sctlib.EcSctSigner(f"audit-spki-{curve.name}", curve)
        spki = loglistlib.spki_from_signer(s)
        assert spki == jloglist.spki_from_signer(s)
        key = loglistlib.parse_spki(spki)
        assert key == jloglist.parse_spki(spki)
        assert key["alg"] == curve.name
        assert (int(key["x"], 16), int(key["y"], 16)) == s.q
    r = sctlib.RsaSctSigner()
    spki = loglistlib.spki_from_signer(r)
    assert spki == jloglist.spki_from_signer(r)
    assert loglistlib.parse_spki(spki) == {"alg": "rsa", "n": hex(r.n),
                                           "e": hex(r.e)}
    for bad, match in ((bytes.fromhex("302a300506032b6570032100") + bytes(32),
                        "algorithm OID"),
                       (b"\x30\x03\x02\x01\x01", None)):
        with pytest.raises(ValueError, match=match):
            loglistlib.parse_spki(bad)
        with pytest.raises(ValueError):
            jloglist.parse_spki(bad)


# -- the quarantine lane ---------------------------------------------------------


def test_quarantine_spool_file_and_replay(tmp_path):
    """Same records and the same spool files as the JAX package's."""
    from ct_mapreduce_tpu.audit import quarantine as jquar

    a, b = b"\x30\x03\x02\x01\x01", b"\x30\x03\x02\x01\x02"
    spools = {"port": quarlib.QuarantineSpool(str(tmp_path / "port")),
              "jax": jquar.QuarantineSpool(str(tmp_path / "jax"))}
    for spool in spools.values():
        spool.file(a, index=5, log_url="l", reasons=["digest"])
        spool.file(b, index=6, log_url="l", reasons=["ok", "r"])
        spool.file(a, index=7, log_url="l", reasons=["digest"])
    spool = spools["port"]
    assert spool.count == 3 and spool.records == spools["jax"].records
    for name in sorted(os.listdir(tmp_path / "port")):
        assert (tmp_path / "port" / name).read_bytes() \
            == (tmp_path / "jax" / name).read_bytes()
    recs = spool.replay()
    assert len(recs) == 2 and recs == spools["jax"].replay()
    assert set(spool.replay_ders()) == {a, b}
    (tmp_path / "port" / "zzzz.json").write_text(
        json.dumps({"format": "NOPE", "der": ""}))
    with pytest.raises(ValueError, match="NOPE"):
        spool.replay()
    mem = quarlib.QuarantineSpool("")
    mem.file(a, index=0)
    assert mem.count == 1 and mem.replay_ders() == [a]


def _pack_rows(ders):
    pad = max(len(d) for d in ders)
    data = np.zeros((len(ders), pad), np.uint8)
    length = np.zeros((len(ders),), np.int32)
    for j, d in enumerate(ders):
        data[j, :len(d)] = np.frombuffer(d, np.uint8)
        length[j] = len(d)
    return data, length


def test_check_batch_unmeasured_without_native(monkeypatch):
    monkeypatch.setenv("CTMR_NATIVE", "0")
    data, length = _pack_rows([b"\x30\x00"])
    chk = quarlib.check_batch(data, length)
    assert not chk.measured and chk.count == 0


@pytest.mark.skipif(not _native_available(),
                    reason="the native SCT extractor needs a C++ compiler")
def test_check_batch_native_mirror_agree_on_mutants():
    """Byte-flip mutants of the KAT certificate: the native extractor and
    the mirror decide identically, and ``compare_extractions`` names a
    field a lane disagrees on."""
    issuer, _leaf, _signer, der = _kat_materials()
    rng = np.random.default_rng(20261019)
    mutants = [der]
    for _ in range(120):
        b = bytearray(der)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(len(b)))] ^= int(rng.integers(1, 256))
        mutants.append(bytes(b))
    data, length = _pack_rows(mutants)
    ikh = np.tile(np.frombuffer(sctlib.issuer_key_hash_of(issuer), np.uint8),
                  (len(mutants), 1))
    chk = quarlib.check_batch(data, length, issuer_key_hash=ikh)
    assert chk.measured and chk.count == 0, chk.reasons
    mirror = sctlib.extract_scts_np(data, length, issuer_key_hash=ikh)
    other = sctlib.extract_scts_np(data, length, issuer_key_hash=ikh)
    other.timestamp_ms = np.array(other.timestamp_ms, copy=True)
    other.timestamp_ms[0] += 1
    diff = quarlib.compare_extractions(mirror, other)
    assert diff.count == 1 and diff.reasons == {0: ["timestamp_ms"]}


# -- the recorded-shard driver ---------------------------------------------------

SMALL_KINDS = (["p256_valid"] * 6 + ["p256_corrupt"] * 2
               + ["p384_retired"] * 2 + ["rsa"] * 2 + ["unknown_log"] * 2
               + ["out_of_interval"] * 2 + ["no_sct"] * 8)
SMALL_EXPECT = {"entries": 24, "sct_lanes": 16, "no_sct": 8, "verified": 12,
                "failed": 2, "verifier_no_key": 2, "device_lanes": 12,
                "host_lanes": 2, "retired": 2, "out_of_interval": 2,
                "unknown_log": 2}


def _small_doc() -> dict:
    """A 24-entry single-page CTMRAU01 document with every lane class."""
    signers = fxlib.fixture_signers()
    issuers = [minicert.make_cert(serial=100 + i,
                                  issuer_cn=f"Small Audit CA {i}",
                                  is_ca=True, not_after=FUTURE)
               for i in range(2)]
    by_kind = {"p256_valid": "p256", "p256_corrupt": "p256",
               "out_of_interval": "p256", "p384_retired": "p384",
               "rsa": "rsa", "unknown_log": "unknown"}
    entries = []
    for idx, kind in enumerate(SMALL_KINDS):
        issuer = issuers[idx % 2]
        der = minicert.make_cert(
            serial=9000 + idx, issuer_cn=f"Small Audit CA {idx % 2}",
            subject_cn=f"small-{idx}.example", is_ca=False,
            not_after=FUTURE)
        ts = fxlib.TS_IN_INTERVAL + idx
        if kind != "no_sct":
            if kind == "out_of_interval":
                ts = fxlib.TS_OUTSIDE + idx
            der = sctlib.attach_sct(
                der, signers[by_kind[kind]], ts,
                corrupt_signature=(kind == "p256_corrupt"),
                issuer_der=issuer)
        entries.append({
            "leaf_input": base64.b64encode(
                leaflib.encode_leaf_input(der, timestamp_ms=ts)).decode(),
            "extra_data": base64.b64encode(
                leaflib.encode_extra_data([issuer])).decode()})
    return {"format": drvlib.RECORDED_FORMAT,
            "log_url": "https://small.audit.example/",
            "log_list": fxlib.fixture_log_list_doc(signers),
            "pages": [{"start": 0, "entries": entries}]}


DRIVER_KW = {"batch_size": 16, "flush_size": 16, "batch_width": 32}


def _port_driver(doc, **kw):
    return drvlib.AuditDriver(loglistlib.parse_log_list(doc["log_list"]),
                              device="cpu", **dict(DRIVER_KW, **kw))


def _report(rep) -> dict:
    out = rep.to_json()
    out.pop("wall_s")
    return out


def _metered(run):
    sink = tmetrics.InMemSink()
    prev = tmetrics.get_sink()
    tmetrics.set_sink(sink)
    try:
        return run(), sink.snapshot()
    finally:
        tmetrics.set_sink(prev)


@pytest.fixture(scope="module")
def small_runs(tmp_path_factory):
    """The small document through the JAX driver and the port's, each
    with the filter armed, and each checkpoint saved."""
    d = tmp_path_factory.mktemp("audit")
    doc = _small_doc()
    jdrv = jdrvlib.AuditDriver(
        jloglist.parse_log_list(doc["log_list"]),
        filter_path=str(d / "jax.filter"), **DRIVER_KW)
    jrep = jdrv.run_recorded(doc)
    jdrv.aggregator.save_checkpoint(str(d / "jax.npz"))
    drv = _port_driver(doc, filter_path=str(d / "port.filter"))
    rep, snap = _metered(lambda: drv.run_recorded(doc))
    drv.aggregator.save_checkpoint(str(d / "port.npz"))
    return {"doc": doc, "dir": d, "jax": (jdrv, jrep), "port": (drv, rep),
            "snap": snap}


def test_driver_small_doc_tallies_match_jax(small_runs):
    _, jrep = small_runs["jax"]
    drv, rep = small_runs["port"]
    assert _report(rep) == _report(jrep)
    assert rep.per_issuer == jrep.per_issuer
    for name, want in SMALL_EXPECT.items():
        assert getattr(rep, name) == want, name
    assert rep.quarantined == 0 and rep.decode_failed == 0
    assert rep.divergence_measured == _native_available()
    assert len(rep.per_issuer) == 2
    assert sum(v for v, _ in rep.per_issuer.values()) == 12
    assert sum(f for _, f in rep.per_issuer.values()) == 2
    c = small_runs["snap"]["counters"]
    assert c["audit.entries"] == 24.0 and c["audit.verified"] == 12.0
    assert c["audit.failed"] == 2.0 and c["audit.unknown_log"] == 2.0
    assert c["audit.retired_sct"] == 2.0 and c["audit.out_of_interval"] == 2.0
    assert "audit.quarantined" not in c
    assert drv.spool.replay() == small_runs["jax"][0].spool.replay() == []
    json.dumps(rep.to_json())


def test_driver_emits_the_jax_filter(small_runs):
    """The audited corpus compiles to the JAX driver's artifact bytes;
    every captured serial answers known."""
    from ct_mapreduce_tpu_torch.filter import read_artifact

    d = small_runs["dir"]
    blob = (d / "port.filter").read_bytes()
    assert blob == (d / "jax.filter").read_bytes()
    art = read_artifact(str(d / "port.filter"))
    assert art.n_serials == 24 and len({i for i, _ in art.groups}) == 2
    agg = small_runs["port"][0].aggregator
    for (idx, eh), serials in sorted(agg.filter_capture.items()):
        iss = agg.registry.issuer_at(idx).id()
        assert all(art.query(iss, eh, s) for s in serials)


def test_driver_tile_scaling():
    doc = _small_doc()
    rep = _port_driver(doc).run_recorded(doc, tile=3)
    for name, want in SMALL_EXPECT.items():
        assert getattr(rep, name) == 3 * want, name
    assert rep.tile == 3 and rep.pages == 1
    assert sum(rep.per_log.values()) == 3 * SMALL_EXPECT["sct_lanes"]
    assert sum(v for v, _ in rep.per_issuer.values()) == 36
    assert sum(f for _, f in rep.per_issuer.values()) == 6


def test_driver_exact_through_grows():
    """A table that grows several times during the run leaves the report
    equal to one that never grows."""
    doc = _small_doc()
    drv = _port_driver(doc, capacity=16)
    start = drv.aggregator.capacity
    grown = drv.run_recorded(doc, tile=4)
    assert drv.aggregator.capacity >= 4 * start
    flat = _port_driver(doc).run_recorded(doc, tile=4)
    assert _report(grown) == _report(flat)
    assert grown.per_issuer == flat.per_issuer


@pytest.mark.skipif(not _native_available(),
                    reason="quarantine needs the native SCT extractor")
def test_quarantine_exclusion_property(tmp_path, monkeypatch):
    """A diverging lane is spooled, and the aggregate equals a run where
    the entry never existed."""
    from ct_mapreduce_tpu_torch.native import leafpack

    doc = _small_doc()
    n = len(doc["pages"][0]["entries"])
    real = leafpack.extract_scts
    fired = {"n": 0}

    def tampered(data, length, issuer_key_hash=None, **kw):
        out = real(data, length, issuer_key_hash=issuer_key_hash, **kw)
        if fired["n"] == 0 and out.ok.shape[0] == n:
            fired["n"] = 1
            out.timestamp_ms = np.array(out.timestamp_ms, copy=True)
            out.timestamp_ms[0] += 1
        return out

    monkeypatch.setattr(leafpack, "extract_scts", tampered)
    drv = _port_driver(doc, quarantine_dir=str(tmp_path / "spool"))
    rep, snap = _metered(lambda: drv.run_recorded(doc))
    assert fired["n"] == 1
    assert rep.quarantined == 1 and rep.divergence_measured
    assert snap["counters"]["audit.quarantined"] == 1.0
    assert rep.entries == 23
    recs = drv.spool.replay()
    assert len(recs) == 1 and recs[0]["reasons"] == ["timestamp_ms"]
    assert recs[0]["index"] == 0
    dec = leaflib.decode_json_entry(0, doc["pages"][0]["entries"][0])
    assert drv.spool.replay_ders() == [dec.cert_der]
    monkeypatch.setattr(leafpack, "extract_scts", real)
    doc2 = _small_doc()
    del doc2["pages"][0]["entries"][0]
    rep2 = _port_driver(doc2).run_recorded(doc2)
    for f in ("verified", "failed", "verifier_no_key", "device_lanes",
              "host_lanes", "entries", "no_sct"):
        assert getattr(rep, f) == getattr(rep2, f), f
    assert sorted(rep.per_issuer.values()) == sorted(rep2.per_issuer.values())


def test_driver_feeds_statistics_serve_and_checkpoint(small_runs):
    """The port's audit checkpoint: the port's report and the JAX
    package's print the same verified/failed tallies, the JAX snapshot
    reader folds the same per-issuer counts, and the serve plane's
    ``/issuer`` meta sums to the report."""
    from ct_mapreduce_tpu.agg.aggregator import HostSnapshotAggregator
    from ct_mapreduce_tpu.cmd import storage_statistics as jstats
    from ct_mapreduce_tpu.config import CTConfig as JConfig
    from ct_mapreduce_tpu_torch.cmd import storage_statistics as stats
    from ct_mapreduce_tpu_torch.config import CTConfig
    from ct_mapreduce_tpu_torch.serve.server import MembershipOracle

    drv, rep = small_runs["port"]
    path = str(small_runs["dir"] / "port.npz")
    texts = []
    for cfg_cls, mod in ((CTConfig, stats), (JConfig, jstats)):
        cfg = cfg_cls()
        cfg.backend = "tpu"
        cfg.agg_state_path = path
        out = io.StringIO()
        assert mod.report_from_tpu_snapshot(cfg, out) == 0
        texts.append(out.getvalue())
        report = mod.collect_tpu_report(cfg)
        assert report["totals"]["sctsVerified"] == rep.verified
        assert report["totals"]["sctsFailed"] == rep.failed
    assert texts[0] == texts[1]
    assert f"{rep.verified} scts verified" in texts[0]
    assert f"{rep.failed} scts failed" in texts[0]
    h = HostSnapshotAggregator(capacity=1 << 10)
    h.load_checkpoint(path)
    assert h.verify_counts() == rep.per_issuer
    oracle = MembershipOracle(drv.aggregator, replicas=1, device=False,
                              cache_size=-1)
    try:
        metas = [oracle.issuer_meta(i) for i in rep.per_issuer]
        assert (sum(m["verified"] for m in metas),
                sum(m["failed"] for m in metas)) == (rep.verified, rep.failed)
    finally:
        oracle.close()


def test_resolve_audit_knob_ladder(monkeypatch):
    from ct_mapreduce_tpu import audit as jaudit

    for var in AUDIT_ENV:
        monkeypatch.delenv(var, raising=False)
    steps = [({}, (None, None), ("", "")),
             ({"CTMR_AUDIT_LOG_LIST": "/tmp/list.json",
               "CTMR_AUDIT_QUARANTINE_DIR": "/tmp/spool"}, (None, None),
              ("/tmp/list.json", "/tmp/spool")),
             ({}, ("x.json", ""), ("x.json", "/tmp/spool")),
             ({}, ("x.json", "/spool2"), ("x.json", "/spool2"))]
    for env, args, want in steps:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert auditpkg.resolve_audit(*args) == jaudit.resolve_audit(*args) \
            == want
    monkeypatch.delenv("CTMR_AUDIT_LOG_LIST")
    with pytest.raises(ValueError, match="log list"):
        drvlib.load_driver()


def test_load_driver_reads_the_knobs(tmp_path, monkeypatch):
    for var in AUDIT_ENV:
        monkeypatch.delenv(var, raising=False)
    _, _, doc = _fixture_list()
    path = tmp_path / "ll.json"
    path.write_text(json.dumps(doc))
    monkeypatch.setenv("CTMR_AUDIT_LOG_LIST", str(path))
    monkeypatch.setenv("CTMR_AUDIT_QUARANTINE_DIR", str(tmp_path / "q"))
    drv = drvlib.load_driver(device="cpu")
    assert len(drv.log_list) == 3
    assert drv.spool.directory == str(tmp_path / "q")
    assert os.path.isdir(tmp_path / "q")


def test_audit_cli_json_matches_jax(tmp_path, capsys, monkeypatch):
    """The port's entry point and the JAX repo's ``tools/audit.py`` print
    the same JSON report (all but ``wall_s``) and exit codes; the text
    mode renders; the filter and the state file load."""
    from ct_mapreduce_tpu_torch.filter import read_artifact
    from ct_mapreduce_tpu_torch.tools import audit as audit_cli
    from tools import audit as jaudit_cli

    for var in AUDIT_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("CTMR_VERIFY_BATCH", "32")
    path = str(tmp_path / "small.json.gz")
    drvlib.write_recorded(path, _small_doc())
    args = ["--recorded", path, "--json", "--flush-size", "16",
            "--batch-size", "16"]
    reps = {}
    for pkg, main in (("port", lambda a: audit_cli.main(a, device="cpu")),
                      ("jax", jaudit_cli.main)):
        capsys.readouterr()
        rc = main(args)
        reps[pkg] = (rc, json.loads(capsys.readouterr().out))
        reps[pkg][1].pop("wall_s")
    assert reps["port"] == reps["jax"]
    assert reps["port"][0] == 0 and reps["port"][1]["verified"] == 12
    fpath = str(tmp_path / "cli.filter")
    assert audit_cli.main(["--recorded", path, "--emit-filter", fpath,
                           "--flush-size", "16", "--batch-size", "16",
                           "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "per-issuer" in out and "audited 24 entries" in out
    assert read_artifact(fpath).n_serials == 24
    assert os.path.exists(fpath + ".state.npz")
    with pytest.raises(SystemExit):
        audit_cli.main(["--json"], device="cpu")


def test_recorded_format_rejected_loudly(tmp_path):
    path = str(tmp_path / "bad.json.gz")
    drvlib.write_recorded(path, {"pages": []})
    assert drvlib.load_recorded(path)["format"] == drvlib.RECORDED_FORMAT
    other = str(tmp_path / "jax.json.gz")
    jdrvlib.write_recorded(other, {"pages": []})
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()
    with gzip.open(path, "wt", encoding="utf-8") as fh:
        json.dump({"format": "CTMRXX99", "pages": []}, fh)
    with pytest.raises(ValueError, match="CTMRXX99"):
        drvlib.load_recorded(path)


def test_checked_in_shard_matches_generator(tmp_path):
    """The port's generator writes the checked-in shard byte for byte."""
    doc = drvlib.load_recorded(SHARD)
    assert doc["mix"] == dict(fxlib.MIX, no_sct=816)
    assert sum(len(p["entries"]) for p in doc["pages"]) == 1024
    out = str(tmp_path / "regen.json.gz")
    assert fxlib.main([out]) == 0
    with open(out, "rb") as a, open(SHARD, "rb") as b:
        assert a.read() == b.read()
    ll = loglistlib.parse_log_list(doc["log_list"])
    signers = fxlib.fixture_signers()
    assert set(ll.shards) == {signers[k].log_id
                              for k in ("p256", "p384", "rsa")}
    assert fxlib.main([]) == 2


def test_shard_tallies_equal_the_mix():
    """The whole checked-in shard through the port's driver: every tally
    is what the shard's mix implies (``expected_tallies``)."""
    rep = drvlib.AuditDriver(
        loglistlib.parse_log_list(drvlib.load_recorded(SHARD)["log_list"]),
        device="cpu", batch_width=64).run_recorded(SHARD)
    want = fxlib.expected_tallies()
    assert rep.entries == want["entries"] and rep.no_sct == want["no_sct"]
    for name in ("sct_lanes", "verified", "failed", "device_lanes",
                 "host_lanes", "retired", "out_of_interval", "unknown_log"):
        assert getattr(rep, name) == want[name], name
    assert rep.verifier_no_key == want["no_key"]
    assert len(rep.per_issuer) == fxlib.N_ISSUERS
    assert rep.quarantined == 0


# -- the parser-divergence harness -------------------------------------------


def test_classify_corpus_matches_jax(tmp_path):
    """The shard's DERs plus seeded structured mutants through both
    packages' walkers: equal reports field for field, no verdict
    mismatch; the trends written under ``tmp_path`` are equal."""
    from ct_mapreduce_tpu.core import divergence as jdiv
    from ct_mapreduce_tpu_torch.core import divergence

    ders = fxlib.shard_ders(drvlib.load_recorded(SHARD))
    rng = np.random.default_rng(20261019)
    mutants = divergence.grammar_mutants(ders[:64], rng, 192)
    jmutants = jdiv.grammar_mutants(ders[:64],
                                    np.random.default_rng(20261019), 192)
    assert mutants == jmutants
    corpus = ders[:256] + mutants
    rep = divergence.classify_corpus(corpus, device="cpu")
    jrep = jdiv.classify_corpus(corpus)
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert rep.verdict_mismatch == 0 and rep.total == 448
    assert rep.device_accepts >= 256
    assert divergence.iter_tlvs(ders[0]) == jdiv.iter_tlvs(ders[0])
    trends = {}
    for name, mod, r in (("port", divergence, rep), ("jax", jdiv, jrep)):
        path = str(tmp_path / f"{name}.json")
        mod.record_trend(r, path, corpus="real")
        trends[name] = mod.record_trend(r, path, corpus="fuzz")
    assert trends["port"] == trends["jax"]
    assert divergence.trend_floor(str(tmp_path / "port.json"), "real") \
        == round(rep.device_accept_rate, 6)
    snap = _metered(lambda: divergence.publish(rep))[1]
    assert snap["gauges"]["parse.device_accept_rate"] \
        == rep.device_accept_rate
