"""The port's ct-fetch and storage-statistics
(``ct_mapreduce_tpu_torch/cmd/``) against the JAX package's, on the CPU,
and the port's ``CTConfig`` against the JAX one.

The same log (``tests/fakelog.py`` for the JAX package, the port's
``utils/fakelog.py`` for the port, with the same certificates) goes
through each package's ``ct_fetch.main`` with the same ini, the port on
``device="cpu"``. In every configuration — ``backend = tpu``, the
database backend, ``certPath``, ``-offset``/``-limit``,
``overlapWorkers`` 0 and 2, staged (``chunksPerDispatch`` 2),
``meshShape`` ``shard:1`` — the two runs give the same cursor, the same
drain, the same ``storage-statistics`` text (``-v 1``, ``-v 2``, ``-v
3``, ``-json``) and PEM trees equal file for file. Each package's
report reads the other's checkpoint to the same text. The cases of
``tests/test_cmd.py`` that need no mesh are asserted on the port along
the way: ``ct-getcert`` (direct and through the query plane's
``/getcert``) prints the JAX package's PEM, ``ct-query`` prints the JAX
package's JSON over either table layout (the answering view's age
masked), and ct-fetch with ``queryPort`` serves the run's serials.

Size: ``tableBits`` 12, ``batchSize`` 64, logs of 48 entries, so the
JAX side compiles each program once for the file. Report lines carry
the cursor's wall-clock ``LastUpdateTime``, which is masked before the
texts are compared. With ``emitFilter`` both packages' ct-fetch write
the same ``.filter`` bytes in either format, and both ``ct-filter``
CLIs build, inspect and query alike; with ``verifySignatures`` both
print the same SCT totals. Tolerance: exact equality.
"""

import dataclasses
import datetime
import io
import json
import os
import re

import pytest

from ct_mapreduce_tpu.cmd import ct_fetch as jfetch
from ct_mapreduce_tpu.cmd import storage_statistics as jstats
from ct_mapreduce_tpu.config import CTConfig as JConfig
from ct_mapreduce_tpu_torch.cmd import ct_fetch as tfetch
from ct_mapreduce_tpu_torch.cmd import storage_statistics as tstats
from ct_mapreduce_tpu_torch.config import CTConfig as TConfig
from ct_mapreduce_tpu_torch.utils import fakelog as tfakelog

from tests import certgen
from tests import fakelog as jfakelog

UTC = datetime.timezone.utc
FUTURE = datetime.datetime(2031, 6, 15, tzinfo=UTC)
PKG = {"jax": (jfetch, jstats, jfakelog.FakeLog, "ct_mapreduce_tpu"),
       "port": (tfetch, tstats, tfakelog.FakeLog, "ct_mapreduce_tpu_torch")}
N_ENTRIES, N_DUPES = 48, 8
BASE_INI = ("backend = tpu\nbatchSize = 64\ntableBits = 12\n"
            "meshShape = shard:1\nhealthAddr = \nnobars = true\n")


def _certs(n=N_ENTRIES, dupes=N_DUPES, issuers=2):
    """``n`` leaves under ``issuers`` CAs (two expiry hours each), the
    last ``dupes`` replaying earlier serials, plus one CA leaf and one
    expired leaf (both filtered)."""
    cas = [certgen.make_cert(serial=1, issuer_cn=f"CLI CA {k}", is_ca=True,
                             not_after=FUTURE, key_seed=10 + k)
           for k in range(issuers)]
    out = []
    for s in range(n):
        u = s % (n - dupes)
        k = u % issuers
        leaf = certgen.make_cert(
            serial=1000 + u, issuer_cn=f"CLI CA {k}",
            subject_cn="cli.example.com", is_ca=False,
            crl_dps=(f"http://crl{k}.cli.example/ca.crl",),
            not_after=FUTURE + datetime.timedelta(hours=u % 2))
        out.append((leaf, cas[k]))
    out.insert(5, (certgen.make_cert(serial=77, issuer_cn="CLI CA 0",
                                     is_ca=True, not_after=FUTURE), cas[0]))
    out.insert(9, (certgen.make_cert(
        serial=78, issuer_cn="CLI CA 1", is_ca=False,
        not_after=datetime.datetime(2025, 6, 1, tzinfo=UTC)), cas[1]))
    return out


CERTS = _certs()


def _log(pkg, certs=CERTS, max_batch=16):
    log = PKG[pkg][2]()
    for i, (leaf, issuer) in enumerate(certs):
        log.add_cert(leaf, issuer, timestamp_ms=1700000000000 + i)
    log.max_batch = max_batch
    return log


def _patch(monkeypatch, pkg, log):
    """Route the package's default urllib transport to ``log``."""
    import importlib

    ctclient = importlib.import_module(f"{PKG[pkg][3]}.ingest.ctclient")
    monkeypatch.setattr(ctclient, "_urllib_transport", log.transport)


def _ini(*parts: str) -> str:
    """Ini text of ``parts`` in order, a later directive replacing an
    earlier one of the same name."""
    lines: dict[str, str] = {}
    for part in parts:
        for line in part.splitlines():
            if line.strip():
                lines[line.split("=", 1)[0].strip()] = line
    return "\n".join(lines.values()) + "\n"


def _fetch(pkg, argv):
    fetch = PKG[pkg][0]
    if pkg == "port":
        return fetch.main(argv, device="cpu")
    return fetch.main(argv)


def _mask(text: str) -> str:
    return re.sub(r"LastUpdateTime=[^\n\"]*", "LastUpdateTime=*", text)


def _report(pkg, argv, capsys) -> str:
    capsys.readouterr()
    assert PKG[pkg][1].main(argv) == 0
    return _mask(capsys.readouterr().out)


def _tree(root) -> dict:
    """Relative path → bytes of every file under ``root``; the cursor
    files' wall-clock update time is dropped."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                data = fh.read()
            rel = os.path.relpath(p, root)
            if rel.startswith("state" + os.sep):
                doc = json.loads(data)
                doc.pop("LastUpdateTime", None)
                data = json.dumps(doc, sort_keys=True).encode()
            out[rel] = data
    return out


def _drain(path):
    """A checkpoint's drain, read on the CPU by the port."""
    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator

    agg = TorchAggregator(capacity=1 << 10, device="cpu")
    agg.load_checkpoint(path)
    snap = agg.drain()
    return snap.counts, snap.crls, snap.dns, snap.total


SCENARIOS = {
    "tpu": ("", []),
    "certpath": ("certPath = {d}/certs\n", []),
    "offset_limit": ("certPath = {d}/certs\n", ["-offset", "7", "-limit",
                                                "20"]),
    "overlap2": ("certPath = {d}/certs\noverlapWorkers = 2\n", []),
    "staged": ("certPath = {d}/certs\nchunksPerDispatch = 2\n"
               "stagingDepth = 2\nbatchSize = 16\n", []),
    "depth0": ("deviceQueueDepth = 0\nnumThreads = 2\n", []),
}


def _run(pkg, name, tmp_path, monkeypatch, capsys) -> dict:
    """One package's ct-fetch of scenario ``name`` and its reports."""
    extra, flags = SCENARIOS[name]
    d = tmp_path / pkg
    d.mkdir()
    ini = d / "ct.ini"
    state = d / "agg.npz"
    log = _log(pkg)
    _patch(monkeypatch, pkg, log)
    ini.write_text(_ini(f"logList = {log.url}", BASE_INI,
                        f"aggStatePath = {state}", extra.format(d=d)))
    assert _fetch(pkg, ["-config", str(ini), "-nobars"] + flags) == 0
    out = {"drain": _drain(str(state))}
    for v in ("1", "2", "3"):
        out[f"v{v}"] = _report(pkg, ["-config", str(ini), "-v", v], capsys)
    out["json"] = json.loads(_report(pkg, ["-config", str(ini), "-json"],
                                     capsys))
    if (d / "certs").exists():
        out["tree"] = _tree(d / "certs")
    out["ini"], out["state"] = ini, state
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ct_fetch_and_report_match_jax(name, tmp_path, monkeypatch, capsys):
    runs = {pkg: _run(pkg, name, tmp_path, monkeypatch, capsys)
            for pkg in PKG}
    j, t = runs["jax"], runs["port"]
    for key in ("drain", "v1", "v2", "v3", "json", "tree"):
        assert t.get(key) == j.get(key), key
    counts, _, _, total = t["drain"]
    # 40 distinct leaves; entries 7..26 hold 19 of them and the expired
    # leaf.
    want = 19 if name == "offset_limit" else 40
    assert total == want
    assert f"{want} serials" in t["v1"]
    assert t["json"]["totals"]["serials"] == want
    if "tree" in t:
        pems = [p for p in t["tree"] if not p.startswith("state")
                and not os.path.basename(p).startswith(".")]
        assert len(pems) == want  # one PEM per first-seen certificate
        assert "count-only" not in t["v2"]
        assert t["v3"].count("-----BEGIN CERTIFICATE-----") == want
        cursor = json.loads(t["tree"][next(
            p for p in t["tree"] if p.startswith("state"))])
        assert cursor["MaxEntry"] == (27 if name == "offset_limit"
                                      else N_ENTRIES + 2)
    else:
        assert "count-only" in t["v2"]
    # Each package's report reads the other's checkpoint to the same text.
    for pkg, other in (("jax", "port"), ("port", "jax")):
        ini = runs[pkg]["ini"]
        text = ini.read_text().replace(str(runs[pkg]["state"]),
                                       str(runs[other]["state"]))
        ini.write_text(text)
        assert _report(pkg, ["-config", str(ini), "-v", "2"],
                       capsys) == runs[pkg]["v2"]


def test_ct_fetch_database_backend(tmp_path, monkeypatch, capsys):
    """The per-entry path: PEM trees and cursors equal."""
    trees = {}
    for pkg in PKG:
        d = tmp_path / pkg
        log = _log(pkg)
        _patch(monkeypatch, pkg, log)
        ini = tmp_path / f"{pkg}.ini"
        ini.write_text(f"logList = {log.url}\ncertPath = {d}\n"
                       "healthAddr = \n")
        assert _fetch(pkg, ["-config", str(ini), "-nobars"]) == 0
        trees[pkg] = _tree(d)
    assert trees["port"] == trees["jax"]
    pems = [p for p in trees["port"] if not p.startswith("state")
            and not os.path.basename(p).startswith(".")]
    assert len(pems) == 40
    assert any(p.startswith("state") for p in trees["port"])


def test_ct_fetch_resumes_from_its_cursor(tmp_path, monkeypatch, capsys):
    """A second run over a grown log resumes from the cursor in the PEM
    tree's state file and from ``aggStatePath``, and drains as one
    uninterrupted run does, in either package."""
    out = {}
    for pkg in PKG:
        d = tmp_path / pkg
        full = _log(pkg)
        part = _log(pkg, certs=CERTS[:20])
        ini = tmp_path / f"{pkg}.ini"
        ini.write_text(f"logList = {full.url}\n" + BASE_INI
                       + f"aggStatePath = {d}/agg.npz\ncertPath = {d}/c\n")
        _patch(monkeypatch, pkg, part)
        assert _fetch(pkg, ["-config", str(ini)]) == 0
        _patch(monkeypatch, pkg, full)
        assert _fetch(pkg, ["-config", str(ini)]) == 0
        starts = [r for r in full.requests if "get-entries" in r]
        assert "start=20&" in starts[0]  # resumed at the cursor
        one = tmp_path / f"{pkg}-one.ini"
        one.write_text(f"logList = {full.url}\n" + BASE_INI
                       + f"aggStatePath = {d}/one.npz\n"
                       f"certPath = {d}/one\n")
        assert _fetch(pkg, ["-config", str(one)]) == 0
        out[pkg] = (_drain(f"{d}/agg.npz"), _tree(f"{d}/c"))
        assert out[pkg][0] == _drain(f"{d}/one.npz")
        assert out[pkg][1] == _tree(f"{d}/one")
    assert out["port"] == out["jax"]


def test_mesh_shape_on_the_port(tmp_path, monkeypatch):
    """``meshShape = shard:1`` and an empty meshShape on the CPU build
    the single-device aggregator and drain as the JAX package's
    ``shard:1`` run; a shape of more devices than are visible (one on
    the CPU) is refused as the JAX package refuses it."""
    from ct_mapreduce_tpu.models.ingest_model import (
        build_aggregator as jbuild,
    )
    from ct_mapreduce_tpu.agg.aggregator import TpuAggregator
    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.models.ingest_model import build_aggregator

    cfg = dict(table_bits=10, batch_size=64, mesh_shape="shard:1")
    assert isinstance(jbuild(JConfig(**cfg)), TpuAggregator)
    assert isinstance(build_aggregator(TConfig(**cfg), device="cpu"),
                      TorchAggregator)
    drains = []
    for pkg, mesh in (("jax", "shard:1"), ("port", "shard:1"),
                      ("port", "")):
        d = tmp_path / f"{pkg}{mesh.replace(':', '')}"
        log = _log(pkg)
        _patch(monkeypatch, pkg, log)
        ini = tmp_path / f"{d.name}.ini"
        ini.write_text(_ini(f"logList = {log.url}", BASE_INI,
                            f"meshShape = {mesh}", f"aggStatePath = {d}.npz"))
        assert _fetch(pkg, ["-config", str(ini)]) == 0
        drains.append(_drain(f"{d}.npz"))
    assert drains[0] == drains[1] == drains[2]
    for mesh, n in (("shard:2", 2), ("data:4,expert:2", 8)):
        with pytest.raises(ValueError,
                           match=f"mesh needs {n} devices, only 1"):
            build_aggregator(TConfig(table_bits=10, mesh_shape=mesh),
                             device="cpu")


@pytest.mark.parametrize("directive,item", [
    ("metricsPort = 9464", "item 14"), ("fleetMetrics = true", "item 14"),
    ("sloMaxIngestLag = 10", "item 14")])
def test_unported_directives_raise(tmp_path, monkeypatch, directive, item):
    for env in ("CTMR_NUM_WORKERS", "CTMR_COORDINATOR",
                "CTMR_CHECKPOINT_PERIOD", "CTMR_EMIT_FILTER", "CTMR_VERIFY"):
        monkeypatch.delenv(env, raising=False)
    ini = tmp_path / "ct.ini"
    ini.write_text("logList = https://ct.example.com/fake\n" + BASE_INI
                   + directive + "\n")
    with pytest.raises(ValueError, match=item):
        tfetch.main(["-config", str(ini)], device="cpu")


def test_ct_fetch_verify_signatures_matches_jax(tmp_path, monkeypatch,
                                               capsys):
    """``verifySignatures`` with ``verifyLogKeys`` over a log whose
    leaves carry SCTs from two P-256 logs (some signatures corrupted,
    some leaves without an SCT): both packages' ct-fetch print the same
    storage-statistics reports with the generator's SCT totals, and each
    report reads the other's checkpoint alike. ``CTMR_VERIFY_BATCH`` 32,
    so the JAX side compiles one verify shape."""
    from ct_mapreduce_tpu_torch.verify import lane as tlane
    from ct_mapreduce_tpu_torch.verify import sct as tsct

    for env in ("CTMR_VERIFY", "CTMR_VERIFY_KEYS",
                "CTMR_VERIFY_PRECOMP_WINDOW", "CTMR_VERIFY_QTABLE_SIZE"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("CTMR_VERIFY_BATCH", "32")
    signers = [tsct.EcSctSigner("cmd-a"), tsct.EcSctSigner("cmd-b")]
    reg = tlane.LogKeyRegistry()
    for sg in signers:
        reg.register_signer(sg)
    keys = tmp_path / "keys.json"
    keys.write_text(reg.to_json())
    certs, want = [], {"verified": 0, "failed": 0}
    for i, (leaf, issuer) in enumerate(CERTS):
        if i in (5, 9) or i % 4 == 3:  # the CA and expired leaves, and
            certs.append((leaf, issuer))  # every fourth: no SCT
            continue
        bad = i % 5 == 0
        certs.append((tsct.attach_sct(leaf, signers[i % 2], 10**12 + i,
                                      corrupt_signature=bad,
                                      issuer_der=issuer), issuer))
        want["failed" if bad else "verified"] += 1
    runs = {}
    for pkg in PKG:
        d = tmp_path / pkg
        d.mkdir()
        log = _log(pkg, certs)
        _patch(monkeypatch, pkg, log)
        ini = d / "ct.ini"
        state = d / "agg.npz"
        ini.write_text(_ini(f"logList = {log.url}", BASE_INI,
                            f"aggStatePath = {state}",
                            f"verifySignatures = true\n"
                            f"verifyLogKeys = {keys}\n"))
        assert _fetch(pkg, ["-config", str(ini), "-nobars"]) == 0
        runs[pkg] = {"ini": ini, "state": state, "drain": _drain(str(state)),
                     "v1": _report(pkg, ["-config", str(ini), "-v", "1"],
                                   capsys),
                     "json": json.loads(_report(
                         pkg, ["-config", str(ini), "-json"], capsys))}
    j, t = runs["jax"], runs["port"]
    assert (t["drain"], t["v1"], t["json"]) == (j["drain"], j["v1"],
                                                j["json"])
    assert f"{want['verified']} scts verified" in t["v1"]
    assert f"{want['failed']} scts failed" in t["v1"]
    assert t["json"]["totals"]["sctsVerified"] == want["verified"]
    assert t["json"]["totals"]["sctsFailed"] == want["failed"]
    for pkg, other in (("jax", "port"), ("port", "jax")):
        ini = runs[pkg]["ini"]
        ini.write_text(ini.read_text().replace(str(runs[pkg]["state"]),
                                               str(runs[other]["state"])))
        assert _report(pkg, ["-config", str(ini), "-v", "1"],
                       capsys) == runs[pkg]["v1"]


def test_ct_fetch_requires_loglist(capsys):
    assert jfetch.main(["-nobars"]) == tfetch.main(["-nobars"]) == 2


def test_storage_statistics_parity_mode(monkeypatch):
    """The database report over an in-process engine run prints the
    same text in both packages (``-v 2``), and the JSON collector the
    same totals."""
    import importlib

    texts, reports = {}, {}
    for pkg in PKG:
        root = PKG[pkg][3]
        engine_mod = importlib.import_module(f"{root}.engine")
        sync = importlib.import_module(f"{root}.ingest.sync")
        stats = PKG[pkg][1]
        config = PKG[pkg][0].CTConfig.load([])
        database, cache, backend = engine_mod.get_configured_storage(config)
        sink = sync.DatabaseSink(database, now=datetime.datetime(
            2025, 1, 1, tzinfo=UTC))
        engine = sync.LogSyncEngine(sink, database, num_threads=1)
        engine.start_store_threads()
        log = _log(pkg)
        engine.sync_log(log.url, transport=log.transport)
        engine.wait_for_downloads(timeout=30)
        engine.stop()
        monkeypatch.setattr(stats, "get_configured_storage",
                            lambda c, _r=(database, cache, backend): _r)
        out = io.StringIO()
        assert stats.report_from_database(config, out, verbosity=2) == 0
        texts[pkg] = out.getvalue()
        reports[pkg] = stats.collect_database_report(config)
    assert texts["port"] == texts["jax"]
    assert reports["port"] == reports["jax"]
    assert "overall totals: 2 issuers, 40 serials" in texts["port"]
    assert "Serials:" in texts["port"]


# -- CTConfig -----------------------------------------------------------

CONFIG_CASES = {
    "defaults": ("", [], {}),
    "ini": ("numThreads = 7\nlogList = https://a.example/log, "
            "https://b.example/log\nrunForever = true\n"
            "issuerCNFilter = Let's Encrypt\n", [], {}),
    "env_beats_ini": ("numThreads = 7\ncertPath = /from/ini\n", [],
                      {"numThreads": "3", "certPath": "/from/env"}),
    "flags": ("offset = 5\nlimit = 10\n",
              ["--offset", "100", "--limit", "200", "-nobars", "-v", "2",
               "-outputRefreshPeriod", "1s"], {"offset": "50"}),
    "unparseable": ("numThreads = banana\nrunForever = maybe\n", [], {}),
    "device": ("backend = tpu\nbatchSize = 131072\ntableBits = 24\n"
               "tableGrowAt = 0.8\ntableMaxBits = 26\nmeshShape = shard:1\n",
               ["--backend", "redis"], {"tableGrowAt": "banana"}),
    "observability": ("tracePath = /tmp/t.json\nmetricsPort = 9464\n", [],
                      {"metricsPort": "9000"}),
    "staged": ("chunksPerDispatch = 8\nstagingDepth = 3\n", [],
               {"chunksPerDispatch": "16"}),
    "serve": ("queryPort = 9090\nserveReplicas = 4\nserveDevice = false\n"
              "serveCacheSize = 512\n", [], {"serveReplicas": "many"}),
    "verify": ("verifySignatures = true\nverifyLogKeys = /k.json\n"
               "verifyPrecompWindow = 0\nverifyQTableSize = 48\n", [],
               {"verifySignatures": "maybe"}),
    "fleet": ("numWorkers = 4\nworkerId = 2\ncheckpointPeriod = 30s\n"
              "coordinatorBackend = redis\n", [], {"workerId": "0"}),
    "profile": ("platformProfile = /p.json\ndistribHistory = 6\n"
                "maxDeltaChain = 3\ncheckpointMode = ck01\n"
                "ckptMaxChain = 4\nckptSegmentBudgetMB = 16\n", [], {}),
    "filter_obs": ("emitFilter = true\nfilterFpRate = 0.005\n"
                   "filterFormat = fl01\nfleetMetrics = false\n"
                   "sloMaxIngestLag = 7\nsloMaxServeP99Ms = 2.5\n"
                   "auditLogList = /ll.json\n", [], {}),
    "sink": ("overlapWorkers = 2\npreparsedIngest = true\n"
             "decodeWorkers = 3\ndecodeThreads = 2\n"
             "deviceQueueDepth = 0\nlogExpiredEntries = 1\n"
             "savePeriod = 5s\npollingDelayMean = 1s\n"
             "pollingDelayStdDev = 5\nprofileDir = /prof\n", [], {}),
}


@pytest.mark.parametrize("name", sorted(CONFIG_CASES))
def test_config_parses_as_jax(name, tmp_path):
    """The port's ``CTConfig`` parses the same ini, flags and env to the
    same fields as the JAX one, and documents every directive it does."""
    text, flags, env = CONFIG_CASES[name]
    ini = tmp_path / "ct.ini"
    ini.write_text(text)
    argv = ["--config", str(ini)] + flags
    kw = dict(env=env, default_ini=str(tmp_path / "missing.ini"))
    j = dataclasses.asdict(JConfig.load(argv, **kw))
    t = dataclasses.asdict(TConfig.load(argv, **kw))
    assert t == j
    cfg = TConfig.load(argv, **kw)
    assert cfg.log_urls() == JConfig.load(argv, **kw).log_urls()
    assert cfg.issuer_cn_filters() == JConfig.load(
        argv, **kw).issuer_cn_filters()
    if name == "defaults":
        assert (cfg.num_threads, cfg.save_period, cfg.health_addr) == (
            1, "15m", ":8080")
        usage, jusage = TConfig().usage(), JConfig().usage()
        for directive in TConfig._DIRECTIVES:
            assert (directive in usage) == (directive in jusage), directive
        for directive in ("certPath", "redisHost", "issuerCNFilter",
                          "runForever", "logList", "healthAddr", "backend",
                          "meshShape", "overlapWorkers", "aggStatePath"):
            assert directive in usage, directive
        assert TConfig._DIRECTIVES == JConfig._DIRECTIVES


# -- ct-getcert, ct-query and the query plane -----------------------------


def _getcert(pkg, argv, transport) -> tuple[int, str]:
    import importlib

    mod = importlib.import_module(f"{PKG[pkg][3]}.cmd.ct_getcert")
    out = io.StringIO()
    return mod.main(argv, transport=transport, out=out), out.getvalue()


def test_ct_getcert(capsys):
    """One entry by index, printed as the JAX package prints it."""
    outs = {}
    for pkg in PKG:
        log = _log(pkg)
        outs[pkg] = _getcert(pkg, ["-log", log.url, "-index", "1"],
                             log.transport)
    assert outs["port"] == outs["jax"]
    rc, pem = outs["port"]
    assert rc == 0 and pem.startswith("-----BEGIN CERTIFICATE-----")
    from ct_mapreduce_tpu_torch.core import der as hostder

    assert pem.encode() == hostder.der_to_pem(CERTS[1][0])


def test_ct_getcert_routes_via_query_plane(tmp_path):
    """With a query plane up, ct-getcert fetches through its /getcert
    proxy (no direct transport at all), by ``-queryAddr`` or by an ini's
    ``queryPort``; with the plane down it falls back to the direct
    transport. Every PEM equals the JAX package's direct fetch."""
    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.serve.server import QueryServer

    jlog = _log("jax")
    want = {i: _getcert("jax", ["-log", jlog.url, "-index", str(i)],
                        jlog.transport) for i in (0, 1)}
    log = _log("port")
    agg = TorchAggregator(capacity=1 << 10, batch_size=64, device="cpu")
    srv = QueryServer(agg, 0, host="127.0.0.1",
                      transport=log.transport).start()
    try:
        assert _getcert("port", ["-log", log.url, "-index", "1",
                                 "-queryAddr", f"127.0.0.1:{srv.port}"],
                        None) == want[1]
        ini = tmp_path / "q.ini"
        ini.write_text(f"queryPort = {srv.port}\n")
        assert _getcert("port", ["-log", log.url, "-index", "0",
                                 "-config", str(ini)], None) == want[0]
    finally:
        srv.stop()
    assert _getcert("port", ["-log", log.url, "-index", "1",
                             "-queryAddr", f"127.0.0.1:{srv.port}"],
                    log.transport) == want[1]


@pytest.mark.parametrize("layout", ["bucket", "open"])
def test_ct_query_cli_matches_jax(layout, monkeypatch):
    """ct-query against each package's query plane over the same
    ingest: the same exit codes and the same JSON (the view's age
    masked); an unreachable plane exits 2."""
    import importlib

    from ct_mapreduce_tpu.agg.aggregator import TpuAggregator
    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.core import der as hostder
    from ct_mapreduce_tpu_torch.core.types import ExpDate, Issuer
    from ct_mapreduce_tpu_torch.utils import syncerts

    monkeypatch.setenv("CTMR_TABLE", layout)
    tpl = syncerts.make_template(issuer_cn="Query CLI CA")
    entries = [(syncerts.stamp_serial(tpl, j), tpl.issuer_der)
               for j in range(5)]
    issuer_id = Issuer.from_spki(hostder.parse_cert(tpl.issuer_der).spki).id()
    exp_id = ExpDate.from_unix_hour(
        hostder.parse_cert(tpl.leaf_der).not_after_unix_hour).id()

    def serial_hex(j):
        der = syncerts.stamp_serial(tpl, j)
        return der[tpl.serial_off:tpl.serial_off + tpl.serial_len].hex()

    # Masked: the answering view's age and epoch and the replica
    # pool's state (the second replica is captured on a background
    # thread), and the /healthz totals of the process-wide metric sink.
    racy = ("staleness_s", "snapshot_age_s", "replica_ages_s", "epoch",
            "snapshot_epoch", "replicas", "replica_epochs",
            "replica_device", "refresh_in_flight", "shed_total",
            "batches_total", "cache_hit_total", "cache_miss_total",
            "device_fallback_total")

    def mask(doc):
        if isinstance(doc, dict):
            return {k: "*" if k in racy else mask(v) for k, v in doc.items()}
        return doc

    calls = [
        ["-issuer", issuer_id, "-expDate", exp_id, "-serial", serial_hex(0),
         "-serial", serial_hex(4)],
        ["-issuer", issuer_id, "-expDate", exp_id, "-serial",
         serial_hex(999)],
        ["-issuerMeta", issuer_id],
        ["-health"],
    ]
    got = {}
    kw = dict(capacity=1 << 10, batch_size=64, max_capacity=1 << 10)
    for pkg, agg in (("jax", TpuAggregator(**kw)),
                     ("port", TorchAggregator(device="cpu", **kw))):
        server = importlib.import_module(f"{PKG[pkg][3]}.serve.server")
        cli = importlib.import_module(f"{PKG[pkg][3]}.cmd.ct_query")
        agg.ingest(entries)
        srv = server.QueryServer(agg, 0, host="127.0.0.1",
                                 max_delay_s=0.001).start()
        addr = f"127.0.0.1:{srv.port}"
        got[pkg] = []
        try:
            for argv in calls:
                out = io.StringIO()
                rc = cli.main(["-addr", addr] + argv, out=out)
                doc = json.loads(out.getvalue())
                assert doc.get("epoch", 1) >= 1
                got[pkg].append((rc, mask(doc)))
        finally:
            srv.stop()
        assert cli.main(["-addr", addr, "-health"], out=io.StringIO()) == 2
    assert got["port"] == got["jax"]
    (rc0, known), (rc1, unknown), (rc2, meta), (rc3, health) = got["port"]
    assert (rc0, rc1, rc2, rc3) == (0, 1, 0, 0)
    assert [r["known"] for r in known["results"]] == [True, True]
    assert meta["unknown_total"] == 5 and health["healthy"] is True


def test_ct_fetch_starts_query_plane(tmp_path, monkeypatch):
    """queryPort on the port's ct-fetch: the query plane answers for the
    run's serials while it lives (probed just before ct-fetch stops it)
    and is gone after main() returns."""
    import socket

    from ct_mapreduce_tpu_torch.core import der as hostder
    from ct_mapreduce_tpu_torch.core.types import ExpDate, Issuer
    from ct_mapreduce_tpu_torch.serve import server as serve_server
    from ct_mapreduce_tpu_torch.serve.client import QueryClient

    log = _log("port")
    _patch(monkeypatch, "port", log)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    leaf, ca = CERTS[0]
    f = hostder.parse_cert(leaf)
    query = {"issuer": Issuer.from_spki(hostder.parse_cert(ca).spki).id(),
             "expDate": ExpDate.from_unix_hour(f.not_after_unix_hour).id(),
             "serial": f.serial.hex()}
    ghost = dict(query, serial="7f" + f.serial.hex())
    probed = {}
    orig_stop = serve_server.QueryServer.stop

    def spy_stop(self):
        try:
            client = QueryClient(f"127.0.0.1:{self.port}")
            probed["health"] = client.healthz()
            probed["query"] = client.query([query, ghost])
        finally:
            orig_stop(self)

    monkeypatch.setattr(serve_server.QueryServer, "stop", spy_stop)
    ini = tmp_path / "ct.ini"
    ini.write_text(_ini(f"logList = {log.url}", BASE_INI,
                        f"aggStatePath = {tmp_path / 'agg.npz'}",
                        f"queryPort = {port}"))
    assert tfetch.main(["-config", str(ini)], device="cpu") == 0
    assert probed["health"]["healthy"] is True
    assert [r["known"] for r in probed["query"]["results"]] == [True, False]
    with pytest.raises(OSError):
        QueryClient(f"127.0.0.1:{port}", timeout_s=2).healthz()


_FILTER_ENV = ("CTMR_EMIT_FILTER", "CTMR_FILTER_PATH", "CTMR_FILTER_FP_RATE",
               "CTMR_FILTER_FORMAT", "CTMR_FILTER_SPILL_DIR",
               "CTMR_FILTER_STREAM_CHUNK", "CTMR_FILTER_FUSED_LANES")


def _emit_run(pkg, d, monkeypatch, fmt):
    """One ct-fetch of the shared log with emitFilter; returns the
    checkpoint path and the artifact's bytes."""
    for env in _FILTER_ENV:
        monkeypatch.delenv(env, raising=False)
    log = _log(pkg)
    _patch(monkeypatch, pkg, log)
    d.mkdir()
    ini = d / "ct.ini"
    ini.write_text(_ini(f"logList = {log.url}", BASE_INI,
                        f"aggStatePath = {d / 'agg.npz'}",
                        "emitFilter = true", f"filterFormat = {fmt}",
                        "filterFpRate = 0.02", "filterStreamChunk = 16"))
    assert _fetch(pkg, ["-config", str(ini)]) == 0
    return str(d / "agg.npz"), (d / "agg.npz.filter").read_bytes()


@pytest.mark.parametrize("fmt", ["fl01", "fl02"])
def test_ct_fetch_emit_filter_matches_jax(tmp_path, monkeypatch, fmt):
    """emitFilter through both packages' ct-fetch over one log: the
    emitted ``<aggStatePath>.filter`` files are byte-identical, and every
    first-seen serial answers known."""
    from ct_mapreduce_tpu_torch.filter import FilterArtifact

    blobs = {pkg: _emit_run(pkg, tmp_path / pkg, monkeypatch, fmt)[1]
             for pkg in ("jax", "port")}
    assert blobs["port"] == blobs["jax"]
    art = FilterArtifact.from_bytes(blobs["port"])
    assert art.fmt == fmt and art.n_serials == N_ENTRIES - N_DUPES


def _filter_cli(pkg, argv, capsys):
    from ct_mapreduce_tpu.cmd import ct_filter as jfilter
    from ct_mapreduce_tpu_torch.cmd import ct_filter as tfilter

    capsys.readouterr()
    if pkg == "port":
        rc = tfilter.main(["-device", "cpu"] + argv)
    else:
        rc = jfilter.main(argv)
    return rc, capsys.readouterr().out


def test_ct_filter_clis_match_jax(tmp_path, monkeypatch, capsys):
    """Both ct-filter CLIs over the port's emitFilter checkpoint: build
    writes the same bytes (those ct-fetch emitted), inspect and query
    print the same text with the same exit codes (0 all known, 1 any
    unknown, 2 on a usage error); ``delta``, ``apply`` and ``container``
    over two builds write the same files and print the same text."""
    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.core.types import ExpDate

    state, emitted = _emit_run("port", tmp_path / "run", monkeypatch, "fl02")
    agg = TorchAggregator(capacity=1 << 10, device="cpu")
    agg.load_checkpoint(state)
    (idx, eh), serials = sorted(agg.filter_capture.items())[0]
    iss = agg.registry.issuer_at(idx).id()
    exp_id = ExpDate.from_unix_hour(eh).id()
    known = sorted(serials)[0].hex()
    outs = {}
    for pkg in ("jax", "port"):
        out = str(tmp_path / f"{pkg}.filter")
        rc, text = _filter_cli(pkg, ["build", "-state", state, "-out", out,
                                     "-fpRate", "0.02"], capsys)
        assert rc == 0 and json.loads(text)["groups"] == 2
        with open(out, "rb") as fh:
            assert fh.read() == emitted
        runs = [["inspect", "-artifact", out],
                ["inspect", "-artifact", out, "-json"],
                ["query", "-artifact", out, "-issuer", iss,
                 "-expDate", exp_id, "-serial", known],
                ["query", "-artifact", out, "-issuer", "nobody",
                 "-expDate", exp_id, "-serial", known],
                ["query", "-artifact", out, "-issuer", iss,
                 "-expDate", exp_id, "-serial", "zz"],
                ["query", "-artifact", out, "-issuer", iss,
                 "-expDate", exp_id]]
        outs[pkg] = [_filter_cli(pkg, argv, capsys) for argv in runs]
    assert outs["port"] == outs["jax"]
    assert [rc for rc, _ in outs["port"]] == [0, 0, 0, 1, 2, 2]
    assert json.loads(outs["port"][1][1])["groups"] == 2
    plane = {}
    for pkg in ("jax", "port"):
        d = tmp_path / f"{pkg}-plane"
        d.mkdir()
        base, target = str(tmp_path / "jax.filter"), str(d / "t.filter")
        rc, _ = _filter_cli(pkg, ["build", "-state", state, "-out", target,
                                  "-fpRate", "0.05"], capsys)
        assert rc == 0
        runs = [["delta", "-base", base, "-target", target,
                 "-out", str(d / "d.delta"), "-fromEpoch", "3",
                 "-toEpoch", "4"],
                ["apply", "-base", base, "-delta", str(d / "d.delta"),
                 "-out", str(d / "r.filter")],
                ["container", "-artifact", target, "-kind", "clubcard",
                 "-out", str(d / "t.cc")],
                ["delta", "-base", base, "-target", str(d / "nope"),
                 "-out", str(d / "x.delta")]]
        got = [(rc, text.replace(str(d), "<d>"))
               for rc, text in (_filter_cli(pkg, argv, capsys)
                                for argv in runs)]
        got.append([(d / n).read_bytes()
                    for n in ("d.delta", "r.filter", "t.cc")])
        assert got[-1][1] == (d / "t.filter").read_bytes()
        plane[pkg] = got
    assert plane["port"] == plane["jax"]
    assert [rc for rc, _ in plane["port"][:4]] == [0, 0, 0, 2]
