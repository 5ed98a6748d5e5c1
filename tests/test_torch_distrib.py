"""The port's filter distribution plane (``ct_mapreduce_tpu_torch.distrib``,
the serve plane's filter-first tier and ``/filter*`` routes, ct-fetch's
``refresh_serve_filter`` and ``ct-filter-torch delta/apply/container``)
against the JAX package's, on the CPU.

The cases of ``tests/test_distrib.py`` and the distribution cases of
``tests/test_filter.py`` and ``tests/test_filter_format.py`` run on the
port. Every delta, bundle, manifest and container the port writes is
held to the JAX package's bytes for the same artifacts (whose bytes the
two packages already share), deltas apply across the packages in both
directions, and a JAX ``QueryServer`` and a port one over equal state
serve the same bytes, ETags, 304s, encodings and delta bundles.
Inputs are made from seeds with NumPy. Tolerance: exact bytes and exact
counts.
"""

import gzip
import hashlib
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from ct_mapreduce_tpu import distrib as jdistrib
from ct_mapreduce_tpu.agg.aggregator import TpuAggregator
from ct_mapreduce_tpu.distrib import delta as jdelta
from ct_mapreduce_tpu.filter import build_artifact as jbuild_artifact
from ct_mapreduce_tpu_torch import distrib
from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
from ct_mapreduce_tpu_torch.core.types import ExpDate
from ct_mapreduce_tpu_torch.distrib import delta as delta_mod
from ct_mapreduce_tpu_torch.distrib.container import ContainerError
from ct_mapreduce_tpu_torch.filter import (
    FORMAT_FL01,
    FORMAT_FL02,
    FilterArtifact,
    build_artifact,
    build_from_aggregator,
)
from ct_mapreduce_tpu_torch.serve.server import MembershipOracle, QueryServer
from ct_mapreduce_tpu_torch.telemetry import metrics as tmetrics
from ct_mapreduce_tpu_torch.utils import minicert

FORMATS = (FORMAT_FL01, FORMAT_FL02)
ISSUER_DER = minicert.make_cert(serial=1, issuer_cn="Distrib CA", is_ca=True)
ISSUER_DER_B = minicert.make_cert(serial=2, issuer_cn="Distrib CA B",
                                  is_ca=True)


def corpus(n=60, issuer_cn="Distrib CA", issuer=ISSUER_DER, base=1000):
    return [(minicert.make_cert(serial=base + s, issuer_cn=issuer_cn,
                                subject_cn=f"d{s}.example"), issuer)
            for s in range(n)]


def epoch_sets(rng, n_groups, per_group, salt):
    return {
        (f"issuer-{g}", 500_000 + 24 * g): {
            bytes([salt, g, s % 251, 7]) + bytes(
                [int(x) for x in rng.integers(0, 256, 2)])
            for s in range(per_group)
        }
        for g in range(n_groups)
    }


def build(sets, fmt=FORMAT_FL02):
    """The port's artifact bytes, held to the JAX package's."""
    blob = build_artifact(sets, fp_rate=0.01, use_device=False,
                          fmt=fmt).to_bytes()
    assert blob == jbuild_artifact(sets, fp_rate=0.01, use_device=False,
                                   fmt=fmt).to_bytes()
    return blob


def port_agg(**kw):
    kw.setdefault("capacity", 1 << 10)
    return TorchAggregator(batch_size=64, device="cpu", **kw)


def captured_agg(ents, **kw):
    agg = port_agg(**kw)
    agg.enable_filter_capture()
    agg.ingest(ents)
    return agg


def chain_both(blobs):
    """Each package's delta links over ``blobs``, held equal."""
    links = [distrib.compute_delta(blobs[i], blobs[i + 1], i, i + 1)
             for i in range(len(blobs) - 1)]
    assert links == [jdistrib.compute_delta(blobs[i], blobs[i + 1], i, i + 1)
                     for i in range(len(blobs) - 1)]
    return links


def evolve(rng, sets, steps, seq):
    """Randomized epochs: serials added, groups added and removed."""
    blobs = []
    for _ in range(steps):
        for key in sorted(sets)[:2]:
            sets[key] = set(sets[key]) | {
                bytes([int(x) for x in rng.integers(0, 256, 5)])
                for _ in range(int(rng.integers(1, 6)))}
        if rng.integers(2):
            sets[(f"new-{seq}-{len(blobs)}", 700_000)] = {
                bytes([int(x) for x in rng.integers(0, 256, 4)])}
        if rng.integers(2) and len(sets) > 3:
            del sets[sorted(sets)[-1]]
        blobs.append(sets_copy(sets))
    return blobs


def sets_copy(sets):
    return {k: set(v) for k, v in sets.items()}


# -- delta chains ------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
def test_delta_chain_replays_any_epoch_sequence(fmt):
    """Randomized epoch sequences replay through the delta chain to the
    full build's bytes at every prefix; the port's links equal the JAX
    package's, and each package replays the other's."""
    rng = np.random.default_rng(20260805)
    for seq in range(2):
        sets = epoch_sets(rng, n_groups=6, per_group=25, salt=seq)
        blobs = [build(sets, fmt)] + [
            build(s, fmt) for s in evolve(rng, sets, 4, seq)]
        links = chain_both(blobs)
        want = b"CTMRDL01" if fmt == FORMAT_FL01 else b"CTMRDL02"
        assert all(link[:8] == want for link in links)
        for i in range(1, len(blobs)):
            assert distrib.apply_chain(blobs[0], links[:i]) == blobs[i]
            assert jdistrib.apply_chain(blobs[0], links[:i]) == blobs[i]
        assert delta_mod.delta_format(links[0]) == fmt


def test_delta_chain_across_growth_and_fleet_merge(tmp_path):
    """Epoch 0 → 1 spans a grow-and-rehash of the port's table; epoch
    1 → 2 lands on a merged two-checkpoint artifact. Both packages'
    links are equal and replay to the merged build's bytes."""
    from ct_mapreduce_tpu_torch.agg import merge
    from ct_mapreduce_tpu_torch.filter import build_from_merged

    agg = captured_agg(corpus(n=40, base=1000), capacity=1 << 8,
                       grow_at=0.5, max_capacity=1 << 14)
    e0 = build_from_aggregator(agg, fp_rate=0.01).to_bytes()
    agg.ingest(corpus(n=120, base=3000))
    assert agg.capacity > (1 << 8), "growth never fired"
    e1 = build_from_aggregator(agg, fp_rate=0.01).to_bytes()
    p0 = str(tmp_path / "agg.w0.npz")
    agg.save_checkpoint(p0)
    other = captured_agg(corpus(n=50, issuer_cn="Distrib CA B",
                                issuer=ISSUER_DER_B, base=9000))
    p1 = str(tmp_path / "agg.w1.npz")
    other.save_checkpoint(p1)
    e2 = build_from_merged(merge.load_checkpoints([p0, p1]),
                           fp_rate=0.01, device="cpu").to_bytes()
    links = chain_both([e0, e1, e2])
    assert distrib.apply_chain(e0, links) == e2
    assert jdistrib.apply_chain(e0, links) == e2
    assert distrib.apply_delta(distrib.apply_delta(e0, links[0]),
                               links[1]) == e2


@pytest.mark.parametrize("case", ["corrupt", "truncated", "misordered",
                                  "magic"])
def test_delta_rejects_corruption_and_misorder(case):
    """A corrupted, truncated, misordered or foreign link raises
    ``DeltaError`` in both packages, with the same message."""
    rng = np.random.default_rng(7)
    s0 = epoch_sets(rng, 4, 20, salt=1)
    s1 = {k: set(v) | {b"\x01\x02\x03"} for k, v in s0.items()}
    b0, b1 = build(s0), build(s1)
    d = chain_both([b0, b1])[0]
    assert distrib.apply_delta(b0, d) == b1
    corrupt = bytearray(d)
    corrupt[-3] ^= 0x40
    base, link, match = {
        "corrupt": (b0, bytes(corrupt), "hash mismatch"),
        "truncated": (b0, d[:-5], "truncated"),
        "misordered": (b1, d, "base mismatch"),
        "magic": (b0, b"XXXXXXXX" + d[8:], "magic"),
    }[case]
    with pytest.raises(distrib.DeltaError, match=match) as port_err:
        distrib.apply_delta(base, link)
    with pytest.raises(jdistrib.DeltaError) as jax_err:
        jdistrib.apply_delta(base, link)
    assert str(port_err.value) == str(jax_err.value)


def test_chain_manifest_validates_links():
    rng = np.random.default_rng(11)
    sets = epoch_sets(rng, 3, 15, salt=2)
    blobs = [build(sets)]
    for i in range(3):
        sets[sorted(sets)[0]] = set(sets[sorted(sets)[0]]) | {bytes([i, 9])}
        blobs.append(build(sets))
    dblobs = chain_both(blobs)
    links = [delta_mod.ChainLink(
        from_epoch=i, to_epoch=i + 1,
        sha256=hashlib.sha256(db).hexdigest(),
        base_sha256=delta_mod.artifact_sha256(blobs[i]),
        target_sha256=delta_mod.artifact_sha256(blobs[i + 1]),
        n_bytes=len(db)) for i, db in enumerate(dblobs)]
    man = distrib.ChainManifest(
        latest_epoch=3, latest_sha256=delta_mod.artifact_sha256(blobs[3]),
        latest_bytes=len(blobs[3]), anchors=[0], links=links,
        fmt="CTMRDL02")
    jman = jdistrib.ChainManifest.from_json(man.to_json())
    assert jman.to_json() == man.to_json()
    back = distrib.ChainManifest.from_json(man.to_json())
    assert back.to_json() == man.to_json()
    path = man.validate_chain(0, 3, dblobs)
    assert [li.from_epoch for li in path] == [0, 1, 2]
    assert distrib.apply_chain(blobs[0], dblobs) == blobs[3]
    bad = dblobs[:1] + [dblobs[1][:-1] + b"\x00"] + dblobs[2:]
    with pytest.raises(distrib.DeltaError, match="hash mismatch"):
        man.validate_chain(0, 3, bad)
    with pytest.raises(distrib.DeltaError, match="length mismatch"):
        man.validate_chain(0, 3, dblobs[:2])
    with pytest.raises(distrib.DeltaError, match="no delta path"):
        man.validate_chain(5, 9, [])
    assert man.link_path(2, 1) is None
    assert jman.link_path(0, 3) is not None


def test_split_bundle_roundtrip():
    rng = np.random.default_rng(13)
    sets = epoch_sets(rng, 3, 10, salt=3)
    b0 = build(sets)
    sets[sorted(sets)[0]] = set(sets[sorted(sets)[0]]) | {b"\xaa"}
    b1 = build(sets)
    sets[sorted(sets)[1]] = set(sets[sorted(sets)[1]]) | {b"\xbb"}
    b2 = build(sets)
    d1 = distrib.compute_delta(b0, b1, 10, 11)
    d2 = distrib.compute_delta(b1, b2, 11, 12)
    assert distrib.split_bundle(d1 + d2) == [d1, d2] \
        == jdistrib.split_bundle(d1 + d2)
    assert distrib.apply_chain(b0, distrib.split_bundle(d1 + d2)) == b2
    with pytest.raises(distrib.DeltaError):
        distrib.split_bundle(d1 + b"junk")


def test_dl02_untouched_groups_ship_zero_bytes():
    """Single-group churn: the link names only the churned group."""
    rng = np.random.default_rng(11)
    sets = epoch_sets(rng, 6, 30, salt=1)
    churn_key = sorted(sets)[1]
    sets2 = sets_copy(sets)
    sets2[churn_key] |= {b"\x10\x20\x30"}
    b1, b2 = build(sets), build(sets2)
    link = chain_both([b1, b2])[0]
    header, _ = delta_mod.parse_delta(link)
    assert header == jdelta.parse_delta(link)[0]
    touched = ([(e["issuer"], e["expHour"]) for e in header["added"]]
               + [(e["issuer"], e["expHour"]) for e in header["patched"]])
    assert touched == [churn_key]
    assert header["removed"] == []
    assert header["payloadBytes"] < len(b2) / 3 and len(link) < len(b2)


def test_mixed_format_delta_refused_and_rollover_anchors():
    sets = epoch_sets(np.random.default_rng(5), 3, 30, salt=1)
    b01, b02 = build(sets, FORMAT_FL01), build(sets, FORMAT_FL02)
    for a, b in ((b01, b02), (b02, b01)):
        with pytest.raises(distrib.DeltaError):
            distrib.compute_delta(a, b, 0, 1)
    dists = [distrib.FilterDistributor(), jdistrib.FilterDistributor()]
    sets[sorted(sets)[0]].add(b"\x77\x88")
    b3 = build(sets)
    for d in dists:
        assert d.publish(1, b01) and d.publish(2, b02)
        assert d.delta_bundle(1, 2) is None  # anchor in the span
        assert d.publish(3, b3)
    man = dists[0].manifest()
    assert man == dists[1].manifest()
    assert man["format"] == "CTMRDL02" and 2 in man["anchors"]
    bundle = dists[0].delta_bundle(2, 3)
    assert bundle == dists[1].delta_bundle(2, 3)
    distrib.ChainManifest.from_json(man).validate_chain(2, 3, [bundle])
    assert distrib.apply_chain(b02, [bundle]) == b3


# -- containers ----------------------------------------------------------------


@pytest.mark.parametrize("kind", distrib.CONTAINER_KINDS)
def test_container_query_parity_and_determinism(kind):
    """The port's container bytes equal the JAX package's; decoded by
    either package they answer exactly what the source artifact does,
    for every captured serial and for random probes."""
    agg = captured_agg(corpus(n=80, base=1000))
    art = build_from_aggregator(agg, fp_rate=0.01)
    blob = art.to_bytes()
    cb = distrib.encode_container(art, kind)
    assert cb == distrib.encode_container(FilterArtifact.from_bytes(blob),
                                          kind)
    from ct_mapreduce_tpu.filter import FilterArtifact as JArtifact

    assert cb == jdistrib.encode_container(JArtifact.from_bytes(blob), kind)
    back = distrib.decode_container(cb)
    assert back.to_bytes() == blob
    assert jdistrib.decode_container(cb).to_bytes() == blob
    rng = np.random.default_rng(20260805)
    probes = [rng.integers(0, 256, 5, dtype=np.uint8).tobytes()
              for _ in range(150)]
    for (idx, eh), serials in sorted(agg.filter_capture.items()):
        iss = agg.registry.issuer_at(idx).id()
        for sb in sorted(serials)[:30]:
            assert back.query(iss, eh, sb)
        for p in probes:
            assert back.query(iss, eh, p) == art.query(iss, eh, p)
        sb = sorted(serials)[0]
        assert back.query(iss, eh + 24, sb) == art.query(iss, eh + 24, sb)


def test_container_error_paths():
    with pytest.raises(ContainerError, match="magic"):
        distrib.decode_container(b"NOTAMAGICblahblah")
    art = build_artifact({("i", 1): {b"\x01"}}, 0.01, use_device=False)
    mlbf = distrib.encode_container(art, "mlbf")
    with pytest.raises(ContainerError):
        distrib.decode_container(mlbf[:-3])
    with pytest.raises(ContainerError, match="kind"):
        distrib.encode_container(art, "bloom3000")
    club = distrib.encode_container(art, "clubcard")
    with pytest.raises(ContainerError):
        distrib.decode_container(club[:20])


@pytest.mark.parametrize("fmt", FORMATS)
def test_container_rev2_magics_round_trip_format(fmt):
    sets = epoch_sets(np.random.default_rng(9), 3, 30, salt=1)
    art = build_artifact(sets, fp_rate=0.01, use_device=False, fmt=fmt)
    rev = "01" if fmt == FORMAT_FL01 else "02"
    for kind, magic in (("mlbf", b"CTMRMB" + rev.encode()),
                        ("clubcard", b"CTMRCC" + rev.encode())):
        blob = distrib.encode_container(art, kind)
        assert blob[:8] == magic
        back = distrib.decode_container(blob)
        assert back.fmt == fmt and back.to_bytes() == art.to_bytes()


# -- the distributor -----------------------------------------------------------


def epoch_blobs(n, groups=8, per=20):
    rng = np.random.default_rng(99)
    sets = epoch_sets(rng, groups, per, salt=9)
    out = [build(sets)]
    for i in range(n - 1):
        key = sorted(sets)[i % len(sets)]
        sets[key] = set(sets[key]) | {bytes([i, 77, j]) for j in range(3)}
        out.append(build(sets))
    return out


def test_distributor_chain_anchors_and_eviction():
    """The port's store and the JAX one, fed the same epochs, hold the
    same manifest, anchors and bundles."""
    blobs = epoch_blobs(8)
    d = distrib.FilterDistributor(history=4, max_chain=2)
    jd = jdistrib.FilterDistributor(history=4, max_chain=2)
    for e, blob in enumerate(blobs):
        assert d.publish(e, blob) and jd.publish(e, blob)
    man = d.manifest()
    assert man == jd.manifest()
    assert man["epochsHeld"] == [4, 5, 6, 7]
    assert d.latest().epoch == 7 and d.latest().blob == blobs[7]
    assert d.latest().containers == jd.latest().containers
    assert d.latest().etag == jd.latest().etag
    assert man["maxDeltaChain"] == 2
    links = {(li["fromEpoch"], li["toEpoch"]) for li in man["links"]}
    assert all(t == f + 1 for f, t in links)
    replayable = [(f, t) for f, t in sorted(links) if f >= 4]
    assert replayable, links
    f, t = replayable[0]
    bundle = d.delta_bundle(f, t)
    assert bundle is not None and bundle == jd.delta_bundle(f, t)
    assert distrib.apply_chain(blobs[f], distrib.split_bundle(bundle)) \
        == blobs[t]
    assert d.delta_bundle(0, 7) is None
    assert not d.publish(3, blobs[3])
    assert not d.publish(8, blobs[7])  # content unchanged: a no-op
    assert d.stats() == jd.stats()


def test_distributor_source_ranking():
    blobs = epoch_blobs(4)
    for d in (distrib.FilterDistributor(), jdistrib.FilterDistributor()):
        assert d.publish(100, blobs[0], source="local")
        assert d.publish(101, blobs[1], source="local")
        assert d.publish(1, blobs[2], source="fleet")
        assert d.latest().epoch == 1 and d.latest().blob == blobs[2]
        assert not d.publish(102, blobs[3], source="local")
        assert d.latest().blob == blobs[2]
        assert d.publish(2, blobs[3], source="fleet")
        assert d.latest().epoch == 2


def test_encoded_cache_and_gzip_bytes():
    """The pre-compressed variants equal the JAX package's bytes (gzip
    with mtime 0) and are cached per key, never for ad-hoc payloads."""
    blob = epoch_blobs(1)[0]
    d, jd = distrib.FilterDistributor(), jdistrib.FilterDistributor()
    gz = d.encoded(("full", 0), blob, "gzip")
    assert gz == jd.encoded(("full", 0), blob, "gzip")
    assert gzip.decompress(gz) == blob
    assert d.encoded(("full", 0), blob, "gzip") is gz
    assert d.encoded(None, blob, "gzip") == gz
    assert d.encoded(("full", 0), blob, None) is blob
    assert distrib.zstd_available() == jdistrib.zstd_available()


@pytest.mark.parametrize("header", [
    "gzip", "gzip;q=0", "", "identity", "br, gzip;q=0.5", "zstd",
    "zstd, gzip", "*", "gzip;q=banana", "GZIP", " , ,gzip"])
def test_negotiate_encoding(header):
    assert distrib.negotiate_encoding(header) \
        == jdistrib.negotiate_encoding(header)
    if header in ("gzip", "br, gzip;q=0.5", "GZIP"):
        assert distrib.negotiate_encoding(header) == "gzip"
    if header in ("gzip;q=0", "", "identity"):
        assert distrib.negotiate_encoding(header) is None


def test_resolve_distrib_layering(monkeypatch, tmp_path):
    """Explicit > env > profile > defaults, step for step the JAX
    package's ladder."""
    for var in ("CTMR_DISTRIB_HISTORY", "CTMR_MAX_DELTA_CHAIN",
                "CTMR_PLATFORM_PROFILE"):
        monkeypatch.delenv(var, raising=False)
    prof = tmp_path / "prof.json"
    prof.write_text(json.dumps({
        "version": 1, "platform": "test", "knobs": {"distrib": {"distribHistory": 12,
                                            "maxDeltaChain": 9}}}))
    steps = [({}, {}, (8, 4)),
             ({"CTMR_DISTRIB_HISTORY": "16", "CTMR_MAX_DELTA_CHAIN": "6"},
              {}, (16, 6)),
             ({}, {"history": 3, "max_chain": 2}, (3, 2)),
             ({"CTMR_DISTRIB_HISTORY": "lots"}, {}, (8, 6)),
             ({"CTMR_PLATFORM_PROFILE": str(prof),
               "CTMR_DISTRIB_HISTORY": None, "CTMR_MAX_DELTA_CHAIN": None},
              {}, (12, 9)),
             ({"CTMR_MAX_DELTA_CHAIN": "5"}, {}, (12, 5)),
             ({}, {"max_chain": 2}, (12, 2)),
             ({}, {"history": 1, "max_chain": -3}, (2, 5))]
    for env, kw, want in steps:
        for k, v in env.items():
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        assert distrib.resolve_distrib(**kw) == jdistrib.resolve_distrib(**kw)
        if want is not None:
            assert distrib.resolve_distrib(**kw) == want


# -- the serve plane: filter-first tier and routes ---------------------------


def _get(url, headers=None):
    return urllib.request.urlopen(
        urllib.request.Request(url, headers=headers or {}), timeout=30)


def _http_error(url, headers=None):
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(url, headers)
    return err.value


@pytest.fixture
def served_pair(tmp_path):
    """A JAX ``QueryServer`` and a port one over equal state (the port's
    checkpoint loaded into the JAX aggregator), both with the filter
    tier on; then the same two epochs published into both stores."""
    agg = captured_agg(corpus(n=70, base=1000))
    path = str(tmp_path / "agg.npz")
    agg.save_checkpoint(path)
    jagg = TpuAggregator(capacity=1 << 10, batch_size=64)
    jagg.load_checkpoint(path)
    from ct_mapreduce_tpu.serve.server import QueryServer as JQueryServer

    servers = {
        "port": QueryServer(agg, 0, host="127.0.0.1", filter_first=True,
                            device=False).start(),
        "jax": JQueryServer(jagg, 0, host="127.0.0.1", filter_first=True,
                            device=False).start(),
    }
    e0 = {k: s.oracle.distributor.latest().blob for k, s in servers.items()}
    assert e0["port"] == e0["jax"]
    blob0 = e0["port"]
    agg.ingest(corpus(n=30, base=7000))
    blob1 = build_from_aggregator(agg, fp_rate=0.01).to_bytes()
    for s in servers.values():
        assert s.oracle.publish_artifact(100, blob0, source="fleet")
        assert s.oracle.publish_artifact(101, blob1, source="fleet")
    try:
        yield servers, blob0, blob1
    finally:
        for s in servers.values():
            s.stop()


def test_http_etag_304_encoding_delta_parity_with_jax(served_pair):
    servers, blob0, blob1 = served_pair
    bases = {k: f"http://127.0.0.1:{s.port}" for k, s in servers.items()}
    seen = {}
    for pkg, base in bases.items():
        got = {}
        r = _get(base + "/filter")
        got["full"], got["etag"] = r.read(), r.headers["ETag"]
        assert r.headers["Cache-Control"] == \
            "public, max-age=60, must-revalidate"
        assert r.headers["Last-Modified"] and r.headers["X-Filter-Epoch"] \
            == "101"
        assert r.headers["Vary"] == "Accept-Encoding"
        for kind in ("mlbf", "clubcard"):
            r = _get(f"{base}/filter/container/{kind}")
            got[kind] = (r.read(), r.headers["ETag"])
        err = _http_error(base + "/filter", {"If-None-Match": got["etag"]})
        got["304"] = (err.code, err.read(), err.headers["ETag"])
        r = _get(base + "/filter", {"If-None-Match": '"deadbeef"'})
        got["stale_etag"] = r.read()
        r = _get(base + "/filter", {"Accept-Encoding": "gzip"})
        got["gzip"] = (r.headers["Content-Encoding"], r.read())
        r = _get(base + "/filter", {"Accept-Encoding": "identity"})
        got["identity"] = ("Content-Encoding" in r.headers, r.read())
        man = json.loads(_get(base + "/filter/manifest").read())
        got["manifest"] = man
        r = _get(f"{base}/filter/delta/100/101")
        got["delta"] = (r.read(), r.headers["ETag"],
                        r.headers["Cache-Control"])
        r = _get(f"{base}/filter/delta/100/101", {"Accept-Encoding": "gzip"})
        got["delta_gz"] = r.read()
        got["no_chain"] = _http_error(f"{base}/filter/delta/998/999").code
        got["bad_kind"] = _http_error(f"{base}/filter/container/nope").code
        got["bad_delta"] = _http_error(f"{base}/filter/delta/1").code
        seen[pkg] = got
    assert seen["port"] == seen["jax"]
    got = seen["port"]
    assert got["full"] == blob1 == got["stale_etag"] == got["identity"][1]
    assert got["etag"] == '"' + hashlib.sha256(blob1).hexdigest() + '"'
    assert got["304"] == (304, b"", got["etag"])
    assert got["gzip"][0] == "gzip"
    assert gzip.decompress(got["gzip"][1]) == blob1
    assert got["identity"][0] is False
    for kind in ("mlbf", "clubcard"):
        assert distrib.decode_container(got[kind][0]).n_serials == 100
    man = got["manifest"]
    assert man["format"] == "CTMRDL02" and man["latestEpoch"] == 101
    assert man["containers"] == ["clubcard", "mlbf"]
    assert "gzip" in man["encodings"]
    links = distrib.split_bundle(got["delta"][0])
    distrib.ChainManifest.from_json(man).validate_chain(100, 101, links)
    assert distrib.apply_chain(blob0, links) == blob1
    assert "immutable" in got["delta"][2]
    assert gzip.decompress(got["delta_gz"]) == got["delta"][0]
    assert (got["no_chain"], got["bad_kind"], got["bad_delta"]) \
        == (404, 404, 400)
    stats = servers["port"].oracle.stats()
    assert stats["distrib_latest_epoch"] == 101
    assert stats["distrib_links"] >= 1


def test_filter_routes_serve_artifact():
    agg = captured_agg(corpus(n=50))
    (idx, eh), serials = next(iter(sorted(agg.filter_capture.items())))
    iss = agg.registry.issuer_at(idx).id()
    exp_id = ExpDate.from_unix_hour(eh).id()
    sb = next(iter(serials))
    srv = QueryServer(agg, 0, host="127.0.0.1", filter_first=True).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        full = FilterArtifact.from_bytes(_get(f"{base}/filter").read())
        assert full.query(iss, eh, sb)
        part = FilterArtifact.from_bytes(
            _get(f"{base}/filter/{iss}/{exp_id}").read())
        assert part.query(iss, eh, sb)
        assert part.to_bytes() == full.group_bytes(iss, exp_id)
        assert _http_error(f"{base}/filter/unknown/2031-01-01").code == 404
        assert _http_error(f"{base}/filter/a/b/c/d").code == 400
        stats = srv.oracle.stats()
        assert stats["filter_first"] and stats["filter_serials"] == 50
        assert stats["filter_format"] == FORMAT_FL02
    finally:
        srv.stop()


def test_filter_route_cold_tier_404():
    srv = QueryServer(port_agg(), 0, host="127.0.0.1").start()
    try:
        err = _http_error(f"http://127.0.0.1:{srv.port}/filter")
        assert err.code == 404
        assert "not armed" in json.loads(err.read())["error"]
        assert srv.oracle.distributor is None
        assert srv.oracle.stats()["filter_first"] is False
    finally:
        srv.stop()


def test_filter_first_parity_under_concurrent_ingest():
    """The two-tier lookup answers exactly what the table-backed oracle
    answers while ingest keeps mutating the table."""
    agg = captured_agg(corpus(n=120) + corpus(n=20))
    items_known = [(idx, eh, sb)
                   for (idx, eh), serials in agg.filter_capture.items()
                   for sb in sorted(serials)[:40]]
    idx0, eh0 = next(iter(agg.filter_capture))
    items_unknown = [(idx0, eh0, bytes([200 + (j % 50), j % 251, 7]))
                     for j in range(60)]
    items_other = [(idx0 + 999, eh0, b"\x01\x02"), (-1, eh0, b"\x01\x02"),
                   (idx0, eh0 + 999, b"\x01\x02")]
    items = items_known + items_unknown + items_other
    sink = tmetrics.InMemSink()
    prev = tmetrics.get_sink()
    tmetrics.set_sink(sink)
    tiered = MembershipOracle(agg, filter_first=True, max_delay_s=0.001)
    plain = MembershipOracle(agg, filter_first=False, max_delay_s=0.001)
    assert tiered.filter_tier is not None
    stop = threading.Event()

    def churn():
        s = 0
        while not stop.is_set():
            agg.ingest(corpus(n=10, base=700_000 + s))
            s += 10

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    try:
        for _ in range(4):
            a = [r[0] for r in tiered.query_raw(items)]
            b = [r[0] for r in plain.query_raw(items)]
            assert a == b
            assert a[:len(items_known)] == [True] * len(items_known)
    finally:
        stop.set()
        t.join(timeout=30)
        tiered.close()
        plain.close()
        tmetrics.set_sink(prev)
    counters = sink.snapshot()["counters"]
    assert counters.get("serve.filter_negative", 0) > 0
    assert counters.get("serve.filter_forward", 0) > 0


def test_serve_refresh_reuses_clean_groups():
    agg = captured_agg(corpus(n=30))
    oracle = MembershipOracle(agg, filter_first=True, max_delay_s=0.001)
    try:
        n_groups = len(oracle.filter_tier.artifact.groups)
        oracle.refresh_filter()
        stats = oracle.stats()
        assert stats["filter_format"] == FORMAT_FL02
        assert stats["filter_groups_reused"] >= n_groups
    finally:
        oracle.close()


def test_quiet_plane_refresh_publishes_a_new_epoch(tmp_path):
    """With no query between two refreshes the replica pool's floor
    epoch does not move; the JAX package's oracle then drops the second
    build as stale and keeps serving the first. The port captures fresh
    views and publishes it under a new epoch."""
    from ct_mapreduce_tpu.serve.server import (
        MembershipOracle as JMembershipOracle,
    )

    jagg = TpuAggregator(capacity=1 << 10, batch_size=64)
    jagg.enable_filter_capture()
    agg = port_agg()
    agg.enable_filter_capture()
    port = MembershipOracle(agg, filter_first=True, device=False)
    jax = JMembershipOracle(jagg, filter_first=True, device=False)
    try:
        empty = port.distributor.latest()
        assert empty.blob == jax.distributor.latest().blob
        assert empty.epoch == jax.distributor.latest().epoch == 0
        agg.ingest(corpus(n=20))
        # The same state on the JAX side, read from the port's file.
        path = str(tmp_path / "agg.npz")
        agg.save_checkpoint(path)
        jagg.load_checkpoint(path)
        port.refresh_filter()
        jax.refresh_filter()
        assert jax.distributor.latest().blob == empty.blob  # stale
        latest = port.distributor.latest()
        assert latest.epoch > 0
        assert latest.blob == port.filter_tier.artifact.to_bytes() \
            == jax.filter_tier.artifact.to_bytes()
        assert port.distributor.delta_bundle(0, latest.epoch) is not None
    finally:
        port.close()
        jax.close()


def test_publish_artifact_fleet_source_via_oracle():
    agg = captured_agg(corpus(n=30))
    oracle = MembershipOracle(agg, filter_first=True, max_delay_s=0.001)
    try:
        assert oracle.distributor.latest() is not None
        merged = build_from_aggregator(agg, fp_rate=0.02).to_bytes()
        assert oracle.publish_artifact(3, merged)
        assert oracle.distributor.latest().epoch == 3
        assert oracle.distributor.latest().blob == merged
        oracle.refresh_filter()
        assert oracle.distributor.latest().blob == merged
    finally:
        oracle.close()
    cold = MembershipOracle(port_agg(), max_delay_s=0.001)
    try:
        assert not cold.publish_artifact(1, merged)
    finally:
        cold.close()


# -- ct-fetch and the CLI ------------------------------------------------------


def test_ct_fetch_serves_its_filter(tmp_path, monkeypatch):
    """emitFilter + queryPort on the port's ct-fetch: the plane arms the
    filter-first tier, and after the final save ``/filter`` serves the
    emitted artifact's bytes; the manifest and a container agree."""
    import socket

    from ct_mapreduce_tpu_torch.cmd import ct_fetch
    from ct_mapreduce_tpu_torch.ingest import ctclient
    from ct_mapreduce_tpu_torch.serve import server as serve_server
    from ct_mapreduce_tpu_torch.utils.fakelog import FakeLog

    for env in ("CTMR_EMIT_FILTER", "CTMR_FILTER_PATH", "CTMR_FILTER_FORMAT",
                "CTMR_SERVE_FILTER_FIRST", "CTMR_DISTRIB_HISTORY"):
        monkeypatch.delenv(env, raising=False)
    log = FakeLog()
    for i, (leaf, issuer) in enumerate(corpus(n=40)):
        log.add_cert(leaf, issuer, timestamp_ms=1700000000000 + i)
    monkeypatch.setattr(ctclient, "_urllib_transport", log.transport)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    probed = {}
    orig_stop = serve_server.QueryServer.stop

    def spy_stop(self):
        try:
            base = f"http://127.0.0.1:{self.port}"
            probed["full"] = _get(base + "/filter").read()
            probed["manifest"] = json.loads(
                _get(base + "/filter/manifest").read())
            probed["mlbf"] = _get(base + "/filter/container/mlbf").read()
            probed["stats"] = self.oracle.stats()
        finally:
            orig_stop(self)

    monkeypatch.setattr(serve_server.QueryServer, "stop", spy_stop)
    state = tmp_path / "agg.npz"
    ini = tmp_path / "ct.ini"
    ini.write_text(
        f"logList = {log.url}\nbackend = tpu\nbatchSize = 64\n"
        f"tableBits = 10\nhealthAddr = \naggStatePath = {state}\n"
        f"emitFilter = true\nqueryPort = {port}\ndistribHistory = 3\n"
        f"maxDeltaChain = 2\n")
    assert ct_fetch.main(["-config", str(ini), "-nobars"],
                         device="cpu") == 0
    emitted = (tmp_path / "agg.npz.filter").read_bytes()
    assert probed["full"] == emitted
    man = probed["manifest"]
    assert man["latestSha256"] == hashlib.sha256(emitted).hexdigest()
    assert man["maxDeltaChain"] == 2 and man["latestEpoch"] > 0
    assert distrib.decode_container(probed["mlbf"]).to_bytes() == emitted
    assert probed["stats"]["filter_first"] is True
    assert probed["stats"]["filter_serials"] == 40
    # The oracle's first build (no serials yet), then the saves' builds.
    assert len(probed["stats"]["distrib_epochs"]) >= 2


def test_ct_filter_cli_delta_apply_container_match_jax(tmp_path):
    """``ct-filter-torch delta/apply/container`` write the reference
    CLI's bytes and print its JSON; a corrupted link exits 2 in both."""
    from ct_mapreduce_tpu.cmd import ct_filter as jfilter
    from ct_mapreduce_tpu_torch.cmd import ct_filter

    rng = np.random.default_rng(17)
    s0 = epoch_sets(rng, 4, 15, salt=5)
    s1 = {k: set(v) | {b"\x42\x42"} for k, v in s0.items()}
    p0, p1 = tmp_path / "e0.filter", tmp_path / "e1.filter"
    p0.write_bytes(build(s0))
    p1.write_bytes(build(s1))
    outs = {}
    for pkg, main in (("port", ct_filter.main), ("jax", jfilter.main)):
        d = tmp_path / pkg
        d.mkdir()
        runs = [["delta", "-base", str(p0), "-target", str(p1),
                 "-out", str(d / "d.delta"), "-fromEpoch", "0",
                 "-toEpoch", "1"],
                ["apply", "-base", str(p0), "-delta", str(d / "d.delta"),
                 "-out", str(d / "replayed.filter")],
                ["container", "-artifact", str(p1), "-kind", "mlbf",
                 "-out", str(d / "run.mlbf")],
                ["container", "-artifact", str(p1), "-kind", "clubcard",
                 "-out", str(d / "run.clubcard")]]
        got = []
        for argv in runs:
            buf = io.StringIO()
            rc = main(argv, out=buf)
            text = buf.getvalue().replace(str(d), "<d>")
            got.append((rc, text))
        bad = bytearray((d / "d.delta").read_bytes())
        bad[-1] ^= 0xFF
        (d / "bad.delta").write_bytes(bytes(bad))
        got.append(main(["apply", "-base", str(p0), "-delta",
                         str(d / "bad.delta"), "-out", str(d / "x.filter")],
                        out=io.StringIO()))
        got.append(main(["delta", "-base", str(p0), "-target",
                         str(tmp_path / "missing"), "-out",
                         str(d / "y.delta")], out=io.StringIO()))
        got.append({name: (d / name).read_bytes() for name in (
            "d.delta", "replayed.filter", "run.mlbf", "run.clubcard")})
        outs[pkg] = got
    assert outs["port"] == outs["jax"]
    files = outs["port"][-1]
    assert files["replayed.filter"] == p1.read_bytes()
    assert [rc for rc, _ in outs["port"][:4]] == [0, 0, 0, 0]
    assert outs["port"][4:6] == [2, 2]
    assert json.loads(outs["port"][0][1])["bytes"] \
        == len(files["d.delta"])
    assert os.path.getsize(p1) == json.loads(outs["port"][1][1])["bytes"]
