"""The port's filter emission (``ct_mapreduce_tpu_torch.filter`` and the
aggregator's capture) against the JAX package's, on the CPU.

Two halves:

- Byte equality with the JAX package on the same seeded corpora: the
  JAX device lane (jit on the CPU) against the port's plain torch lane
  (K1's and K5's plain versions) and its host NumPy lane, per group and
  fused, streamed and from ``PackedGroupSource``, in both formats
  (``CTMRFL01``/``CTMRFL02``); canonical keys and the oversized-serial
  key; capture checkpoints (ck01 ``filter_keys``/``filter_hashes``, ck02
  ``captureTokens``) crossing both ways to equal artifacts and
  ``ckpt_state_digest``; a merged two-"worker" build equal to the serial
  run's, in both packages.
- The cases of ``tests/test_filter.py``, ``tests/test_filter_format.py``
  (the non-DL02 ones) and ``tests/test_filter_scale.py``, run on the
  port at their sizes. The cases left out wait on ROADMAP items 12
  (``test_zero_false_negatives_sharded_layout``) and 15 (the serve
  plane's filter tier, ``/filter`` routes and the DL02 delta plane).

Tolerance: exact equality everywhere (bytes, words, digests).
"""

import datetime
import json
import os

import numpy as np
import pytest

from ct_mapreduce_tpu.agg import merge as jmerge
from ct_mapreduce_tpu.agg.aggregator import (
    HostSnapshotAggregator,
    TpuAggregator,
)
from ct_mapreduce_tpu.filter import artifact as jartifact
from ct_mapreduce_tpu.filter import build_artifact as jbuild
from ct_mapreduce_tpu.filter import build_from_aggregator as jfrom_agg
from ct_mapreduce_tpu.filter import build_from_merged as jfrom_merged
from ct_mapreduce_tpu.filter import cache as jcache
from ct_mapreduce_tpu.filter import resolve_filter as jresolve
from ct_mapreduce_tpu.filter import spill as jspill
from ct_mapreduce_tpu.filter import stream as jstream
from ct_mapreduce_tpu.filter.cascade import FilterCascade as JCascade
from ct_mapreduce_tpu.tune import harness as jharness
from ct_mapreduce_tpu_torch.agg import merge
from ct_mapreduce_tpu_torch.agg.aggregator import (
    TorchAggregator,
    ckpt_state_digest,
)
from ct_mapreduce_tpu_torch.config import CTConfig
from ct_mapreduce_tpu_torch.core.types import ExpDate
from ct_mapreduce_tpu_torch.filter import (
    FORMAT_FL01,
    FORMAT_FL02,
    FilterArtifact,
    GroupBuildCache,
    ListGroupSource,
    PackedGroupSource,
    SpillCaptureRing,
    build_artifact,
    build_artifact_from_sources,
    build_from_aggregator,
    build_from_merged,
    canonical_keys,
    content_token,
    default_format,
    normalize_format,
    read_artifact,
    resolve_filter,
)
from ct_mapreduce_tpu_torch.filter import cascade as cascade_mod
from ct_mapreduce_tpu_torch.filter import fused as fused_mod
from ct_mapreduce_tpu_torch.filter import stream
from ct_mapreduce_tpu_torch.filter.cache import serial_hash
from ct_mapreduce_tpu_torch.filter.cascade import FilterCascade
from ct_mapreduce_tpu_torch.ops import sha256
from ct_mapreduce_tpu_torch.utils import minicert

NOW = datetime.datetime(2025, 1, 1, tzinfo=datetime.timezone.utc)
CAP = 1 << 10
ISSUER = minicert.make_cert(serial=1, issuer_cn="Filter CA", is_ca=True)
ISSUER_B = minicert.make_cert(serial=2, issuer_cn="Filter CA B", is_ca=True)
FORMATS = ("fl01", "fl02")


def corpus(n=120, dupes=20, cn="Filter CA", issuer=ISSUER, base=1000):
    ents = [(minicert.make_cert(serial=base + s, issuer_cn=cn,
                                subject_cn=f"f{s}.example"), issuer)
            for s in range(n)]
    return ents + ents[:dupes]


def port_agg(**kw):
    kw.setdefault("capacity", CAP)
    return TorchAggregator(batch_size=64, now=NOW, device="cpu", **kw)


def jax_agg(**kw):
    kw.setdefault("capacity", CAP)
    return TpuAggregator(batch_size=64, now=NOW, **kw)


def captured(agg, ents):
    agg.enable_filter_capture()
    agg.ingest(ents)
    return agg


def identity_items(agg):
    return [(agg.registry.issuer_at(idx).id(), eh, sb)
            for (idx, eh), ss in sorted(agg.filter_capture.items())
            for sb in sorted(ss)]


def random_state(rng, n_groups=None, oversized=True, big=0):
    """Randomized {(issuerID, expHour): [serial bytes]} corpora with
    duplicate serials, issuers shared across expiry buckets, oversized
    host-lane serials, and (``big``) one group past DEVICE_BUILD_MIN."""
    n_groups = n_groups or int(rng.integers(1, 8))
    state = {}
    for g in range(n_groups):
        iss = f"scale-issuer-{g % max(1, n_groups // 2)}"
        n = big if (big and g == 0) else int(rng.integers(1, 300))
        serials = [rng.integers(0, 256, int(rng.integers(3, 20)),
                                dtype=np.uint8).tobytes() for _ in range(n)]
        if oversized and g % 2 == 0:
            serials.append(bytes([g]) * 61)
        state[(iss, 500_000 + 24 * g)] = serials + serials[: n // 4]
    return state


def group_sets(rng, n_groups=5, per_group=30, salt=1):
    return {
        (f"issuer-{g}", 500_000 + 24 * g): {
            bytes([salt, g, s % 251, 9]) + bytes(
                [int(x) for x in rng.integers(0, 256, 2)])
            for s in range(per_group)}
        for g in range(n_groups)}


def tokens_of(sets):
    return {key: content_token(ss) for key, ss in sets.items()}


def packed_sources(state):
    """The state as PackedGroupSources: pre-packed chunks, the oversized
    serials in a block of their own."""
    sources = []
    for (iss, eh), serials in sorted(state.items()):
        uniq = sorted(set(serials))
        fit = [s for s in uniq if len(s) <= 46]
        big = [s for s in uniq if len(s) > 46]

        def provider(chunk_size, fit=fit, big=big):
            for s0 in range(0, len(fit), chunk_size):
                lens, mat = stream.pack_serials(fit[s0: s0 + chunk_size])
                yield lens, mat, []
            if big:
                yield (np.zeros((0,), np.int64),
                       np.zeros((0, 46), np.uint8), list(big))

        sources.append(PackedGroupSource(iss, eh, len(uniq), provider))
    return sources


# -- byte equality with the JAX package -----------------------------------


@pytest.fixture(scope="module")
def big_state():
    """A corpus whose first group passes DEVICE_BUILD_MIN, so the default
    lanes choose the device (the JAX jit, the port's plain torch)."""
    return random_state(np.random.default_rng(2026), n_groups=5, big=5000)


@pytest.fixture(scope="module")
def jax_ref(big_state):
    """The JAX package's device-lane bytes (jit on the CPU), per format."""
    return {fmt: jbuild(big_state, fp_rate=0.02, use_device=True, fmt=fmt,
                        fused_lanes=2048).to_bytes() for fmt in FORMATS}


LANES = {
    "plain_torch": dict(use_device=True, device="cpu"),
    "host_numpy": dict(use_device=False),
    "per_group_plain": dict(use_device=True, device="cpu", fused=False),
    "per_group_host": dict(use_device=False, fused=False),
    "fused_default": dict(device="cpu", fused_lanes=777, stream_chunk=999),
}


@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_builds_match_jax_bytes(big_state, jax_ref, fmt, lane):
    blob = build_artifact(big_state, fp_rate=0.02, fmt=fmt,
                          **LANES[lane]).to_bytes()
    assert blob == jax_ref[fmt]
    assert blob[:8] == {"fl01": b"CTMRFL01", "fl02": b"CTMRFL02"}[fmt]


@pytest.mark.parametrize("fmt", FORMATS)
def test_streamed_packed_sources_match_jax_bytes(big_state, jax_ref, fmt):
    blob = build_artifact_from_sources(
        packed_sources(big_state), fp_rate=0.02, device="cpu", fmt=fmt,
        stream_chunk=1500).to_bytes()
    assert blob == jax_ref[fmt]


def test_canonical_keys_and_oversized_key_match_jax():
    """K1's plain version (the device lane on the CPU) and the host
    mirror against the JAX package's jitted ``pipeline.fingerprints``;
    the oversized-serial key against the JAX one."""
    rng = np.random.default_rng(9)
    n = 300
    serials = [rng.integers(0, 256, int(rng.integers(0, 47)),
                            dtype=np.uint8).tobytes() for _ in range(n)]
    serials += [b"\x41" * 47, b"\x42" * 60]
    ords = rng.integers(0, 1 << 14, len(serials))
    ehs = rng.integers(400_000, 700_000, len(serials))
    want = jartifact.canonical_keys(ords, ehs, serials, use_device=True)
    for kw in (dict(use_device=True, device="cpu"),
               dict(use_device=False), dict(use_device=True, device="cpu",
                                            chunk=7)):
        got = canonical_keys(ords, ehs, serials, **kw)
        assert got.dtype == np.uint32 and np.array_equal(got, want), kw
    for ordinal, eh, sb in ((3, 500_000, b"\x9a" * 60), (0, -5, b"")):
        assert np.array_equal(stream.oversized_key(ordinal, eh, sb),
                              jstream.oversized_key(ordinal, eh, sb))
    # The int32 bit patterns of the plain K1 view as the JAX uint32s.
    lens, mat = stream.pack_serials(serials[:n])
    import torch

    fps = sha256.fingerprints_plain(
        torch.from_numpy(ords[:n].astype(np.int32)),
        torch.from_numpy(ehs[:n].astype(np.int32)),
        torch.from_numpy(mat), torch.from_numpy(lens.astype(np.int32)))
    assert fps.dtype == torch.int32
    assert np.array_equal(fps.numpy().view("<u4"), want[:n])


def test_cascade_words_match_jax():
    rng = np.random.default_rng(7)
    inc = rng.integers(0, 2**32, size=(4500, 4), dtype=np.uint32)
    exc = rng.integers(0, 2**32, size=(999, 4), dtype=np.uint32)
    ref = JCascade.build(inc, exc, 0.02, use_device=True)
    for kw in (dict(use_device=False), dict(use_device=True, device="cpu")):
        got = FilterCascade.build(inc, exc, 0.02, **kw)
        assert len(got.layers) == len(ref.layers)
        for a, b in zip(got.layers, ref.layers):
            assert (a.m, a.k) == (b.m, b.k)
            assert np.array_equal(a.words, b.words)


@pytest.mark.parametrize("fmt", FORMATS)
def test_aggregator_capture_and_emission_match_jax(tmp_path, fmt):
    """The same entries through both packages' aggregators with
    emission on: equal captures, content hashes, emitted bytes."""
    ents = corpus(n=90, dupes=15) + corpus(n=40, dupes=5, cn="Filter CA B",
                                           issuer=ISSUER_B, base=500_000)
    out = {}
    for name, agg in (("jax", jax_agg()), ("port", port_agg())):
        agg.configure_filter_emission(str(tmp_path / f"{name}.filter"),
                                      fp_rate=0.02, fmt=fmt)
        agg.ingest(ents)
        agg.save_checkpoint(str(tmp_path / f"{name}.npz"))
        out[name] = agg
    j, p = out["jax"], out["port"]
    assert p.filter_capture == j.filter_capture
    assert p.capture_content_hashes() == j.capture_content_hashes()
    blob = (tmp_path / "port.filter").read_bytes()
    assert blob == (tmp_path / "jax.filter").read_bytes()
    assert read_artifact(str(tmp_path / "port.filter")).fmt == fmt


@pytest.fixture(scope="module")
def capture_writers(tmp_path_factory):
    """Both packages after the same three ingests with capture on, each
    saving a ck02 base + 2 segments (with captureTokens) and then a ck01
    file of the final state."""
    d = tmp_path_factory.mktemp("capx")
    out = {}
    for name, agg in (("jax", jax_agg()), ("port", port_agg())):
        agg.enable_filter_capture()
        agg.configure_checkpointing(mode="ck02")
        chain = str(d / f"{name}-chain.npz")
        for t in range(3):
            agg.ingest(corpus(n=30, dupes=5, base=1000 * (t + 1)))
            agg.save_checkpoint(chain)
        agg.configure_checkpointing(mode="ck01")
        ck01 = str(d / f"{name}.npz")
        agg.save_checkpoint(ck01)
        out[name] = (agg, chain, ck01)
    return out


@pytest.mark.parametrize("writer,kind", [
    ("jax", "ck01"), ("jax", "chain"), ("port", "ck01"), ("port", "chain")])
def test_capture_checkpoints_cross_both_ways(capture_writers, writer,
                                             kind):
    agg, chain, ck01 = capture_writers[writer]
    path = chain if kind == "chain" else ck01
    if kind == "chain":
        segs = sorted(f for f in os.listdir(os.path.dirname(chain))
                      if f.startswith(os.path.basename(chain) + ".ckseg"))
        assert len(segs) == 2
        with np.load(path, allow_pickle=True) as z:
            assert "filter_keys" in z
    with np.load(ck01, allow_pickle=True) as z:
        assert {"filter_keys", "filter_vals", "filter_hashes"} <= set(z)
    p = port_agg()
    p.load_checkpoint(path)
    j = HostSnapshotAggregator(capacity=CAP)
    j.load_checkpoint(path)
    assert p.filter_capture == j.filter_capture == agg.filter_capture
    digest = (jharness.ckpt_state_digest(agg) if writer == "jax"
              else ckpt_state_digest(agg))
    assert ckpt_state_digest(p) == jharness.ckpt_state_digest(j) == digest
    for fmt in FORMATS:
        blob = build_from_aggregator(p, fp_rate=0.01, fmt=fmt).to_bytes()
        assert blob == jfrom_agg(j, fp_rate=0.01, fmt=fmt).to_bytes()


def test_port_ck02_segments_carry_jax_capture_tokens(capture_writers):
    """Each package's chain segments hold the same captureTokens for the
    same churn (the blob's other fields are held equal by
    tests/test_torch_ckpt.py)."""
    from ct_mapreduce_tpu_torch.agg import ckpt

    blobs = {}
    for name in ("jax", "port"):
        _, chain, _ = capture_writers[name]
        blobs[name] = [b for _, _, _, b in ckpt.resolve_chain(chain).segments]
    assert len(blobs["port"]) == len(blobs["jax"]) == 2
    for pb, jb in zip(blobs["port"], blobs["jax"]):
        assert pb["captureTokens"] and pb == jb


@pytest.mark.parametrize("fmt", FORMATS)
def test_merged_two_workers_match_serial_run_and_jax(tmp_path, fmt):
    """Two workers over halves with different issuer orders, checkpointed
    and merged, compile to the serial run's bytes, and both packages'
    merges agree; the worker files are the port's."""
    half_a = corpus(n=60, dupes=10, base=1000)
    half_b = corpus(n=60, dupes=10, cn="Filter CA B", issuer=ISSUER_B,
                    base=500_000)
    paths = []
    for w, ents in enumerate((half_b, half_a)):
        p = str(tmp_path / f"agg.w{w}.npz")
        captured(port_agg(), ents).save_checkpoint(p)
        paths.append(p)
    serial = captured(port_agg(), half_a + half_b)
    sp = str(tmp_path / "agg.serial.npz")
    serial.save_checkpoint(sp)
    merged = build_from_merged(merge.load_checkpoints(paths), fp_rate=0.01,
                               fmt=fmt, device="cpu").to_bytes()
    assert merged == build_from_merged(merge.load_checkpoints([sp]),
                                       fp_rate=0.01, fmt=fmt).to_bytes()
    assert merged == build_from_aggregator(serial, fp_rate=0.01,
                                           fmt=fmt).to_bytes()
    assert merged == jfrom_merged(jmerge.load_checkpoints(paths),
                                  fp_rate=0.01, fmt=fmt).to_bytes()


def test_cache_and_spill_copies_match_jax(tmp_path):
    """The jax-free copies behave as the JAX modules: equal tokens, equal
    cache verdicts, byte-equal spill segments and merged items."""
    rng = np.random.default_rng(17)
    serials = {rng.integers(0, 256, 9, dtype=np.uint8).tobytes()
               for _ in range(50)}
    assert content_token(serials) == jcache.content_token(serials)
    assert serial_hash(b"\x01\x02") == jcache.serial_hash(b"\x01\x02")
    rings = [SpillCaptureRing(str(tmp_path / "p"), mem_bytes=512),
             jspill.SpillCaptureRing(str(tmp_path / "j"), mem_bytes=512)]
    for j in range(120):
        key = (j % 3, 500_000 + j % 2)
        for r in rings:
            r.add(key, bytes([j % 97]) * (3 + j % 9))
    assert rings[0].items() == rings[1].items()
    assert rings[0].stats() == rings[1].stats()
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) and names
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes()
    caches = [GroupBuildCache(), jcache.GroupBuildCache()]
    for c in caches:
        c.put("i", 5, (1, 2), 0.01, "g")
        c.get("i", 5, (1, 2), 0.01)
        c.get("i", 5, (1, 3), 0.01)
        c.get("i", 5, None, 0.01)
        c.prune([("x", 1)])
    assert [(c.hits, c.misses, len(c)) for c in caches] == [(1, 2, 0)] * 2


def test_resolve_filter_matches_jax(monkeypatch, tmp_path):
    envs = ({}, {"CTMR_EMIT_FILTER": "1", "CTMR_FILTER_FP_RATE": "0.05",
                 "CTMR_FILTER_FORMAT": "fl01",
                 "CTMR_FILTER_STREAM_CHUNK": "4096"},
            {"CTMR_FILTER_FP_RATE": "nope", "CTMR_FILTER_FORMAT": "fl99",
             "CTMR_FILTER_SPILL_MB": "64"})
    names = ("CTMR_EMIT_FILTER", "CTMR_FILTER_PATH", "CTMR_FILTER_FP_RATE",
             "CTMR_FILTER_FORMAT", "CTMR_FILTER_STREAM_CHUNK",
             "CTMR_FILTER_SPILL_MB", "CTMR_FILTER_SPILL_DIR",
             "CTMR_FILTER_FUSED_LANES", "CTMR_PLATFORM_PROFILE")
    for env in envs:
        for n in names:
            monkeypatch.delenv(n, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for kw in ({}, dict(state_path="/x/agg.npz"),
                   dict(emit=False, path="/y/f.bin", fp_rate=0.2,
                        fmt="fl02", fused_lanes=2048)):
            assert tuple(resolve_filter(**kw)) == tuple(jresolve(**kw))


# -- tests/test_filter.py on the port --------------------------------------


def test_cascade_exact_over_disjoint_sets():
    rng = np.random.default_rng(2026)
    inc = rng.integers(0, 2**32, size=(400, 4), dtype=np.uint32)
    exc = rng.integers(0, 2**32, size=(3000, 4), dtype=np.uint32)
    c = FilterCascade.build(inc, exc, 0.01)
    assert c.contains(inc).all()
    assert not c.contains(exc).any()
    assert len(c.layers) >= 1
    assert c.bits_per_entry() < 64


def test_cascade_empty_edges():
    empty = np.zeros((0, 4), np.uint32)
    keys = np.arange(40, dtype=np.uint32).reshape(10, 4)
    c = FilterCascade.build(empty, keys, 0.01)
    assert not c.layers and not c.contains(keys).any()
    c = FilterCascade.build(keys, empty, 0.01)
    assert len(c.layers) == 1 and c.contains(keys).all()


def test_cascade_device_host_bit_parity():
    rng = np.random.default_rng(7)
    inc = rng.integers(0, 2**32, size=(257, 4), dtype=np.uint32)
    exc = rng.integers(0, 2**32, size=(999, 4), dtype=np.uint32)
    host = FilterCascade.build(inc, exc, 0.02, use_device=False)
    dev = FilterCascade.build(inc, exc, 0.02, use_device=True, device="cpu")
    assert len(host.layers) == len(dev.layers)
    for a, b in zip(host.layers, dev.layers):
        assert (a.m, a.k) == (b.m, b.k)
        assert np.array_equal(a.words, b.words)


def test_cascade_env_disables_device(monkeypatch):
    monkeypatch.setenv("CTMR_FILTER_DEVICE", "0")
    assert not cascade_mod.device_enabled()
    monkeypatch.delenv("CTMR_FILTER_DEVICE")
    assert cascade_mod.device_enabled()


def test_canonical_keys_oversized_host_lane():
    big_a, big_b = b"\x41" * 60, b"\x42" * 60
    small = b"\x41" * 8
    keys = canonical_keys(np.array([3, 3, 3]), np.array([500_000] * 3),
                          [big_a, big_b, small])
    assert len({k.tobytes() for k in keys}) == 3
    again = canonical_keys(np.array([3]), np.array([500_000]), [big_a])
    assert np.array_equal(again[0], keys[0])


@pytest.mark.parametrize("layout,grow", [("bucket", True),
                                         ("open", False)])
def test_zero_false_negatives_across_layouts(monkeypatch, layout, grow):
    monkeypatch.setenv("CTMR_TABLE", layout)
    if grow:
        agg = port_agg(capacity=1 << 8, grow_at=0.5, max_capacity=1 << 14)
    else:
        agg = port_agg()
    captured(agg, corpus(n=150, dupes=25))
    if grow:
        assert agg.capacity > (1 << 8), "growth never fired"
    snap = agg.drain()
    assert sum(len(v) for v in agg.filter_capture.values()) == snap.total
    art = build_from_aggregator(agg, fp_rate=0.01)
    for iss, eh, sb in identity_items(agg):
        assert art.query(iss, eh, sb), (iss, eh, sb.hex())


def test_oversized_serial_rides_capture_and_artifact():
    agg = captured(port_agg(), corpus(n=40, dupes=0))
    big = b"\x9a" * 60
    idx, eh = next(iter(agg.filter_capture))

    class F:
        serial = big
        issuer_dn = "CN=Filter CA"
        crl_distribution_points = []

    agg.host_serials.setdefault((idx, eh), set())
    agg._host_dedup(F(), idx, eh)
    art = build_from_aggregator(agg, fp_rate=0.01)
    assert art.query(agg.registry.issuer_at(idx).id(), eh, big)


def test_artifact_deterministic_across_ingest_order():
    ents = corpus(n=90, dupes=0)
    blobs = [build_from_aggregator(captured(port_agg(), order),
                                   fp_rate=0.01).to_bytes()
             for order in (ents, list(reversed(ents)))]
    assert blobs[0] == blobs[1]


def test_merged_refuses_captureless_checkpoint(tmp_path):
    agg = port_agg()
    agg.ingest(corpus(n=20, dupes=0))  # capture off
    p = str(tmp_path / "nocap.npz")
    agg.save_checkpoint(p)
    merged = merge.load_checkpoints([p])
    assert merged.capture_missing == [p]
    with pytest.raises(ValueError, match="emitFilter"):
        build_from_merged(merged, fp_rate=0.01)
    art = build_from_merged(merged, fp_rate=0.01, allow_partial=True)
    assert art.n_serials == 0


def test_checkpoint_unperturbed_when_filter_off(tmp_path):
    agg = port_agg()
    agg.ingest(corpus(n=30, dupes=5))
    p1, p2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    agg.save_checkpoint(p1)
    agg.save_checkpoint(p2)
    assert open(p1, "rb").read() == open(p2, "rb").read()
    with np.load(p1, allow_pickle=True) as z:
        assert "filter_keys" not in z.files and "filter_vals" not in z.files


def test_pre_round15_checkpoint_loads_cleanly(tmp_path):
    agg = port_agg()
    agg.ingest(corpus(n=25, dupes=0))
    p = str(tmp_path / "legacy.npz")
    agg.save_checkpoint(p)
    fresh = port_agg()
    fresh.load_checkpoint(p)
    assert fresh.filter_capture is None
    assert fresh.drain().total == agg.drain().total
    fresh.enable_filter_capture()  # re-seeds from the host sets only
    assert fresh.filter_capture == {
        k: set(v) for k, v in fresh.host_serials.items()}


def test_capture_survives_checkpoint_roundtrip(tmp_path):
    agg = captured(port_agg(), corpus(n=40, dupes=8))
    p = str(tmp_path / "cap.npz")
    agg.save_checkpoint(p)
    back = port_agg()
    back.want_serials = False
    back.load_checkpoint(p)
    assert back.filter_capture == agg.filter_capture
    assert back.want_serials


def test_emission_writes_artifact_next_to_snapshot(tmp_path):
    from ct_mapreduce_tpu_torch.telemetry.metrics import get_sink

    errors = get_sink().snapshot()["counters"].get("filter.emit_error", 0)
    agg = port_agg()
    agg.configure_filter_emission(str(tmp_path / "agg.filter"),
                                  fp_rate=0.02)
    agg.ingest(corpus(n=30, dupes=0))
    agg.save_checkpoint(str(tmp_path / "agg.npz"))
    art = read_artifact(str(tmp_path / "agg.filter"))
    assert art.fp_rate == 0.02
    assert art.n_serials == agg.drain().total
    # A failed emission is counted and never poisons the checkpoint.
    agg.emit_filter_path = str(tmp_path / "missing-dir" / "x.filter")
    agg.save_checkpoint(str(tmp_path / "agg.npz"))
    counters = get_sink().snapshot()["counters"]
    assert counters.get("filter.emit_error", 0) == errors + 1
    assert port_agg().load_checkpoint(str(tmp_path / "agg.npz")) is None


def test_resolve_filter_layering(monkeypatch):
    for env in ("CTMR_EMIT_FILTER", "CTMR_FILTER_PATH",
                "CTMR_FILTER_FP_RATE"):
        monkeypatch.delenv(env, raising=False)
    r = resolve_filter(state_path="/x/agg.npz")
    assert (r.emit, r.path, r.fp_rate) == (False, "/x/agg.npz.filter", 0.01)
    monkeypatch.setenv("CTMR_EMIT_FILTER", "1")
    monkeypatch.setenv("CTMR_FILTER_FP_RATE", "0.05")
    r = resolve_filter(state_path="/x/agg.npz")
    assert (r.emit, r.fp_rate) == (True, 0.05)
    r = resolve_filter(emit=False, path="/y/f.bin", fp_rate=0.2)
    assert (r.emit, r.path, r.fp_rate) == (False, "/y/f.bin", 0.2)
    monkeypatch.setenv("CTMR_FILTER_FP_RATE", "nope")
    assert resolve_filter().fp_rate == 0.01


@pytest.mark.parametrize("text,want", [
    ("emitFilter = true\nfilterPath = /tmp/f.bin\nfilterFpRate = 0.001\n",
     dict(emit_filter=True, filter_path="/tmp/f.bin", filter_fp_rate=0.001)),
    ("filterCaptureSpillDir = /tmp/ring\nfilterCaptureSpillMB = 96\n"
     "filterStreamChunk = 65536\nfilterFusedLanes = 131072\n",
     dict(filter_capture_spill_dir="/tmp/ring", filter_capture_spill_mb=96,
          filter_stream_chunk=65536, filter_fused_lanes=131072)),
])
def test_config_directives(tmp_path, text, want):
    ini = tmp_path / "f.ini"
    ini.write_text(text)
    cfg = CTConfig.load(["-config", str(ini)], env={})
    assert {k: getattr(cfg, k) for k in want} == want
    for line in text.splitlines():
        assert line.split(" = ")[0] in cfg.usage()


# -- tests/test_filter_format.py (the non-DL02 cases) on the port ----------


def test_cross_format_parity_over_observed_universe():
    sets = group_sets(np.random.default_rng(2026), n_groups=5)
    art01 = build_artifact(sets, fp_rate=0.01, use_device=False, fmt="fl01")
    art02 = build_artifact(sets, fp_rate=0.01, use_device=False, fmt="fl02")
    assert art01.fmt == FORMAT_FL01 and art02.fmt == FORMAT_FL02
    assert art01.to_bytes()[:8] == b"CTMRFL01"
    assert art02.to_bytes()[:8] == b"CTMRFL02"
    for (iss, eh), serials in sorted(sets.items()):
        probe = sorted(serials)
        assert art01.query_group(art01.group_for(iss, eh), probe).all()
        assert art02.query_group(art02.group_for(iss, eh), probe).all()
    assert sorted(g.ordinal for g in art01.groups.values()) == \
        list(range(len(sets)))
    for g in art02.groups.values():
        assert g.ordinal == 0 and len(g.cascade.layers) == 1
    back = FilterArtifact.from_bytes(art02.to_bytes())
    assert back.fmt == FORMAT_FL02 and back.to_bytes() == art02.to_bytes()
    g = next(iter(art02.groups.values()))
    part = FilterArtifact.from_bytes(art02.group_bytes(g.issuer, g.exp_id))
    assert list(part.groups) == [(g.issuer, g.exp_id)]
    assert art02.group_bytes("nobody", g.exp_id) is None


def test_fl02_group_bytes_decoupled_across_corpus_churn():
    rng = np.random.default_rng(7)
    sets = group_sets(rng, n_groups=4)
    churn_key = sorted(sets)[0]
    sets2 = {k: set(v) for k, v in sets.items()}
    sets2[churn_key] = set(sets2[churn_key]) | {b"\xfe\xed" * 3}
    sets2[("aa-new-issuer", 900_000)] = {b"\x01\x02\x03\x04"}
    for fmt, decoupled in (("fl02", True), ("fl01", False)):
        a1 = build_artifact(sets, fp_rate=0.01, use_device=False, fmt=fmt)
        a2 = build_artifact(sets2, fp_rate=0.01, use_device=False, fmt=fmt)
        moved = sum(a1.group_bytes(iss, eh) != a2.group_bytes(iss, eh)
                    for (iss, eh) in sorted(sets) if (iss, eh) != churn_key)
        assert moved == (0 if decoupled else len(sets) - 1)


def test_capture_hashes_exact_across_growth_and_checkpoint(tmp_path):
    agg = port_agg(capacity=1 << 8, grow_at=0.5, max_capacity=1 << 14)
    captured(agg, corpus(n=150, dupes=0) + corpus(
        n=20, dupes=0, cn="Filter CA B", issuer=ISSUER_B, base=500_000))
    assert agg.capacity > (1 << 8), "growth never fired"
    hashes = agg.capture_content_hashes()
    assert hashes is not None
    for key, serials in sorted(agg.filter_capture.items()):
        assert hashes[key] == content_token(serials)[1]
    path = str(tmp_path / "agg.npz")
    agg.save_checkpoint(path)
    with np.load(path, allow_pickle=True) as z:
        assert "filter_hashes" in z
    back = port_agg()
    back.load_checkpoint(path)
    assert back.capture_content_hashes() == hashes
    back.ingest(corpus(n=5, dupes=0, base=9000))
    h2 = back.capture_content_hashes()
    for key, serials in sorted(back.filter_capture.items()):
        assert h2[key] == content_token(serials)[1]


def test_fleet_merge_and_serial_run_agree_on_tokens(tmp_path):
    half_a = corpus(n=40, dupes=0)
    half_b = corpus(n=40, dupes=0)[:20] + corpus(
        n=25, dupes=0, cn="Filter CA B", issuer=ISSUER_B, base=600_000)
    paths = []
    for w, ents in enumerate((half_a, half_b)):
        p = str(tmp_path / f"agg.w{w}.npz")
        captured(port_agg(), ents).save_checkpoint(p)
        paths.append(p)
    serial = captured(port_agg(), half_a + half_b)
    cache = GroupBuildCache()
    art_m = build_from_merged(merge.load_checkpoints(paths), fp_rate=0.01,
                              cache=cache)
    assert cache.hits == 0
    art_s = build_from_aggregator(serial, fp_rate=0.01, cache=cache)
    assert cache.hits == len(art_m.groups)
    assert art_s.to_bytes() == art_m.to_bytes()


def test_spill_ring_hash_exactness_contract(tmp_path):
    ring = SpillCaptureRing(str(tmp_path / "r1"), mem_bytes=1 << 20)
    key = (1, 500_000)
    for sb in (b"\x01\x02", b"\x03\x04", b"\x01\x02"):
        ring.add(key, sb)
    assert ring.content_hashes() == {
        key: serial_hash(b"\x01\x02") ^ serial_hash(b"\x03\x04")}
    spilly = SpillCaptureRing(str(tmp_path / "r2"), mem_bytes=64)
    for j in range(40):
        spilly.add(key, bytes([j]) * 8)
    assert spilly.spilled_bytes > 0 and spilly.content_hashes() is None
    del spilly
    resumed = SpillCaptureRing(str(tmp_path / "r2"), mem_bytes=1 << 20)
    assert resumed.content_hashes() is None


def test_spilled_capture_still_feeds_the_cache(tmp_path):
    agg = port_agg()
    agg.enable_filter_capture(spill_dir=str(tmp_path / "ring"),
                              spill_mem_bytes=256)
    agg.ingest(corpus(n=60, dupes=0))
    assert isinstance(agg.filter_capture, SpillCaptureRing)
    assert agg.filter_capture.spilled_bytes > 0
    assert agg.capture_content_hashes() is None
    cache = GroupBuildCache()
    art1 = build_from_aggregator(agg, fp_rate=0.01, cache=cache)
    art2 = build_from_aggregator(agg, fp_rate=0.01, cache=cache)
    assert cache.hits == len(art1.groups)
    assert art2.to_bytes() == art1.to_bytes()


def test_clean_groups_reused_verbatim_across_epochs():
    rng = np.random.default_rng(41)
    sets1 = group_sets(rng, n_groups=5)
    churn_key = sorted(sets1)[2]
    sets2 = {k: set(v) for k, v in sets1.items()}
    sets2[churn_key] = set(sets2[churn_key]) | {b"\xaa\xbb\xcc\xdd"}
    cache = GroupBuildCache()
    art1 = build_artifact(sets1, fp_rate=0.01, use_device=False, fmt="fl02",
                          cache=cache, tokens=tokens_of(sets1))
    art2 = build_artifact(sets2, fp_rate=0.01, use_device=False, fmt="fl02",
                          cache=cache, tokens=tokens_of(sets2))
    assert cache.hits == len(sets1) - 1
    for key in sorted(sets1):
        same = art2.group_for(*key) is art1.group_for(*key)
        assert same == (key != churn_key)
    scratch = build_artifact(sets2, fp_rate=0.01, use_device=False,
                             fmt="fl02")
    assert art2.to_bytes() == scratch.to_bytes()


def test_cache_ignores_fl01_and_fp_rate_changes():
    sets = group_sets(np.random.default_rng(3), n_groups=3)
    cache = GroupBuildCache()
    build_artifact(sets, fp_rate=0.01, use_device=False, fmt="fl01",
                   cache=cache, tokens=tokens_of(sets))
    assert cache.misses == 0
    build_artifact(sets, fp_rate=0.01, use_device=False, fmt="fl02",
                   cache=cache, tokens=tokens_of(sets))
    assert cache.hits == 0
    build_artifact(sets, fp_rate=0.02, use_device=False, fmt="fl02",
                   cache=cache, tokens=tokens_of(sets))
    assert cache.hits == 0


def test_format_knob_ladder(monkeypatch):
    monkeypatch.delenv("CTMR_FILTER_FORMAT", raising=False)
    assert default_format() == FORMAT_FL02
    assert resolve_filter().fmt == FORMAT_FL02
    monkeypatch.setenv("CTMR_FILTER_FORMAT", "CTMRFL01")
    assert default_format() == FORMAT_FL01
    assert resolve_filter().fmt == FORMAT_FL01
    assert resolve_filter(fmt="fl02").fmt == FORMAT_FL02
    monkeypatch.setenv("CTMR_FILTER_FORMAT", "fl99")
    assert default_format() == FORMAT_FL02
    assert resolve_filter().fmt == FORMAT_FL02
    with pytest.raises(ValueError):
        resolve_filter(fmt="fl99")
    with pytest.raises(ValueError):
        normalize_format("CTMRFL99")


# -- tests/test_filter_scale.py on the port --------------------------------


def test_build_paths_byte_identity_property():
    rng = np.random.default_rng(20260805)
    for trial in range(4):
        state = random_state(rng)
        ref = build_artifact(state, fp_rate=0.02, use_device=False,
                             fused=False).to_bytes()
        for kwargs in (dict(), dict(stream_chunk=17), dict(fused_lanes=64),
                       dict(stream_chunk=5, fused_lanes=29)):
            blob = build_artifact(state, fp_rate=0.02, use_device=False,
                                  **kwargs).to_bytes()
            assert blob == ref, (trial, kwargs)
        assert ref == jbuild(state, fp_rate=0.02, use_device=False,
                             fused=False).to_bytes()


def test_fused_device_lane_byte_identity():
    state = random_state(np.random.default_rng(7), n_groups=4)
    host = build_artifact(state, fp_rate=0.02, use_device=False).to_bytes()
    dev = build_artifact(state, fp_rate=0.02, use_device=True, device="cpu",
                         fused_lanes=128).to_bytes()
    assert dev == host


def test_packed_source_matches_list_source():
    state = random_state(np.random.default_rng(11), n_groups=3)
    ref = build_artifact(state, fp_rate=0.01, use_device=False).to_bytes()
    blob = build_artifact_from_sources(
        packed_sources(state), fp_rate=0.01, use_device=False,
        stream_chunk=13).to_bytes()
    assert blob == ref


def test_fused_contains_matches_layer_contains():
    from ct_mapreduce_tpu_torch.filter.cascade import (
        build_layer,
        layer_contains,
    )

    rng = np.random.default_rng(3)
    ms = np.array([1024, 2048, 512], np.int64)
    ks = np.array([5, 7, 2], np.int64)
    offs_words = np.concatenate(([0], np.cumsum(ms // 32)[:-1]))
    keysets = [rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32)
               for n in (40, 70, 9)]
    words = [build_layer(keysets[g], int(ms[g]), int(ks[g]), 2,
                         use_device=False) for g in range(3)]
    probes = [rng.integers(0, 2**32, size=(25, 4), dtype=np.uint32)
              for _ in range(3)]
    S = np.concatenate(keysets + probes)
    spans, pos = [], 0
    for n in [k.shape[0] for k in keysets] + [25, 25, 25]:
        spans.append(np.arange(pos, pos + n, dtype=np.int64))
        pos += n
    chunks = [(0, spans[0]), (1, spans[1]), (2, spans[2]),
              (0, spans[3]), (1, spans[4]), (2, spans[5])]
    got = fused_mod.fused_contains(np.concatenate(words), chunks, S, 2,
                                   offs_words, ms, ks)
    for (g, idx), hit in zip(chunks, got):
        want = layer_contains(words[g], int(ms[g]), int(ks[g]), 2, S[idx])
        assert np.array_equal(hit, want), g
    assert got[0].all() and got[1].all() and got[2].all()


def test_fused_dispatch_collapse():
    rng = np.random.default_rng(5)
    groups = [rng.integers(0, 2**32, size=(int(rng.integers(20, 120)), 4),
                           dtype=np.uint32) for _ in range(12)]
    cascades, stats = fused_mod.build_cascades_fused(groups, 0.02,
                                                     use_device=False)
    assert stats.layers >= 12
    assert stats.dispatches < stats.layers
    assert stats.mean_groups_per_dispatch() > 2.0
    allk = np.concatenate(groups)
    bounds = np.cumsum([0] + [g.shape[0] for g in groups])
    mask = np.zeros(allk.shape[0], bool)
    mask[bounds[3]: bounds[4]] = True
    ref = FilterCascade.build(groups[3], allk[~mask], 0.02,
                              use_device=False)
    assert len(ref.layers) == len(cascades[3].layers)
    for a, b in zip(ref.layers, cascades[3].layers):
        assert (a.m, a.k) == (b.m, b.k)
        assert np.array_equal(a.words, b.words)


def make_ring_state(ring_or_dict, rng, n=300):
    for _ in range(n):
        key = (int(rng.integers(0, 4)), 500_000 + int(rng.integers(0, 3)))
        sb = rng.integers(0, 256, int(rng.integers(3, 18)),
                          dtype=np.uint8).tobytes()
        if isinstance(ring_or_dict, SpillCaptureRing):
            ring_or_dict.add(key, sb)
        else:
            ring_or_dict.setdefault(key, set()).add(sb)


def test_spill_ring_matches_dict_capture(tmp_path):
    ring = SpillCaptureRing(str(tmp_path / "spill"), mem_bytes=2048)
    plain: dict = {}
    make_ring_state(ring, np.random.default_rng(17))
    make_ring_state(plain, np.random.default_rng(17))
    assert ring.spilled_bytes > 0 and ring.stats()["segments"] >= 1
    assert ring.items() == sorted((k, set(v)) for k, v in plain.items())
    assert ring.items() == ring.items()


def test_spill_ring_crash_restart_resume(tmp_path):
    spill = str(tmp_path / "spill")
    ring = SpillCaptureRing(spill, mem_bytes=64)
    for j in range(40):
        ring.add((1, 500_000), bytes([j]) * 8)
    flushed = ring.spilled_bytes
    segs = ring.stats()["segments"]
    assert segs >= 2
    pre_crash = {sb for _, s in ring.items() for sb in s}
    del ring
    back = SpillCaptureRing(spill, mem_bytes=1 << 20)
    assert back.spilled_bytes == flushed
    assert {sb for _, s in back.items() for sb in s} == pre_crash
    back.add((2, 500_001), b"\xaa" * 9)
    back.flush()
    assert back.stats()["segments"] == segs + 1
    assert ((2, 500_001), {b"\xaa" * 9}) in back.items()


def test_aggregator_spill_capture_byte_identity(tmp_path, monkeypatch):
    monkeypatch.setenv("CTMR_TABLE", "bucket")
    ents = corpus(n=150, dupes=30)
    aggs = []
    for spill in (False, True):
        agg = port_agg(capacity=1 << 8, grow_at=0.5, max_capacity=1 << 14)
        if spill:
            agg.enable_filter_capture(spill_dir=str(tmp_path / "ring"),
                                      spill_mem_bytes=512)
        else:
            agg.enable_filter_capture()
        agg.ingest(ents)
        assert agg.capacity > (1 << 8)
        aggs.append(agg)
    plain, spilled = aggs
    assert isinstance(spilled.filter_capture, SpillCaptureRing)
    assert spilled.filter_capture.spilled_bytes > 0
    a = build_from_aggregator(plain, fp_rate=0.01).to_bytes()
    assert build_from_aggregator(spilled, fp_rate=0.01).to_bytes() == a
    p1, p2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    plain.save_checkpoint(p1)
    spilled.save_checkpoint(p2)
    with np.load(p1, allow_pickle=True) as z1, \
            np.load(p2, allow_pickle=True) as z2:
        assert np.array_equal(z1["filter_keys"], z2["filter_keys"])
        assert list(z1["filter_vals"]) == list(z2["filter_vals"])
    back = port_agg()
    back.load_checkpoint(p2)
    assert isinstance(back.filter_capture, dict)
    back.enable_filter_capture(spill_dir=str(tmp_path / "ring2"),
                               spill_mem_bytes=256)
    assert isinstance(back.filter_capture, SpillCaptureRing)
    assert build_from_aggregator(back, fp_rate=0.01).to_bytes() == a


def test_fleet_merged_matches_streamed_spilled(tmp_path):
    half_a = corpus(n=45, dupes=0, base=1000)
    half_b = corpus(n=45, dupes=0, cn="Filter CA B", issuer=ISSUER_B,
                    base=600_000)
    paths = []
    for w, ents in enumerate((half_b, half_a)):
        agg = port_agg()
        agg.enable_filter_capture(spill_dir=str(tmp_path / f"ring{w}"),
                                  spill_mem_bytes=256)
        agg.ingest(ents)
        p = str(tmp_path / f"agg.w{w}.npz")
        agg.save_checkpoint(p)
        paths.append(p)
    serial = captured(port_agg(), half_a + half_b)
    merged_blob = build_from_merged(merge.load_checkpoints(paths),
                                    fp_rate=0.01).to_bytes()
    in_mem = build_from_aggregator(serial, fp_rate=0.01).to_bytes()
    assert merged_blob == in_mem
    assert build_from_aggregator(serial, fp_rate=0.01).to_bytes() == in_mem


def test_resolve_filter_scale_knobs(monkeypatch, tmp_path):
    for env in ("CTMR_FILTER_SPILL_DIR", "CTMR_FILTER_SPILL_MB",
                "CTMR_FILTER_STREAM_CHUNK", "CTMR_FILTER_FUSED_LANES",
                "CTMR_PLATFORM_PROFILE"):
        monkeypatch.delenv(env, raising=False)
    r = resolve_filter()
    assert (r.spill_dir, r.spill_mb, r.stream_chunk, r.fused_lanes) == \
        ("", 256, 0, 0)
    monkeypatch.setenv("CTMR_FILTER_SPILL_DIR", "/x/ring")
    monkeypatch.setenv("CTMR_FILTER_SPILL_MB", "64")
    monkeypatch.setenv("CTMR_FILTER_STREAM_CHUNK", "4096")
    r = resolve_filter()
    assert (r.spill_dir, r.spill_mb, r.stream_chunk) == \
        ("/x/ring", 64, 4096)
    r = resolve_filter(spill_dir="/y", spill_mb=32, stream_chunk=512,
                       fused_lanes=2048)
    assert (r.spill_dir, r.spill_mb, r.stream_chunk, r.fused_lanes) == \
        ("/y", 32, 512, 2048)
    prof = tmp_path / "prof.json"
    prof.write_text(json.dumps({
        "version": 1, "platform": "test",
        "knobs": {"filter": {"filterCaptureSpillMB": 128,
                             "filterFusedLanes": 8192}}}))
    monkeypatch.setenv("CTMR_PLATFORM_PROFILE", str(prof))
    monkeypatch.delenv("CTMR_FILTER_SPILL_MB", raising=False)
    r = resolve_filter()
    assert (r.spill_mb, r.fused_lanes) == (128, 8192)


def test_list_source_semantics():
    src = ListGroupSource("iss", 500_000,
                          [b"\x02", b"\x01", b"\x02", b"\x61" * 60])
    assert src.n == 3
    blocks = list(stream.key_blocks(src, 0, 2, use_device=False))
    assert sum(b.shape[0] for b in blocks) == 3
    keys = np.concatenate(blocks)
    assert len({k.tobytes() for k in keys}) == 3


def test_query_by_exp_date_spellings():
    sets = group_sets(np.random.default_rng(5), n_groups=2)
    art = build_artifact(sets, fp_rate=0.01, use_device=False)
    (iss, eh), serials = sorted(sets.items())[0]
    sb = sorted(serials)[0]
    exp_id = ExpDate.from_unix_hour(eh).id()
    assert art.query(iss, eh, sb) and art.query(iss, exp_id, sb)
    assert not art.query(iss, "not-a-date", sb)


@pytest.fixture(scope="module")
def jax_sink_capture():
    """The JAX package's unstaged sink with capture over the sink tests'
    pages (an oversized serial, a too-wide leaf, replays, filtered
    leaves): its capture and content hashes."""
    from tests.test_torch_sink import NOW as SNOW, PAGES_FLUSHING, FLUSH
    from ct_mapreduce_tpu.ingest import sync as jsync

    agg = TpuAggregator(capacity=1 << 9, batch_size=FLUSH, now=SNOW)
    agg.enable_filter_capture()
    sink = jsync.AggregatorSink(agg, flush_size=FLUSH, device_queue_depth=2)
    sink.PAD_LEN = 1024
    for n, (lis, eds) in enumerate(PAGES_FLUSHING):
        sink.store_raw_batch(jsync.RawBatch(lis, eds, n * FLUSH, "log"))
    sink.close()
    return agg.filter_capture, agg.capture_content_hashes()


@pytest.mark.parametrize("kw", [
    dict(device_queue_depth=2), dict(chunks_per_dispatch=3, staging_depth=2),
    dict(preparsed=True, device_queue_depth=2)],
    ids=["unstaged", "staged", "preparsed"])
def test_sink_lanes_capture_like_jax(jax_sink_capture, kw):
    """Every fold site captures: the walker fold, the staged envelopes
    (through the same fold), the pre-parsed fold and the host lane give
    the JAX sink's capture and hashes. The sink keeps serial bytes
    although it has no PEM backend, because the capture needs them."""
    from tests.test_torch_sink import NOW as SNOW, PAGES_FLUSHING, FLUSH
    from ct_mapreduce_tpu_torch.ingest import sync as tsync

    agg = TorchAggregator(capacity=1 << 9, batch_size=FLUSH, now=SNOW,
                          device="cpu")
    agg.enable_filter_capture()
    sink = tsync.AggregatorSink(agg, flush_size=FLUSH, **kw)
    assert agg.want_serials
    sink.PAD_LEN = 1024
    for n, (lis, eds) in enumerate(PAGES_FLUSHING):
        sink.store_raw_batch(tsync.RawBatch(lis, eds, n * FLUSH, "log"))
    sink.close()
    want, hashes = jax_sink_capture
    assert agg.filter_capture == want
    assert agg.capture_content_hashes() == hashes
    assert any(len(sb) > 46 for ss in want.values() for sb in ss)
