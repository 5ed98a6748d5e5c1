"""The port's signature-verification lane against the JAX package's, on
the CPU.

- ``ops/bigint.py``: the same seeded limb vectors through both
  packages' functions for the four moduli (P-256/P-384 field and order):
  every output limb for limb.
- ``ops/ecdsa.py`` (K6's plain versions): verdicts on the known-answer
  corpus and the windowed-ladder edge cases of ``tests/test_ecdsa.py``
  equal to the JAX package's jitted ``verify_batch`` (one call a curve,
  window 8, width 32, a module fixture) and to
  ``verify/host.py::verify_ecdsa``; every other verdict, window 0
  included, is held to the host verifier, which compiles nothing.
  Window tables equal the JAX package's.
- SCT extraction, native and NumPy, equal to the JAX package's
  ``SctBatch``.
- The cases of ``tests/test_verify_lane.py`` through the port's sink
  (``TorchAggregator(device="cpu")``), serial and staged, beside the JAX
  sink on the same pages: stats, per-issuer verdicts, checkpoints and
  reports crossing both ways.

What the reference marks slow is slow here too (P-384 window 0, the
wide widths, the mutation fuzz). Tolerance: exact equality.
"""

import functools
import io
import json
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import test_ecdsa as ref
import test_verify_lane as ref_lane
from ct_mapreduce_tpu.agg.aggregator import (
    HostSnapshotAggregator,
    TpuAggregator,
)
from ct_mapreduce_tpu.ingest import sync as jsync
from ct_mapreduce_tpu.native import leafpack as jleafpack
from ct_mapreduce_tpu.ops import bigint as jbig
from ct_mapreduce_tpu.ops import ecdsa as jecdsa
from ct_mapreduce_tpu.verify import lane as jlane
from ct_mapreduce_tpu.verify import sct as jsct
from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
from ct_mapreduce_tpu_torch.ingest import sync as tsync
from ct_mapreduce_tpu_torch.native import leafpack as tleafpack
from ct_mapreduce_tpu_torch.ops import bigint as tbig
from ct_mapreduce_tpu_torch.ops import ecdsa as tecdsa
from ct_mapreduce_tpu_torch.verify import host, lane as tlane, sct as tsct

WIDTH = 32
MODS = {"p256_p": (jbig.P256_P, tbig.P256_P),
        "p256_n": (jbig.P256_N, tbig.P256_N),
        "p384_p": (jbig.P384_P, tbig.P384_P),
        "p384_n": (jbig.P384_N, tbig.P384_N)}
CURVES = {"p256": (ref.C, host.P256, tecdsa.P256_OPS),
          "p384": (ref.C384, host.P384, tecdsa.P384_OPS)}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(j, t) -> None:
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


# -- bigint ---------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MODS))
def test_bigint_matches_jax(name):
    jm, tm = MODS[name]
    nl = jm.nlimb
    n_int = jbig.int_from_limbs(jm.n)
    rng = np.random.default_rng(len(name) * 7 + nl)
    vals = [int.from_bytes(rng.bytes(2 * nl), "little") % n_int
            for _ in range(30)] + [0, 1, n_int - 1]
    a = np.stack([jbig.limbs_from_int(v, nl) for v in vals])
    b = a[::-1].copy()
    raw = rng.integers(0, 1 << 16, (len(vals), nl)).astype(np.uint32)
    ja, jb_, jr = jnp.asarray(a), jnp.asarray(b), jnp.asarray(raw)
    ta, tb, tr = _t(a), _t(b), _t(raw)
    _eq(jbig.mont_mul(ja, jb_, jm), tbig.mont_mul(ta, tb, tm))
    _eq(jbig.mont_mul(jr, jb_, jm), tbig.mont_mul(tr, tb, tm))
    _eq(jbig.to_mont(jr, jm), tbig.to_mont(tr, tm))
    _eq(jbig.from_mont(ja, jm), tbig.from_mont(ta, tm))
    _eq(jbig.add_mod(ja, jb_, jm), tbig.add_mod(ta, tb, tm))
    _eq(jbig.sub_mod(ja, jb_, jm), tbig.sub_mod(ta, tb, tm))
    _eq(jbig.mod_reduce_once(jr, jm), tbig.mod_reduce_once(tr, tm))
    _eq(jbig.geq(jr, jb_), tbig.geq(tr, tb))
    for j, t in zip(jbig.sub_raw(jr, jb_), tbig.sub_raw(tr, tb)):
        _eq(j, t)
    cols = rng.integers(0, 1 << 31, (8, nl + 1)).astype(np.uint32)
    for j, t in zip(jbig._carry_norm(jnp.asarray(cols), nl),
                    tbig._carry_norm(_t(cols), nl)):
        _eq(j, t)
    _eq(jbig.mont_inv(ja[:6], jm), tbig.mont_inv(ta[:6], tm))
    z = a[:10].copy()
    z[3] = z[7] = 0  # zero lanes, masked through the product
    _eq(jbig.batch_inv_mont(jnp.asarray(z), jm), tbig.batch_inv_mont(_t(z), tm))
    for w in (2, 4, 8):
        for j in (0, 1, 16 * nl // w - 1):
            _eq(jbig.window_digit(ja, jnp.int32(j), w),
                tbig.window_digit(ta, j, w))
    by = rng.integers(0, 256, (5, 2 * nl), dtype=np.uint8)
    _eq(jbig.bytes_to_limbs(jnp.asarray(by)),
        tbig.bytes_to_limbs(torch.from_numpy(by)))
    assert [int(x) for x in tm.n] == [int(x) for x in jm.n]
    assert (tm.n0p, tm.r2.tolist(), tm.one_m.tolist()) == (
        jm.n0p, jm.r2.tolist(), jm.one_m.tolist())


# -- verdicts -------------------------------------------------------------


def _corpus(curve: str):
    c = CURVES[curve][0]
    cases = ref._kat_corpus(c) + ref._window_edge_corpus(c)
    return [cs[1] for cs in cases], [cs[2] for cs in cases]


def _arrays(rows, c, width: int = WIDTH):
    n = len(rows)
    nb = c.byte_len
    digest = np.zeros((width, 32), np.uint8)
    r, s, qx, qy = (np.zeros((width, nb), np.uint8) for _ in range(4))
    digest[:n], r[:n], s[:n], qx[:n], qy[:n] = ref._rows_to_arrays(rows, c)
    valid = np.zeros((width,), bool)
    valid[:n] = True
    return digest, r, s, qx, qy, valid


def _tverify(rows, window: int, curve: str = "p256", width: int = WIDTH):
    """The port's verdicts (the plain versions, on the CPU)."""
    c, _, ops = CURVES[curve]
    out = tecdsa.verify_batch(ops, *_arrays(rows, c, width), window=window,
                              device="cpu")
    return out[: len(rows)].tolist()


@pytest.fixture(scope="module")
def jax_verdicts():
    """The JAX package's jitted windowed verify over each curve's whole
    corpus: one call a curve at window 8, width 32."""
    out = {}
    for curve, (c, _, _) in CURVES.items():
        rows, _ = _corpus(curve)
        fn = jecdsa.verify_p256 if curve == "p256" else jecdsa.verify_p384
        out[curve] = fn(*_arrays(rows, c), window=8)[: len(rows)].tolist()
    return out


@pytest.mark.parametrize("curve,window", [("p256", 8), ("p256", 0),
                                          ("p384", 8)])
def test_known_answers_match_jax_and_host(jax_verdicts, curve, window):
    """The KAT corpus and the windowed-ladder edges (u1 = 0, infinity
    mid-ladder, accumulator == table point): the port == the JAX
    package's verify == the host verifier == the expectation."""
    rows, expected = _corpus(curve)
    assert ref._hverify(rows, CURVES[curve][0]) == expected
    assert jax_verdicts[curve] == expected
    assert _tverify(rows, window, curve) == expected


@pytest.mark.slow
def test_p384_window0_matches_host():
    rows, expected = _corpus("p384")
    assert _tverify(rows, 0, "p384") == expected


def test_batch_inversion_zero_lane_isolation():
    """s = 0 lanes and an R-at-infinity lane between valid ones: every
    lane answers exactly what it answers alone."""
    dg, r, s, q = ref._sign("iso-a", b"isolation")
    rows = [
        (dg, r, s, q[0], q[1]),
        (dg, r, 0, q[0], q[1]),
        (dg, r, s, q[0], q[1]),
        ref._window_edge_corpus()[2][1],
        (dg, r, ref.C.n - s, q[0], q[1]),
        (ref.hashlib.sha256(b"no").digest(), r, s, q[0], q[1]),
    ]
    batch = _tverify(rows, 8)
    assert batch == ref._hverify(rows) == [True, False, True, False, True,
                                          False]
    for i, row in enumerate(rows):
        assert _tverify([row], 8, width=1) == [batch[i]], i


def test_all_valid_and_all_invalid_batches():
    valid_rows = []
    for i in range(WIDTH):
        dg, r, s, q = ref._sign(f"fill-{i % 5}", b"m%d" % i)
        valid_rows.append((dg, r, s, q[0], q[1]))
    assert _tverify(valid_rows, 0) == [True] * WIDTH
    invalid_rows = [(dg, 0, s, x, y) for dg, _r, s, x, y in valid_rows]
    assert _tverify(invalid_rows, 0) == [False] * WIDTH


def test_padding_mask_parity():
    """The same rows behind invalid filler lanes answer identically."""
    rows = [cs[1] for cs in ref._kat_corpus()[:10]]
    base = _tverify(rows, 8)
    filler = ref._sign("pad-filler", b"pad")
    mixed = []
    for row in rows:
        mixed.append((filler[0], 0, 0, 0, 0))
        mixed.append(row)
    assert _tverify(mixed, 8)[1::2] == base


@pytest.mark.slow
def test_batch_width_parity_wide():
    rows, expected = _corpus("p256")
    assert _tverify(rows, 0, width=64) == expected
    assert _tverify(rows, 0, width=128) == expected
    assert _tverify(rows, 8, width=64) == expected


@pytest.mark.slow
@pytest.mark.parametrize("window,curve", [
    (0, "p256"), (2, "p256"), (4, "p256"), (8, "p256"),
    (0, "p384"), (8, "p384"),
])
def test_mutation_fuzz_host_parity(window, curve):
    """≥400 mutated signatures (P-256; 128 for P-384): the port's
    verdict equals the host verdict on every lane."""
    c = CURVES[curve][0]
    nbits = 8 * c.byte_len
    rng = random.Random(0x5C7 + window)
    count = 13 * WIDTH if curve == "p256" else 4 * WIDTH
    rows = []
    for i in range(count):
        dg, r, s, q = ref._sign(f"fuzz-{i % 7}", b"fz%d" % (i % 29), c)
        row = [bytearray(dg), r, s, q[0], q[1]]
        kind = rng.randrange(8)
        if kind == 1:
            row[0][rng.randrange(32)] ^= 1 << rng.randrange(8)
        elif kind in (2, 3, 4, 5):
            row[kind - 1] ^= 1 << rng.randrange(nbits)
        elif kind == 6:
            row[rng.randrange(1, 5)] = rng.getrandbits(nbits)
        elif kind == 7:
            row[2] = c.n - row[2]
        rows.append((bytes(row[0]), row[1], row[2], row[3], row[4]))
    for lo in range(0, len(rows), WIDTH):
        chunk = rows[lo: lo + WIDTH]
        assert _tverify(chunk, window, curve) == ref._hverify(chunk, c), lo


def test_window_tables_match_jax():
    """``point_table_np`` equals the JAX function's (G at w = 8, a key at
    w = 4 on P-384), entries equal d·2^(w·j)·G by the host scalar
    multiplication, and the packed device tables hold the same limbs."""
    c = host.P256
    tab = tecdsa.point_table_np(c, c.gx, c.gy, 8)
    np.testing.assert_array_equal(tab, jecdsa.point_table_np(
        ref.C, c.gx, c.gy, 8))
    for j, d in ((0, 1), (0, 255), (3, 17), (31, 2)):
        pt = host._point_mul(c, d << (8 * j), (c.gx, c.gy))
        assert tbig.int_from_limbs(tab[j, d, 0]) == pt[0] * (1 << 256) % c.p
        assert tbig.int_from_limbs(tab[j, d, 1]) == pt[1] * (1 << 256) % c.p
    assert not tab[:, 0].any()
    q = ref._key("tab-384", ref.C384)[1]
    tab4 = tecdsa.point_table_np(host.P384, q[0], q[1], 4)
    np.testing.assert_array_equal(tab4, jecdsa.point_table_np(
        ref.C384, q[0], q[1], 4))
    gtab, _ = tecdsa.fixed_base_table(tecdsa.P256_OPS, 8, "cpu")
    np.testing.assert_array_equal(
        tecdsa._unpack(gtab).numpy(),
        np.asarray(jecdsa.fixed_base_table(jecdsa.P256_OPS, 8)[0]))
    assert tecdsa.resolve_precomp_window(0) == jecdsa.resolve_precomp_window(0)


def test_plain_version_checks_inputs_and_device():
    """The dispatch takes the plain version only for CPU tensors; a lane
    with a key index past the slots reads the last slot (XLA's gather
    clamps) and still answers."""
    rows, expected = _corpus("p256")
    c, _, ops = CURVES["p256"]
    args = [torch.from_numpy(a) for a in _arrays(rows, c)]
    gtab, _ = tecdsa.fixed_base_table(ops, 8, "cpu")
    qtab = tecdsa.zero_qtable(1, 32, 256, 16, "cpu")
    far = torch.full((WIDTH,), 99, dtype=torch.int32)
    out = tecdsa.verify_windowed(ops, *args, far, gtab, qtab)
    assert out.dtype == torch.bool and out.shape == (WIDTH,)
    assert not out[len(rows):].any()
    with pytest.raises(ValueError, match="device"):
        tecdsa.verify_jacobian(ops, *[a.to("meta") for a in args])


# -- SCT extraction -------------------------------------------------------


def test_sct_extraction_matches_jax():
    data, length = ref._sct_corpus()
    want = jsct.extract_scts_np(data, length)
    got = [tsct.extract_scts_np(data, length)]
    got += [tleafpack.extract_scts(data, length, threads=t) for t in (1, 4)]
    ikh = np.random.default_rng(3).integers(0, 256, (len(data), 32),
                                            dtype=np.uint8)
    want_ikh = jleafpack.extract_scts(data, length, issuer_key_hash=ikh)
    got_ikh = tleafpack.extract_scts(data, length, threads=4,
                                     issuer_key_hash=ikh)
    assert want.ok[:7].tolist() == [1, 1, 2, 2, 0, 1, 1]
    for fld in ("ok", "digest", "log_id", "timestamp_ms", "r", "s",
                "hash_alg", "sig_alg"):
        for g in got:
            np.testing.assert_array_equal(getattr(g, fld), getattr(want, fld),
                                          err_msg=fld)
        np.testing.assert_array_equal(getattr(got_ikh, fld),
                                      getattr(want_ikh, fld), err_msg=fld)


def test_extract_scts_python_route(monkeypatch):
    data, length = ref._sct_corpus()
    monkeypatch.setenv("CTMR_NATIVE", "0")
    fb = tleafpack.extract_scts(data, length)
    monkeypatch.delenv("CTMR_NATIVE")
    want = jsct.extract_scts_np(data, length)
    np.testing.assert_array_equal(fb.ok, want.ok)
    np.testing.assert_array_equal(fb.digest, want.digest)


def test_signers_and_registry_cross_packages(tmp_path):
    """The port's fixture signers sign what the JAX package's verify,
    and a key file written by either package loads in the other."""
    signers = [tsct.EcSctSigner("rt-a"), tsct.EcSctSigner("rt-b", host.P384),
               tsct.RsaSctSigner()]
    jsigners = [jsct.EcSctSigner("rt-a"), jsct.EcSctSigner("rt-b", ref.C384),
                jsct.RsaSctSigner()]
    assert [s.key_entry() for s in signers] == [
        s.key_entry() for s in jsigners]
    base = ref_lane.minicert.make_cert(serial=5, issuer_cn="RT CA")
    cert = tsct.attach_sct(base, signers[1], 12345)
    assert cert == jsct.attach_sct(base, jsigners[1], 12345)
    reg = tlane.LogKeyRegistry()
    for s in signers:
        reg.register_signer(s)
    tlane._key_coord(reg.get(signers[0].log_id), "x")
    path = tmp_path / "keys.json"
    path.write_text(reg.to_json())
    assert "_epoch" not in path.read_text()
    jreg = jlane.LogKeyRegistry.from_json_file(str(path))
    assert jreg.to_json() == reg.to_json() and jreg.epoch == reg.epoch == 3
    path.write_text(jreg.to_json())
    back = tlane.LogKeyRegistry.from_json_file(str(path))
    assert back.is_p256(signers[0].log_id)
    assert not back.is_p256(signers[1].log_id)
    assert back.get(signers[2].log_id)["alg"] == "rsa"


# -- the lane through the sink --------------------------------------------


def _signers():
    return (tsct.EcSctSigner("vl-a"), tsct.EcSctSigner("vl-b", host.P384),
            tsct.RsaSctSigner())


def _port_sink(pairs, chunks_per_dispatch=1, flush=16):
    agg = TorchAggregator(capacity=1 << 12, batch_size=flush, device="cpu")
    sink = tsync.AggregatorSink(agg, flush_size=flush, device_queue_depth=0,
                                verify_signatures=True,
                                chunks_per_dispatch=chunks_per_dispatch)
    sink.verifier.batch_width = WIDTH
    for s in _signers():
        sink.verifier.keys.register_signer(s)
    lis, eds = ref_lane._wire(pairs)
    sink.store_raw_batch(tsync.RawBatch(lis, eds, 0, "v-log"))
    sink.flush()
    return agg, sink


@pytest.fixture(scope="module")
def lane_runs():
    """One serial sink run of the reference lane corpus in each package
    (the JAX run reuses the verify compile of ``jax_verdicts``'s
    shapes), shared by every read-side test."""
    pairs, expect = ref_lane._corpus()
    jagg, jsink = ref_lane._run_sink(pairs)
    agg, sink = _port_sink(pairs)
    return {"pairs": pairs, "expect": expect, "jax": (jagg, jsink),
            "port": (agg, sink)}


def _check_outcomes(agg, sink, expect, n_pairs):
    ref_lane._check_outcomes(agg, sink, expect, n_pairs)


@pytest.mark.parametrize("staged", [False, True])
def test_sink_lane_outcomes_match_jax(lane_runs, staged):
    pairs, expect = lane_runs["pairs"], lane_runs["expect"]
    jagg, jsink = lane_runs["jax"]
    agg, sink = (_port_sink(pairs, chunks_per_dispatch=2) if staged
                 else lane_runs["port"])
    _check_outcomes(agg, sink, expect, len(pairs))
    assert sink.verifier.stats == jsink.verifier.stats
    assert agg.verify_counts() == jagg.verify_counts()
    assert sink.verifier.health() == jsink.verifier.health()


def test_lane_python_extraction_parity(lane_runs, monkeypatch):
    """CTMR_NATIVE=0 (Python decode AND extraction): the same outcomes."""
    monkeypatch.setenv("CTMR_NATIVE", "0")
    _agg, sink = _port_sink(lane_runs["pairs"])
    assert sink.verifier.stats == lane_runs["port"][1].verifier.stats


def test_verify_off_means_no_verifier(monkeypatch):
    monkeypatch.delenv("CTMR_VERIFY", raising=False)
    agg = TorchAggregator(capacity=1 << 12, batch_size=16, device="cpu")
    sink = tsync.AggregatorSink(agg, flush_size=16, device_queue_depth=0)
    assert sink.verifier is None
    assert not agg.verify_counts()
    assert not agg.drain().verified


def test_checkpoints_cross_packages(lane_runs, tmp_path):
    """A port ck01 and a port ck02 with verify vectors load in the
    reference reader, and the JAX ck01 in the port, to equal vectors and
    drains; a file without the vectors loads as zeros."""
    expect = lane_runs["expect"]
    jagg, _ = lane_runs["jax"]
    agg, _ = lane_runs["port"]
    path = str(tmp_path / "agg.npz")
    agg.save_checkpoint(path)
    h = HostSnapshotAggregator(capacity=1 << 10)
    h.load_checkpoint(path)
    np.testing.assert_array_equal(np.trim_zeros(h.verify_verified, "b"),
                                  np.trim_zeros(agg.verify_verified, "b"))
    snap = h.drain()
    assert sum(snap.verified.values()) == expect["verified"]
    assert sum(snap.failed.values()) == expect["failed"]
    assert snap.verified == agg.drain().verified

    chain = str(tmp_path / "chain.npz")
    agg.configure_checkpointing(mode="ck02")
    agg.save_checkpoint(chain)
    h2 = HostSnapshotAggregator(capacity=1 << 10)
    h2.load_checkpoint(chain)
    assert h2.verify_counts() == agg.verify_counts()
    agg.configure_checkpointing(mode="ck01")

    jpath = str(tmp_path / "jax.npz")
    jagg.save_checkpoint(jpath)
    r = TorchAggregator(capacity=1 << 10, device="cpu")
    r.load_checkpoint(jpath)
    assert r.verify_counts() == jagg.verify_counts()
    assert r.drain().failed == jagg.drain().failed

    z = dict(np.load(path, allow_pickle=True))
    z.pop("verify_verified")
    z.pop("verify_failed")
    legacy = str(tmp_path / "legacy.npz")
    with open(legacy, "wb") as fh:
        np.savez_compressed(fh, **z)
    r2 = TorchAggregator(capacity=1 << 10, device="cpu")
    r2.load_checkpoint(legacy)
    assert not r2.verify_counts() and not r2.drain().verified


def test_issuer_meta_carries_verify_counts(lane_runs):
    from ct_mapreduce_tpu_torch.serve.server import MembershipOracle

    expect = lane_runs["expect"]
    agg, _ = lane_runs["port"]
    oracle = MembershipOracle(agg, replicas=1, device=False, cache_size=-1)
    try:
        iss_id = next(iter(agg.verify_counts()))
        meta = oracle.issuer_meta(iss_id)
        assert meta["verified"] == expect["verified"]
        assert meta["failed"] == expect["failed"]
    finally:
        oracle.close()


def test_storage_statistics_verify_totals(lane_runs, tmp_path):
    """The reference report and the port's print the same text for the
    port's checkpoint and for the JAX one, with the SCT tails."""
    from ct_mapreduce_tpu.cmd import storage_statistics as jstats
    from ct_mapreduce_tpu.config import CTConfig as JConfig
    from ct_mapreduce_tpu_torch.cmd import storage_statistics as tstats
    from ct_mapreduce_tpu_torch.config import CTConfig as TConfig

    expect = lane_runs["expect"]
    texts = []
    for name, agg in (("port", lane_runs["port"][0]),
                      ("jax", lane_runs["jax"][0])):
        path = str(tmp_path / f"{name}.npz")
        agg.save_checkpoint(path)
        for mod, cfg_cls in ((jstats, JConfig), (tstats, TConfig)):
            cfg = cfg_cls()
            cfg.backend = "tpu"
            cfg.agg_state_path = path
            out = io.StringIO()
            assert mod.report_from_tpu_snapshot(cfg, out) == 0
            texts.append(out.getvalue())
            report = mod.collect_tpu_report(cfg)
            assert report["totals"]["sctsVerified"] == expect["verified"]
            assert report["totals"]["sctsFailed"] == expect["failed"]
            json.dumps(report)
    assert len(set(texts)) == 1
    assert f"{expect['verified']} scts verified" in texts[0]
    assert f"{expect['failed']} scts failed" in texts[0]


def test_resolve_verify_env_layering(monkeypatch):
    for var in ("CTMR_VERIFY", "CTMR_VERIFY_KEYS", "CTMR_VERIFY_BATCH",
                "CTMR_VERIFY_PRECOMP_WINDOW", "CTMR_VERIFY_QTABLE_SIZE"):
        monkeypatch.delenv(var, raising=False)
    calls = [(), (True,), (False, "x.json", 64, 2, 3)]
    kwcalls = [{"flag": True, "window": 0}]

    def both():
        out = [tlane.resolve_verify(*a) for a in calls]
        out += [tlane.resolve_verify(**k) for k in kwcalls]
        assert out == [jlane.resolve_verify(*a) for a in calls] + [
            jlane.resolve_verify(**k) for k in kwcalls]
        return out

    assert both()[0] == (False, "", 1024, 8, 32)
    monkeypatch.setenv("CTMR_VERIFY", "1")
    monkeypatch.setenv("CTMR_VERIFY_KEYS", "/tmp/k.json")
    monkeypatch.setenv("CTMR_VERIFY_BATCH", "256")
    monkeypatch.setenv("CTMR_VERIFY_PRECOMP_WINDOW", "4")
    monkeypatch.setenv("CTMR_VERIFY_QTABLE_SIZE", "7")
    assert both()[0] == (True, "/tmp/k.json", 256, 4, 7)
    monkeypatch.setenv("CTMR_VERIFY_BATCH", "zap")
    out = both()
    assert out[2] == (False, "x.json", 64, 2, 3)
    assert out[1] == (True, "/tmp/k.json", 1024, 4, 7)
    assert out[3][3] == 0
    monkeypatch.setenv("CTMR_VERIFY_PRECOMP_WINDOW", "5")
    monkeypatch.setenv("CTMR_VERIFY_QTABLE_SIZE", "junk")
    assert both()[1][3:] == (8, 32)


def test_sink_loads_keys_from_file(tmp_path):
    """A key file the JAX package wrote builds the port sink's verifier,
    through ``build_sink`` from the directives as ct-fetch does."""
    from ct_mapreduce_tpu_torch.config import CTConfig

    reg = jlane.LogKeyRegistry()
    for s in ref_lane._signers():
        reg.register_signer(s)
    keys_path = tmp_path / "keys.json"
    keys_path.write_text(reg.to_json())
    ini = tmp_path / "ct.ini"
    ini.write_text(f"backend = tpu\ntableBits = 8\nverifySignatures = true\n"
                   f"verifyLogKeys = {keys_path}\nverifyPrecompWindow = 4\n"
                   f"verifyQTableSize = 5\n")
    sink, _model = tsync.build_sink(CTConfig.load(["-config", str(ini)],
                                                  env={}), device="cpu")
    v = sink.verifier
    assert isinstance(v, tlane.SignatureVerifier)
    assert len(v.keys) == 3 and v.keys.is_p256(ref_lane._signers()[0].log_id)
    assert (v.window, v.qtable_size, v.batch_width) == (4, 5, 1024)


def test_health_body_carries_the_verify_section():
    """ct-fetch's health body gains the lane's ``verify`` section (the
    JAX package has it on the metrics server's /healthz): knobs, totals,
    Q-table occupancy."""
    from ct_mapreduce_tpu_torch.ingest.health import HealthServer

    agg = TorchAggregator(capacity=1 << 10, device="cpu")
    v = tlane.SignatureVerifier(agg, batch_width=WIDTH, qtable_size=3)

    class Engine:
        def last_updates(self):
            return {}

    hs = HealthServer(Engine(), 1.0, addr="127.0.0.1:0",
                      verifier=v)
    code, body = hs.status()
    assert code == 503 and body["verify"] == {
        "window": 8, "stats": v.stats, "qtable": {}}
    assert "verify" not in HealthServer(Engine(), 1.0).status()[1]


def _submit(verifier, certs):
    data, length = ref_lane._sct_rows(certs)
    scts = tsct.extract_scts_np(data, length)
    verifier.submit_chunk(scts, np.zeros((len(certs),), np.int64),
                          np.ones((len(certs),), bool), data, length)


def test_qtable_lru_eviction_and_epoch_invalidation():
    ka, kb = tsct.EcSctSigner("qt-a"), tsct.EcSctSigner("qt-b")
    ca, cb = ref_lane._sct_cert(ka, 1), ref_lane._sct_cert(kb, 2)
    agg = TorchAggregator(capacity=1 << 12, batch_size=16, device="cpu")
    tight = tlane.SignatureVerifier(agg, batch_width=WIDTH, qtable_size=1)
    for s in (ka, kb):
        tight.keys.register_signer(s)
    _submit(tight, [ca, cb])
    tight.drain()
    st = tight.stats
    assert (st["qtable_misses"], st["qtable_hits"]) == (2, 0)
    _submit(tight, [ca])
    tight.drain()
    assert (st["qtable_misses"], st["qtable_hits"]) == (3, 0)
    assert tight.health()["qtable"]["p256"]["occupancy"] == 1
    assert st["verified"] == 3 and st["failed"] == 0

    roomy = tlane.SignatureVerifier(agg, batch_width=WIDTH, qtable_size=4)
    for s in (ka, kb):
        roomy.keys.register_signer(s)
    _submit(roomy, [ca, cb])
    _submit(roomy, [ca, cb])
    roomy.drain()
    st = roomy.stats
    assert (st["qtable_misses"], st["qtable_hits"]) == (2, 2)
    roomy.keys.register_signer(ka)
    _submit(roomy, [ca, cb])
    roomy.drain()
    assert (st["qtable_misses"], st["qtable_hits"]) == (3, 3)
    h = roomy.health()
    assert h["window"] == roomy.window > 0
    assert h["qtable"]["p256"] == {"capacity": 4, "occupancy": 3}
    assert h["stats"]["verified"] == st["verified"] == 6
    assert int(agg.verify_verified[0]) == 9 and not agg.verify_failed.any()


def test_p384_host_routing():
    """A lane keyed to a P-384 entry whose SCT is RSA-signed goes to the
    host verifier and fails closed."""
    rsa = tsct.RsaSctSigner()
    cert = ref_lane._sct_cert(rsa, 3)
    p384k = tsct.EcSctSigner("fb-384", host.P384)
    agg = TorchAggregator(capacity=1 << 12, batch_size=16, device="cpu")
    v = tlane.SignatureVerifier(agg, batch_width=WIDTH)
    v.keys.register({"log_id": rsa.log_id.hex(), "alg": "p384",
                     "x": hex(p384k.q[0]), "y": hex(p384k.q[1])})
    _submit(v, [cert])
    v.drain()
    st = v.stats
    assert st["host_lanes"] == 1 and st["device_lanes"] == 0
    assert st["p384_lanes"] == 0
    assert st["failed"] == 1 and st["verified"] == 0


def test_lane_window0_parity():
    """verifyPrecompWindow = 0 runs the Jacobian ladder: the same
    outcomes as the windowed default, and no tables."""
    ka = tsct.EcSctSigner("w0-a")
    certs = [ref_lane._sct_cert(ka, 10), ref_lane._sct_cert(ka, 11)]
    certs.append(tsct.attach_sct(
        ref_lane.minicert.make_cert(serial=12, issuer_cn="QT CA",
                                    subject_cn="qt12", is_ca=False,
                                    not_after=ref_lane.FUTURE),
        ka, 10**12, corrupt_signature=True))
    outcomes = []
    for window in (0, None):
        agg = TorchAggregator(capacity=1 << 12, batch_size=16, device="cpu")
        v = tlane.SignatureVerifier(agg, batch_width=WIDTH, window=window)
        v.keys.register_signer(ka)
        _submit(v, certs)
        v.drain()
        outcomes.append((v.stats["verified"], v.stats["failed"],
                         v.stats["device_lanes"], v.stats["qtable_misses"]))
        if window == 0:
            assert v._lanes["p256"].gtab is None
    assert outcomes == [(2, 1, 3, 0), (2, 1, 3, 1)]


@pytest.mark.parametrize("curve", ["p256", "p384"])
def test_k6_bound_counts_the_batch_inversions(curve):
    """K6's bound counts what the JAX package's ``_verify_windowed``
    needs: its two batch inversions cost 3 products a lane each and one
    Fermat chain a batch (``bigint.mont_inv``: a square an exponent bit,
    a product a set bit). K6 batch-inverts s and Z by the block (at
    window 0 too, where the count follows its batch form): a product
    tree over the block's lanes and a binary GCD at its root."""
    from ct_mapreduce_tpu_torch.ops import ecdsa_cuda

    _jc, c, ops = CURVES[curve]
    jmods = ((jbig.P256_N, jbig.P256_P) if curve == "p256"
             else (jbig.P384_N, jbig.P384_P))
    chains = tuple(len(m.exp_inv_bits) + int(np.sum(m.exp_inv_bits))
                   for m in jmods)
    assert ecdsa_cuda.chain_products(ops) == chains
    assert ecdsa_cuda.batch_products_needed(ops) == sum(chains)
    rng = random.Random(7)
    for _ in range(8):
        u1, u2 = rng.randrange(c.n), rng.randrange(c.n)
        for w in (2, 4, 8):
            # Z's share (3) and x = X / Z, to the plain domain (2).
            assert (ecdsa_cuda.products(ops, w, True, u1, u2)
                    - ecdsa_cuda.products(ops, w, True, u1, u2, True)
                    == 3 + 2)
        # Window 0: Z's share (3), zinv^2, X zinv^2 and to plain (3).
        assert (ecdsa_cuda.products(ops, 0, True, u1, u2)
                - ecdsa_cuda.products(ops, 0, True, u1, u2, True) == 3 + 3)
    assert ecdsa_cuda.products(ops, 8, False) == 5
    for w in (8, 0):
        b = ecdsa_cuda.block_lanes(w)
        live = np.zeros(3 * b + 1, bool)  # four blocks, the last one lane
        live[[0, 5, 2 * b + 3, 3 * b]] = True  # block 1 has no live lane
        live_z = live.copy()
        live_z[3 * b] = False
        # A product tree over every lane of a block with a live lane: 3 b
        # - 1 products, less the live lanes' shares.
        assert ecdsa_cuda.block_products(ops, w, live, live_z) == (
            5 * (3 * b - 1) - 3 * 4 - 3 * 3)
        assert ecdsa_cuda.block_gcds(w, live, live_z) == 5


# -- a model of K6's schedule ---------------------------------------------


def _block_inverse(vals, live, m, block):
    """K6's block batch inversion: a product tree over ``block`` leaves
    (the live values, 1 for every other lane and past the end), the
    root inverted once, the inverses down the tree; a lane that is not
    live gets 0."""
    leaves = [v if lv else 1 for v, lv in zip(vals, live)]
    tree = [0] * block + leaves + [1] * (block - len(leaves))
    for k in range(block - 1, 0, -1):
        tree[k] = tree[2 * k] * tree[2 * k + 1] % m
    tree[1] = pow(tree[1], -1, m)
    for k in range(1, block):
        inv = tree[k]
        tree[2 * k], tree[2 * k + 1] = (inv * tree[2 * k + 1] % m,
                                        inv * tree[2 * k] % m)
    return [tree[block + j] if lv else 0 for j, lv in enumerate(live)]


def _madd_complete(c, X, Y, Z, x2, y2):
    """Renes-Costello-Batina 2015 Alg. 5 (a = -3) in K6's order."""
    p, b = c.p, c.b
    t0, t1 = X * x2 % p, Y * y2 % p
    t3 = ((x2 + y2) * (X + Y) - t0 - t1) % p
    t4, ty = (y2 * Z + Y) % p, (x2 * Z + X) % p
    x3 = 3 * (ty - b * Z) % p
    z3t, x3t = (t1 - x3) % p, (t1 + x3) % p
    y3 = 3 * (b * ty - 3 * Z - t0) % p
    t0n = (3 * t0 - 3 * Z) % p
    return ((t3 * x3t - t4 * y3) % p, (x3t * z3t + t0n * y3) % p,
            (t4 * z3t + t3 * t0n) % p)


@functools.lru_cache(maxsize=None)
def _window_table(c, P, w):
    """Entry [j][d] = d * 2^(w j) * P, affine (None for d = 0)."""
    tab = []
    for _ in range(c.n.bit_length() // w + 1):
        row, acc = [None], None
        for _ in range(1, 1 << w):
            acc = host._point_add(c, acc, P)
            row.append(acc)
        tab.append(row)
        P = host._point_add(c, acc, P)  # 2^w * P
    return tab


def _k6_model(c, lanes, valid, key_idx, keys, window=4, block=16):
    """K6's schedule in Python ints, block by block: the input checks, s
    by block batch inversion with its masks, u1 and u2, the windowed
    ladder of complete mixed additions from the identity (0 : 1 : 0)
    (Q from the lane's key slot), Z by block batch inversion (a result
    at infinity is not live), x mod n == r."""
    p, n = c.p, c.n
    lim = 1 << (8 * c.byte_len)
    g_tab = _window_table(c, (c.gx, c.gy), window)
    q_tabs = {}
    nwin = 8 * c.byte_len // window
    verdicts = []
    for b0 in range(0, len(lanes), block):
        chunk = [(i, lanes[i]) for i in range(b0, min(len(lanes), b0 + block))]
        ok, s_vals = [], []
        for i, (_k, dg, r, s, x, y) in chunk:
            r, s, x, y = r % lim, s % lim, x % lim, y % lim
            good = (bool(valid[i]) and 0 < r < n and 0 < s < n and x < p
                    and y < p and bool(x or y)
                    and (y * y - x * x * x + 3 * x - c.b) % p == 0)
            ok.append(good)
            s_vals.append(s)
        w = _block_inverse(s_vals, ok, n, block)
        pts = []
        for (i, (_k, dg, r, s, x, y)), good, wi in zip(chunk, ok, w):
            X, Y, Z = 0, 1, 0
            if good:
                z = host.digest_to_z(c, dg) % n
                u1, u2 = z * wi % n, (r % lim) * wi % n
                slot = min(max(int(key_idx[i]), 0), len(keys) - 1)
                if slot not in q_tabs:
                    q_tabs[slot] = _window_table(c, tuple(keys[slot]),
                                                 window)
                for j in range(nwin):
                    for u, tab in ((u1, g_tab), (u2, q_tabs[slot])):
                        d = (u >> (window * j)) & ((1 << window) - 1)
                        if d:
                            X, Y, Z = _madd_complete(c, X, Y, Z, *tab[j][d])
            pts.append((X, Z))
        live = [good and Z != 0 for good, (_X, Z) in zip(ok, pts)]
        zi = _block_inverse([Z for _X, Z in pts], live, p, block)
        for (i, ln), lv, (X, _Z), zinv in zip(chunk, live, pts, zi):
            verdicts.append(lv and X * zinv % p % n == ln[2] % lim)
    return verdicts


@pytest.mark.parametrize("curve", ["p256", "p384"])
def test_k6_schedule_model_matches_host(curve):
    """K6's order of operations (block batch inversions over a product
    tree with masked leaves, the windowed complete-addition ladder) in
    Python ints, held to verify_ecdsa on chip_smoke.py's edge lanes (a
    block of failed checks, one good lane among bad ones, results at
    infinity, u1 G = u2 Q) and on 64 lanes of its phase 13 corpus; and a
    bad lane never moves a neighbour: the good lanes' verdicts are the
    same with every other lane made padding. Blocks of 16 lanes keep it
    cheap; the schedule is the same at any power of two."""
    import chip_smoke

    c = CURVES[curve][1]
    lim = 1 << (8 * c.byte_len)
    for corpus in (chip_smoke.k6_edge_corpus(c, 3, block=16),
                   chip_smoke.k6_corpus(c, 64, 5)):
        _rows, valid, key_idx, keys, lanes = corpus
        truth = [bool(v) and host.verify_ecdsa(c, dg, r % lim, s % lim,
                                               x % lim, y % lim)
                 for v, (_k, dg, r, s, x, y) in zip(valid, lanes)]
        got = _k6_model(c, lanes, valid, key_idx, keys, block=16)
        assert got == truth
        assert 0 < sum(truth) < len(truth)
        kinds = np.array([ln[0] for ln in lanes])
        alone = _k6_model(c, lanes, valid & (kinds == 0), key_idx, keys,
                          block=16)
        assert [a for a, k in zip(alone, kinds) if k == 0] == [
            t for t, k in zip(truth, kinds) if k == 0]


def test_grow_verify_totals_matches_jax():
    agg = TorchAggregator(capacity=1 << 10, device="cpu")
    jagg = TpuAggregator(capacity=1 << 10, batch_size=16)
    n0 = agg.verify_verified.shape[0]
    assert n0 == jagg.verify_verified.shape[0]
    for a in (agg, jagg):
        a.verify_failed[3] = 7
        a.grow_verify_totals(n0 + 5)
    assert agg.verify_verified.shape == jagg.verify_verified.shape
    assert agg.verify_failed[3] == 7 and agg.verify_failed.dtype == np.int64


def test_lane_leaves_the_dedup_side_as_jax(lane_runs):
    """The lane changes nothing on the dedup side: the port's sink with
    the lane drains as the JAX sink without it."""
    lis, eds = ref_lane._wire(lane_runs["pairs"])
    jagg = TpuAggregator(capacity=1 << 12, batch_size=16)
    jsink = jsync.AggregatorSink(jagg, flush_size=16, device_queue_depth=0)
    jsink.store_raw_batch(jsync.RawBatch(lis, eds, 0, "v-log"))
    jsink.flush()
    snap, jsnap = lane_runs["port"][0].drain(), jagg.drain()
    assert (snap.counts, snap.crls, snap.dns, snap.total) == (
        jsnap.counts, jsnap.crls, jsnap.dns, jsnap.total)
    assert snap.verified and not jsnap.verified
