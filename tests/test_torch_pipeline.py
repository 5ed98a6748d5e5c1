"""The port's walker step (``ops/pipeline.py``: ``local_lanes`` and
``ingest_core``) against the JAX package's, on the CPU.

Three steps over one table share seeded rows: leaves of several issuers
with replays, an expired leaf, a CA certificate, a leaf expiring in the
current hour (boundary hour), an issuer CN of 70 bytes filtered by a
64-byte prefix (past the 61-byte device window: undecidable, host
lane), a prefix of exactly 61 bytes, issuer indices out of range
(negative and past ``num_issuers``), invalid lanes, byte-flipped rows
the walker rejects, and a two-bucket table with one hop, so lanes
overflow their probe chains. ``StepOut``, ``LocalLanes``, table rows
and counts must be equal. Tolerance: exact equality.
"""

import datetime

import numpy as np
import pytest
import torch

from ct_mapreduce_tpu.ops import buckettable as jbt
from ct_mapreduce_tpu.ops import pipeline as jpipeline
from ct_mapreduce_tpu_torch.core import der, packing
from ct_mapreduce_tpu_torch.ops import buckettable as tbt
from ct_mapreduce_tpu_torch.ops import pipeline as tpipeline
from ct_mapreduce_tpu_torch.utils import dercases, syncerts

UTC = datetime.timezone.utc
NOW = datetime.datetime(2025, 1, 1, 12, tzinfo=UTC)
NOW_HOUR = int(NOW.timestamp()) // 3600
BASE_HOUR = packing.DEFAULT_BASE_HOUR
B = 128
N_ISSUERS = 6
LONG_CN = "Pipeline Long CA " + "z" * 53  # 70 bytes
PREFIXES = ("Pipeline Issuer 1", "Pipeline Issuer 3", LONG_CN[:64],
            ("Pipeline Issuer 2" + "q" * 61)[:61])
CAPACITY = 24 * 2


def _templates():
    def tpl(cn, slen, key="ec", **delta):
        return syncerts.make_template(
            issuer_cn=cn, not_after=NOW + datetime.timedelta(**delta),
            serial_len=slen, key_type=key, rich_extensions=slen % 2 == 0)

    t = [tpl(f"Pipeline Issuer {i}", 8 + 3 * i, "rsa2048" if i % 2 else "ec",
             days=100 + 40 * i) for i in range(4)]
    t += [tpl(LONG_CN, 10, days=300),
          tpl("Pipeline Issuer 1", 9, days=-3),  # expired
          tpl("Pipeline Issuer 3", 11, minutes=20),  # boundary hour
          tpl(("Pipeline Issuer 2" + "q" * 61)[:61], 12, days=50)]
    ca = der.parse_cert(t[1].issuer_der)
    t.append(syncerts.CertTemplate(t[1].issuer_der, t[1].issuer_der,
                                   ca.serial_off, ca.serial_len))
    return t


def _steps():
    """Three steps of B lanes: (data, length, issuer_idx, valid)."""
    tpls = _templates()
    rng = np.random.default_rng(2026)
    out, pool = [], []
    counter = 1
    for step in range(3):
        tof = rng.integers(0, len(tpls), B)
        ctr = np.zeros(B, np.int64)
        for i in range(B):
            if pool and rng.random() < 0.3:
                tof[i], ctr[i] = pool[rng.integers(len(pool))]
            else:
                ctr[i], counter = counter, counter + 1
                pool.append((tof[i], ctr[i]))
        pairs = [(syncerts.stamp_serial(tpls[t], int(c)), None)
                 for t, c in zip(tof, ctr)]
        data, length = dercases.pack(pairs, 2048)
        flip = rng.random(B) < 0.08
        data[flip, rng.integers(0, 200, B)[flip]] ^= 0x5A
        issuer = (tof % 8).astype(np.int32)
        issuer[rng.random(B) < 0.05] = -1
        issuer[rng.random(B) < 0.05] = N_ISSUERS + 2
        valid = rng.random(B) > 0.04
        out.append((data, length, issuer, valid))
    return out


def _prefix_arrays():
    enc = [p.encode() for p in PREFIXES]
    k = min(61, max(len(e) for e in enc))
    arr = np.zeros((len(enc), k), np.uint8)
    lens = np.zeros((len(enc), 2), np.int32)
    for i, e in enumerate(enc):
        arr[i, : min(len(e), k)] = np.frombuffer(e[:k], np.uint8)
        lens[i] = (min(len(e), k), len(e))
    return arr, lens


def _np(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.int32 and x.ndim == 2 and \
        x.shape[1] == 4 else x


@pytest.fixture(scope="module")
def steps():
    return _steps()


def test_local_lanes_match_jax(steps):
    import jax

    arr, lens = _prefix_arrays()
    data, length, issuer, valid = steps[0]
    want = jax.jit(jpipeline.local_lanes, static_argnames="num_issuers")(
        data, length, issuer, valid, np.int32(NOW_HOUR), np.int32(BASE_HOUR),
        arr, lens, num_issuers=N_ISSUERS)
    got = tpipeline.local_lanes(
        *(torch.from_numpy(a) for a in (data, length, issuer, valid)),
        NOW_HOUR, BASE_HOUR, torch.from_numpy(arr), torch.from_numpy(lens),
        N_ISSUERS)
    for f in jpipeline.LocalLanes._fields:
        if f == "parsed":
            for g in want.parsed._fields:
                np.testing.assert_array_equal(
                    _np(getattr(got.parsed, g)), np.asarray(getattr(want.parsed, g)),
                    err_msg=g)
        elif f == "meta":
            np.testing.assert_array_equal(got.meta.numpy().view(np.uint32),
                                          np.asarray(want.meta), err_msg=f)
        else:
            np.testing.assert_array_equal(_np(getattr(got, f)),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
    ok = np.asarray(want.parsed.ok) & valid
    passed = np.asarray(want.passed)
    # The rows reach every route: each filter, an undecidable CN (passed
    # but not device-exact), the boundary hour, out-of-range issuers.
    assert np.asarray(want.filtered_cn).any() and np.asarray(want.filtered_ca).any()
    assert np.asarray(want.filtered_expired).any() and (~ok & valid).any()
    assert (passed & ~np.asarray(want.device_exact)).sum() > 3
    assert (np.asarray(want.parsed.not_after_hour) == NOW_HOUR).any()


def test_ingest_core_matches_jax(steps):
    arr, lens = _prefix_arrays()
    jt = jbt.make_table(CAPACITY)
    tt = tbt.make_table(CAPACITY, device="cpu")
    overflowed = 0
    for data, length, issuer, valid in steps:
        jt, want = jpipeline.ingest_step(
            jt, data, length, issuer, valid, np.int32(NOW_HOUR),
            np.int32(BASE_HOUR), arr, lens, num_issuers=N_ISSUERS,
            max_probes=1)
        tt, got = tpipeline.ingest_core(
            tt, *(torch.from_numpy(a) for a in (data, length, issuer, valid)),
            NOW_HOUR, BASE_HOUR, torch.from_numpy(arr),
            torch.from_numpy(lens), num_issuers=N_ISSUERS, max_probes=1)
        for f in jpipeline.StepOut._fields:
            np.testing.assert_array_equal(_np(getattr(got, f)),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(tbt.host_rows(tt), np.asarray(jt.rows))
        assert int(tt.count) == int(np.asarray(jt.count))
        overflowed += int(np.asarray(want.probe_overflow).sum())
        assert np.asarray(want.was_unknown).any()
    assert overflowed > 0


def test_pack_lane_words_matches_jax(steps):
    import jax

    arr, lens = _prefix_arrays()
    jt = jbt.make_table(CAPACITY)
    tt = tbt.make_table(CAPACITY, device="cpu")
    seen_flags = 0
    for data, length, issuer, valid in steps:
        jt, want = jpipeline.ingest_step(
            jt, data, length, issuer, valid, np.int32(NOW_HOUR),
            np.int32(BASE_HOUR), arr, lens, num_issuers=N_ISSUERS,
            max_probes=1)
        tt, got = tpipeline.ingest_core(
            tt, *(torch.from_numpy(a) for a in (data, length, issuer, valid)),
            NOW_HOUR, BASE_HOUR, torch.from_numpy(arr),
            torch.from_numpy(lens), num_issuers=N_ISSUERS, max_probes=1)
        want_words = np.asarray(jax.jit(jpipeline.pack_lane_words)(want))
        got_words = tpipeline.pack_lane_words(got)
        assert got_words.dtype == torch.int32 and got_words.shape == (7, B)
        np.testing.assert_array_equal(got_words.numpy(), want_words)
        seen_flags |= int(np.bitwise_or.reduce(want_words[0]))
    # Every flag bit the layout defines is set on some lane.
    assert seen_flags == 0x3F


def test_staged_core_matches_jax(steps):
    """The three steps as one K=3 envelope: packed words, serials, the
    summed counts and the table equal the JAX envelope's, and equal the
    port's three unstaged steps."""
    arr, lens = _prefix_arrays()
    data, length, issuer, valid = (np.stack([s[i] for s in steps])
                                   for i in range(4))
    jt, want = jpipeline.ingest_step_staged(
        jbt.make_table(CAPACITY), data, length, issuer, valid,
        np.int32(NOW_HOUR), np.int32(BASE_HOUR), arr, lens,
        num_issuers=N_ISSUERS, max_probes=1)
    tt, got = tpipeline.staged_core(
        tbt.make_table(CAPACITY, device="cpu"),
        *(torch.from_numpy(a) for a in (data, length, issuer, valid)),
        NOW_HOUR, BASE_HOUR, torch.from_numpy(arr), torch.from_numpy(lens),
        num_issuers=N_ISSUERS, max_probes=1)
    for f in jpipeline.StagedStepOut._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tbt.host_rows(tt), np.asarray(jt.rows))
    assert int(tt.count) == int(np.asarray(jt.count))

    ut = tbt.make_table(CAPACITY, device="cpu")
    for k in range(3):
        ut, out = tpipeline.ingest_core(
            ut, *(torch.from_numpy(a[k]) for a in (data, length, issuer,
                                                   valid)),
            NOW_HOUR, BASE_HOUR, torch.from_numpy(arr),
            torch.from_numpy(lens), num_issuers=N_ISSUERS, max_probes=1)
        assert torch.equal(tpipeline.pack_lane_words(out), got.packed[k])
    assert torch.equal(ut.rows, tt.rows)
