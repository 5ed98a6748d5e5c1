"""The port's checkpoints (``agg/ckpt.py`` and the aggregator's save and
load family) against the JAX package's, on the CPU.

Two halves:

- Cross-loading: the same certificate entries (two issuers with CRL
  distribution points, replays, an oversized serial that takes the
  exact host lane) through ``TpuAggregator`` and
  ``TorchAggregator(device="cpu")``; ck01 files and ck02 chains written
  by either package load in the other and drain the same, with equal
  ``ckpt_state_digest``; both packages then continue from a loaded
  checkpoint to equal drains; the segment codec and the segments
  written for the same churn are equal, tokens aside.
- The cases of ``tests/test_ckpt.py`` run on the port: an empty tick,
  compaction, a stale manifest, a broken chain, a moved disk tip, the
  three poisons, ``merge.load_checkpoints`` over chains, the refused
  formats, and the kill points before a rename; beside them a snapshot
  of another shard count (re-hashed), saves racing an ingesting
  thread, and the knob ladder of both packages.

Tolerance: exact equality everywhere.
"""

import datetime
import inspect
import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ct_mapreduce_tpu.agg import ckpt as jckpt
from ct_mapreduce_tpu.agg.aggregator import (
    HostSnapshotAggregator,
    TpuAggregator,
)
from ct_mapreduce_tpu.tune import harness as jharness
from ct_mapreduce_tpu_torch.agg import ckpt, merge
from ct_mapreduce_tpu_torch.agg.aggregator import (
    TorchAggregator,
    ckpt_state_digest,
)
from ct_mapreduce_tpu_torch.utils import minicert

UTC = datetime.timezone.utc
NOW = datetime.datetime(2025, 1, 1, tzinfo=UTC)
CAP = 1 << 10
BATCH = 64
ISSUERS = [minicert.make_cert(serial=1, issuer_cn=f"Ck CA {k}", is_ca=True)
           for k in range(2)]
ENTRIES = 400  # the harness corpus (tests/test_ckpt.py's sizes)
BITS = 12


def _entries(start: int, n: int):
    """n leaves alternating two issuers, every fifth one a replay of an
    earlier serial, plus one serial too long for the device (host lane)."""
    out = []
    for j in range(n):
        k = j % 2
        serial = start + (j - 5 if j % 5 == 4 else j)
        out.append((minicert.make_cert(
            serial=serial, issuer_cn=f"Ck CA {k}", subject_cn="ck.example",
            crl_dps=(f"http://crl{k}.example/ca.crl",)), ISSUERS[k]))
    out.append((minicert.make_cert(
        serial=start | (1 << 400), issuer_cn="Ck CA 0", serial_len=None,
        subject_cn="ck.example"), ISSUERS[0]))
    return out


def _jax_agg():
    return TpuAggregator(capacity=CAP, batch_size=BATCH, now=NOW)


def _port_agg():
    return TorchAggregator(capacity=CAP, batch_size=BATCH, now=NOW,
                           device="cpu")


def _same_drain(a, b):
    sa, sb = a.drain(), b.drain()
    assert sa.counts == sb.counts
    assert sa.crls == sb.crls and sa.dns == sb.dns
    assert sa.total == sb.total and sa.total > 0
    assert sa.verified == sb.verified and sa.failed == sb.failed


def _port_build(entries: int, table_bits: int):
    """The port's counterpart of ``tune.harness.build_aggregator``: a
    table pre-filled with synthetic serials through the bulk reinsert."""
    import numpy as np

    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.core import packing

    agg = TorchAggregator(capacity=1 << table_bits, batch_size=4096,
                          grow_at=0.0, device="cpu")
    eh = agg.base_hour + 1000
    serials = np.zeros((entries, packing.MAX_SERIAL_BYTES), np.uint8)
    counters = np.arange(entries, dtype=np.uint64)
    for i in range(8):
        serials[:, 15 - i] = ((counters >> np.uint64(8 * i))
                              & np.uint64(0xFF)).astype(np.uint8)
    keys = packing.fingerprints_np(
        np.zeros((entries,), np.int64), np.full((entries,), eh, np.int64),
        serials, np.full((entries,), 16, np.int64))
    # Issuer 0 at hour offset eh - base_hour (the meta word).
    meta = np.full((entries,), eh - agg.base_hour, np.uint32)
    assert agg._bulk_reinsert(keys, meta) == 0
    agg._table_fill = entries
    agg._device_written = True
    return agg, eh


def _port_churn(agg, eh: int, n: int, start: int) -> None:
    """The port's counterpart of ``tune.harness.ckpt_churn``: n fresh
    synthetic serials through the pre-parsed lane (which dirty-logs)."""
    import numpy as np

    from ct_mapreduce_tpu_torch.core import packing
    from ct_mapreduce_tpu_torch.native.leafpack import Sidecar

    s = packing.MAX_SERIAL_BYTES
    serials = np.zeros((n, s), np.uint8)
    counters = np.arange(start, start + n, dtype=np.uint64)
    for i in range(8):
        serials[:, 15 - i] = ((counters >> np.uint64(8 * i))
                              & np.uint64(0xFF)).astype(np.uint8)
    zeros = np.zeros((n,), np.int32)
    nah = max(int(eh), agg._now_hour() + 1000)
    sc = Sidecar(
        ok=np.ones((n,), np.uint8), serial_off=zeros,
        serial_len=np.full((n,), 16, np.int32),
        not_after_hour=np.full((n,), nah, np.int32),
        is_ca=np.zeros((n,), np.uint8), has_crldp=np.zeros((n,), np.uint8),
        cn_off=zeros, cn_len=zeros, issuer_off=zeros, issuer_len=zeros,
        spki_off=zeros, spki_len=zeros, crldp_off=zeros, crldp_len=zeros)
    res = agg.ingest_preparsed(sc, np.zeros((n,), np.int32),
                               np.ones((n,), bool), serials,
                               np.full((n,), s, np.int32))
    assert int(res.was_unknown.sum()) == n


def _mk(tmp_path, mode="ck02", max_chain=0):
    agg, eh = _port_build(ENTRIES, BITS)
    agg.configure_checkpointing(mode=mode, max_chain=max_chain)
    return agg, eh, str(tmp_path / "agg.npz")


def _reader(path):
    r = TorchAggregator(capacity=1 << BITS, device="cpu")
    r.load_checkpoint(path)
    return r


# -- the segment codec ----------------------------------------------------


def test_segment_codec_equal_across_packages():
    dev = [(0, 401000, b"\x00" * 8 + b"\x01" * 8), (2, 401007, b"ab")]
    host = [(1, 401001, b"longserial" * 4)]
    blob = {"baseHour": 400000, "countAfter": 7, "crlAdds": [[1, ["u"]]]}
    data, header = ckpt.encode_segment(3, "f" * 64, dev, host, blob)
    jdata, jheader = jckpt.encode_segment(3, "f" * 64, dev, host, blob)
    assert data == jdata and header == jheader
    assert ckpt.decode_segment(data) == jckpt.decode_segment(data)
    assert ckpt.decode_segment(data) == (header, dev, host, blob)

    flipped = bytearray(data)
    flipped[-1] ^= 0xFF
    bad = [bytes(flipped), b"NOTCK02!" + data[8:]]
    bad += [data[:cut] for cut in (4, 11, len(data) // 2, len(data) - 1)]
    for raw in bad:
        with pytest.raises(jckpt.CkptError):
            jckpt.decode_segment(raw)
        with pytest.raises(ckpt.CkptError):
            ckpt.decode_segment(raw)
    assert (ckpt.MAGIC, ckpt.FORMAT, ckpt.REC.format, ckpt.KILL_ENV) == (
        jckpt.MAGIC, jckpt.FORMAT, jckpt.REC.format, jckpt.KILL_ENV)


# -- cross-loading --------------------------------------------------------


@pytest.fixture(scope="module")
def writers(tmp_path_factory):
    """The JAX package and the port after the same three ingests, each
    saving a ck02 base + 2 segments across them and then a ck01 file of
    the final state."""
    d = tmp_path_factory.mktemp("ckx")
    out = {}
    for name, agg in (("jax", _jax_agg()), ("port", _port_agg())):
        agg.configure_checkpointing(mode="ck02")
        chain = str(d / f"{name}-chain.npz")
        for t in range(3):
            agg.ingest(_entries(1000 * (t + 1), 30))
            agg.save_checkpoint(chain)
        agg.configure_checkpointing(mode="ck01")
        full = str(d / f"{name}-full.npz")
        agg.save_checkpoint(full)
        out[name] = {"agg": agg, "chain": chain, "full": full}
    return out


def test_port_ck01_loads_in_jax(writers):
    jw, pw = writers["jax"], writers["port"]
    want = jharness.ckpt_state_digest(jw["agg"])
    assert ckpt_state_digest(pw["agg"]) == want
    r = HostSnapshotAggregator(capacity=CAP)
    r.load_checkpoint(pw["full"])
    _same_drain(r, jw["agg"])
    assert jharness.ckpt_state_digest(r) == want
    assert r.host_serials == jw["agg"].host_serials and r.host_serials


def test_npz_fields_match_jax(writers):
    """Field names, dtypes and shapes of the two ck01 files are the
    same, and so is every field's content."""
    with np.load(writers["jax"]["full"], allow_pickle=True) as zj, \
            np.load(writers["port"]["full"], allow_pickle=True) as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for f in zj.files:
            assert zj[f].dtype == zp[f].dtype and zj[f].shape == zp[f].shape, f
            np.testing.assert_array_equal(zp[f], zj[f], err_msg=f)


def test_port_ck02_chain_loads_in_jax(writers):
    pw = writers["port"]
    assert len(ckpt.resolve_chain(pw["chain"]).segments) == 2
    assert len(jckpt.resolve_chain(pw["chain"]).segments) == 2
    r = HostSnapshotAggregator(capacity=CAP)
    r.load_checkpoint(pw["chain"])
    _same_drain(r, pw["agg"])
    assert jharness.ckpt_state_digest(r) == ckpt_state_digest(pw["agg"])


def test_jax_checkpoints_load_in_port_and_resume(writers):
    """A JAX ck01 file and a JAX ck02 chain load in the port and drain as
    the JAX writer; then the port and a JAX aggregator loaded from the
    same chain take the same new entries to equal drains."""
    jw = writers["jax"]
    for path in (jw["full"], jw["chain"]):
        r = _port_agg()
        r.load_checkpoint(path)
        _same_drain(r, jw["agg"])
        assert ckpt_state_digest(r) == jharness.ckpt_state_digest(jw["agg"])
    assert len(jckpt.resolve_chain(jw["chain"]).segments) == 2
    more = _entries(5000, 30) + _entries(1000, 10)  # fresh and replayed
    jr = _jax_agg()
    jr.load_checkpoint(jw["chain"])
    pr = _port_agg()
    pr.load_checkpoint(jw["chain"])
    jr.ingest(more)
    pr.ingest(more)
    _same_drain(jr, pr)
    assert jr.metrics == pr.metrics


def test_segments_equal_across_packages(writers):
    """The same churn gives the same segment records and blob in both
    packages; only the hash chain (which starts at the base file's
    bytes) differs."""
    jp, pp = writers["jax"]["chain"], writers["port"]["chain"]
    for seq in (1, 2):
        with open(ckpt.segment_path(jp, seq), "rb") as f:
            jh, jdev, jhost, jblob = jckpt.decode_segment(f.read())
        with open(ckpt.segment_path(pp, seq), "rb") as f:
            ph, pdev, phost, pblob = ckpt.decode_segment(f.read())
        assert pdev == jdev and len(pdev) > 0
        assert phost == jhost and len(phost) > 0
        assert pblob == jblob
        chained = ("baseSha256", "payloadSha256", "targetSha256")
        assert ({k: v for k, v in ph.items() if k not in chained}
                == {k: v for k, v in jh.items() if k not in chained})


def test_refused_formats(tmp_path, writers, monkeypatch):
    """Formats once refused now load: an open-layout table (item 8), in
    its own layout, and a filter capture (item 10), to the writer's
    digest, capture and content hashes included."""
    monkeypatch.setenv("CTMR_TABLE", "open")
    opened = HostSnapshotAggregator(capacity=CAP)
    opened.configure_checkpointing(mode="ck01")
    open_path = str(tmp_path / "open.npz")
    opened.save_checkpoint(open_path)
    monkeypatch.delenv("CTMR_TABLE")
    r = _port_agg()
    r.load_checkpoint(open_path)
    assert r.table.rows.shape == (CAP, 5)
    assert ckpt_state_digest(r) == jharness.ckpt_state_digest(opened)
    captured = HostSnapshotAggregator(capacity=CAP)
    captured.enable_filter_capture()
    captured.configure_checkpointing(mode="ck01")
    cap_path = str(tmp_path / "capture.npz")
    captured.save_checkpoint(cap_path)
    r = _port_agg()
    r.load_checkpoint(cap_path)
    assert r.filter_capture == captured.filter_capture == {}
    assert r.capture_content_hashes() == {}
    assert ckpt_state_digest(r) == jharness.ckpt_state_digest(captured)


# -- tests/test_ckpt.py on the port --------------------------------------


def test_chain_restore_matches_ck01_oracle(tmp_path):
    agg, eh, path = _mk(tmp_path)
    agg.save_checkpoint(path)
    _port_churn(agg, eh, 37, ENTRIES)
    agg.save_checkpoint(path)
    _port_churn(agg, eh, 23, ENTRIES + 1000)
    agg.save_checkpoint(path)
    want = ckpt_state_digest(agg)
    chain = ckpt.resolve_chain(path)
    assert [s[0]["devRows"] for s in chain.segments] == [37, 23]
    oracle = str(tmp_path / "oracle.npz")
    agg.configure_checkpointing(mode="ck01")
    agg.save_checkpoint(oracle)
    assert not os.path.exists(ckpt.manifest_path(oracle))
    for src in (path, oracle):
        assert ckpt_state_digest(_reader(src)) == want

    # A restored writer extends the chain instead of anchoring.
    r = _reader(path)
    r.configure_checkpointing(mode="ck02")
    _port_churn(r, eh, 13, ENTRIES + 2000)
    r.save_checkpoint(path)
    chain = ckpt.resolve_chain(path)
    assert [s[0]["seq"] for s in chain.segments] == [1, 2, 3]
    assert ckpt_state_digest(_reader(path)) == ckpt_state_digest(r)


def test_empty_tick_writes_no_segment(tmp_path):
    agg, eh, path = _mk(tmp_path)
    agg.save_checkpoint(path)
    agg.save_checkpoint(path)
    assert len(ckpt.resolve_chain(path).segments) == 0
    assert not os.path.exists(ckpt.segment_path(path, 1))


def test_compaction_bounds_chain(tmp_path):
    agg, eh, path = _mk(tmp_path, max_chain=2)
    agg.save_checkpoint(path)
    lengths = []
    for t in range(5):
        _port_churn(agg, eh, 5, ENTRIES + 100 * t)
        agg.save_checkpoint(path)
        lengths.append(len(ckpt.resolve_chain(path).segments))
    # Ticks 1, 2 extend; tick 3 anchors (chain at maxChain); 4, 5 extend.
    assert lengths == [1, 2, 0, 1, 2]
    assert ckpt_state_digest(_reader(path)) == ckpt_state_digest(agg)


def test_stale_manifest_heals_to_base_alone(tmp_path):
    agg, eh, path = _mk(tmp_path)
    agg.save_checkpoint(path)
    want_base = ckpt_state_digest(agg)
    _port_churn(agg, eh, 9, ENTRIES)
    agg.save_checkpoint(path)
    # A base changed under its manifest (a compaction that died between
    # the base rename and the manifest rename): the base loads alone.
    with open(path, "ab") as fh:
        fh.write(b"\x00")
    assert len(ckpt.resolve_chain(path).segments) == 0
    assert ckpt_state_digest(_reader(path)) == want_base


def test_broken_listed_chain_raises(tmp_path):
    agg, eh, path = _mk(tmp_path)
    agg.save_checkpoint(path)
    _port_churn(agg, eh, 9, ENTRIES)
    agg.save_checkpoint(path)
    seg = ckpt.segment_path(path, 1)
    with open(seg, "rb") as f:
        raw = f.read()
    bad = bytearray(raw)
    bad[-1] ^= 0xFF
    with open(seg, "wb") as f:
        f.write(bytes(bad))
    with pytest.raises(ckpt.CkptError):
        ckpt.resolve_chain(path)
    with pytest.raises(ckpt.CkptError):
        _reader(path)
    os.unlink(seg)
    with pytest.raises(ckpt.CkptError):
        ckpt.resolve_chain(path)
    with open(seg, "wb") as f:
        f.write(raw)
    assert len(ckpt.resolve_chain(path).segments) == 1


def test_disk_tip_mismatch_forces_anchor(tmp_path):
    agg, eh, path = _mk(tmp_path)
    agg.save_checkpoint(path)
    _port_churn(agg, eh, 9, ENTRIES)
    agg.save_checkpoint(path)
    man = ckpt.read_manifest(path)
    man["chain"] = []  # roll the manifest back
    ckpt.write_manifest(path, man)
    _port_churn(agg, eh, 9, ENTRIES + 500)
    agg.save_checkpoint(path)  # must anchor, not extend
    assert len(ckpt.resolve_chain(path).segments) == 0
    assert ckpt_state_digest(_reader(path)) == ckpt_state_digest(agg)


@pytest.mark.parametrize("poison", ["serial-less", "budget", "grow"])
def test_poisons_force_a_full_base(tmp_path, poison):
    """A serial-less fold, the segment budget and a grow each drop the
    dirty log; the next save writes a full base that restores the same
    state."""
    agg, eh, path = _mk(tmp_path)
    agg.save_checkpoint(path)
    _port_churn(agg, eh, 9, ENTRIES)
    if poison == "serial-less":
        agg.want_serials = False
        _port_churn(agg, eh, 9, ENTRIES + 500)
        agg.want_serials = True
    elif poison == "budget":
        budget = agg._ckpt_resolved().segment_budget_mb << 20
        agg._ckpt_row_bytes = budget - 1
        _port_churn(agg, eh, 9, ENTRIES + 500)
    else:
        agg.grow(1 << (BITS + 1))
    assert agg._ckpt_dirty_lost
    agg.save_checkpoint(path)
    assert len(ckpt.resolve_chain(path).segments) == 0
    assert ckpt_state_digest(_reader(path)) == ckpt_state_digest(agg)


def test_merge_loads_chains(tmp_path):
    from ct_mapreduce_tpu_torch.core.types import Issuer

    agg, eh, path = _mk(tmp_path)
    agg.registry.assign_issuer(Issuer.from_string("CN=Test CA"))
    _port_churn(agg, eh, 15, ENTRIES)
    agg.save_checkpoint(path)
    _port_churn(agg, eh, 15, ENTRIES + 1000)
    agg.save_checkpoint(path)
    assert len(ckpt.resolve_chain(path).segments) == 1
    other = str(tmp_path / "other.npz")
    agg.configure_checkpointing(mode="ck01")
    agg.save_checkpoint(other)
    assert merge.expand_state_paths(str(tmp_path / "*.npz")) == [path, other]
    merged = merge.load_checkpoints([path, other])
    snap = merged.drain()
    assert snap.total == 2 * int(agg._table_fill)
    assert snap.counts == {k: 2 * v for k, v in agg.drain().counts.items()}


_KILL_CHILD = """
import os, sys
sys.path.insert(0, sys.argv[1])
path, point = sys.argv[2], sys.argv[3]
from ct_mapreduce_tpu_torch.agg.aggregator import ckpt_state_digest

agg, eh = _port_build(400, 12)
agg.configure_checkpointing(mode="ck02")
agg.save_checkpoint(path)                       # durable base
print("DIGEST " + ckpt_state_digest(agg), flush=True)
_port_churn(agg, eh, 21, 400)
os.environ["CTMR_CKPT_KILL"] = point
agg.save_checkpoint(path)                       # dies inside
raise SystemExit(3)                             # must not be reached
"""


@pytest.mark.parametrize("point", ["seg-pre-rename", "manifest-pre-rename"])
def test_kill_before_rename_keeps_last_tick(tmp_path, point):
    """Dying BEFORE a rename publishes nothing: the durable chain is the
    previous tick's (the base) and restores to the digest the child
    printed there. The child imports the port only."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = str(tmp_path / "agg.npz")
    child = tmp_path / "kill_child.py"
    child.write_text(inspect.getsource(_port_build) + "\n"
                     + inspect.getsource(_port_churn) + "\n"
                     + textwrap.dedent(_KILL_CHILD))
    env = dict(os.environ)
    env.pop("CTMR_CKPT_KILL", None)
    proc = subprocess.run([sys.executable, str(child), repo, path, point],
                          capture_output=True, text=True, timeout=60, env=env)
    assert proc.returncode == -signal.SIGKILL, proc.stdout + proc.stderr
    assert "ct_mapreduce_tpu." not in proc.stderr
    digest = next(line.split(" ", 1)[1] for line in proc.stdout.splitlines()
                  if line.startswith("DIGEST "))
    assert len(ckpt.resolve_chain(path).segments) == 0
    if point == "manifest-pre-rename":
        assert os.path.exists(ckpt.segment_path(path, 1))
    assert ckpt_state_digest(_reader(path)) == digest
    # The JAX package's loader agrees.
    r = HostSnapshotAggregator(capacity=1 << BITS)
    r.load_checkpoint(path)
    assert jharness.ckpt_state_digest(r) == digest
    assert json.loads(open(ckpt.manifest_path(path)).read())["chain"] == []


def test_sharded_snapshot_rehashes(tmp_path, writers):
    """A snapshot written under another shard count addresses its slots
    by shard, so its rows re-hash into this table instead of loading by
    position: the drain is the writer's."""
    src = writers["port"]["full"]
    with np.load(src, allow_pickle=True) as z:
        fields = {f: z[f] for f in z.files}
    fields["n_shards"] = np.int64(2)
    path = str(tmp_path / "sharded.npz")
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **fields)
    r = _port_agg()
    r.load_checkpoint(path)
    _same_drain(r, writers["port"]["agg"])
    assert ckpt_state_digest(r) == ckpt_state_digest(writers["port"]["agg"])


def test_saves_from_another_thread(tmp_path):
    """Checkpoint saves race a thread that keeps ingesting (with a short
    switch interval): every save lands whole, and the last one restores
    the final state exactly."""
    import threading

    agg = _port_agg()
    agg.configure_checkpointing(mode="ck02", max_chain=3)
    path = str(tmp_path / "race.npz")
    errors, done = [], threading.Event()

    def saver():
        while not done.is_set():
            try:
                agg.save_checkpoint(path)
                ckpt.resolve_chain(path)
            except Exception as err:  # reported by the assert below
                errors.append(err)
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t = threading.Thread(target=saver)
    try:
        t.start()
        for i in range(6):
            agg.ingest(_entries(10_000 * (i + 1), 40))
    finally:
        done.set()
        t.join(timeout=60)
        sys.setswitchinterval(old)
    assert not t.is_alive() and not errors, errors
    agg.save_checkpoint(path)
    assert ckpt_state_digest(_reader(path)) == ckpt_state_digest(agg)


def test_knob_ladder_matches_jax(tmp_path, monkeypatch):
    """explicit > env > profile > default for the checkpoint and staging
    knobs, as in the JAX package; a profile fingerprinted on another
    platform (the JAX tuner's TPU) is ignored, so knobs fall to env and
    defaults."""
    from ct_mapreduce_tpu.ingest.sync import resolve_staging as jstaging
    from ct_mapreduce_tpu_torch.ingest.sync import resolve_staging

    plain = tmp_path / "plain.json"
    plain.write_text(json.dumps({"version": 1, "knobs": {
        "ckpt": {"checkpointMode": "ck01", "ckptMaxChain": 3},
        "staging": {"chunksPerDispatch": 4}}}))
    foreign = tmp_path / "foreign.json"
    foreign.write_text(json.dumps({
        "version": 1, "knobs": {"ckpt": {"checkpointMode": "ck01"}},
        "fingerprint": {"jax_backend": "tpu", "device_kind": "TPU v5 lite",
                        "device_count": 8}}))
    monkeypatch.setenv("CTMR_PLATFORM_PROFILE", str(plain))
    for env in ({}, {"CTMR_CHECKPOINT_MODE": "ck02",
                     "CTMR_STAGING_DEPTH": "5"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for kw in ({}, {"mode": "ck02", "max_chain": 6}):
            assert tuple(ckpt.resolve_ckpt(**kw)) == tuple(
                jckpt.resolve_ckpt(**kw))
        assert resolve_staging() == jstaging()
        assert resolve_staging(2, 3) == jstaging(2, 3) == (2, 3)
    assert ckpt.resolve_ckpt().max_chain == 3
    assert resolve_staging() == (4, 5)
    monkeypatch.setenv("CTMR_PLATFORM_PROFILE", str(foreign))
    monkeypatch.delenv("CTMR_CHECKPOINT_MODE")
    assert ckpt.resolve_ckpt() == (ckpt.MODE_INCREMENTAL,
                                   ckpt.DEFAULT_MAX_CHAIN,
                                   ckpt.DEFAULT_SEGMENT_BUDGET_MB)
