"""The port on a CUDA card: each kernel (the fingerprint SHA-256, the
DER walker, the ten probe stages, the Bloom bit-scatter K5, the ECDSA
verify K6) against its plain PyTorch version,
and the tensor-op layers on the card (both dedup-table layouts, the
query plane's pinned views) against the same code on the CPU.
Tolerance: exact equality (integer arithmetic throughout).

Every test here needs a CUDA device and skips without one. The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ct_mapreduce_tpu_torch.core import packing
from ct_mapreduce_tpu_torch.ops import (
    buckettable, der_kernel, der_kernel_cuda, hashtable, pipeline, sha256,
    sha256_cuda)
from ct_mapreduce_tpu_torch.tools import mosaic_probe
from ct_mapreduce_tpu_torch.utils import dercases

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _fields(n: int, seed: int):
    rng = np.random.default_rng(seed)
    slen = (np.arange(n) % (packing.MAX_SERIAL_BYTES + 1)).astype(np.int32)
    ser = rng.integers(0, 256, (n, packing.MAX_SERIAL_BYTES), dtype=np.uint8)
    ser[np.arange(packing.MAX_SERIAL_BYTES)[None, :] >= slen[:, None]] = 0
    ii = rng.integers(0, 1 << 14, n).astype(np.int32)
    eh = rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
    return ii, eh, ser, slen


def test_fingerprint_kernel_matches_plain_and_hashlib(cuda):
    fields = _fields(4099, 1)  # not a multiple of the block size
    args = [torch.from_numpy(a).to(cuda) for a in fields]
    before = sha256_cuda.LAUNCHES
    got = sha256.sha256_fingerprint64(*args)
    torch.cuda.synchronize()
    assert sha256_cuda.LAUNCHES == before + 1
    assert torch.equal(got, sha256.fingerprints_plain(*args))
    got = got.cpu().numpy().view(np.uint32)
    np.testing.assert_array_equal(got, packing.fingerprints_np(*fields))
    ii, eh, ser, slen = fields
    for i in range(0, len(ii), 97):
        msg = packing.fingerprint_message(
            int(ii[i]), int(eh[i]), ser[i, : slen[i]].tobytes())
        assert got[i].astype(">u4").tobytes() == hashlib.sha256(msg).digest()[16:]


def test_fingerprint_kernel_checks_its_inputs(cuda):
    ii, eh, ser, slen = (torch.from_numpy(a).to(cuda) for a in _fields(64, 2))
    with pytest.raises(TypeError):
        sha256_cuda.fingerprint64(ii.long(), eh, ser, slen)
    with pytest.raises(ValueError, match="shape"):
        sha256_cuda.fingerprint64(ii, eh[:10], ser, slen)
    with pytest.raises(ValueError, match="contiguous"):
        sha256_cuda.fingerprint64(ii, eh, ser.t().contiguous().t(), slen)
    with pytest.raises(ValueError):
        sha256_cuda.fingerprint64(ii, eh.cpu(), ser, slen)
    before = sha256_cuda.LAUNCHES
    empty = sha256_cuda.fingerprint64(ii[:0], eh[:0], ser[:0], slen[:0])
    assert empty.shape == (0, 4) and sha256_cuda.LAUNCHES == before


def test_insert_and_step_on_card_match_cpu(cuda):
    """The bucket insert and the pre-parsed step give the same bytes on
    the card as on the CPU (sort stability, cummax, scatter order)."""
    rng = np.random.default_rng(3)
    k, b = 2, 4096
    slen = rng.integers(8, 21, (k, b)).astype(np.int32)
    ser = rng.integers(0, 256, (k, b, 46), dtype=np.uint8)
    ser[np.arange(46)[None, None, :] >= slen[..., None]] = 0
    ser[1, :1024], slen[1, :1024] = ser[0, :1024], slen[0, :1024]
    nah = rng.integers(400_000, 500_000, (k, b)).astype(np.int32)
    nah[1, :1024] = nah[0, :1024]
    ii = rng.integers(0, 64, (k, b)).astype(np.int32)
    ii[1, :1024] = ii[0, :1024]
    ins = rng.random((k, b)) < 0.97
    outs = []
    for dev in (torch.device("cpu"), cuda):
        table = buckettable.make_table(24 * 256, device=dev)  # ~65% load
        table, out = pipeline.preparsed_core(
            table, *(torch.from_numpy(a).to(dev) for a in (ser, slen, nah, ii, ins)),
            400_000, num_issuers=64, max_probes=4, flag_cap=64)
        keys = torch.from_numpy(packing.fingerprints_np(
            ii[0], nah[0], ser[0], slen[0]).view(np.int32)).to(dev)
        outs.append((buckettable.host_rows(table), out.packed.cpu().numpy(),
                     out.overflow_bits.cpu().numpy(),
                     buckettable.contains(table, keys).cpu().numpy()))
    for c, g in zip(*outs):
        np.testing.assert_array_equal(g, c)
    assert (outs[0][0][:, buckettable.FILL_WORD] == buckettable.SLOTS).any()


def test_open_table_on_card_matches_cpu(cuda):
    """The open-addressing insert and contains give the same rows,
    count and flags on the card as on the CPU, bit for bit: duplicates
    in a batch (the scatter-min election), replays, invalid lanes and
    probe overflow in a table past its load."""
    rng = np.random.default_rng(12)
    pool = rng.integers(0, 1 << 32, (6000, 4), dtype=np.uint64).astype(np.uint32)
    batches = []
    for _ in range(4):
        keys = pool[rng.integers(0, len(pool), 4096)]
        keys[0] = 0  # the all-zero key takes the sentinel's place
        meta = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
        batches.append((keys, meta, rng.random(4096) < 0.95))
    runs = []
    for dev in (torch.device("cpu"), cuda):
        table = hashtable.make_table(1 << 13, device=dev)
        out = []
        for keys, meta, valid in batches:
            table, wu, ovf = hashtable.insert(
                table, torch.from_numpy(keys.view(np.int32)).to(dev),
                torch.from_numpy(meta.view(np.int32)).to(dev),
                torch.from_numpy(valid).to(dev), max_probes=8)
            out += [hashtable.host_rows(table).copy(), int(table.count),
                    wu.cpu().numpy(), ovf.cpu().numpy()]
        probe = torch.from_numpy(pool.view(np.int32)).to(dev)
        out.append(hashtable.contains(table, probe, max_probes=8).cpu().numpy())
        runs.append(out)
    for c, g in zip(*runs):
        np.testing.assert_array_equal(g, c)
    assert runs[0][-2].any(), "no lane overflowed"
    np.testing.assert_array_equal(
        runs[0][-1], hashtable.contains_np(runs[0][-5], pool, max_probes=8))


@pytest.mark.parametrize("layout", ["bucket", "open"])
def test_pinned_view_on_card_answers_like_contains_np(cuda, layout,
                                                      monkeypatch):
    """A ReplicaPool over an aggregator on the card pins its replicas'
    rows on CUDA, and their device ``contains`` answers equal the host
    ``contains_np`` mirror's, with no device fallback."""
    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.serve.snapshot import ReplicaPool
    from ct_mapreduce_tpu_torch.telemetry import metrics
    from ct_mapreduce_tpu_torch.utils import syncerts

    monkeypatch.setenv("CTMR_TABLE", layout)
    tpl = syncerts.make_template(issuer_cn="Card Serve CA")
    agg = TorchAggregator(capacity=1 << 12, batch_size=256, device=cuda)
    agg.ingest([(syncerts.stamp_serial(tpl, j), tpl.issuer_der)
                for j in range(1000)])
    sink = metrics.InMemSink()
    prev = metrics.get_sink()
    metrics.set_sink(sink)
    try:
        pool = ReplicaPool(agg, n_replicas=2, max_staleness_s=1e9).warm()
        rng = np.random.default_rng(4)
        keys, _ = agg._drain_table()
        fps = np.concatenate([
            keys, rng.integers(0, 1 << 32, (777, 4),
                               dtype=np.uint64).astype(np.uint32)])
        live = agg.table.rows.cpu().numpy().view(np.uint32)
        here = torch.device("cuda", torch.cuda.current_device())
        for v in pool._replicas:
            assert v.layout == layout and v.pinned_device == here
            assert v._rows is None  # captured on the card, no host copy
            np.testing.assert_array_equal(v.rows, live)
            host = v._contains_host(fps)
            assert host[: len(keys)].all() and not host[len(keys):].any()
            np.testing.assert_array_equal(v.contains_fps(fps), host)
            assert v._device and v.pinned_device.type == "cuda"
        assert sink.snapshot()["counters"].get("serve.device_fallback", 0) == 0
    finally:
        metrics.set_sink(prev)


def test_pinned_view_on_card_raises_instead_of_host_fallback(cuda,
                                                             monkeypatch):
    """A fault in a CUDA view's ``contains`` fails the lookup: the view
    stays on the card and no host fallback is counted."""
    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.ops import pipeline
    from ct_mapreduce_tpu_torch.serve.snapshot import capture_view
    from ct_mapreduce_tpu_torch.telemetry import metrics
    from ct_mapreduce_tpu_torch.utils import syncerts

    tpl = syncerts.make_template(issuer_cn="Card Fault CA")
    agg = TorchAggregator(capacity=1 << 12, batch_size=256, device=cuda)
    agg.ingest([(syncerts.stamp_serial(tpl, j), tpl.issuer_der)
                for j in range(100)])
    view = capture_view(agg, epoch=1, device=True)
    here = torch.device("cuda", torch.cuda.current_device())
    assert view.pinned_device == here

    def fault(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(pipeline, "table_contains", fault)
    sink = metrics.InMemSink()
    prev = metrics.get_sink()
    metrics.set_sink(sink)
    try:
        keys, _ = agg._drain_table()
        with pytest.raises(RuntimeError, match="illegal memory access"):
            view.contains_fps(keys)
        assert view._device and view.pinned_device == here
        assert sink.snapshot()["counters"].get("serve.device_fallback", 0) == 0
    finally:
        metrics.set_sink(prev)


def test_aggregator_on_card_matches_cpu(cuda):
    """The whole slice on the card against the same slice on the CPU:
    replays, expired and CA leaves, a leaf in its expiry hour (exact
    host lane), a grow and probe overflow (host lane + device guard)."""
    import datetime

    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.core import der
    from ct_mapreduce_tpu_torch.native import leafpack
    from ct_mapreduce_tpu_torch.utils import syncerts

    utc = datetime.timezone.utc
    now = datetime.datetime(2025, 1, 1, tzinfo=utc)
    tpls = [syncerts.make_template(
        issuer_cn=f"Card Issuer {i}", serial_len=8 + 3 * i,
        not_after=now + datetime.timedelta(days=100 + 50 * i),
        key_type="rsa2048" if i % 2 else "ec") for i in range(4)]
    tpls.append(syncerts.make_template(  # expired
        issuer_cn="Card Issuer 0", not_after=now - datetime.timedelta(days=3)))
    tpls.append(syncerts.make_template(  # expires within the hour
        issuer_cn="Card Issuer 1", not_after=now + datetime.timedelta(minutes=9)))
    ca = der.parse_cert(tpls[2].issuer_der)
    tpls.append(syncerts.CertTemplate(tpls[2].issuer_der, tpls[2].issuer_der,
                                      ca.serial_off, ca.serial_len))
    rng = np.random.default_rng(9)
    batches, pool, counter = [], [], 1
    for _ in range(5):
        entries = []
        for t in rng.choice(len(tpls), size=160, p=[.3, .2, .2, .1, .1, .05, .05]):
            if pool and rng.random() < 0.4:
                t, c = pool[rng.integers(len(pool))]
            else:
                c, counter = counter, counter + 1
                pool.append((t, c))
            entries.append((syncerts.stamp_serial(tpls[t], int(c)), int(t)))
        batches.append(packing.pack_entries(entries, pad_len=2048))
    runs = []
    for dev in (torch.device("cpu"), cuda):
        agg = TorchAggregator(capacity=24 * 8, batch_size=128, now=now,
                              max_probes=2, grow_at=0.9, max_capacity=24 * 16,
                              device=dev)
        idx_of = np.array([agg.registry.get_or_assign(t.issuer_der)
                           for t in tpls], np.int32)
        results = []
        for pb in batches:
            sc = leafpack.extract_sidecars(pb.data, pb.length)
            res = agg.ingest_preparsed(sc, idx_of[pb.issuer_idx], pb.valid,
                                       pb.data, pb.length)
            results.append((res.was_unknown.copy(), res.filtered.copy(),
                            list(res.serials),
                            buckettable.host_rows(agg.table).copy()))
        snap = agg.drain()
        runs.append((results, dict(agg.metrics), agg.capacity,
                     (snap.counts, snap.crls, snap.dns, snap.total)))
    (cpu_res, cpu_m, cpu_cap, cpu_snap), (gpu_res, gpu_m, gpu_cap, gpu_snap) = runs
    for c, g in zip(cpu_res, gpu_res):
        np.testing.assert_array_equal(g[0], c[0])
        np.testing.assert_array_equal(g[1], c[1])
        assert g[2] == c[2]
        np.testing.assert_array_equal(g[3], c[3])
    assert (gpu_m, gpu_cap, gpu_snap) == (cpu_m, cpu_cap, cpu_snap)
    assert cpu_cap > 24 * 8 and cpu_m["overflow"] > 0
    assert cpu_m["host_lane"] > cpu_m["overflow"]


def _walker_rows(pad: int):
    """Crafted edge cases, templates and their mutants, packed at ``pad``."""
    import datetime

    from ct_mapreduce_tpu_torch.utils import syncerts

    utc = datetime.timezone.utc
    ders = dercases.crafted()
    for i in range(6):
        t = syncerts.make_template(
            issuer_cn=f"Walker Issuer {i}", serial_len=8 + 2 * i,
            key_type="rsa2048" if i % 2 else "ec", rich_extensions=i > 1,
            not_after=datetime.datetime(2026 + 20 * i, 5, 6, 7, tzinfo=utc))
        ders += [(t.leaf_der, None), (t.issuer_der, None)]
    data, length = dercases.pack(ders, pad)
    mut, mlen = dercases.mutate_rows(data, length, 4096,
                                     np.random.default_rng(pad))
    return np.concatenate([data, mut]), np.concatenate([length, mlen])


def _assert_walks_equal(got, want):
    for f in der_kernel.ParsedCerts._fields:
        assert torch.equal(getattr(got.parsed, f), getattr(want.parsed, f)), f
    assert torch.equal(got.serials, want.serials)
    assert torch.equal(got.fits, want.fits)
    assert torch.equal(got.cn_window, want.cn_window)


# Row widths: multiples of 16 (the flat-window path, a 2 KB leaf row)
# and odd widths, whose rows start at every offset from a 16-byte chunk.
@pytest.mark.parametrize("pad", [192, 193, 2047, 2048])
@pytest.mark.parametrize("scan,cn_window",
                         [(True, 61), (True, 1), (True, 0), (False, 0)])
def test_walker_kernel_matches_plain(cuda, pad, scan, cn_window):
    data, length = _walker_rows(pad)
    d, ln = torch.from_numpy(data).to(cuda), torch.from_numpy(length).to(cuda)
    before = der_kernel_cuda.LAUNCHES
    got = der_kernel.walk(d, ln, scan, cn_window)
    torch.cuda.synchronize()
    assert der_kernel_cuda.LAUNCHES == before + 1
    want = der_kernel.walk_plain(d, ln, scan, cn_window)
    _assert_walks_equal(got, want)
    ok = want.parsed.ok
    assert int(ok.sum()) < ok.numel()
    if pad > 256:  # every certificate is longer than the narrow rows
        assert int(ok.sum()) > 0


@pytest.mark.parametrize("pad", [193, 2047])
@pytest.mark.parametrize("scan,cn_window", [(True, 61), (False, 0)])
def test_walker_kernel_on_unaligned_views(cuda, pad, scan, cn_window):
    """Contiguous views whose first byte is not 16-byte aligned: the
    rows from the second on (``d[1:]`` at an odd width) and the rows
    one byte into a flat buffer. The first lane's first chunk and the
    last lane's last chunk then reach past the tensor; the kernel reads
    them byte by byte and gives the plain version's results."""
    data, length = _walker_rows(pad)
    d, ln = torch.from_numpy(data).to(cuda), torch.from_numpy(length).to(cuda)
    flat = torch.zeros(d.numel() + 1, dtype=torch.uint8, device=cuda)
    flat[1:] = d.reshape(-1)
    for view, lv in ((d[1:], ln[1:]), (flat[1:].view(d.shape), ln)):
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        got = der_kernel.walk(view, lv, scan, cn_window)
        torch.cuda.synchronize()
        _assert_walks_equal(got, der_kernel.walk_plain(view, lv, scan, cn_window))


@pytest.mark.parametrize("serial_k", [1, 47, 256])
def test_walker_kernel_serial_widths(cuda, serial_k):
    """The staged serial window at its narrowest, at an odd width and at
    the widest the shared-memory staging takes, over a batch whose last
    block is partial."""
    data, length = _walker_rows(2047)
    d, ln = torch.from_numpy(data).to(cuda), torch.from_numpy(length).to(cuda)
    assert d.shape[0] % 128 != 0
    got = der_kernel.walk(d, ln, True, 61, serial_k)
    torch.cuda.synchronize()
    _assert_walks_equal(got, der_kernel.walk_plain(d, ln, True, 61, serial_k))


def test_walker_kernel_checks_its_inputs(cuda):
    data, length = _walker_rows(192)
    d, ln = torch.from_numpy(data).to(cuda), torch.from_numpy(length).to(cuda)
    with pytest.raises(TypeError):
        der_kernel_cuda.walk(d, ln.long(), True)
    with pytest.raises(ValueError, match="shape"):
        der_kernel_cuda.walk(d, ln[:5], True)
    with pytest.raises(ValueError, match="contiguous"):
        der_kernel_cuda.walk(d[:, ::2], ln, True)
    with pytest.raises(ValueError, match="cn_window"):
        der_kernel_cuda.walk(d, ln, True, 62)
    for width in (0, der_kernel_cuda.MAX_SERIAL_WINDOW + 1):
        with pytest.raises(ValueError, match="max_serial_bytes"):
            der_kernel_cuda.walk(d, ln, True, 61, width)
    before = der_kernel_cuda.LAUNCHES
    empty = der_kernel_cuda.walk(d[:0], ln[:0], True, 61)
    assert empty.serials.shape == (0, 46) and der_kernel_cuda.LAUNCHES == before


@pytest.mark.parametrize("rows", ["cert", "random", "crafted"])
def test_serial_stage_window_matches_plain(cuda, rows):
    """Stage 9's staged window on certificate rows, random words and
    crafted rows whose version, serial header or serial runs past the
    window and past the row: equal to the plain version and to the model
    of the window (and, on certificates, to the host parser)."""
    expected = None
    if rows == "cert":
        words, expected = mosaic_probe.stage_inputs(
            mosaic_probe.SERIAL_STAGE, 1 << 16)
    elif rows == "random":
        words = mosaic_probe.random_words(5, 1 << 16)
    else:
        words = mosaic_probe.crafted_serial_rows(5, copies=64)
    w = mosaic_probe.to_tensor(words, cuda)
    got = mosaic_probe.run_stage(mosaic_probe.SERIAL_STAGE, w)
    torch.cuda.synchronize()
    assert torch.equal(got, mosaic_probe.plain_stage(
        mosaic_probe.SERIAL_STAGE, w))
    model, _past = mosaic_probe.serial_window_model(words)
    np.testing.assert_array_equal(got.cpu().numpy(), model)
    if expected is not None:
        np.testing.assert_array_equal(got.cpu().numpy(), expected)


@pytest.mark.parametrize("stage", [4, 8])
@pytest.mark.parametrize("lanes", [1, 127, 129, 1000, (1 << 16) + 5])
def test_one_pass_and_tiled_stages_at_odd_widths(cuda, stage, lanes):
    """Stage 4's one pass and stage 8's staged tiles at widths that are
    not multiples of the 128-lane tile: equal to the plain version (and
    stage 4 to its model)."""
    words = mosaic_probe.random_words(lanes, lanes)
    w = mosaic_probe.to_tensor(words, cuda)
    got = mosaic_probe.run_stage(stage, w)
    torch.cuda.synchronize()
    assert torch.equal(got, mosaic_probe.plain_stage(stage, w))
    if stage == 4:
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      mosaic_probe.fori_masked_model(words))


def test_one_pass_and_tiled_stages_on_crafted_rows(cuda):
    """Stage 8 on its edge rows (every byte 0xFF or 0, walks that reach
    offsets 248-251, constructed chains), whole and shifted by one lane
    so that each case lands elsewhere in a tile; stage 4 on its edge
    words."""
    words = mosaic_probe.crafted_tlv_rows(3, copies=64)
    for rows in (words, words[:, 1:]):
        w = mosaic_probe.to_tensor(rows, cuda)
        got = mosaic_probe.kernel_stage(8, w)
        torch.cuda.synchronize()
        assert torch.equal(got, mosaic_probe.plain_stage(8, w))
    edges = mosaic_probe.crafted_masked_rows(1000)
    w = mosaic_probe.to_tensor(edges, cuda)
    got = mosaic_probe.kernel_stage(4, w)
    torch.cuda.synchronize()
    assert torch.equal(got, mosaic_probe.plain_stage(4, w))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  mosaic_probe.fori_masked_model(edges))


@pytest.mark.parametrize("stage", [2, 3])
@pytest.mark.parametrize("lanes", [1, 127, 129, 1000, (1 << 16) + 5])
def test_dyn_and_window_stages_at_odd_widths(cuda, stage, lanes):
    """Stage 2's scattered read and stage 3's staged window at widths
    that are not multiples of the 128-lane block: equal to the plain
    version (and stage 3 to its window model)."""
    words = mosaic_probe.random_words(lanes + stage, lanes)
    w = mosaic_probe.to_tensor(words, cuda)
    got = mosaic_probe.run_stage(stage, w)
    torch.cuda.synchronize()
    assert torch.equal(got, mosaic_probe.plain_stage(stage, w))
    if stage == 3:
        model, _past = mosaic_probe.fori_window_model(words)
        np.testing.assert_array_equal(got.cpu().numpy(), model)


def test_dyn_and_window_stages_on_crafted_rows(cuda):
    """Stage 2 with byte 0 at each of its 256 values (every word, the
    wrap into word 0) and stage 3 on walks whose last read lands at each
    offset 15..60 and on rows of 0xFF and 0 bytes, whole and shifted by
    one lane so that each case lands elsewhere in a block."""
    for stage, words in ((2, mosaic_probe.crafted_dyn_rows(3, 64)),
                         (3, mosaic_probe.crafted_fori_rows(3, 64))):
        for rows in (words, words[:, 1:]):
            w = mosaic_probe.to_tensor(rows, cuda)
            got = mosaic_probe.kernel_stage(stage, w)
            torch.cuda.synchronize()
            assert torch.equal(got, mosaic_probe.plain_stage(stage, w))
            if stage == 3:
                model, past = mosaic_probe.fori_window_model(rows)
                np.testing.assert_array_equal(got.cpu().numpy(), model)
                assert past.any() and not past.all()


@pytest.mark.parametrize("stage", [1, 7])
def test_word_stages_at_tails_off_alignment_and_on_crafted_rows(cuda, stage):
    """Stages 1 and 7 (four lanes a thread, one 16-byte load and store)
    at widths whose last 1, 2 or 3 lanes are a tail, in views 4, 8 and
    12 B past a 16-byte boundary (a 4-byte load a lane), and stage 7 on
    its edge rows, whole and shifted by one lane: equal to the plain
    version."""
    cases = [mosaic_probe.to_tensor(
        mosaic_probe.random_words(lanes + stage, lanes), cuda)
        for lanes in (1, 2, 3, 127, 129, 130, 1000, (1 << 16) + 5)]
    for offset in (1, 2, 3):
        view = mosaic_probe.offset_tensor(
            mosaic_probe.random_words(offset, (1 << 16) + 3), cuda, offset)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4 * offset
        cases.append(view)
    if stage == 7:
        rows = mosaic_probe.crafted_step_rows(3, 8)
        cases += [mosaic_probe.to_tensor(r, cuda) for r in (rows, rows[:, 1:])]
    for w in cases:
        got = mosaic_probe.kernel_stage(stage, w)
        torch.cuda.synchronize()
        assert torch.equal(got, mosaic_probe.plain_stage(stage, w)), w.shape


def test_probe_empty_launch(cuda):
    """The empty kernel launches at the grids its floors time and counts
    as no stage."""
    before = list(mosaic_probe.LAUNCHES)
    for blocks, threads in ((8192, mosaic_probe.LANES),
                            mosaic_probe.word_grid(1 << 20), (1, 1024)):
        mosaic_probe.empty_launch(blocks, threads, cuda)
    torch.cuda.synchronize()
    assert mosaic_probe.LAUNCHES == before


@pytest.mark.parametrize("lanes", [mosaic_probe.LANES, 1000])
def test_probe_stages_match_plain(cuda, lanes):
    for stage in range(len(mosaic_probe.STAGES)):
        words, expected = mosaic_probe.stage_inputs(stage, lanes, seed=lanes)
        w = mosaic_probe.to_tensor(words, cuda)
        before = mosaic_probe.LAUNCHES[stage]
        got = mosaic_probe.run_stage(stage, w)
        torch.cuda.synchronize()
        assert mosaic_probe.LAUNCHES[stage] == before + 1
        assert torch.equal(got, mosaic_probe.plain_stage(stage, w)), stage
        if expected is not None:
            np.testing.assert_array_equal(got.cpu().numpy(), expected)


def test_walker_lane_on_card_matches_cpu(cuda):
    """The walker lane through the aggregator on the card against the
    same lane on the CPU: a CN filter with an over-long prefix (host
    lane), replays, a grow and probe overflow."""
    import datetime

    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.utils import syncerts

    utc = datetime.timezone.utc
    now = datetime.datetime(2025, 1, 1, tzinfo=utc)
    long_cn = "Card Long " + "y" * 64
    cns = [f"Card Issuer {i}" for i in range(4)] + [long_cn]
    tpls = [syncerts.make_template(
        issuer_cn=cn, serial_len=8 + 2 * i, rich_extensions=i % 2 == 0,
        not_after=now + datetime.timedelta(days=100 + 50 * i),
        key_type="rsa2048" if i % 2 else "ec") for i, cn in enumerate(cns)]
    rng = np.random.default_rng(11)
    batches, pool, counter = [], [], 1
    for _ in range(5):
        entries = []
        for t in rng.choice(len(tpls), size=160, p=[.3, .3, .2, .1, .1]):
            if pool and rng.random() < 0.4:
                t, c = pool[rng.integers(len(pool))]
            else:
                c, counter = counter, counter + 1
                pool.append((t, c))
            entries.append((syncerts.stamp_serial(tpls[t], int(c)), int(t)))
        batches.append(packing.pack_entries(entries, pad_len=2048))
    runs = []
    for dev in (torch.device("cpu"), cuda):
        agg = TorchAggregator(capacity=24 * 8, batch_size=128, now=now,
                              max_probes=1, grow_at=0.9, max_capacity=24 * 16,
                              cn_prefixes=("Card Issuer 0", "Card Issuer 1",
                                           "Card Issuer 2", long_cn[:64]),
                              device=dev)
        idx_of = np.array([agg.registry.get_or_assign(t.issuer_der)
                           for t in tpls], np.int32)
        results = []
        for pb in batches:
            res = agg.ingest_packed(pb.data, pb.length, idx_of[pb.issuer_idx],
                                    pb.valid)
            results.append((res.was_unknown.copy(), res.filtered.copy(),
                            list(res.serials),
                            buckettable.host_rows(agg.table).copy()))
        snap = agg.drain()
        runs.append((results, dict(agg.metrics), agg.capacity,
                     (snap.counts, snap.crls, snap.dns, snap.total)))
    (cpu_res, cpu_m, cpu_cap, cpu_snap), (gpu_res, gpu_m, gpu_cap, gpu_snap) = runs
    for c, g in zip(cpu_res, gpu_res):
        np.testing.assert_array_equal(g[0], c[0])
        np.testing.assert_array_equal(g[1], c[1])
        assert g[2] == c[2]
        np.testing.assert_array_equal(g[3], c[3])
    assert (gpu_m, gpu_cap, gpu_snap) == (cpu_m, cpu_cap, cpu_snap)
    assert cpu_cap > 24 * 8 and cpu_m["overflow"] > 0
    assert cpu_m["filtered_cn"] > 0 and cpu_m["host_lane"] > cpu_m["overflow"]


def _sink_pages(n_pages: int, per_page: int):
    """Raw get-entries pages of minicert leaves (two issuers, replays
    across pages, one CA leaf a page) and their base64 wire form."""
    import base64

    from ct_mapreduce_tpu_torch.ingest import leaf as leaflib
    from ct_mapreduce_tpu_torch.utils import minicert

    issuers = [minicert.make_cert(serial=1, issuer_cn=f"Pin CA {k}",
                                  is_ca=True) for k in range(2)]
    eds = [base64.b64encode(leaflib.encode_extra_data([i])).decode()
           for i in issuers]
    pages, serial = [], 10
    for p in range(n_pages):
        lis, ed = [], []
        for j in range(per_page):
            k = j % 2
            s = serial - per_page if (j % 9 == 8 and p) else serial
            serial += 1
            leaf = minicert.make_cert(
                serial=s, issuer_cn=f"Pin CA {k}", subject_cn="pin.example",
                is_ca=(j == 3), crl_dps=(f"http://crl{k}.example/c.crl",))
            lis.append(base64.b64encode(
                leaflib.encode_leaf_input(leaf, j)).decode())
            ed.append(eds[k])
        pages.append((lis, ed))
    return pages


def _sink_drain(device, pages, pad_len=2048, varied=False, **kw):
    """The pages through a sink on ``device``. ``varied`` re-cuts them
    into pages of 5 to 40 entries with a flush() every third page;
    ``pad_len`` 1024 decodes the minicert leaves wide and narrows
    them."""
    import datetime

    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.ingest import sync
    from ct_mapreduce_tpu_torch.telemetry import metrics

    if varied:
        lis = [li for p in pages for li in p[0]]
        eds = [ed for p in pages for ed in p[1]]
        pages, at = [], 0
        while at < len(lis):
            n = (5, 40, 17, 29, 3)[len(pages) % 5]
            pages.append((lis[at:at + n], eds[at:at + n]))
            at += n
    now = datetime.datetime(2025, 1, 1, tzinfo=datetime.timezone.utc)
    agg = TorchAggregator(capacity=1 << 12, batch_size=64, now=now,
                          device=device)
    sink = sync.AggregatorSink(agg, flush_size=64, **kw)
    sink.PAD_LEN = pad_len
    metrics.get_sink().reset()
    for n, (lis, eds) in enumerate(pages):
        sink.store_raw_batch(sync.RawBatch(lis, eds, n * 64, "log"))
        if varied and n % 3 == 2:
            sink.flush()
    sink.close()
    counters = metrics.get_sink().snapshot()["counters"]
    snap = agg.drain()
    return ((snap.counts, snap.crls, snap.dns, snap.total,
             agg.issuer_totals.tolist(), dict(agg.metrics)), counters, sink)


@pytest.mark.parametrize("kw", [
    dict(device_queue_depth=0), dict(device_queue_depth=2),
    dict(chunks_per_dispatch=2, staging_depth=1),
    dict(chunks_per_dispatch=2, staging_depth=2),
    dict(device_queue_depth=2, pad_len=1024),
    dict(device_queue_depth=2, varied=True),
    dict(chunks_per_dispatch=2, staging_depth=2, varied=True)],
    ids=["unstaged-depth0", "unstaged-depth2", "staged-depth1",
         "staged-depth2", "unstaged-narrowed", "unstaged-varied",
         "staged-varied"])
def test_sink_pinned_buffers_on_card_match_cpu(cuda, kw):
    """The sink on the card, with every row copy from pinned memory and
    its buffers reused (16 envelopes or 32 chunks through a pool of at
    most depth + 1 buffers, also with pages of varying size, partial
    chunks at flush() and chunks narrowed after a wide decode), drains
    as the CPU path."""
    pages = _sink_pages(32, 64)
    want, _, _ = _sink_drain("cpu", pages, **kw)
    got, counters, sink = _sink_drain(cuda, pages, **kw)
    assert got == want and want[3] > 1500
    assert counters["ingest.h2d_bytes"] > 0
    assert counters["ingest.h2d_pinned_bytes"] == counters["ingest.h2d_bytes"]
    pool = sink._row_bufs
    keep = (sink.staging_depth if sink.chunks_per_dispatch > 1
            else sink.device_queue_depth)
    assert 1 <= pool.allocated == pool.live <= keep + 1
    assert all(b.is_pinned() for b in pool._free)
    if kw.get("pad_len") == 1024:  # every chunk shipped 512-byte rows
        assert counters["ingest.h2d_bytes"] == 32 * 64 * 512


def test_checkpoint_round_trip_card_and_cpu(cuda, tmp_path):
    """A ck02 chain and a ck01 file written on the card load on the CPU
    and on the card to the writer's digest and drain, and a chain the
    CPU writes loads on the card."""
    import datetime

    from ct_mapreduce_tpu_torch.agg import ckpt
    from ct_mapreduce_tpu_torch.agg.aggregator import (
        TorchAggregator, ckpt_state_digest)
    from ct_mapreduce_tpu_torch.utils import minicert

    now = datetime.datetime(2025, 1, 1, tzinfo=datetime.timezone.utc)
    issuers = [minicert.make_cert(serial=1, issuer_cn=f"Ck CA {k}",
                                  is_ca=True) for k in range(2)]

    def entries(start):
        return [(minicert.make_cert(serial=start + j % 150,
                                    issuer_cn=f"Ck CA {j % 2}",
                                    crl_dps=("http://c.example/c.crl",)),
                 issuers[j % 2]) for j in range(200)]

    for writer_dev, reader_devs in ((cuda, ("cpu", cuda)), ("cpu", (cuda,))):
        w = TorchAggregator(capacity=1 << 10, batch_size=128, now=now,
                            device=writer_dev)
        w.configure_checkpointing(mode="ck02")
        chain = str(tmp_path / f"{writer_dev}-chain.npz")
        for t in range(3):
            w.ingest(entries(1000 * (t + 1)))
            w.save_checkpoint(chain)
        assert len(ckpt.resolve_chain(chain).segments) == 2
        w.configure_checkpointing(mode="ck01")
        full = str(tmp_path / f"{writer_dev}-full.npz")
        w.save_checkpoint(full)
        want = (ckpt_state_digest(w), w.drain())
        for path in (chain, full):
            for dev in reader_devs:
                r = TorchAggregator(capacity=1 << 10, device=dev)
                r.load_checkpoint(path)
                assert r.table.rows.device.type == torch.device(dev).type
                assert (ckpt_state_digest(r), r.drain()) == want


@pytest.mark.parametrize("kw", [
    dict(overlap_workers=2, device_queue_depth=1),
    dict(overlap_workers=2, chunks_per_dispatch=2, staging_depth=1)],
    ids=["overlap-unstaged", "overlap-staged"])
def test_overlap_sink_pool_bound_on_card(cuda, kw):
    """The overlapped sink on the card: decoded chunks wait for the submit
    thread holding pinned buffers, and the pool keeps no more than
    ``row_buffer_bound()`` (depth + the prepared window + 2) with a slow
    fold; the drain equals the CPU path's."""
    import time

    pages = _sink_pages(32, 64)
    want, _, _ = _sink_drain("cpu", pages, **kw)

    from ct_mapreduce_tpu_torch.ingest import sync

    orig = sync.AggregatorSink._complete_item
    bounds = []

    def slow(self, pending, der_of):
        bounds.append(self.row_buffer_bound())
        time.sleep(0.01)
        orig(self, pending, der_of)

    sync.AggregatorSink._complete_item = slow
    try:
        got, counters, sink = _sink_drain(cuda, pages, **kw)
    finally:
        sync.AggregatorSink._complete_item = orig
    assert got == want and want[3] > 1500
    assert counters["ingest.h2d_pinned_bytes"] == counters["ingest.h2d_bytes"]
    pool = sink._row_bufs
    bound = bounds[0]
    assert bound == 1 + (2 + 1) + 2
    assert 1 <= pool.allocated == pool.live <= bound
    assert all(b.is_pinned() for b in pool._free)


def test_ct_fetch_on_card_matches_cpu(cuda, tmp_path):
    """One ct-fetch run (``cmd/ct_fetch.main``, ``backend = tpu``, with
    ``certPath`` and ``overlapWorkers`` 2) against the port's loopback log
    over HTTP on the card: its drain, cursor and PEM tree equal the same
    run with ``device="cpu"``, and ``storage-statistics`` prints the same
    report for both."""
    import contextlib
    import io
    import os

    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.cmd import ct_fetch, storage_statistics
    from ct_mapreduce_tpu_torch.utils.fakelog import FakeLog, LogServer

    log = FakeLog()
    for lis, eds in _sink_pages(6, 64):
        for li, ed in zip(lis, eds):
            log.add_raw(li, ed)
    log.max_batch = 100
    out = {}
    with LogServer(log) as srv:
        for dev in ("cpu", cuda):
            d = tmp_path / str(torch.device(dev).type)
            d.mkdir()
            ini = d / "ct.ini"
            ini.write_text(
                f"logList = {srv.url}\nbackend = tpu\nbatchSize = 64\n"
                f"tableBits = 10\naggStatePath = {d}/agg.npz\n"
                f"certPath = {d}/certs\noverlapWorkers = 2\nhealthAddr = \n")
            assert ct_fetch.main(["-config", str(ini), "-nobars"],
                                 device=dev) == 0
            r = TorchAggregator(capacity=1 << 10, device="cpu")
            r.load_checkpoint(str(d / "agg.npz"))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert storage_statistics.main(
                    ["-config", str(ini), "-v", "2"]) == 0
            report = "\n".join(ln for ln in buf.getvalue().splitlines()
                               if "LastUpdateTime" not in ln)
            tree = {}
            for dirpath, _, files in os.walk(d / "certs"):
                for f in files:
                    if "state" not in dirpath:
                        p = os.path.join(dirpath, f)
                        with open(p, "rb") as fh:
                            tree[os.path.relpath(p, d)] = fh.read()
            out[dev if dev == "cpu" else "cuda"] = (r.drain(), report, tree)
    assert out["cuda"] == out["cpu"]
    assert out["cpu"][0].total > 300 and len(out["cpu"][2]) > 300


# -- K5, the Bloom bit-scatter of the filter build ------------------------

def _bloom_host_words(keys, gid, offs, ms, ks, layer, total_bits):
    """The probe bits by the host NumPy arithmetic of filter/cascade.py,
    packed as the arena's little-endian words."""
    from ct_mapreduce_tpu_torch.filter.cascade import _pack_words, _probe_np

    bits = np.zeros((total_bits,), bool)
    for g in range(len(ms)):
        sel = gid == g
        if sel.any():
            pos = _probe_np(keys[sel], int(ms[g]), int(ks[g]), layer)
            bits[int(offs[g]) + pos.reshape(-1)] = True
    return _pack_words(bits)


def _bloom_args(device, keys, gid, offs, ms, ks):
    from ct_mapreduce_tpu_torch.filter.cascade import keys_tensor

    return [keys_tensor(keys, device),
            torch.from_numpy(gid.astype(np.int32)).to(device),
            torch.from_numpy(np.asarray(offs, np.int64)).to(device),
            torch.from_numpy(np.asarray(ms, np.int32)).to(device),
            torch.from_numpy(np.asarray(ks, np.int32)).to(device)]


def test_bloom_kernel_matches_plain_one_layer(cuda):
    from ct_mapreduce_tpu_torch.filter.cascade import layer_params
    from ct_mapreduce_tpu_torch.ops import bloom, bloom_cuda

    n = 1 << 16
    keys = np.random.default_rng(11).integers(0, 2**32, (n, 4), np.uint32)
    m, k = layer_params(n, 0.01)
    gid = np.zeros((n,), np.int32)
    kt, gt, ot, mt, kst = _bloom_args(cuda, keys, gid, [0], [m], [k])
    got = torch.zeros((m // 32,), dtype=torch.int32, device=cuda)
    before = bloom_cuda.LAUNCHES
    bloom.bloom_scatter(got, kt, gt, ot, mt, kst, 3)
    torch.cuda.synchronize()
    assert bloom_cuda.LAUNCHES == before + 1
    want = torch.zeros_like(got)
    bloom.bloom_scatter_plain(want, kt, gt, ot, mt, kst, 3)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.cpu().numpy().view(np.uint32),
        _bloom_host_words(keys, gid, [0], [m], [k], 3, m))


def test_bloom_kernel_matches_plain_fused_high_offsets(cuda):
    """Three groups in one arena of 2^31 - 32 bits: k 1 at offset 0, k
    16 just above 2^30 bits, and a 2^20-bit group at the arena's end.
    Word indices past 2^25 (bit offsets past 2^30) must land where the
    host arithmetic puts them."""
    from ct_mapreduce_tpu_torch.ops import bloom

    total = (1 << 31) - 32
    ms = np.array([1024, 4096, 1 << 20], np.int64)
    ks = np.array([1, 16, 7], np.int64)
    offs = np.array([0, (1 << 30) + 64, total - (1 << 20)], np.int64)
    rng = np.random.default_rng(12)
    n = (1 << 18) + 3
    keys = rng.integers(0, 2**32, (n, 4), np.uint32)
    gid = rng.integers(0, 3, n).astype(np.int32)
    kt, gt, ot, mt, kst = _bloom_args(cuda, keys, gid, offs, ms, ks)
    got = torch.zeros((total // 32,), dtype=torch.int32, device=cuda)
    bloom.bloom_scatter(got, kt, gt, ot, mt, kst, 5)
    torch.cuda.synchronize()
    want = torch.zeros_like(got)
    bloom.bloom_scatter_plain(want, kt, gt, ot, mt, kst, 5)
    assert torch.equal(got, want)
    host = _bloom_host_words(keys, gid, offs, ms, ks, 5, total)
    got_np = got.cpu().numpy().view(np.uint32)
    for g in range(3):
        w0, w1 = int(offs[g]) // 32, int(offs[g] + ms[g]) // 32
        np.testing.assert_array_equal(got_np[w0:w1], host[w0:w1])
    assert int(np.count_nonzero(got_np)) == int(np.count_nonzero(host))
    # A second dispatch into the same (now non-zero) arena, its lanes in
    # shuffled group order: the kernel's owners load what is there.
    keys2 = rng.integers(0, 2**32, (4097, 4), np.uint32)
    gid2 = rng.permutation(np.arange(4097) % 3).astype(np.int32)
    k2, g2, _o, _m, _k = _bloom_args(cuda, keys2, gid2, offs, ms, ks)
    bloom.bloom_scatter(got, k2, g2, ot, mt, kst, 6)
    bloom.bloom_scatter_plain(want, k2, g2, ot, mt, kst, 6)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _k5_case(name: str, rng):
    """(keys, gid, offs, ms, ks, arena words, dispatches) of a K5 edge
    case: uint32 keys, int32 gid, the group vectors, a uint32 arena to
    start from (non-zero in some cases) and the lane cuts of its
    dispatches into that one arena."""
    from ct_mapreduce_tpu_torch.filter.cascade import layer_params

    region = 1 << 18  # the kernel's least region (ops/bloom.py)
    if name == "spanning_and_shared":
        # one group over four regions, then 40 small groups in one region
        ms = np.array([3 * region + 96] + [2048] * 40, np.int64)
        ks = np.array([7] + [3] * 40, np.int64)
        n = 60_000
        gid = np.where(np.arange(n) < 40_000, 0,
                       1 + np.arange(n) % 40).astype(np.int32)
    elif name in ("k1_k16_m64", "n1", "n255", "n257"):
        # the last two groups start off a word boundary
        ms = np.array([64, 4096, 64, 1 << 20, 100, 28], np.int64)
        ks = np.array([16, 1, 1, 16, 5, 2], np.int64)
        n = {"n1": 1, "n255": 255, "n257": 257}.get(name, 70_001)
        gid = rng.integers(0, 6, n).astype(np.int32)
    elif name == "dense_region":
        # one region, many work items of one group
        ms, ks, n = np.array([1 << 17], np.int64), np.array([7], np.int64), 1 << 16
        gid = np.zeros((n,), np.int32)
    else:  # "zipf_shuffled", "zipf_two_dispatches"
        sizes = rng.multinomial(200_000 - 300, np.full(300, 1 / 300)) + 1
        params = np.array([layer_params(int(c), 0.01) for c in sizes])
        ms, ks, n = params[:, 0], params[:, 1], 200_000
        gid = np.repeat(np.arange(300), sizes).astype(np.int32)
        if name == "zipf_shuffled":
            gid = rng.permutation(gid)
    offs = np.concatenate(([0], np.cumsum(ms)[:-1]))
    words = np.zeros((int(ms.sum()) // 32,), np.uint32)
    if name in ("zipf_two_dispatches", "spanning_and_shared", "n257"):
        words = (rng.integers(0, 2**32, words.shape, np.uint32)
                 * (rng.random(words.shape) < 0.05)).astype(np.uint32)
    cuts = [0, n // 2, n] if name == "zipf_two_dispatches" else [0, n]
    keys = rng.integers(0, 2**32, (n, 4), np.uint32)
    return keys, gid, offs, ms, ks, words, cuts


K5_CASES = ["spanning_and_shared", "k1_k16_m64", "n1", "n255", "n257",
            "dense_region", "zipf_shuffled", "zipf_two_dispatches"]


@pytest.mark.parametrize("case", K5_CASES)
def test_bloom_kernel_edge_cases_match_plain(cuda, case):
    """K5 against its plain version (and the NumPy model of its
    schedule) on arenas non-zero on entry, several dispatches into one
    arena, shuffled gid, groups over several regions and regions shared
    by many groups, k 1 and 16, m 64, n 1 / 255 / 257."""
    from ct_mapreduce_tpu_torch.ops import bloom, bloom_cuda

    rng = np.random.default_rng(K5_CASES.index(case) + 40)
    keys, gid, offs, ms, ks, words, cuts = _k5_case(case, rng)
    got = torch.from_numpy(words.view(np.int32).copy()).to(cuda)
    want = got.clone()
    model = words.copy()
    before = bloom_cuda.LAUNCHES
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        kt, gt, ot, mt, kst = _bloom_args(cuda, keys[lo:hi], gid[lo:hi],
                                          offs, ms, ks)
        bloom.bloom_scatter(got, kt, gt, ot, mt, kst, 9,
                            kmax=int(ks.max()) if lo else None)
        bloom.bloom_scatter_plain(want, kt, gt, ot, mt, kst, 9)
        bloom.binned_model(model, keys[lo:hi], gid[lo:hi], offs, ms, ks, 9)
    torch.cuda.synchronize()
    assert bloom_cuda.LAUNCHES == before + len(cuts) - 1
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), model)


@pytest.mark.parametrize("arena_bits", [1 << 22, 161 << 20, 1 << 29, 9 << 26])
def test_bloom_kernel_schedules_match_plain(cuda, arena_bits):
    """K5 over arenas of 16, 644 and 2,048 regions of 2^18 bits and of
    1,152 of 2^19 (past 2^29 bits the region grows): 300 groups spread
    over the arena, lanes in random group order, so that past 256
    regions every tile spans most of them; and each prefix of its
    phases: only the whole launch writes, and the same words."""
    from ct_mapreduce_tpu_torch.ops import bloom, bloom_cuda

    rng = np.random.default_rng(arena_bits % 1000)
    ms = np.full(300, (arena_bits // 300) & ~31, np.int64)
    ks = rng.integers(1, 17, 300)
    n = 200_000
    gid = rng.integers(0, 300, n).astype(np.int32)
    offs = np.concatenate(([0], np.cumsum(ms)[:-1]))
    keys = rng.integers(0, 2**32, (n, 4), np.uint32)
    kt, gt, ot, mt, kst = _bloom_args(cuda, keys, gid, offs, ms, ks)
    want = torch.zeros((int(ms.sum()) // 32,), dtype=torch.int32,
                       device=cuda)
    bloom.bloom_scatter_plain(want, kt, gt, ot, mt, kst, 2)
    for phases in range(len(bloom_cuda.PHASES) + 1):
        got = torch.zeros_like(want)
        bloom_cuda.scatter_phases(got, kt, gt, ot, mt, kst, 2,
                                  phases=phases)
        torch.cuda.synchronize()
        if phases == len(bloom_cuda.PHASES):
            assert torch.equal(got, want)
        else:
            assert not got.any()  # only the owner pass writes the arena


_SHORT_KMAX = """
import torch
from ct_mapreduce_tpu_torch.ops import bloom_cuda
dev = torch.device("cuda")
keys = torch.arange(1024, dtype=torch.int32, device=dev).view(256, 4)
gid = torch.zeros((256,), dtype=torch.int32, device=dev)
words = torch.zeros((64,), dtype=torch.int32, device=dev)
offs = torch.zeros((1,), dtype=torch.int64, device=dev)
ms = torch.tensor([2048], dtype=torch.int32, device=dev)
ks = torch.tensor([5], dtype=torch.int32, device=dev)
bloom_cuda.scatter(words, keys, gid, offs, ms, ks, 0, kmax=5)
torch.cuda.synchronize()
print("kmax 5:", int(torch.count_nonzero(words)) > 0, flush=True)
bloom_cuda.scatter(words, keys, gid, offs, ms, ks, 0, kmax=4)
torch.cuda.synchronize()
print("kmax 4: no trap", flush=True)
"""


def test_bloom_kernel_traps_a_short_kmax(cuda):
    """A kmax below a group's k traps K5 before it writes anything: the
    launch fails, raised at the next synchronising call. In a process of
    its own, since a trap ends that process's CUDA context."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _SHORT_KMAX], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert "kmax 5: True" in res.stdout, res.stdout + res.stderr
    assert "no trap" not in res.stdout
    assert res.returncode != 0


def test_bloom_kernel_checks_its_inputs(cuda):
    from ct_mapreduce_tpu_torch.ops import bloom_cuda

    keys = np.zeros((8, 4), np.uint32)
    kt, gt, ot, mt, kst = _bloom_args(
        cuda, keys, np.zeros((8,), np.int32), [0], [64], [2])
    words = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        bloom_cuda.scatter(words.cpu(), kt, gt, ot, mt, kst, 0)
    with pytest.raises(TypeError):
        bloom_cuda.scatter(words, kt.to(torch.int64), gt, ot, mt, kst, 0)
    flat = torch.zeros((8 * 4 + 1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        bloom_cuda.scatter(words, flat[1:].view(8, 4), gt, ot, mt, kst, 0)
    with pytest.raises(ValueError, match="kmax"):
        bloom_cuda.scatter(words, kt, gt, ot, mt, kst, 0, kmax=33)
    with pytest.raises(ValueError, match="phases"):
        bloom_cuda.scatter_phases(words, kt, gt, ot, mt, kst, 0, phases=6)


@pytest.mark.parametrize("fmt", ["fl01", "fl02"])
def test_filter_build_on_card_matches_cpu(cuda, fmt):
    """A corpus past DEVICE_BUILD_MIN through the streamed, fused build:
    K1 and K5 on the card give the bytes of the CPU's plain lane and of
    the host NumPy lane, per group and fused."""
    from ct_mapreduce_tpu_torch.filter import build_artifact
    from ct_mapreduce_tpu_torch.ops import bloom_cuda

    rng = np.random.default_rng(13)
    state = {}
    for g in range(6):
        n = 6000 if g < 2 else int(rng.integers(10, 900))
        serials = {rng.integers(0, 256, int(rng.integers(3, 21)),
                                dtype=np.uint8).tobytes() for _ in range(n)}
        if g == 1:
            serials.add(b"\x07" * 60)  # the oversized host lane
        state[(f"card-issuer-{g % 4}", 500_000 + 24 * g)] = serials
    host = build_artifact(state, fp_rate=0.01, use_device=False,
                          fmt=fmt).to_bytes()
    k1, k5 = sha256_cuda.LAUNCHES, bloom_cuda.LAUNCHES
    card = build_artifact(state, fp_rate=0.01, device=cuda, fmt=fmt,
                          fused_lanes=4096).to_bytes()
    assert sha256_cuda.LAUNCHES > k1 and bloom_cuda.LAUNCHES > k5
    per_group = build_artifact(state, fp_rate=0.01, use_device=True,
                               device=cuda, fmt=fmt, fused=False).to_bytes()
    cpu = build_artifact(state, fp_rate=0.01, use_device=True,
                         device="cpu", fmt=fmt).to_bytes()
    assert card == host == per_group == cpu


# -- K6, the ECDSA verify -------------------------------------------------

def _k6_case(curve: str, window: int, n: int, device, seed: int = 5):
    """``n`` lanes of chip_smoke.py's phase 13 corpus (about 80% valid
    signatures under 4 keys, the rest mutated or padding) on ``device``,
    with the G table and Q-table slots of ``window``. Returns (ops, row
    tensors, valid, key_idx, gtab, qtab) and the lanes as ints."""
    import chip_smoke

    from ct_mapreduce_tpu_torch.ops import ecdsa

    ops = ecdsa.CURVE_OPS[curve]
    rows, valid, key_idx, keys, lanes = chip_smoke.k6_corpus(ops.curve, n,
                                                             seed)
    gtab = qtab = None
    if window:
        gtab, _ = ecdsa.fixed_base_table(ops, window, device)
        qtab = ecdsa.zero_qtable(32, ops.nbits // window, 1 << window,
                                 ops.mod_p.nlimb, device)
        for slot, (x, y) in enumerate(keys):
            ecdsa.qtable_slot_set(qtab, slot, ecdsa.point_table_cached(
                ops, window, x, y)[0])
    args = [torch.from_numpy(a).to(device) for a in rows]
    return (ops, args, torch.from_numpy(valid).to(device),
            torch.from_numpy(key_idx).to(device), gtab, qtab), lanes


def _k6(case, plain: bool):
    from ct_mapreduce_tpu_torch.ops import ecdsa, ecdsa_cuda

    ops, args, valid, key_idx, gtab, qtab = case
    if gtab is None:
        fn = ecdsa._verify_jacobian if plain else ecdsa_cuda.verify_jacobian
        return fn(ops, *args, valid)
    fn = ecdsa._verify_windowed if plain else ecdsa_cuda.verify_windowed
    return fn(ops, *args, valid, key_idx, gtab, qtab)


@pytest.mark.parametrize("curve", ["p256", "p384"])
@pytest.mark.parametrize("window", [0, 2, 4, 8])
def test_ecdsa_kernel_matches_plain(cuda, curve, window):
    """K6 against its plain version at the lane's width (1,024), verdict
    for verdict, and a sample against verify_ecdsa."""
    from ct_mapreduce_tpu_torch.ops import ecdsa_cuda
    from ct_mapreduce_tpu_torch.verify import host

    case, lanes = _k6_case(curve, window, 1024, cuda)
    before = ecdsa_cuda.LAUNCHES
    got = _k6(case, False)
    torch.cuda.synchronize()
    assert ecdsa_cuda.LAUNCHES == before + 1
    want = _k6(case, True)
    assert torch.equal(got, want)
    assert 0.6 < float(got.float().mean()) < 0.9
    c = case[0].curve
    lim = 1 << (8 * c.byte_len)
    for i, (kind, dg, r, s, x, y) in enumerate(lanes[:8]):
        assert bool(got[i]) == (kind != 9 and host.verify_ecdsa(
            c, dg, r % lim, s % lim, x % lim, y % lim)), i


@pytest.mark.parametrize("window", [0, 8])
def test_ecdsa_kernel_widths(cuda, window):
    """The same lanes at widths 32, 1,024 and 2^16 (P-256): each
    launch's verdicts are the prefix of the plain version's on 2^16."""
    wide, _ = _k6_case("p256", window, 1 << 16, cuda)
    want = _k6(wide, True)
    for n in (32, 1024, 1 << 16):
        ops, args, valid, key_idx, gtab, qtab = wide
        case = (ops, [a[:n] for a in args], valid[:n], key_idx[:n], gtab,
                qtab)
        assert torch.equal(_k6(case, False), want[:n]), n


@pytest.mark.parametrize("curve", ["p256", "p384"])
@pytest.mark.parametrize("window", [0, 8])
def test_ecdsa_kernel_widths_that_cut_a_group_or_block(cuda, curve, window):
    """Widths that end inside a thread group or a block of K6 (1, 3, 31,
    127, 129, 1,023, 1,025): each launch's verdicts are the prefix of
    the plain version's on 1,025 lanes."""
    wide, _ = _k6_case(curve, window, 1025, cuda, seed=11)
    want = _k6(wide, True)
    ops, args, valid, key_idx, gtab, qtab = wide
    for n in (1, 3, 31, 127, 129, 1023, 1025):
        case = (ops, [a[:n] for a in args], valid[:n], key_idx[:n], gtab,
                qtab)
        assert torch.equal(_k6(case, False), want[:n]), n


@pytest.mark.parametrize("curve", ["p256", "p384"])
@pytest.mark.parametrize("window", [0, 8])
def test_ecdsa_kernel_edge_blocks(cuda, curve, window):
    """chip_smoke.py's edge lanes, in runs of K6's widest block: every
    lane failing a check; one good lane among s = 0, r = n and off-curve
    lanes; results at infinity (Q = G, r = -e mod n) between good lanes;
    Q = G with r = e (u1 G = u2 Q). K6 == the plain version ==
    verify_ecdsa, and each run alone gives its lanes the same
    verdicts."""
    import chip_smoke

    from ct_mapreduce_tpu_torch.ops import ecdsa, ecdsa_cuda
    from ct_mapreduce_tpu_torch.verify import host

    ops = ecdsa.CURVE_OPS[curve]
    c = ops.curve
    rows, valid, key_idx, keys, lanes = chip_smoke.k6_edge_corpus(c, 3)
    gtab = qtab = None
    if window:
        gtab, _ = ecdsa.fixed_base_table(ops, window, cuda)
        qtab = ecdsa.zero_qtable(len(keys), ops.nbits // window, 1 << window,
                                 ops.mod_p.nlimb, cuda)
        for slot, (x, y) in enumerate(keys):
            ecdsa.qtable_slot_set(qtab, slot, ecdsa.point_table_cached(
                ops, window, x, y)[0])
    case = (ops, [torch.from_numpy(a).to(cuda) for a in rows],
            torch.from_numpy(valid).to(cuda),
            torch.from_numpy(key_idx).to(cuda), gtab, qtab)
    got = _k6(case, False)
    assert torch.equal(got, _k6(case, True))
    lim = 1 << (8 * c.byte_len)
    truth = [bool(v) and host.verify_ecdsa(c, dg, r % lim, s % lim, x % lim,
                                           y % lim)
             for v, (_k, dg, r, s, x, y) in zip(valid, lanes)]
    assert got.cpu().tolist() == truth
    b = max(ecdsa_cuda.block_lanes(w) for w in (8, 0))
    assert not any(truth[:b]) and sum(truth[b:2 * b]) == 1
    ops_, args, v, k, gtab, qtab = case
    for lo in range(0, len(lanes), b):
        part = (ops_, [a[lo:lo + b] for a in args], v[lo:lo + b],
                k[lo:lo + b], gtab, qtab)
        assert torch.equal(_k6(part, False), got[lo:lo + b]), lo


@pytest.mark.parametrize("curve", ["p256", "p384"])
@pytest.mark.parametrize("window", [0, 8])
def test_ecdsa_kernel_bad_lane_never_moves_a_neighbour(cuda, curve, window):
    """Adversarial lanes (r, s = 0 or n, off-curve and out-of-range keys,
    a result at infinity's inputs, padding) between valid ones: every
    valid lane's verdict equals the one it gets with the adversarial
    lanes made padding."""
    case, lanes = _k6_case(curve, window, 1024, cuda, seed=9)
    mixed = _k6(case, False)
    ops, args, valid, key_idx, gtab, qtab = case
    kinds = torch.tensor([k for k, *_ in lanes], device=cuda)
    clean_valid = valid & (kinds == 0)
    alone = _k6((ops, args, clean_valid, key_idx, gtab, qtab), False)
    assert torch.equal(mixed[kinds == 0], alone[kinds == 0])
    assert not alone[kinds != 0].any()
    assert mixed[kinds == 0].all()


def test_ecdsa_kernel_checks_its_inputs(cuda):
    from ct_mapreduce_tpu_torch.ops import ecdsa, ecdsa_cuda

    (ops, args, valid, key_idx, gtab, qtab), _ = _k6_case("p256", 8, 64,
                                                          cuda)
    before = ecdsa_cuda.LAUNCHES
    empty = ecdsa_cuda.verify_windowed(ops, *[a[:0] for a in args],
                                       valid[:0], key_idx[:0], gtab, qtab)
    assert empty.shape == (0,) and ecdsa_cuda.LAUNCHES == before
    with pytest.raises(TypeError):
        ecdsa_cuda.verify_jacobian(ops, *args, valid.to(torch.uint8))
    with pytest.raises(ValueError, match="shape"):
        ecdsa_cuda.verify_jacobian(ops, args[0][:, :16], *args[1:], valid)
    with pytest.raises(ValueError):
        ecdsa_cuda.verify_windowed(ops, *args, valid, key_idx, gtab.cpu(),
                                   qtab)
    with pytest.raises(ValueError, match="CUDA"):
        ecdsa_cuda.verify_jacobian(ops, *[a.cpu() for a in args],
                                   valid.cpu())
    # The dispatch launches the kernel for CUDA tensors.
    ecdsa.verify_jacobian(ops, *args, valid)
    assert ecdsa_cuda.LAUNCHES == before + 1


def test_verify_lane_on_card_matches_cpu(cuda):
    """The verify lane on a CUDA aggregator (K6, tables on the card) and
    on a CPU one (the plain versions) over the same SCT rows: equal
    stats and per-issuer vectors, K6 launched."""
    import datetime

    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.ops import ecdsa_cuda
    from ct_mapreduce_tpu_torch.utils import minicert
    from ct_mapreduce_tpu_torch.verify import host, lane, sct

    future = datetime.datetime(2031, 6, 15, tzinfo=datetime.timezone.utc)
    signers = [sct.EcSctSigner("card-a"), sct.EcSctSigner("card-b", host.P384),
               sct.RsaSctSigner()]
    certs = []
    for i in range(12):
        base = minicert.make_cert(serial=100 + i, issuer_cn="Card CA",
                                  subject_cn=f"c{i}", not_after=future)
        certs.append(sct.attach_sct(base, signers[i % 3], 10**12 + i,
                                    corrupt_signature=i % 4 == 1))
    pad = max(len(c) for c in certs) + 16
    data = np.zeros((len(certs), pad), np.uint8)
    length = np.zeros((len(certs),), np.int32)
    for i, c in enumerate(certs):
        data[i, : len(c)] = np.frombuffer(c, np.uint8)
        length[i] = len(c)
    scts = sct.extract_scts_np(data, length)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        agg = TorchAggregator(capacity=1 << 10, device=dev)
        for window in (8, 0):
            v = lane.SignatureVerifier(agg, batch_width=32, window=window)
            for sg in signers:
                v.keys.register_signer(sg)
            before = ecdsa_cuda.LAUNCHES
            v.submit_chunk(scts, np.arange(len(certs)) % 2,
                           np.ones((len(certs),), bool), data, length)
            v.drain()
            if dev.type == "cuda":
                assert ecdsa_cuda.LAUNCHES > before
            out[(dev.type, window)] = dict(v.stats)
        out[dev.type] = (agg.verify_verified.copy(), agg.verify_failed.copy())
    for window in (8, 0):
        assert out[("cuda", window)] == out[("cpu", window)]
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    assert out[("cuda", 8)]["verified"] == 9 and out[("cuda", 8)]["failed"] == 3


@pytest.mark.parametrize("layout", ["bucket", "open"])
def test_sharded_step_on_card_matches_cpu(cuda, layout, monkeypatch):
    """The sharded step (the walker lane's K3 and K1 once a device, the
    K7 dispatch and exchange, each shard's insert) on a mesh of four
    shards over the card against the same mesh over the CPU: every
    output, every shard's rows and the drain. Tolerance: exact
    equality."""
    from ct_mapreduce_tpu_torch.agg.sharded import ShardedDedup, mesh_capacity
    from ct_mapreduce_tpu_torch.parallel import make_mesh
    from ct_mapreduce_tpu_torch.utils import syncerts

    monkeypatch.setenv("CTMR_TABLE", layout)
    here = torch.device("cuda", torch.cuda.current_device())
    tpls = [syncerts.make_template(issuer_cn=f"Card Mesh CA {i}",
                                   serial_len=9 + i) for i in range(3)]
    rng = np.random.default_rng(4)
    n = 1024
    tof = rng.integers(0, 3, n)
    ctr = rng.integers(1, 700, n)  # replays within and across steps
    data = np.zeros((n, 1024), np.uint8)
    length = np.zeros((n,), np.int32)
    for i in range(n):
        der = syncerts.stamp_serial(tpls[tof[i]], int(ctr[i]))
        data[i, : len(der)] = np.frombuffer(der, np.uint8)
        length[i] = len(der)
    issuer = tof.astype(np.int32)
    valid = rng.random(n) > 0.03
    now_hour = 480_000
    outs = {}
    for dev in (here, torch.device("cpu")):
        d = ShardedDedup(make_mesh("shard:4", [dev] * 4),
                         capacity=mesh_capacity(4, 24 * 64, layout),
                         max_probes=8, dispatch_factor=0.5)
        steps = [d.step(data[k::2], length[k::2], issuer[k::2], valid[k::2],
                        now_hour) for k in (0, 1)]
        outs[dev.type] = (steps, d.host_rows(), d.drain_np(), d.counts())
    (s_card, r_card, dr_card, c_card) = outs["cuda"]
    (s_cpu, r_cpu, dr_cpu, c_cpu) = outs["cpu"]
    for a, b in zip(s_card, s_cpu):
        for name, x, y in zip(a._fields, a, b):
            assert x.device.type == "cuda", name
            assert torch.equal(x.cpu(), y), name
    np.testing.assert_array_equal(r_card, r_cpu)
    np.testing.assert_array_equal(c_card, c_cpu)
    for x, y in zip(dr_card, dr_cpu):
        np.testing.assert_array_equal(x, y)
