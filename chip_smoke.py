#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full size, one card, a few minutes
    python3 chip_smoke.py --profile DIR   # plus a torch.profiler pass
    python3 chip_smoke.py --sass DIR      # plus the kernel's ptxas/SASS report

The port is ``ct_mapreduce_tpu_torch``, imported from this checkout.

Phases, none of them caught — any failure exits non-zero:

1. card: name and power limit (``nvidia-smi``), then the fingerprint
   kernel (``nvcc`` for sm_90a) and the native sidecar decoder (``g++``)
   built from this checkout, in parallel;
2. the fingerprint kernel against its plain PyTorch version on 2^20
   lanes (bit for bit), a sample against ``hashlib`` and the host
   fingerprint, both timed with CUDA events;
3. the main path through ``IngestModel`` at ``batchSize`` 2^20 from the
   shipped ``tableBits`` 22: 16 issuers split by Zipf(1.1), EC and
   RSA-sized leaves with the rich extension load, serial lengths 8..20,
   about half the entries replaying an earlier serial, a few percent
   expired leaves and CA certificates; enough batches for a table grow.
   ``drain()`` and every batch's per-lane ``was_unknown`` are held to an
   exact host oracle;
4. a 2 GiB table (``tableBits`` 26, 2^22 buckets) prefilled to about 50%
   of its slots with random keys through the port's insert, then one
   main-path batch on top; ``was_unknown`` against the oracle and
   ``contains`` over every inserted key.

The kernel launch count is set to 0 just before each main-path run and
read just after it. Prints the card line, a ``{"kernels": [...]}`` line,
and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet / Hopper white paper):
# HBM3 rate; 32-bit integer operations on the INT32 (ALU) pipe, 132 SMs
# x 64 lanes x 1.98 GHz boost clock; and instruction issue, 132 SMs x
# 4 schedulers x 32 lanes x 1.98 GHz (the data sheet's 67 TFLOP/s
# float32 over 2 flops per FMA), which caps the ALU and FMA pipes
# together.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
DISPATCH_OPS_PER_S = 132 * 128 * 1.98e9

BATCH_LOG2 = 20  # batchSize 2^20, the JAX package's headline batch
MAIN_BATCHES = 10  # enough for the shipped tableBits 22 to grow once
TABLE_BITS = 22  # the shipped default
BIG_TABLE_BITS = 26  # 2^22 buckets: 2 GiB of rows
TIMED_REPS = 25  # CUDA-event timings per turn (two turns each)
KERNEL_CALLS_PER_TIMING = 20  # back-to-back launches between two events


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def build_all() -> dict:
    """Build the fingerprint kernel and the native decoder at once."""
    from ct_mapreduce_tpu_torch import native
    from ct_mapreduce_tpu_torch.ops import sha256_cuda

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        k1 = pool.submit(timed, sha256_cuda.build)
        nat = pool.submit(timed, native.load)
        so, k1_s = k1.result()
        lib, nat_s = nat.result()
    check(lib is not None, "the native sidecar decoder did not build")
    return {"k1_so": so, "k1_build_s": k1_s, "native_build_s": nat_s}


def cuda_times(fn, reps: int, calls: int = 1,
               warmup: int = 3) -> list[float]:
    """``reps`` CUDA-event timings of ``fn()`` in milliseconds, each the
    mean of ``calls`` back-to-back calls between one pair of events, so
    that the host's time between launches hides behind the card's
    work."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


def median(xs: list[float]) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def sass_report(out_dir: str) -> dict:
    """Registers and spills of the fingerprint kernel (``nvcc`` with
    ``-Xptxas -v``, the library's own flags) and its SASS instructions
    by opcode (``cuobjdump -sass``); both outputs go to ``out_dir``."""
    import collections
    import re

    from ct_mapreduce_tpu_torch.ops import sha256_cuda

    os.makedirs(out_dir, exist_ok=True)
    nvcc = sha256_cuda._nvcc()
    so = os.path.join(out_dir, "sha256_fp_ptxas.so")
    res = subprocess.run(
        [nvcc, *sha256_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
         sha256_cuda._SRC],
        capture_output=True, text=True, timeout=600, check=True)
    ptxas = res.stdout + res.stderr
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", so],
        capture_output=True, text=True, timeout=120, check=True).stdout
    for name, text in (("ptxas.txt", ptxas), ("sass.txt", sass)):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(text)
    ops = collections.Counter(m.group(1).split(".")[0] for m in re.finditer(
        r"^\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)",
        sass, re.M))
    regs = re.search(r"Used (\d+) registers", ptxas)
    spills = re.search(r"(\d+) bytes spill stores", ptxas)
    out = {"registers": int(regs.group(1)) if regs else None,
           "spill_store_bytes": int(spills.group(1)) if spills else None,
           "instructions": sum(ops.values()),
           "by_opcode": dict(ops.most_common())}
    print(f"sass: {out['registers']} registers, {out['spill_store_bytes']} "
          f"B spilled, {out['instructions']} instructions; "
          f"{dict(ops.most_common(8))}", flush=True)
    return out


# -- phase 2: the kernel against its plain version ----------------------

def kernel_check(device, n: int, seed: int, reps: int) -> dict:
    import numpy as np
    import torch

    from ct_mapreduce_tpu_torch.core import packing
    from ct_mapreduce_tpu_torch.ops import sha256, sha256_cuda

    rng = np.random.default_rng(seed)
    slen = rng.integers(0, packing.MAX_SERIAL_BYTES + 1, n).astype(np.int32)
    ser = rng.integers(0, 256, (n, packing.MAX_SERIAL_BYTES), dtype=np.uint8)
    ser[np.arange(packing.MAX_SERIAL_BYTES)[None, :] >= slen[:, None]] = 0
    ii = rng.integers(0, packing.MAX_ISSUERS, n).astype(np.int32)
    eh = rng.integers(packing.DEFAULT_BASE_HOUR,
                      packing.DEFAULT_BASE_HOUR + packing.META_HOUR_SPAN,
                      n).astype(np.int32)
    args = [torch.from_numpy(a).to(device) for a in (ii, eh, ser, slen)]

    got = sha256_cuda.fingerprint64(*args)
    ref = sha256.fingerprints_plain(*args)
    torch.cuda.synchronize()
    diff = (got.to(torch.int64) & 0xFFFFFFFF) - (ref.to(torch.int64) & 0xFFFFFFFF)
    max_abs_err = int(diff.abs().max())
    check(torch.equal(got, ref),
          f"kernel != plain version on {n} lanes (max abs err {max_abs_err})")
    sample = slice(0, min(n, 4096))
    got_np = got[sample].cpu().numpy().view(np.uint32)
    check(np.array_equal(got_np, packing.fingerprints_np(
        ii[sample], eh[sample], ser[sample], slen[sample])),
        "kernel != host fingerprints_np")
    for i in range(0, got_np.shape[0], 16):
        msg = packing.fingerprint_message(
            int(ii[i]), int(eh[i]), ser[i, : slen[i]].tobytes())
        want = hashlib.sha256(msg).digest()[16:]
        check(got_np[i].astype(">u4").tobytes() == want,
              f"kernel != hashlib at lane {i}")

    kernel_ms, plain_ms = [], []
    for _ in range(2):  # in turns: kernel, plain, kernel, plain
        kernel_ms += cuda_times(lambda: sha256_cuda.fingerprint64(*args),
                                reps, KERNEL_CALLS_PER_TIMING)
        plain_ms += cuda_times(lambda: sha256.fingerprints_plain(*args), reps)
    k_ms = median(kernel_ms)
    p_ms = median(plain_ms)
    bytes_moved = n * (4 + 4 + packing.MAX_SERIAL_BYTES + 4 + 16)
    byte_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    # Shifts and logic must use the INT32 pipe; adds may also go to the
    # FMA pipe as IMAD, so all ops together are held to the issue rate.
    int_pipe_ms = n * sha256.INT_PIPE_OPS_PER_LANE / INT32_OPS_PER_S * 1e3
    dispatch_ms = n * sha256.OPS_PER_LANE / DISPATCH_OPS_PER_S * 1e3
    op_ms = max(int_pipe_ms, dispatch_ms)
    bound_ms = max(byte_ms, op_ms)
    out = {
        "lanes": n, "max_abs_err": max_abs_err, "match": True,
        "kernel_ms": k_ms, "plain_ms": p_ms, "timings": 2 * reps,
        "kernel_calls_per_timing": KERNEL_CALLS_PER_TIMING,
        "kernel_ms_min": min(kernel_ms), "kernel_ms_max": max(kernel_ms),
        "plain_ms_min": min(plain_ms), "plain_ms_max": max(plain_ms),
        "bound_ms": bound_ms,
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "bytes_bound_ms": byte_ms, "int_pipe_bound_ms": int_pipe_ms,
        "dispatch_bound_ms": dispatch_ms,
        "share_of_bound": bound_ms / k_ms,
    }
    print(f"phase 2: fingerprint kernel == plain on {n} lanes; kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({out['bound_by']}), {out['share_of_bound']:.1%} of bound",
          flush=True)
    return out


# -- the synthetic CT stream -------------------------------------------

def _counter_tail(counters, serial_len):
    """The serial counter, big-endian, in the last bytes of each serial
    (byte 0 stays the template's positive 0x4D): yields, for the i-th
    byte from the end, the lanes with room for it, its position in the
    serial, and its value."""
    import numpy as np

    for i in range(8):
        yield (i < serial_len - 1, serial_len - 1 - i,
               ((counters >> (8 * i)) & 0xFF).astype(np.uint8))


class Stream:
    """Leaf rows from per-issuer templates, stamped with serials from a
    global counter. A replay repeats an earlier (template, counter) —
    the precertificate and final certificate a log carries under one
    serial — so the truth of every lane is known by construction."""

    N_ISSUERS = 16
    PAD = 2048

    def __init__(self, seed: int) -> None:
        import numpy as np

        from ct_mapreduce_tpu_torch.core import der
        from ct_mapreduce_tpu_torch.core.types import Issuer
        from ct_mapreduce_tpu_torch.utils import syncerts

        utc = datetime.timezone.utc
        self.rng = np.random.default_rng(seed)
        tpls = []
        for i in range(self.N_ISSUERS):
            tpls.append(syncerts.make_template(
                issuer_cn=f"Smoke Issuer {i:02d} CA",
                not_after=datetime.datetime(2027, 1, 1, tzinfo=utc)
                + datetime.timedelta(days=61 * i, hours=7 * i),
                crl_dp=f"http://crl{i}.smoke.example/ca{i}.crl",
                key_type="rsa2048" if i % 2 else "ec",
                serial_len=8 + (12 * i) // (self.N_ISSUERS - 1),
                rich_extensions=True))
        # An expired leaf under issuer 0, and a CA certificate (issuer
        # 1's own certificate, stamped like a leaf): both filtered.
        tpls.append(syncerts.make_template(
            issuer_cn="Smoke Issuer 00 CA",
            not_after=datetime.datetime(2020, 6, 1, tzinfo=utc),
            crl_dp="http://crl0.smoke.example/ca0.crl", serial_len=12,
            rich_extensions=True))
        ca = der.parse_cert(tpls[1].issuer_der)
        tpls.append(syncerts.CertTemplate(
            leaf_der=tpls[1].issuer_der, issuer_der=tpls[1].issuer_der,
            serial_off=ca.serial_off, serial_len=ca.serial_len))
        self.templates = tpls
        self.filtered = np.zeros(len(tpls), bool)
        self.filtered[self.N_ISSUERS:] = True
        w = syncerts.zipf_weights(self.N_ISSUERS, 1.1) * 0.95
        self.weights = np.concatenate([w, [0.03, 0.02]])
        self.rows = np.zeros((len(tpls), self.PAD), np.uint8)
        self.lens = np.zeros(len(tpls), np.int32)
        for i, t in enumerate(tpls):
            raw = np.frombuffer(t.leaf_der, np.uint8)
            self.rows[i, : raw.size] = raw
            self.lens[i] = raw.size
        self.ser_off = np.array([t.serial_off for t in tpls], np.int64)
        self.ser_len = np.array([t.serial_len for t in tpls], np.int64)
        # Host truth per template: issuer id, expDate hour, DN, CRL.
        self.truth = []
        for t in tpls:
            leaf = der.parse_cert(t.leaf_der)
            iss = der.parse_cert(t.issuer_der)
            self.truth.append({
                "issuer": Issuer.from_spki(iss.spki).id(),
                "hour": leaf.not_after_unix_hour,
                "dn": leaf.issuer_dn,
                "crls": set(leaf.crl_distribution_points),
            })
        self.next_counter = 1
        self.template_of = np.zeros((1,), np.int32)  # by counter

    def issuer_indices(self, model):
        """Registry index of each template's issuer in ``model``."""
        import numpy as np

        reg = model.aggregator.registry
        return np.array([reg.get_or_assign(t.issuer_der)
                         for t in self.templates], np.int32)

    def serial_bytes(self, tof, counters):
        """The stamped serials of (template, counter) lanes, as
        ``uint8[n, 46]`` zero-padded bytes and ``int32[n]`` lengths."""
        import numpy as np

        from ct_mapreduce_tpu_torch.core.packing import MAX_SERIAL_BYTES

        ln = self.ser_len[tof]
        out = np.zeros((len(tof), MAX_SERIAL_BYTES), np.uint8)
        out[:, 0] = 0x4D
        lanes = np.arange(len(tof))
        for ok, pos, byte in _counter_tail(counters, ln):
            out[lanes[ok], pos[ok]] = byte[ok]
        return out, ln.astype(np.int32)

    def batch(self, n: int, replay: float, within_batch_only: bool = False):
        """``n`` lanes; a ``replay`` share repeats an earlier serial
        (from any earlier batch, or only this one). Returns
        (data, length, template id, counter) per lane."""
        import numpy as np

        n_fresh = n - int(n * replay)
        first = self.next_counter
        fresh = np.arange(first, first + n_fresh, dtype=np.int64)
        tof_fresh = self.rng.choice(len(self.templates), size=n_fresh,
                                    p=self.weights).astype(np.int32)
        self.template_of = np.concatenate([self.template_of, tof_fresh])
        self.next_counter += n_fresh
        lo = first if within_batch_only else 1
        rep = self.rng.integers(lo, self.next_counter, n - n_fresh)
        counters = np.concatenate([fresh, rep])
        self.rng.shuffle(counters)
        tof = self.template_of[counters]
        data = self.rows[tof]
        length = self.lens[tof]
        off, ln = self.ser_off[tof], self.ser_len[tof]
        lanes = np.arange(n)
        for ok, pos, byte in _counter_tail(counters, ln):
            data[lanes[ok], (off + pos)[ok]] = byte[ok]
        return data, length, tof, counters


# -- phase 3: the main path --------------------------------------------

class StageTimes:
    """Host-clock time of the layers of ``IngestModel.ingest_packed``:
    sidecar extraction, the device step (synchronised before and after,
    so it holds the copies in and every kernel of the step) and the
    host fold (readback, filters, metadata, host lane). What is left of
    a call is the host's routing plan."""

    def __init__(self, model) -> None:
        from ct_mapreduce_tpu_torch.models import ingest_model

        self.times = {"sidecar": [], "device_step": [], "fold": []}
        self._mod = ingest_model.leafpack
        self._extract = self._mod.extract_sidecars
        self._mod.extract_sidecars = self._wrap("sidecar", self._extract)
        agg = model.aggregator
        agg._device_step_preparsed = self._wrap(
            "device_step", agg._device_step_preparsed, sync=True)
        agg._fold_preparsed = self._wrap("fold", agg._fold_preparsed)

    def _wrap(self, name, fn, sync=False):
        import torch

        def run(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            self.times[name].append(time.perf_counter() - t0)
            return out
        return run

    def close(self) -> dict:
        self._mod.extract_sidecars = self._extract
        return self.times


def _config(batch_log2: int, table_bits: int):
    from ct_mapreduce_tpu_torch.config import CTConfig

    return CTConfig(preparsed_ingest=True, batch_size=1 << batch_log2,
                    table_bits=table_bits)


def main_path(device, stream: Stream, n_batches: int, batch_log2: int,
              table_bits: int, replay: float) -> dict:
    import numpy as np

    from ct_mapreduce_tpu_torch.core.types import ExpDate
    from ct_mapreduce_tpu_torch.models.ingest_model import IngestModel
    from ct_mapreduce_tpu_torch.ops import sha256_cuda

    model = IngestModel.from_config(_config(batch_log2, table_bits),
                                    device=device)
    agg = model.aggregator
    idx_of = stream.issuer_indices(model)
    cap0 = agg.capacity
    n = 1 << batch_log2
    seen = np.zeros((stream.next_counter + n_batches * n + 1,), bool)
    step_s, gen_s = [], []
    stages = StageTimes(model)
    sha256_cuda.LAUNCHES = 0
    for _ in range(n_batches):
        t0 = time.perf_counter()
        data, length, tof, ctr = stream.batch(n, replay)
        t1 = time.perf_counter()
        res = model.ingest_packed(data, length, idx_of[tof],
                                  np.ones((n,), bool))
        step_s.append(time.perf_counter() - t1)
        gen_s.append(t1 - t0)
        # Oracle: the first sighting of a (template, counter) among the
        # lanes that pass the filters is the one unknown lane.
        passing = ~stream.filtered[tof]
        _, first = np.unique(ctr[passing], return_index=True)
        want = np.zeros((n,), bool)
        cand = np.nonzero(passing)[0][first]
        want[cand[~seen[ctr[cand]]]] = True
        seen[ctr[passing]] = True
        check(np.array_equal(res.was_unknown, want),
              f"was_unknown differs from the oracle on "
              f"{int((res.was_unknown != want).sum())} lanes")
        check(np.array_equal(res.filtered, ~passing), "filter verdicts differ")
    launches = sha256_cuda.LAUNCHES
    stage_s = stages.close()
    check(launches > 0, "the fingerprint kernel never ran on the main path")
    check(agg.capacity > cap0, "no table grow happened on the main path")

    snap = model.drain()
    counts: dict = {}
    crls: dict = {}
    dns: dict = {}
    counters = np.nonzero(seen)[0]
    per_tpl = np.bincount(stream.template_of[counters],
                          minlength=len(stream.templates))
    for t, c in enumerate(per_tpl):
        if c == 0:
            continue
        tr = stream.truth[t]
        key = (tr["issuer"], ExpDate.from_unix_hour(tr["hour"]).id())
        counts[key] = counts.get(key, 0) + int(c)
        crls.setdefault(tr["issuer"], set()).update(tr["crls"])
        dns.setdefault(tr["issuer"], set()).add(tr["dn"])
    check(snap.counts == counts, "drained counts differ from the oracle")
    check(snap.crls == crls, "drained CRL sets differ from the oracle")
    check(snap.dns == dns, "drained DN sets differ from the oracle")
    check(snap.total == int(seen.sum()), "drained total differs")
    entries = n_batches * n
    out = {
        "batches": n_batches, "batch": n, "entries": entries,
        "unique_serials": int(seen.sum()), "launches": launches,
        "capacity_start": cap0, "capacity_end": agg.capacity,
        "ingest_s_per_batch": step_s, "gen_s_per_batch": gen_s,
        "stage_s_per_batch": stage_s,
        "entries_per_s": entries / sum(step_s),
        "device_share": sum(stage_s["device_step"]) / sum(step_s),
        "metrics": dict(agg.metrics),
    }
    print(f"phase 3: {entries} entries in {n_batches} batches of {n}, "
          f"{out['unique_serials']} unique; drain == oracle; table "
          f"{cap0} -> {agg.capacity} slots; {launches} kernel launches; "
          f"{out['entries_per_s']:.0f} entries/s through ingest_packed "
          f"(median {median(step_s):.3f} s/batch: sidecars "
          f"{median(stage_s['sidecar']):.3f}, device step "
          f"{median(stage_s['device_step']):.3f}, fold "
          f"{median(stage_s['fold']):.3f})", flush=True)
    return out


# -- phase 4: state at a deployment's scale ----------------------------

def deployment_state(device, stream: Stream, table_bits: int,
                     batch_log2: int, fill: float, seed: int) -> dict:
    import numpy as np
    import torch

    from ct_mapreduce_tpu_torch.core import packing
    from ct_mapreduce_tpu_torch.models.ingest_model import IngestModel
    from ct_mapreduce_tpu_torch.ops import buckettable, sha256_cuda

    model = IngestModel.from_config(_config(batch_log2, table_bits),
                                    device=device)
    agg = model.aggregator
    idx_of = stream.issuer_indices(model)
    n = 1 << batch_log2
    gen = torch.Generator(device=device).manual_seed(seed)
    n_calls = max(1, round(fill * agg.capacity / n))
    prefill = []
    t0 = time.perf_counter()
    for _ in range(n_calls):
        keys = torch.randint(-(1 << 31), 1 << 31, (n, 4), generator=gen,
                             device=device, dtype=torch.int32)
        meta = torch.zeros((n,), dtype=torch.int32, device=device)
        valid = torch.ones((n,), dtype=torch.bool, device=device)
        agg.table, wu, ovf = buckettable.insert(
            agg.table, keys, meta, valid, max_probes=agg.max_probes)
        check(bool(wu.all()) and not bool(ovf.any()),
              "a prefill key was not inserted")
        prefill.append(keys)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    agg._table_fill = int(agg.table.count)
    load = agg._table_fill / agg.capacity

    data, length, tof, ctr = stream.batch(n, 0.5, within_batch_only=True)
    stages = StageTimes(model)
    sha256_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    res = model.ingest_packed(data, length, idx_of[tof], np.ones((n,), bool))
    step_s = time.perf_counter() - t0
    launches = sha256_cuda.LAUNCHES
    stage_s = stages.close()
    check(launches > 0, "the fingerprint kernel never ran on the big table")
    passing = ~stream.filtered[tof]
    _, first = np.unique(ctr[passing], return_index=True)
    want = np.zeros((n,), bool)
    want[np.nonzero(passing)[0][first]] = True
    check(np.array_equal(res.was_unknown, want),
          "was_unknown differs from the oracle on the big table")

    sel = np.nonzero(want)[0]
    ser, slen = stream.serial_bytes(tof[sel], ctr[sel])
    hours = np.array([t["hour"] for t in stream.truth], np.int32)[tof[sel]]
    sc_fp = packing.fingerprints_np(idx_of[tof[sel]], hours, ser, slen)
    batch_keys = torch.from_numpy(sc_fp.view(np.int32)).to(device)
    found = all(bool(buckettable.contains(agg.table, k).all())
                for k in prefill + [batch_keys])
    check(found, "contains missed an inserted key")
    out = {
        "buckets": agg.table.n_buckets,
        "table_bytes": agg.table.rows.numel() * 4,
        "prefill_keys": n_calls * n, "prefill_s": prefill_s,
        "insert_ms_per_prefill_call": prefill_s / n_calls * 1e3,
        "load_before_batch": load, "batch": n, "ingest_s": step_s,
        "stage_s": stage_s,
        "launches": launches, "overflow": agg.metrics["overflow"],
    }
    print(f"phase 4: {out['buckets']} buckets ({out['table_bytes']} B), "
          f"{out['prefill_keys']} keys prefilled in {prefill_s:.2f} s "
          f"(load {load:.3f}); batch of {n} in {step_s:.3f} s (device "
          f"step {stage_s['device_step'][0]:.3f} s); "
          f"was_unknown == oracle; contains found every key", flush=True)
    return out


def device_busy(trace_path: str) -> tuple[float, dict]:
    """From a torch.profiler Chrome trace: the microseconds in which the
    device ran a kernel, copy or memset (the union of their spans, so
    overlaps count once), and per kernel name its total time and count.
    Host-side op rows are not counted: they repeat their kernels' time."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end, by_kernel = 0.0, float("-inf"), {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        t, c = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (t + stop - start, c + 1)
    return busy, by_kernel


def profile_step(device, stream: Stream, batch_log2: int, table_bits: int,
                 out_dir: str) -> dict:
    """torch.profiler over one warm main-path batch: device time by
    kernel, and the device's busy share of the call's wall time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ct_mapreduce_tpu_torch.models.ingest_model import IngestModel

    model = IngestModel.from_config(_config(batch_log2, table_bits),
                                    device=device)
    idx_of = stream.issuer_indices(model)
    n = 1 << batch_log2
    batches = [stream.batch(n, 0.5) for _ in range(2)]
    data, length, tof, _ = batches[0]
    model.ingest_packed(data, length, idx_of[tof], np.ones((n,), bool))
    data, length, tof, _ = batches[1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.ingest_packed(data, length, idx_of[tof], np.ones((n,), bool))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "ingest_step_trace.json")
    prof.export_chrome_trace(path)
    busy_us, by_kernel = device_busy(path)
    busy_s = busy_us / 1e6
    rows = sorted(((t, k, c) for k, (t, c) in by_kernel.items()),
                  reverse=True)
    out = {"wall_s": wall, "device_busy_s": busy_s,
           "device_idle_share": 1.0 - busy_s / wall,
           "top_device_us": [[k, round(t, 1), c] for t, k, c in rows[:15]],
           "k1_device_us": [v for k, v in by_kernel.items()
                            if "sha256_fp" in k]}
    print(f"profile: one batch of {n}: wall {wall:.3f} s, device busy "
          f"{busy_s:.4f} s (idle share {out['device_idle_share']:.3f})",
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20261017,
                    help="seed of every input the run makes")
    ap.add_argument("--profile", default="",
                    help="also profile one main-path batch with "
                         "torch.profiler; the trace goes to this directory")
    ap.add_argument("--sass", default="",
                    help="also report the fingerprint kernel's registers "
                         "(-Xptxas -v) and SASS opcode counts (cuobjdump); "
                         "both outputs go to this directory")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a GPU")
    sys.path.insert(0, HERE)
    try:
        import ct_mapreduce_tpu_torch
    except ImportError as exc:
        fail(f"the port package is not beside this script ({exc})")
    pkg_dir = os.path.dirname(os.path.abspath(ct_mapreduce_tpu_torch.__file__))
    check(os.path.dirname(pkg_dir) == HERE,
          f"imported the port from {pkg_dir}, not from this checkout")
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    card = card_line()
    print(card, flush=True)
    builds = build_all()
    print(f"phase 1: built the fingerprint kernel in "
          f"{builds['k1_build_s']:.1f} s and the native decoder in "
          f"{builds['native_build_s']:.1f} s", flush=True)

    sass = sass_report(args.sass) if args.sass else None
    k1 = kernel_check(device, 1 << BATCH_LOG2, args.seed, TIMED_REPS)
    stream = Stream(args.seed)
    main_out = main_path(device, stream, MAIN_BATCHES, BATCH_LOG2,
                         TABLE_BITS, replay=0.5)
    torch.cuda.empty_cache()
    big = deployment_state(device, stream, BIG_TABLE_BITS, BATCH_LOG2, 0.5,
                           args.seed)
    prof = (profile_step(device, stream, BATCH_LOG2, TABLE_BITS,
                         args.profile) if args.profile else None)
    print(json.dumps({"card": card, "builds": builds, "fingerprint": k1,
                      "main_path": main_out, "big_table": big,
                      "profile": prof, "sass": sass,
                      "wall_s": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"kernels": [{
        "name": "sha256_fp",
        "route": "cuda",
        "source": "ct_mapreduce_tpu_torch/csrc/sha256_fp.cu",
        "replaces": "ct_mapreduce_tpu/ops/pallas_sha256.py:68",
        "launches": main_out["launches"],
        "max_abs_err": k1["max_abs_err"],
        "match": k1["match"],
        "ms": k1["kernel_ms"],
        "kernel_ms": k1["kernel_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
