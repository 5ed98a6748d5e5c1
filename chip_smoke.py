#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full size, one card, a few minutes
    python3 chip_smoke.py --profile DIR   # plus torch.profiler passes
                                          # (a batch of each lane, 8 chunks
                                          # of each sink configuration)
    python3 chip_smoke.py --sass DIR      # plus the kernels' ptxas/SASS report

The port is ``ct_mapreduce_tpu_torch``, imported from this checkout.

Phases, none of them caught — any failure exits non-zero:

1. card: name and power limit (``nvidia-smi``), then the five kernel
   libraries (``nvcc`` for sm_90a: the fingerprint SHA-256 K1, the DER
   walker K3, the ten probe stages, the Bloom bit-scatter K5, the ECDSA
   verify K6) and the native sidecar decoder
   (``g++``), all built from this checkout at once;
2. K1 against its plain PyTorch version on 2^20 lanes (bit for bit), a
   sample against ``hashlib`` and the host fingerprint, both timed with
   CUDA events;
3. K3 against its plain version on 2^20 stream rows plus mutants made
   from ``--seed`` (byte flips, length-octet edits, truncations,
   extension lists past MAX_EXTS) and the crafted edge cases (with the
   family that puts each frame at every offset modulo 16), every field
   bit for bit; the mutants and crafted rows again at odd widths (193,
   2047 bytes) in contiguous views that start off 16-byte alignment;
   the stream and mutant rows against the native scalar walker; K3 and
   its plain version timed on the stream rows;
4. the probe ladder: its command-line path on the card (each stage at
   one tile against its plain version, stage 9 against the host
   parser, stage 9 timed at 2^20 lanes), then every stage at 2^20 lanes
   against its plain version, timed beside its bound in 32-byte
   sectors (stage 9 also on random words and on crafted rows whose
   headers or serial run past its window and the row; stages 1, 2, 3,
   4, 7 and 8 also at widths off the 128-lane block, stages 2, 3, 4, 7
   and 8 on their edge rows, stages 2, 3 and 7 also shifted by one lane,
   stages 1 and 7 also in views 4, 8 and 12 B past 16-byte alignment,
   stage 3 also against its window model and stage 4 against its
   one-pass model; stage 2 beside its two floors, ``torch.gather`` of
   its scattered words and its time with no scattered read, and the
   card's L2 fetch granularity; stages 1 and 7 beside an empty launch
   at one lane a thread, at theirs and of one block and ``out.copy_(w[4])``,
   stage 1 beside its library call);
5. the walker main path, the default lane: ``IngestModel`` at
   ``batchSize`` 2^20 from ``tableBits`` 21, with an issuer
   CN filter that keeps 12 of 16 issuers and a 64-byte prefix of a
   70-byte issuer CN (those lanes take the exact host lane): 16 issuers
   split by Zipf(1.1), EC and RSA-sized leaves with the rich extension
   load, serial lengths 8..20, about half the entries replaying an
   earlier serial, a few percent expired leaves and CA certificates;
   enough batches for a table grow. ``drain()`` and every batch's
   ``was_unknown`` are held to an exact host oracle. After the check,
   one more batch, outside the timed ones, captures the step's bucket
   insert, which is then replayed on copies of the table and timed;
6. the pre-parsed lane over the same batches and config: held to the
   oracle, and its ``drain()`` to the walker lane's; its insert timed
   as in 5;
5b. the open-addressing table (``CTMR_TABLE=open``): the first 2 of
   those batches from ``tableBits`` 21 (2,097,152 slots of 20 B, growing
   once) through the walker lane, then the pre-parsed lane, each drain
   held to the oracle and to phase 5's bucket drain after the same 2
   batches; the step's open insert timed as in 5; the walker lane's
   open table saved as ck01 on the card and loaded into a CPU
   aggregator to the same drain and ``ckpt_state_digest``;
7. a 2 GiB table (``tableBits`` 26, 2^22 buckets) prefilled to about 50%
   of its slots with random keys through the port's insert, then one
   pre-parsed batch on top; ``was_unknown`` against the oracle and
   ``contains`` over every inserted key;
8. the ingest sink as ct-fetch drives it: phase 5's stream (CN filter,
   replays, expired and CA leaves) as raw get-entries pages of 1,000
   entries (base64 ``leaf_input``/``extra_data``), 24 chunks of
   ``batchSize`` 65,536 (1,572,864 entries, enough for ``tableBits`` 20
   to grow) through ``AggregatorSink.store_raw_batch`` in three
   configurations, each sink built by ``build_sink`` from its config
   directives: unstaged at ``deviceQueueDepth`` 2, staged
   (``chunksPerDispatch`` 8, ``stagingDepth`` 2) and pre-parsed; each
   drain held to the oracle and to the others, every copied row byte
   counted as pinned, the pinned row buffers no more than one beyond
   the chunks or envelopes in flight; then one chunk's rows copied to
   the card from pinned and from pageable memory, and the bounce copy
   a pageable chunk would need, each timed;
9. checkpoints on the card: the staged sink's grown table saved as ck01
   and as a ck02 base and loaded on the card and on the CPU to the
   sink's drain; an ``IngestModel`` with ``aggStatePath`` writing a
   ck02 base and two one-batch segments, restored on the card to the
   writer's ``ckpt_state_digest``, then resumed to the oracle's drain;
10. ct-fetch on the card, through ``cmd/ct_fetch.main`` and
   ``cmd/storage_statistics.main`` with inis the phase writes: a log
   server in a process of its own (``utils/fakelog.py`` over
   ``http.server`` on 127.0.0.1, started first so it builds its log
   while phases 1-9 run) serves phase 8's stream as 1,000-entry
   get-entries pages, 786,432 entries; ct-fetch downloads it over the
   client's urllib transport with ``backend = tpu``, ``batchSize``
   65,536, ``tableBits`` 19 (it grows once), ``deviceQueueDepth`` 2 and
   ``aggStatePath``: (a) unstaged, its ``storage-statistics -v 1`` and
   ``-v 2`` reports held to the oracle; (b) ``overlapWorkers`` 2 and (c)
   staged (``chunksPerDispatch`` 8, ``stagingDepth`` 2), each from an
   empty state; every drain (on the card and from the checkpoint) held
   to the oracle and to the others, every pool within its bound; (d)
   with ``certPath``, 65,536 entries, then the log grows to 131,072
   and ct-fetch resumes from the cursor in the PEM tree's state file
   and from ``aggStatePath`` to the drain of one run over all 131,072
   and the oracle's, with one PEM file per first-seen serial, each
   decoding to its leaf;
11. the serve plane on the card: (i) a ``QueryServer`` on port 0 over
   phase 9's restored 3,145,728-slot bucket table (device views, 2
   replicas pinned on the card, a 4,096-entry cache) answers 65,536
   queries over HTTP (64 POSTs of 1,024 from 4 client threads): half
   serials the stream holds (the long-CN issuer's host-lane serials
   among them), half never logged under the same issuers (some longer
   than the fingerprint window), every answer held to the host oracle;
   then the pinned ``contains`` at 1,024 and 65,536 keys, timed beside
   ``contains_np``; (ii) the same over phase 5b's open table; (iii)
   ct-fetch with ``queryPort`` over a 131,072-entry log while a client
   queries ``/query``: no never-logged serial ever answers known, a
   serial known at one epoch stays known at later ones, then
   ``ct-query-torch`` and ``ct-getcert-torch -queryAddr`` run against
   the plane as processes (the PEM equal to the log's entry). No view
   may fall back to the host (``serve.device_fallback`` stays 0), and
   every replica's rows are pinned on CUDA;
12. filter emission on the card: (0) the Bloom bit-scatter K5 against
   its plain version at 2^20 lanes, one layer, a fused round of 1,024
   groups and filter-scale's first dispatch, bit for bit on arenas
   non-zero on entry, both timed, and each of K5's five phases timed,
   with its scratch bytes; (a) filter-main: walker-main's
   first 2 batches (about a million serials in 13 groups) through an
   ``IngestModel`` with ``aggStatePath`` (ck01) and filter emission
   (fl02): the capture equals the oracle's serial sets, ``save()`` emits
   the artifact with ``filter.emit_error`` 0; fl01 over the same capture;
   each artifact equals the host lane's (``CTMR_FILTER_DEVICE=0``),
   ``build_artifact`` over the oracle's sets and a build from the ck01
   restored on the CPU; every captured serial answers known, never-logged
   ones at most twice the 1% target; (b) filter-fetch: ct-fetch with
   ``emitFilter`` over (iii)'s log, ``ct-filter-torch build`` over its
   state equal to the emitted file, ``inspect -json`` and ``query`` (a
   process: exit 0 known, 1 never logged); (c) filter-scale: a streamed
   fl02 build through ``PackedGroupSource`` at 2^24 serials in 1,024
   groups (64 issuers x 16 hours, Zipf(1.1) sizes, lengths 8..20), every
   K5 dispatch held to its plain version, K1 and K5 keys/s, every key a
   member;
13. signature verification on the card: (0) K6 against its plain
   version, verdict for verdict, for P-256 and P-384 at windows 8 and 0
   on 1,024 lanes (the lane's ``verifyBatch``) and 2^16 (about 80% valid
   signatures under 4 keys, the rest r or s 0 or n, s + 1, keys off the
   curve or past p, wrong digests and padding lanes), a sample against
   ``verify_ecdsa``, and at widths that cut a thread group or a block
   (1, 3, 31, 127, 129, 1,023, 1,025); the edge lanes (a block of
   failed checks, one good lane among bad ones, results at infinity,
   u1 G = u2 Q) against the plain version and ``verify_ecdsa``; K6
   timed with CUDA events beside its operations bound (the multiplies
   the function it replaces needs for these lanes, K6's own beside
   them); (a)
   verify-sink: 131,072 entries whose leaves carry SCTs (two P-256 logs
   ~70%, a P-384 log ~10%, an RSA log ~5%, an unregistered log ~5%, no
   SCT ~10%, 1% of the ECDSA signatures corrupted) through the
   ``AggregatorSink`` of ``build_sink`` with ``verifySignatures`` and
   ``verifyLogKeys``: per-issuer verdicts equal the generator's truth,
   the device lanes are the P-256/P-384 ones, the host lanes the RSA
   ones, one Q-table miss a distinct ECDSA key; the same pages without
   the lane for its cost; (b) verify-fetch: ct-fetch with the same
   directives over that stream served on 127.0.0.1, and
   ``storage-statistics -json`` totals equal to the truth;
14. the filter distribution plane and the audit on the card: (a)
   distrib-fetch: ct-fetch with ``queryPort``, ``emitFilter``,
   ``runForever`` and ``distribHistory`` 4 over a log of 65,536 entries
   that grows to (iii)'s 131,072 between two rounds, so that two epochs
   publish through ``refresh_serve_filter``, while a client posts the
   smoke mix; then over HTTP ``/filter`` equals the artifact of the
   final save, a conditional GET answers 304, gzip decodes to the same
   bytes, ``/filter/manifest`` validates its links, the delta bundle of
   the two epochs applied by the client turns the first's bytes into the
   second's, ``/filter/container/mlbf`` and ``/clubcard`` decode to
   artifacts answering as fl02 does on every logged serial and 4,096
   never-logged ones, and the filter-first plane answers the smoke mix
   as the oracle and the table tier do, with the tier armed, K5 launched
   and ``serve.filter_negative`` above 0; ``ct-filter-torch delta``,
   ``apply`` and ``container`` as processes round-trip the two epochs;
   (b) audit-shard: ``tests/data/recorded_shard.json.gz`` (1,024
   entries) through ``python -m ct_mapreduce_tpu_torch.tools.audit``'s
   ``main`` at tile 1 and at tile 128 (131,072 entries, the verify lane
   on, flush and batch 4,096): the tiled report is 128 times tile 1's
   and its verdict counts what the shard's mix implies, the quarantine
   spool (a temporary directory) replays as many records as the report
   counts (0), the ``--emit-filter`` artifact loads in
   ``ct-filter-torch inspect`` (a process); then ``classify_corpus`` on
   the card over the shard's DERs and 8,192 structured mutants: no
   verdict mismatch, buckets equal to the plain walker's on the same
   corpus, the trend written to a temporary file;
15. the sharded dedup, the ingest fleet and a global mesh: (a)
   sharded-walker: walker-main's batches through ``IngestModel``
   on a ``shard:4`` mesh (every visible card, or four shards over
   cuda:0 with one card visible; the mesh and the exchange route are
   printed), every batch's ``was_unknown`` equal to phase 5's and the
   oracle's, the drain to the oracle's, ``dispatch_spill`` and K1/K3
   launches printed, one step's K7 (dispatch, exchange, shard inserts,
   return) replayed on copies of the shard tables and timed beside its
   byte bound; (b) sharded-preparsed: the first 2 batches through the
   pre-parsed lane on a fresh mesh, its drain equal to (a)'s after them;
   (c) sharded-ckpt: (a)'s table as ck01 and as a ck02 base, each loaded
   into a one-device aggregator and a ``shard:2`` mesh and reported by
   storage-statistics, and phase 9's ck01 loaded into a 4-shard mesh,
   every drain and report equal to its source's; (d) sharded-serve: a
   ``QueryServer`` over (a)'s sharded views answers the smoke mix as the
   oracle does, each replica's shard blocks pinned on their shards'
   cards; (e) fleet-fetch: two ``ct-fetch-torch`` processes on the card
   (``numWorkers`` 2, ``coordinatorBackend = redis`` against a
   ``MiniRedis`` on 127.0.0.1, ``checkpointPeriod``, ``emitFilter``)
   over two logs of another seed (the partition), then over one of them
   (its stripes): both workers' merged report equals a serial ct-fetch
   over the same logs and the oracle, and the leader's merged fleet
   filter build over the final checkpoints answers every logged serial;
   (f) global-mesh: two processes join through ``initialize_multihost``
   and take one ``ShardedDedup`` step of 2^18 lanes each on a 2-shard
   global mesh (NCCL with two or more cards, else gloo through host
   memory, as the line says), drain and verdicts equal to a one-process
   2-shard mesh's on the same lanes.

The kernels' launch counts are set to 0 just before each main path
(walker, pre-parsed, both lanes on the open table, probe ladder, each
sink configuration, each ct-fetch run, the served ct-fetch, the filter
emission and fl01 build of 12 (a), the ct-fetch of 12 (b), the build of
12 (c), 13 (a)'s sinks and 13 (b)'s ct-fetch, 14 (a)'s ct-fetch, 14 (b)'s
tile-128 audit and its ``classify_corpus``, 15 (a) and (b), each 15 (e)
serial run and merged filter build, 15 (f)'s one-process step) and
read just after it. Prints the
card line, a ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.
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
# Enough for tableBits 21 (3,145,728 slots) to grow once, before the 4th
# (cut from 6 to make room for phase 15 in the time limit).
MAIN_BATCHES = 4
TABLE_BITS = 21  # one below the shipped 22, which needs 10 batches
BIG_TABLE_BITS = 26  # 2^22 buckets: 2 GiB of rows
TIMED_REPS = 25  # CUDA-event timings per turn (two turns each)
PLAIN_REPS = 5  # timings per turn of a slow plain version
KERNEL_CALLS_PER_TIMING = 20  # back-to-back launches between two events
MUTANTS = 8192  # mutated rows beside the 2^20 stream rows in phase 3
# Row widths that are not multiples of 16: phase 3 walks the mutants and
# crafted rows cut to these widths in views that start unaligned.
ODD_WIDTHS = (193, 2047)
FOOTPRINT_CHUNK = 1 << 16  # lanes per footprint count (memory)
# Widths off the 128-lane block, at which phase 4 also holds stages 1, 2,
# 3, 4, 7 and 8 to their plain versions (tails of 1, 2 and 3 lanes past a
# multiple of 4 for stages 1 and 7).
PROBE_ODD_WIDTHS = (1, 127, 129, 130, 1000, (1 << 16) + 5)
# A read byte costs a thread at least an address add, a load and the
# shift/mask or compare that uses it: integer operations per byte read,
# for the operations half of a walker or probe bound.
OPS_PER_BYTE_READ = 3
# SASS memory instructions the --sass report counts: global, shared and
# local loads and stores (LDL/STL are spills or arrays in local memory).
MEMORY_OPCODES = ("LDG", "STG", "LDS", "STS", "LDL", "STL")


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


def kernel_libs() -> dict:
    from ct_mapreduce_tpu_torch.ops import (
        bloom_cuda, der_kernel_cuda, ecdsa_cuda, sha256_cuda)
    from ct_mapreduce_tpu_torch.tools import mosaic_probe

    return {"k1": sha256_cuda.LIB, "k3": der_kernel_cuda.LIB,
            "probe": mosaic_probe.LIB, "k5": bloom_cuda.LIB,
            "k6": ecdsa_cuda.LIB}


def build_all() -> dict:
    """Build the five kernel libraries and the native decoder at once,
    one compiler process each."""
    from ct_mapreduce_tpu_torch import native

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    jobs = {name: lib.build for name, lib in kernel_libs().items()}
    jobs["native"] = native.load
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futs = {name: pool.submit(timed, fn) for name, fn in jobs.items()}
        done = {name: f.result() for name, f in futs.items()}
    check(done["native"][0] is not None,
          "the native sidecar decoder did not build")
    return {f"{name}_build_s": t for name, (_out, t) in done.items()}


def cuda_times(fn, reps: int, calls: int = 1,
               warmup: int = 3) -> list[float]:
    """``reps`` CUDA-event timings of ``fn()`` in milliseconds, each the
    mean of ``calls`` back-to-back calls between one pair of events. The
    card first spins while the host queues the calls
    (``kernel_times.cuda_ms``), so that a wrapper's host time between
    launches does not show in a short kernel's time."""
    from ct_mapreduce_tpu_torch.tools.kernel_times import cuda_ms

    return cuda_ms(fn, reps, calls, warmup)


def median(xs: list[float]) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def sass_report(out_dir: str) -> dict:
    """Per kernel library: registers and spills (``nvcc`` with
    ``-Xptxas -v``, the library's own flags) and SASS instructions by
    opcode (``cuobjdump -sass``); the raw outputs go to ``out_dir``."""
    import collections
    import re

    from ct_mapreduce_tpu_torch.ops import cuda_build

    os.makedirs(out_dir, exist_ok=True)
    nvcc = cuda_build.nvcc()
    report = {}
    for name, lib in kernel_libs().items():
        so = os.path.join(out_dir, f"{name}_ptxas.so")
        res = subprocess.run(
            [nvcc, *cuda_build.NVCC_FLAGS, *lib.flags, "-Xptxas", "-v",
             "-o", so, lib.path], capture_output=True, text=True,
            timeout=600, check=True)
        ptxas = res.stdout + res.stderr
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", so],
            capture_output=True, text=True, timeout=120, check=True).stdout
        for kind, text in (("ptxas", ptxas), ("sass", sass)):
            with open(os.path.join(out_dir, f"{name}_{kind}.txt"), "w") as f:
                f.write(text)
        opcode = re.compile(
            r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)",
            re.M)
        ops = collections.Counter(m.group(1).split(".")[0]
                                  for m in opcode.finditer(sass))
        if name == "probe":  # stages 1 and 7: the global loads and stores
            word = {}
            for body in re.split(r"\n\s*Function : ", sass)[1:]:
                fname = body.split("\n", 1)[0].strip()
                if "k_word_stage" in fname:
                    word[fname] = dict(collections.Counter(
                        m.group(1) for m in opcode.finditer(body)
                        if m.group(1).startswith(("LDG", "STG"))))
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", ptxas)]
        kernels = {}
        for m in re.finditer(
                r"Function properties for (\S+)\n\s+(\d+) bytes stack "
                r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                r"loads\n.*?Used (\d+) registers([^\n]*)", ptxas):
            smem = re.search(r"(\d+) bytes smem", m.group(6))
            kernels[m.group(1)[-90:]] = {
                "registers": int(m.group(5)), "stack_bytes": int(m.group(2)),
                "spill_store_bytes": int(m.group(3)),
                "spill_load_bytes": int(m.group(4)),
                "static_smem_bytes": int(smem.group(1)) if smem else 0}
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", ptxas)]
        spill_loads = [int(x) for x in re.findall(r"(\d+) bytes spill loads", ptxas)]
        mem = {op: ops.get(op, 0) for op in MEMORY_OPCODES}
        report[name] = {"registers_max": max(regs, default=None),
                        "kernels": kernels,
                        "spill_store_bytes": sum(spills),
                        "spill_load_bytes": sum(spill_loads),
                        "memory_ops": mem,
                        "instructions": sum(ops.values()),
                        "by_opcode": dict(ops.most_common())}
        if name == "probe":
            report[name]["word_stage_memory"] = word
        print(f"sass {name}: at most {report[name]['registers_max']} "
              f"registers, {sum(spills)} B spill stores, {sum(spill_loads)} "
              f"B spill loads, {report[name]['instructions']} instructions; "
              f"{mem}; {dict(ops.most_common(8))}", flush=True)
    for kname, k in report["k6"]["kernels"].items():
        print(f"sass k6 kernel ...{kname[-60:]}: {k}", flush=True)
        check(k["spill_store_bytes"] == 0 and k["spill_load_bytes"] == 0,
              f"a K6 kernel spills: {kname} {k}")
    for name, pick in (("k5", lambda kname: True),
                       ("probe", lambda kname: any(k in kname for k in (
                           "k_serial_extract", "k_fori_masked",
                           "k_tlv_walk", "k_word_stage")))):
        for kname, k in report[name]["kernels"].items():
            if pick(kname):
                print(f"sass {name} kernel ...{kname[-60:]}: {k}", flush=True)
                check(k["spill_store_bytes"] == 0 and k["spill_load_bytes"] == 0,
                      f"a {name} kernel spills: {kname} {k}")
    # Stage 7 decodes its header from one load of word 0: each of its two
    # kernels (16-byte path or not; "Lb1E" mangles kAligned true) makes as
    # many global loads as stage 1's, which reads one byte.
    word = report["probe"]["word_stage_memory"]
    loads = {("TlvStep" in f, "Lb1E" in f): sum(
        v for op, v in c.items() if op.startswith("LDG"))
        for f, c in word.items()}
    print(f"sass probe stages 1 and 7: {word}", flush=True)
    check(len(loads) == 4 and all(loads[True, a] == loads[False, a]
                                  for a in (True, False)),
          f"stage 7 makes other global loads than stage 1: {word}")
    k6 = kernel_libs()["k6"]
    report["k6"]["product"] = k6_product_sass(k6.path, out_dir, k6.flags)
    k3 = report["k3"]
    check(k3["spill_store_bytes"] == 0 and k3["spill_load_bytes"] == 0
          and k3["memory_ops"]["LDL"] == 0 and k3["memory_ops"]["STL"] == 0,
          "the walker kernel uses local memory (spills or a register array "
          "indexed at run time)")
    return report


# K6's Montgomery product alone: a kernel that loads two field elements,
# multiplies them mod p once (twice) and stores the product, for each of
# the source's kernel shapes (``Spec``: limbs, threads a signature,
# signatures a block) or, in K6's first design, for whole NL-limb
# elements, one thread a signature. The two kernels differ by one
# product.
K6_PRODUCT_PROBE = """
#include "{src}"
namespace {{
template <{param}, int kProducts>
__global__ void k6_product_probe(uint32_t* io) {{
{body}
}}
}}  // namespace
extern "C" void ctmr_k6_product_probe(uint32_t* io) {{
{launches}
}}
"""
K6_PRODUCT_BODY_GROUP = """
  const Group<S> g(threadIdx.x);
  Limbs<S> a, b;
  for (int k = 0; k < S::L; ++k) {
    a[k] = io[threadIdx.x * 2 * S::L + k];
    b[k] = io[threadIdx.x * 2 * S::L + S::L + k];
  }
#pragma unroll
  for (int i = 0; i < kProducts; ++i) mont_mul<S, kP>(g, a, a, b);
  for (int k = 0; k < S::L; ++k) io[threadIdx.x * 2 * S::L + k] = a[k];"""
K6_PRODUCT_BODY_THREAD = """
  uint32_t a[NL], b[NL];
  for (int k = 0; k < NL; ++k) {
    a[k] = io[threadIdx.x * 2 * NL + k];
    b[k] = io[threadIdx.x * 2 * NL + NL + k];
  }
#pragma unroll
  for (int i = 0; i < kProducts; ++i) mont_mul<NL, kP>(a, a, b);
  for (int k = 0; k < NL; ++k) io[threadIdx.x * 2 * NL + k] = a[k];"""
K6_SHAPES = ("P256W", "P384W", "P256J", "P384J")


def k6_product_sass(src: str, out_dir: str, flags=()) -> dict:
    """SASS instructions of one Montgomery product mod p of ``src`` (a
    K6 source) for each of its kernel shapes: the probe kernel with two
    products less the one with one, by opcode; per thread and, times the
    threads a signature, per signature. ``flags`` go to ``nvcc`` after
    NVCC_FLAGS, as the library's own."""
    import collections
    import re

    from ct_mapreduce_tpu_torch.ops import cuda_build

    with open(src) as f:
        group = "struct Spec" in f.read()
    args = K6_SHAPES if group else ("8", "12")
    probe = os.path.join(out_dir, "k6_product_probe.cu")
    with open(probe, "w") as f:
        f.write(K6_PRODUCT_PROBE.format(
            src=os.path.abspath(src),
            param="class S" if group else "int NL",
            body=K6_PRODUCT_BODY_GROUP if group else K6_PRODUCT_BODY_THREAD,
            launches="\n".join(f"  k6_product_probe<{a}, {k}><<<1, 32>>>(io);"
                               for a in args for k in (1, 2))))
    nvcc = cuda_build.nvcc()
    so = os.path.join(out_dir, "k6_product_probe.so")
    res = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, *flags, "-o", so,
                          probe], capture_output=True, text=True, timeout=900)
    check(res.returncode == 0,
          f"the K6 product probe did not build: {res.stderr[-2000:]}")
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", so],
        capture_output=True, text=True, timeout=120, check=True).stdout
    os.remove(so)
    parts = [p for p in re.split(r"\n\s+Function : ", sass)[1:]
             if re.search(r"\d+k6_product_probeI", p.split("\n", 1)[0])]
    with open(os.path.join(out_dir, "k6_product_sass.txt"), "w") as f:
        f.write("\n\tFunction : ".join([""] + parts))
    funcs = {}
    for part in parts:
        name = part.split("\n", 1)[0].strip()
        ops = collections.Counter(
            x.group(1).split(".")[0] for x in re.finditer(
                r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                r"([A-Z][A-Z0-9_.]*)", part, re.M))
        m = re.search(r"SpecILi(\d+)ELi(\d+)ELi\d+E", name)
        nl, g = (int(m.group(1)), int(m.group(2))) if m else (
            8 if "ILi8E" in name else 12, 1)
        k = int(re.search(r"Li(\d+)EE+vPj", name).group(1))
        funcs[(nl, g, k)] = ops
    out = {}
    for nl, g in sorted({(nl, g) for nl, g, _k in funcs}):
        diff = funcs[(nl, g, 2)].copy()
        diff.subtract(funcs[(nl, g, 1)])
        n_thread = sum(diff.values())
        name = f"{'p256' if nl == 8 else 'p384'}_g{g}"
        out[name] = {"threads_a_signature": g, "per_thread": n_thread,
                     "per_signature": n_thread * g,
                     "by_opcode": {op: c for op, c in diff.most_common()
                                   if c}}
        print(f"sass k6 product {name}: {n_thread} instructions a thread, "
              f"{n_thread * g} a signature; {dict(diff.most_common(6))}",
              flush=True)
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
    serial — so the truth of every lane is known by construction.

    With ``cn_filter`` the stream comes with an issuer-CN filter that
    keeps ``KEPT`` of the 16 issuers, and one more issuer whose 70-byte
    CN matches a 64-byte prefix: longer than the device's 61-byte CN
    window, so the device cannot decide and those lanes take the exact
    host lane."""

    N_ISSUERS = 16
    KEPT = 12
    PAD = 2048
    LONG_CN = "Smoke Issuer Long-Named Certification Authority " + "L" * 21

    def __init__(self, seed: int, cn_filter: bool = False) -> None:
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
        self.filtered = np.zeros(len(tpls), bool)
        self.filtered[self.N_ISSUERS:] = True
        w = syncerts.zipf_weights(self.N_ISSUERS, 1.1)
        if cn_filter:
            tpls.append(syncerts.make_template(
                issuer_cn=self.LONG_CN, serial_len=14, rich_extensions=True,
                not_after=datetime.datetime(2028, 3, 3, 3, tzinfo=utc),
                crl_dp="http://crl.long.smoke.example/l.crl"))
            self.filtered[self.KEPT:self.N_ISSUERS] = True
            self.filtered = np.append(self.filtered, False)
            self.weights = np.concatenate([w * 0.945, [0.03, 0.02, 0.005]])
        else:
            self.weights = np.concatenate([w * 0.95, [0.03, 0.02]])
        self.cn_filter = cn_filter
        self.templates = tpls
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

    def cn_prefixes(self) -> tuple[str, ...]:
        """The filter that keeps issuers 00..11 and the long-CN issuer."""
        if not self.cn_filter:
            return ()
        return ("Smoke Issuer 0", "Smoke Issuer 10", "Smoke Issuer 11",
                self.LONG_CN[:64])

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


# -- phase 3: the walker kernel against its plain version --------------

PROBE_REPLACES = (119, 127, 137, 147, 166, 183, 197, 223, 247, 361)


def reset_counts() -> None:
    from ct_mapreduce_tpu_torch.ops import (
        bloom_cuda, der_kernel_cuda, ecdsa_cuda, sha256_cuda)
    from ct_mapreduce_tpu_torch.tools import mosaic_probe

    sha256_cuda.LAUNCHES = 0
    der_kernel_cuda.LAUNCHES = 0
    bloom_cuda.LAUNCHES = 0
    ecdsa_cuda.LAUNCHES = 0
    mosaic_probe.LAUNCHES[:] = [0] * len(mosaic_probe.LAUNCHES)


def read_counts() -> dict:
    from ct_mapreduce_tpu_torch.ops import (
        bloom_cuda, der_kernel_cuda, ecdsa_cuda, sha256_cuda)
    from ct_mapreduce_tpu_torch.tools import mosaic_probe

    return {"sha256_fp": sha256_cuda.LAUNCHES,
            "der_walk": der_kernel_cuda.LAUNCHES,
            "bloom_scatter": bloom_cuda.LAUNCHES,
            "ecdsa_verify": ecdsa_cuda.LAUNCHES,
            "probe": list(mosaic_probe.LAUNCHES)}


def _max_abs_err(got, want) -> int:
    import torch

    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def _walker_vs_plain(d, ln, scan: bool, cn_k: int, what: str):
    """K3 and its plain version on the same rows: every field, the serial
    and CN windows bit for bit. Returns (K3's output, max abs err)."""
    import torch

    from ct_mapreduce_tpu_torch.ops import der_kernel, der_kernel_cuda

    got = der_kernel_cuda.walk(d, ln, scan, cn_k)
    want = der_kernel.walk_plain(d, ln, scan, cn_k)
    torch.cuda.synchronize()
    pairs = [(getattr(got.parsed, f), getattr(want.parsed, f), f)
             for f in der_kernel.ParsedCerts._fields]
    pairs += [(got.serials, want.serials, "serials"),
              (got.fits, want.fits, "fits"),
              (got.cn_window, want.cn_window, "cn_window")]
    err = 0
    for g, w, name in pairs:
        e = _max_abs_err(g, w)
        err = max(err, e)
        check(torch.equal(g, w), f"walker kernel != plain version on {what} "
              f"in {name} (scan_issuer_cn={scan}, max abs err {e})")
    return got, err


def walker_check(device, seed: int) -> dict:
    import numpy as np
    import torch

    from ct_mapreduce_tpu_torch.native import leafpack
    from ct_mapreduce_tpu_torch.ops import der_kernel, der_kernel_cuda
    from ct_mapreduce_tpu_torch.utils import dercases

    stream = Stream(seed + 1, cn_filter=True)
    n = 1 << BATCH_LOG2
    data, length, _tof, _ctr = stream.batch(n, 0.5)
    rng = np.random.default_rng(seed)
    mut, mlen = dercases.mutate_rows(data[:65536], length[:65536], MUTANTS, rng)
    cdata, clen = dercases.pack(dercases.crafted(), Stream.PAD)
    rows = np.concatenate([data, mut, cdata])
    lens = np.concatenate([length, mlen, clen])
    d = torch.from_numpy(rows).to(device)
    ln = torch.from_numpy(lens).to(device)
    cn_k = der_kernel.MAX_FIXED_WINDOW_BYTES
    err = 0
    for scan, k in ((True, cn_k), (False, 0)):
        got, e = _walker_vs_plain(d, ln, scan, k, "the stream rows")
        err = max(err, e)
        if scan:
            full = got
    # Odd widths in unaligned views: the mutants and crafted rows cut to
    # each width, from the second row of a buffer (d[1:]) and from one
    # byte into a flat buffer, so the first and last chunks of the
    # tensor reach past it.
    odd, odd_len = np.concatenate([mut, cdata]), np.concatenate([mlen, clen])
    odd_ln = torch.from_numpy(odd_len).to(device)
    for width in ODD_WIDTHS:
        cut = torch.from_numpy(np.ascontiguousarray(odd[:, :width])).to(device)
        rows_buf = torch.zeros((cut.shape[0] + 1, width), dtype=torch.uint8,
                               device=device)
        rows_buf[1:] = cut
        flat = torch.zeros(cut.numel() + 1, dtype=torch.uint8, device=device)
        flat[1:] = cut.reshape(-1)
        for view in (rows_buf[1:], flat[1:].view(cut.shape)):
            check(view.is_contiguous() and view.data_ptr() % 16 != 0,
                  "an odd-width view is 16-byte aligned")
            for scan, k in ((True, cn_k), (False, 0)):
                _got, e = _walker_vs_plain(view, odd_ln, scan, k,
                                           f"{width}-byte rows in a view")
                err = max(err, e)
    ok = full.parsed.ok.cpu().numpy()
    m = n + MUTANTS  # stream rows and mutants: every length inside the row
    sc = leafpack.extract_sidecars(rows[:m], lens[:m])
    native = {"ok": "ok", "serial_off": "serial_off", "serial_len": "serial_len",
              "not_after_hour": "not_after_hour", "is_ca": "is_ca",
              "has_crldp": "has_crldp", "issuer_cn_off": "cn_off",
              "issuer_cn_len": "cn_len", "issuer_off": "issuer_off",
              "issuer_len": "issuer_len", "spki_off": "spki_off",
              "spki_len": "spki_len", "crldp_off": "crldp_off",
              "crldp_len": "crldp_len"}
    for f, g in native.items():
        mine = getattr(full.parsed, f).cpu().numpy()[:m]
        if f == "issuer_cn_off":  # the native walker zeroes it on !ok
            mine = np.where(ok[:m], mine, 0)
        check(np.array_equal(mine.astype(np.int64),
                             getattr(sc, g).astype(np.int64)),
              f"walker kernel != native scalar walker in {f}")
    n_ok = int(ok[:n].sum())
    mut_ok = int(ok[n:m].sum())
    check(n_ok == n, "a stream row was rejected by the walker")

    # Timing and bound on the stream rows, as the main path calls it.
    ds, ls = d[:n], ln[:n]
    kernel_ms, plain_ms = [], []
    for _ in range(2):
        kernel_ms += cuda_times(lambda: der_kernel_cuda.walk(ds, ls, True, cn_k),
                                TIMED_REPS, KERNEL_CALLS_PER_TIMING)
        plain_ms += cuda_times(lambda: der_kernel.walk_plain(ds, ls, True, cn_k),
                               PLAIN_REPS, warmup=1)
    sectors = reads = 0
    for lo in range(0, n, FOOTPRINT_CHUNK):
        sec, rd = der_kernel.footprint(ds[lo:lo + FOOTPRINT_CHUNK],
                                       ls[lo:lo + FOOTPRINT_CHUNK], True, cn_k)
        sectors += int(sec.sum())
        reads += int(rd.sum())
    out_bytes = n * (len(der_kernel_cuda.FIELDS) * 4 + len(der_kernel_cuda.FLAGS)
                     + 46 + cn_k)
    bytes_moved = sectors * 32 + n * 4 + out_bytes
    byte_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    op_ms = reads * OPS_PER_BYTE_READ / INT32_OPS_PER_S * 1e3
    k_ms, p_ms = median(kernel_ms), median(plain_ms)
    out = {"rows": int(rows.shape[0]), "stream_rows": n, "mutants": MUTANTS,
           "crafted": int(cdata.shape[0]), "mutants_ok": mut_ok,
           "max_abs_err": err, "kernel_ms": k_ms, "plain_ms": p_ms,
           "kernel_ms_min": min(kernel_ms), "kernel_ms_max": max(kernel_ms),
           "sectors_per_lane": sectors / n, "reads_per_lane": reads / n,
           "bytes_moved": bytes_moved, "bytes_bound_ms": byte_ms,
           "ops_bound_ms": op_ms, "bound_ms": max(byte_ms, op_ms),
           "bound_by": "bytes" if byte_ms >= op_ms else "operations"}
    out["share_of_bound"] = out["bound_ms"] / k_ms
    out["odd_widths"] = list(ODD_WIDTHS)
    print(f"phase 3: walker kernel == plain on {out['rows']} rows (2^20 "
          f"stream, {MUTANTS} mutants of which {mut_ok} accepted, "
          f"{out['crafted']} crafted) and on the mutants and crafted rows "
          f"at widths {ODD_WIDTHS} in unaligned views, == native walker on "
          f"{m}; kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.2f} ms, bound {out['bound_ms']:.4f} "
          f"ms ({out['bound_by']}; {sectors / n:.1f} sectors, "
          f"{reads / n:.0f} byte reads a lane), {out['share_of_bound']:.1%} "
          f"of bound", flush=True)
    return out


# -- phase 4: the probe ladder -------------------------------------------

def probe_check(device, seed: int) -> dict:
    import numpy as np
    import torch

    from ct_mapreduce_tpu_torch.tools import mosaic_probe as mp
    from ct_mapreduce_tpu_torch.tools.kernel_times import (
        dyn_floors, word_floors)

    reset_counts()
    rc = mp.main(["--device", "cuda"])
    ladder = read_counts()
    check(rc == 0, "the probe ladder failed on the card")
    n = mp.TIMED_TILES * mp.LANES
    stages = []
    for stage, name in enumerate(mp.STAGES):
        words, expected = mp.stage_inputs(stage, n, seed)
        w = mp.to_tensor(words, device)
        got = mp.kernel_stage(stage, w)
        want = mp.plain_stage(stage, w)
        err = _max_abs_err(got, want)
        check(torch.equal(got, want),
              f"probe stage {name} != plain at {n} lanes (max abs err {err})")
        if expected is not None:
            check(np.array_equal(got.cpu().numpy(), expected),
                  f"probe stage {name} != host parser at {n} lanes")
        edges = []
        if stage == mp.SERIAL_STAGE:  # the window's edges
            edges = [("crafted", mp.crafted_serial_rows(seed, 64)),
                     ("random", mp.random_words(seed, 1 << 16))]
        if stage in (1, 2, 3, 4, 7, 8):  # widths off the tile, edge rows
            edges = [(f"random {width}-lane", mp.random_words(seed + width,
                                                               width))
                     for width in PROBE_ODD_WIDTHS]
        if stage in (1, 7):  # the 4-byte path: views off 16-byte alignment
            edges += [(f"random, {4 * off} B past 16-byte alignment",
                       mp.offset_tensor(mp.random_words(seed + off, 1 << 16),
                                        device, off)) for off in (1, 2, 3)]
        if stage in (2, 3, 4, 7, 8):
            crafted = (mp.crafted_masked_rows(1000) if stage == 4 else
                       {2: mp.crafted_dyn_rows, 3: mp.crafted_fori_rows,
                        7: mp.crafted_step_rows,
                        8: mp.crafted_tlv_rows}[stage](seed, 64))
            edges.append(("crafted", crafted))
            if stage in (2, 3, 7):  # each case elsewhere in a block
                edges.append(("crafted, shifted by one lane", crafted[:, 1:]))
        model = {3: lambda r: mp.fori_window_model(r)[0],
                 4: mp.fori_masked_model}.get(stage)
        if model is not None:
            check(np.array_equal(got.cpu().numpy(), model(words)),
                  f"probe stage {name} != its model at {n} lanes")
        for what, rows in edges:
            r = rows if torch.is_tensor(rows) else mp.to_tensor(rows, device)
            check(r.is_contiguous() and (r.data_ptr() % 16 != 0) == (
                "alignment" in what), f"the {what} rows are laid out wrong")
            got_e = mp.kernel_stage(stage, r)
            check(torch.equal(got_e, mp.plain_stage(stage, r)),
                  f"probe stage {name} != plain on {what} rows")
            if model is not None:
                check(np.array_equal(got_e.cpu().numpy(), model(rows)),
                      f"probe stage {name} != its model on {what} rows")
        k_ms = mp.time_stage(stage, w, TIMED_REPS, KERNEL_CALLS_PER_TIMING)
        p_ms = cuda_times(lambda: mp.plain_stage(stage, w), PLAIN_REPS, warmup=1)
        lib_ms = None
        if stage in (0, 5):  # a masked sum is one library reduction

            def lib():
                return torch.sum(w & 0xFF, dim=0, keepdim=True,
                                 dtype=torch.int32)

            check(torch.equal(lib(), got), f"torch.sum != stage {name}")
            lib_ms = median(cuda_times(lib, TIMED_REPS, KERNEL_CALLS_PER_TIMING))
        words_read = reads = 0
        sectors = 0.0
        for lo in range(0, n, FOOTPRINT_CHUNK):  # chunks of whole sectors
            wr, sec, rd = mp.footprint(stage, w[:, lo:lo + FOOTPRINT_CHUNK])
            words_read += int(wr.sum())
            sectors += float(sec.sum())
            reads += int(rd.sum())
        sectors = round(sectors)
        byte_ms = (sectors * 32 + n * 4) / HBM_BYTES_PER_S * 1e3
        # Stage 4's function needs its one-pass form's operations on every
        # word, not a few a byte read.
        ops = (n * mp.WORDS * mp.MASKED_OPS_PER_WORD if stage == 4
               else reads * OPS_PER_BYTE_READ)
        op_ms = ops / INT32_OPS_PER_S * 1e3
        st = {"name": name, "lanes": n, "max_abs_err": err,
              "kernel_ms": median(k_ms), "kernel_ms_min": min(k_ms),
              "kernel_ms_max": max(k_ms), "plain_ms": median(p_ms),
              "library_ms": lib_ms, "words_per_lane": words_read / n,
              "sectors_per_lane": sectors / n,
              "reads_per_lane": reads / n, "bytes_bound_ms": byte_ms,
              "ops_bound_ms": op_ms, "bound_ms": max(byte_ms, op_ms),
              "bound_by": "bytes" if byte_ms >= op_ms else "operations",
              "edge_rows": [what for what, _rows in edges],
              "ladder_launches": ladder["probe"][stage]}
        st["share_of_bound"] = st["bound_ms"] / st["kernel_ms"]
        floors = ""
        if stage in (1, 7):  # how near the card's floors for one word a lane
            st.update(word_floors(mp, w))
            check(st.pop("onehot_library_equal"),
                  "stage 1's library call != its kernel")
            if stage == 1:
                st["library_ms"] = lib_ms = st["onehot_library_ms"]
            floors = (f"; floors: empty launch {st['empty_lane_grid_ms']:.4f}"
                      f" ms at one lane a thread {st['empty_lane_grid']}, "
                      f"{st['empty_stage_grid_ms']:.4f} at the stage's "
                      f"{st['empty_stage_grid']}, "
                      f"{st['empty_one_block_ms']:.4f} of one block; "
                      f"out.copy_(w[4]) {st['copy_ms']:.4f} ms")
        if stage == 2:  # how near the card's floor for a scattered read
            st.update(dyn_floors(mp, words, w, seed))
            check(st.pop("equal"), "a stage-2 floor != what it stands in for")
            st["l2_fetch_granularity"] = mp.l2_fetch_granularity(device)
            floors = (f"; floors: torch.gather {st['scatter_floor_ms']:.4f} "
                      f"ms, no scattered read {st['no_scatter_ms']:.4f} ms; "
                      f"L2 fetch granularity {st['l2_fetch_granularity']} B")
        stages.append(st)
        print(f"phase 4: probe {name} == plain at {n} lanes"
              + (f" and on {len(edges)} edge sets" if edges else "")
              + f"; kernel {st['kernel_ms']:.4f} ms, plain "
              f"{st['plain_ms']:.3f} ms, bound {st['bound_ms']:.4f} ms "
              f"({st['bound_by']}; {words_read / n:.2f} words, "
              f"{sectors / n:.2f} sectors a lane; ops "
              f"{op_ms:.4f} ms), {st['share_of_bound']:.1%} of bound"
              + (f", torch.sum {lib_ms:.4f} ms" if stage in (0, 5) else "")
              + (f", library {lib_ms:.4f} ms" if stage == 1 else "") + floors,
              flush=True)
    return {"ladder_launches": ladder, "stages": stages}


# -- phases 5 and 6: the two lanes over the same batches -----------------

class StageTimes:
    """Host-clock time of the layers of ``IngestModel.ingest_packed``.
    Walker lane: the device step (synchronised before and after, so it
    holds the copies in and every kernel of the step), the fold
    (``_consume_out``: readbacks, filters, per-lane serials, metadata)
    and the exact host lane. Pre-parsed lane: sidecar extraction, the
    device step and the fold (its host lane included). What is left of
    a call is the host's chunking and routing plan."""

    def __init__(self, model) -> None:
        from ct_mapreduce_tpu_torch.models import ingest_model

        agg = model.aggregator
        self.times: dict[str, list[float]] = {}
        self._undo = []
        if model.preparsed:
            self._patch(ingest_model.leafpack, "extract_sidecars", "sidecar")
            self._patch(agg, "_device_step_preparsed", "device_step", True)
            self._patch(agg, "_fold_preparsed", "fold")
        else:
            self._patch(agg, "_device_step_packed", "device_step", True)
            self._patch(agg, "_consume_out", "fold")
            self._patch(agg, "_host_lanes", "host_lane")

    def _patch(self, obj, attr: str, name: str, sync: bool = False) -> None:
        import torch

        fn = getattr(obj, attr)
        times = self.times.setdefault(name, [])

        def run(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out

        setattr(obj, attr, run)
        self._undo.append((obj, attr, fn))

    def close(self) -> dict:
        for obj, attr, fn in self._undo:
            setattr(obj, attr, fn)
        return self.times


class InsertCount:
    """Counts the bucket inserts (``pipeline.table_insert``, PyTorch
    tensor ops until K2 has its kernel) of a main path, the step's and a
    grow's re-insert chunks, and does nothing else to them."""

    def __init__(self) -> None:
        from ct_mapreduce_tpu_torch.ops import pipeline

        self._fn = pipeline.table_insert
        self.calls = 0

        def run(*args, **kwargs):
            self.calls += 1
            return self._fn(*args, **kwargs)

        pipeline.table_insert = run

    def close(self) -> int:
        from ct_mapreduce_tpu_torch.ops import pipeline

        pipeline.table_insert = self._fn
        return self.calls


def _clone_table(table):
    """A copy of a dedup table of either layout."""
    return type(table)(table.rows.clone(), table.count.clone())


def insert_cost(model, stream: Stream, idx_of, n: int, replay: float,
                lane: str) -> dict:
    """One step's insert (the table's layout), apart from the timed
    batches: one more batch goes through the lane with the step's insert
    (the call of width ``n``) captured, with a copy of the table before
    it. The call is then replayed on fresh copies of that table, each
    replay timed with CUDA events (the open insert reads ``pending``
    back every round, so each replay also ends synchronised) and its
    verdicts held to the captured ones. ``_extra_ctr`` holds the extra
    batch's counters that pass the filters (for a later oracle).

    Its byte bound: the distinct home rows its valid keys name, read
    once, and the rows its new keys fill, written once (bucket: the
    home bucket's 512 B row; open: the 20 B slot row; hops and later
    probe positions are left out, so this bounds from below), plus 16 B
    of key, 4 B of meta and 1 B of valid in and 2 B of verdicts out a
    lane."""
    import numpy as np
    import torch

    from ct_mapreduce_tpu_torch.ops import buckettable, hashtable, pipeline

    fn = pipeline.table_insert
    captured = []

    def run(table, keys, meta, valid, **kwargs):
        if keys.shape[0] != n or captured:
            return fn(table, keys, meta, valid, **kwargs)
        before = _clone_table(table)
        out = fn(table, keys, meta, valid, **kwargs)
        captured.append((before, keys, meta, valid, kwargs, out[1], out[2]))
        return out

    pipeline.table_insert = run
    try:
        data, length, tof, ctr = stream.batch(n, replay)
        model.ingest_packed(data, length, idx_of[tof], np.ones((n,), bool))
    finally:
        pipeline.table_insert = fn
    check(len(captured) == 1, f"{lane}: no insert of the step's width")
    before, keys, meta, valid, kwargs, new, ovf = captured[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range(TIMED_REPS):
        table = _clone_table(before)
        start.record()
        _t, got_new, got_ovf = fn(table, keys, meta, valid, **kwargs)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        check(torch.equal(got_new, new) and torch.equal(got_ovf, ovf),
              f"{lane}: a replayed insert gave other verdicts")
    if isinstance(before, hashtable.TableState):
        home = hashtable._home_slot(hashtable._desentinel(keys),
                                    before.capacity)
        rows_read = int(torch.unique(home[valid]).numel())
        rows_written = int(new.sum())
        row_bytes = hashtable.ROW_WORDS * 4
    else:
        home = buckettable._home_bucket(buckettable._desentinel(keys),
                                        before.n_buckets)
        rows_read = int(torch.unique(home[valid]).numel())
        rows_written = int(torch.unique(home[new]).numel())
        row_bytes = buckettable.ROW_WORDS * 4
    moved = (rows_read + rows_written) * row_bytes + n * (16 + 4 + 1 + 2)
    return {"ms": median(ms), "ms_min": min(ms), "ms_max": max(ms),
            "rows_read": rows_read, "rows_written": rows_written,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "_extra_ctr": ctr[~stream.filtered[tof]]}


def _config(batch_log2: int, table_bits: int, preparsed: bool,
            prefixes: tuple[str, ...] = ()):
    from ct_mapreduce_tpu_torch.config import CTConfig

    return CTConfig(preparsed_ingest=preparsed, batch_size=1 << batch_log2,
                    table_bits=table_bits,
                    issuer_cn_filter=",".join(prefixes))


def _oracle_snapshot(stream: Stream, seen):
    """Drained counts, CRL and DN sets of the serials ``seen``."""
    import numpy as np

    from ct_mapreduce_tpu_torch.core.types import ExpDate

    counts: dict = {}
    crls: dict = {}
    dns: dict = {}
    per_tpl = np.bincount(stream.template_of[np.nonzero(seen)[0]],
                          minlength=len(stream.templates))
    for t, c in enumerate(per_tpl):
        if c == 0:
            continue
        tr = stream.truth[t]
        key = (tr["issuer"], ExpDate.from_unix_hour(tr["hour"]).id())
        counts[key] = counts.get(key, 0) + int(c)
        crls.setdefault(tr["issuer"], set()).update(tr["crls"])
        dns.setdefault(tr["issuer"], set()).add(tr["dn"])
    return counts, crls, dns


def main_path(device, stream: Stream, n_batches: int, batch_log2: int,
              table_bits: int, replay: float, preparsed: bool,
              drain_after: int = 0, keep: bool = False, mesh=None,
              cost: bool = True, keep_wu: bool = False) -> dict:
    """One lane through ``IngestModel.ingest_packed`` over ``n_batches``
    of ``stream``, every batch and the drain held to the oracle, in the
    table layout ``CTMR_TABLE`` selects; over ``mesh`` (a
    ``ShardedAggregator``) when one is given. ``drain_after`` also keeps
    the drain after that many batches (``drain_at``); ``keep`` keeps the
    model (``_model``) and the truth of everything it ingested, the
    insert-cost batch included (``_truth``: the stream and its seen
    counters). ``cost`` replays one more step's insert (K2 or K8; K7 on
    a mesh) apart from the timed batches; ``keep_wu`` keeps every
    batch's ``was_unknown`` (``_wu``)."""
    import numpy as np

    from ct_mapreduce_tpu_torch.models.ingest_model import IngestModel
    from ct_mapreduce_tpu_torch.ops import hashtable

    model = IngestModel.from_config(
        _config(batch_log2, table_bits, preparsed, stream.cn_prefixes()),
        mesh=mesh, device=device)
    agg = model.aggregator
    layout = ("open" if isinstance(agg.table, hashtable.TableState)
              else "bucket")
    lane = ("sharded-" if mesh is not None else "") + (
        "preparsed" if preparsed else "walker") + (
        "-open" if layout == "open" else "")
    idx_of = stream.issuer_indices(model)
    cap0 = agg.capacity
    n = 1 << batch_log2
    seen = np.zeros((stream.next_counter + n_batches * n + 1,), bool)
    step_s, gen_s = [], []
    stages = StageTimes(model)
    inserts = InsertCount()
    reset_counts()
    drain_at = None
    wus = []
    for i in range(n_batches):
        t0 = time.perf_counter()
        data, length, tof, ctr = stream.batch(n, replay)
        t1 = time.perf_counter()
        res = model.ingest_packed(data, length, idx_of[tof],
                                  np.ones((n,), bool))
        step_s.append(time.perf_counter() - t1)
        gen_s.append(t1 - t0)
        wus.append(res.was_unknown)
        # Oracle: the first sighting of a (template, counter) among the
        # lanes that pass the filters is the one unknown lane.
        passing = ~stream.filtered[tof]
        _, first = np.unique(ctr[passing], return_index=True)
        want = np.zeros((n,), bool)
        cand = np.nonzero(passing)[0][first]
        want[cand[~seen[ctr[cand]]]] = True
        seen[ctr[passing]] = True
        check(np.array_equal(res.was_unknown, want),
              f"{lane}: was_unknown differs from the oracle on "
              f"{int((res.was_unknown != want).sum())} lanes")
        check(np.array_equal(res.filtered, ~passing),
              f"{lane}: filter verdicts differ")
        if i + 1 == drain_after:
            drain_at = model.drain()
    launches = read_counts()
    stage_s = stages.close()
    insert_calls = inserts.close()
    check(insert_calls > 0, f"{lane}: no {layout} insert on the main path")
    check(launches["sha256_fp"] > 0,
          f"{lane}: the fingerprint kernel never ran on the main path")
    check(preparsed or launches["der_walk"] > 0,
          "walker: the walker kernel never ran on the main path")
    check(agg.capacity > cap0 or not cost,
          f"{lane}: no table grow on the main path")

    snap = model.drain()
    counts, crls, dns = _oracle_snapshot(stream, seen)
    check(snap.counts == counts, f"{lane}: drained counts differ from the oracle")
    check(snap.crls == crls, f"{lane}: drained CRL sets differ from the oracle")
    check(snap.dns == dns, f"{lane}: drained DN sets differ from the oracle")
    check(snap.total == int(seen.sum()), f"{lane}: drained total differs")
    entries = n_batches * n
    out = {
        "lane": lane, "layout": layout, "batches": n_batches, "batch": n,
        "entries": entries,
        "cn_prefixes": list(stream.cn_prefixes()),
        "unique_serials": int(seen.sum()), "launches": launches,
        "capacity_start": cap0, "capacity_end": agg.capacity,
        "ingest_s_per_batch": step_s, "gen_s_per_batch": gen_s,
        "stage_s_per_batch": stage_s,
        "entries_per_s": entries / sum(step_s),
        "device_share": sum(stage_s["device_step"]) / sum(step_s),
        "metrics": dict(agg.metrics),
        "snapshot": snap,
    }
    if keep_wu:
        out["_wu"] = wus
    # After the drain's check, so the extra batch is in no oracle.
    extra_ctr = np.zeros((0,), np.int64)
    if cost:
        fn = k7_cost if mesh is not None else insert_cost
        out["insert"] = dict(fn(model, stream, idx_of, n, replay, lane),
                             calls=insert_calls)
        extra_ctr = out["insert"].pop("_extra_ctr")
    insert = out.get("insert", {"calls": insert_calls, "ms": float("nan"),
                                "bound_ms": float("nan")})
    if drain_after:
        out["drain_at"] = drain_at
    if keep:
        truth = np.zeros((max(seen.shape[0], stream.next_counter + 1),),
                         bool)
        truth[: seen.shape[0]] = seen
        truth[extra_ctr] = True
        out["_model"], out["_truth"] = model, (stream, truth)
    parts = ", ".join(f"{k} {median(v):.3f}" for k, v in stage_s.items() if v)
    print(f"{lane} lane: {entries} entries in {n_batches} batches of {n}, "
          f"{out['unique_serials']} unique, {out['metrics']['host_lane']} "
          f"host-lane lanes; drain == oracle; table {cap0} -> "
          f"{out['capacity_end']} "
          f"slots ({layout}); launches {launches['sha256_fp']} K1, "
          f"{launches['der_walk']} K3; {out['entries_per_s']:.0f} entries/s "
          f"through ingest_packed (median {median(step_s):.3f} s/batch: "
          f"{parts}); insert {insert['calls']} calls, one step's "
          f"{insert['ms']:.2f} ms apart from them, bound "
          f"{insert['bound_ms']:.4f} ms (bytes)", flush=True)
    return out


def k7_cost(model, stream: Stream, idx_of, n: int, replay: float,
            lane: str) -> dict:
    """One sharded step's K7 (dispatch, exchange, shard inserts, the
    verdicts' way home and the counts' sum), apart from the timed
    batches: one more batch goes through the lane with the step's
    ``ShardedDedup.k7`` call captured, with copies of the shard tables
    before it; the call is then replayed on fresh copies of those tables,
    each replay timed with CUDA events and its verdicts and counts held
    to the captured ones. ``_extra_ctr`` holds the extra batch's passing
    counters.

    Its byte bound: every lane's 5-word payload (4 fingerprint words and
    the meta word) sent to its home shard and a verdict word returned, a
    shard's distinct home rows read once and the rows its new keys fill
    written once (512 B bucket rows; hops left out, so this bounds from
    below), plus the insertable flag read a lane."""
    import numpy as np
    import torch

    from ct_mapreduce_tpu_torch.agg import sharded
    from ct_mapreduce_tpu_torch.ops import buckettable

    cls = sharded.ShardedDedup
    fn = cls.k7
    captured = []

    def run(self, lanes, cap, tables=None):
        # The step may grow the table first: capture on whichever
        # dedup the step runs.
        if captured or tables is not None:
            return fn(self, lanes, cap, tables)
        before = self.clone_tables()
        res, counts = fn(self, lanes, cap)
        captured.append((self, before, lanes, cap, res, counts))
        return res, counts

    cls.k7 = run
    try:
        data, length, tof, ctr = stream.batch(n, replay)
        model.ingest_packed(data, length, idx_of[tof], np.ones((n,), bool))
    finally:
        cls.k7 = fn
    check(len(captured) == 1, f"{lane}: no K7 call on the step")
    dedup, before, lanes, cap, res, counts = captured[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range(TIMED_REPS):
        tables = {s: type(t)(t.rows.clone(), t.count.clone())
                  for s, t in before.items()}
        torch.cuda.synchronize()
        start.record()
        got, got_counts = fn(dedup, lanes, cap, tables)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        check(all(torch.equal(got[s][i], res[s][i]) for s in res
                  for i in range(3)) and torch.equal(got_counts, counts),
              f"{lane}: a replayed K7 gave other verdicts")
    lanes_n = sum(int(v[0].shape[0]) for v in lanes.values())
    read, written = [], []
    nb = next(iter(before.values())).n_buckets
    for s, (fps, _meta, ins) in lanes.items():
        keys = buckettable._desentinel(fps)
        home = (sharded._shard_of(keys, dedup.n_shards) * nb
                + buckettable._home_bucket(keys, nb)).cpu()
        read.append(home[ins.cpu()])
        written.append(home[res[s][0].cpu()])
    rows_read = int(torch.unique(torch.cat(read)).numel())
    rows_written = int(torch.unique(torch.cat(written)).numel())
    moved = ((rows_read + rows_written) * buckettable.ROW_WORDS * 4
             + lanes_n * (20 + 4 + 1))
    return {"ms": median(ms), "ms_min": min(ms), "ms_max": max(ms),
            "cap": cap, "lanes": lanes_n, "rows_read": rows_read,
            "rows_written": rows_written,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "_extra_ctr": ctr[~stream.filtered[tof]]}


# -- phase 7: state at a deployment's scale ----------------------------

def deployment_state(device, stream: Stream, table_bits: int,
                     batch_log2: int, fill: float, seed: int) -> dict:
    import numpy as np
    import torch

    from ct_mapreduce_tpu_torch.core import packing
    from ct_mapreduce_tpu_torch.models.ingest_model import IngestModel
    from ct_mapreduce_tpu_torch.ops import buckettable

    model = IngestModel.from_config(
        _config(batch_log2, table_bits, True, stream.cn_prefixes()),
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
    reset_counts()
    t0 = time.perf_counter()
    res = model.ingest_packed(data, length, idx_of[tof], np.ones((n,), bool))
    step_s = time.perf_counter() - t0
    launches = read_counts()["sha256_fp"]
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
    print(f"phase 7: {out['buckets']} buckets ({out['table_bytes']} B), "
          f"{out['prefill_keys']} keys prefilled in {prefill_s:.2f} s "
          f"(load {load:.3f}); batch of {n} in {step_s:.3f} s (device "
          f"step {stage_s['device_step'][0]:.3f} s); "
          f"was_unknown == oracle; contains found every key", flush=True)
    return out


# -- phase 8: the ingest sink on raw get-entries pages ------------------

SINK_BATCH = 1 << 16  # batchSize 65,536, the config default
SINK_TABLE_BITS = 20  # 1,572,864 slots (the default 22 needs 4x the entries)
SINK_PAGE = 1000  # entries a get-entries page (the log client's batch)
# Enough entries that the unique serials (about 1,250,000) pass the grow
# load (0.7 of tableBits 20's 1,572,864 slots) at the replay share below.
SINK_CHUNKS = 24
SINK_REPLAY = 0.1
# The config directives each sink is built from (``build_sink``):
# deviceQueueDepth, chunksPerDispatch, stagingDepth, preparsedIngest.
SINK_CONFIGS = {
    "unstaged": dict(device_queue_depth=2),
    "staged": dict(device_queue_depth=2, chunks_per_dispatch=8,
                   staging_depth=2),
    "preparsed": dict(device_queue_depth=2, preparsed_ingest=True),
}


def sink_config(name: str, stream: "Stream"):
    """The deployment config of sink configuration ``name``: the
    defaults' batchSize and tableBits, the stream's CN filter and the
    configuration's sink directives."""
    import dataclasses

    return dataclasses.replace(
        _config(SINK_BATCH.bit_length() - 1, SINK_TABLE_BITS, False,
                stream.cn_prefixes()), backend="tpu", **SINK_CONFIGS[name])


def wire_extra_data(stream: Stream) -> list[str]:
    """Each template's ``extra_data`` as a log serves it: the base64
    chain holding its issuer certificate."""
    import base64

    from ct_mapreduce_tpu_torch.ingest import leaf as leaflib

    return [base64.b64encode(leaflib.encode_extra_data([t.issuer_der]))
            .decode() for t in stream.templates]


def sink_entries(stream: Stream, extra: list[str], n: int, replay: float,
                 within_batch_only: bool = False):
    """``n`` of ``stream``'s lanes as a log serves them: the base64
    ``leaf_input`` (an RFC 6962 MerkleTreeLeaf holding the X.509 entry)
    and ``extra_data`` (``extra`` by template) of each. Returns (leaf
    inputs, extra datas, template id, counter) per lane."""
    import binascii

    import numpy as np

    data, length, tof, ctr = stream.batch(n, replay, within_batch_only)
    # version, leaf type, timestamp (8 bytes: 1000 ms), entry type (2),
    # the certificate's 3-byte length.
    head = np.zeros((n, 15), np.uint8)
    head[:, 8] = 0x03
    head[:, 9] = 0xE8
    head[:, 12] = (length >> 16) & 0xFF
    head[:, 13] = (length >> 8) & 0xFF
    head[:, 14] = length & 0xFF
    lis = [binascii.b2a_base64(
        head[i].tobytes() + data[i, :length[i]].tobytes() + b"\0\0",
        newline=False).decode() for i in range(n)]
    eds = [extra[t] for t in tof]
    return lis, eds, tof, ctr


def h2d_costs(device, rows: int, width: int) -> dict:
    """One sink chunk's rows (``rows`` x ``width`` bytes) to the card: a
    copy from pinned memory, a copy from pageable memory, and the host
    copy into a pinned bounce buffer that pageable rows would need first,
    each timed on its own (CUDA events for the copies)."""
    import numpy as np
    import torch

    pinned = torch.empty((rows, width), dtype=torch.uint8, pin_memory=True)
    pageable = torch.from_numpy(np.ones((rows, width), np.uint8))
    pinned.copy_(pageable)
    ms = {}
    for name, src in (("pinned", pinned), ("pageable", pageable)):
        ms[f"h2d_{name}_ms"] = median(cuda_times(
            lambda src=src: src.to(device, non_blocking=True), 9))
    t = []
    for _ in range(9):
        t0 = time.perf_counter()
        pinned.copy_(pageable)
        t.append((time.perf_counter() - t0) * 1e3)
    ms["bounce_copy_ms"] = median(t)
    ms["bytes"] = rows * width
    return ms


def sink_run(device, name: str, chunks: int, seed: int) -> dict:
    """Phase 8, one configuration: ``chunks`` x ``SINK_BATCH`` entries of
    the walker-main stream as raw pages through
    ``AggregatorSink.store_raw_batch``, the drain held to the oracle."""
    import numpy as np
    import torch

    from ct_mapreduce_tpu_torch.ingest import sync
    from ct_mapreduce_tpu_torch.telemetry import metrics

    stream = Stream(seed, cn_filter=True)
    sink, model = sync.build_sink(sink_config(name, stream), device=device)
    agg = model.aggregator
    cap0 = agg.capacity
    n_total = chunks * SINK_BATCH
    seen = np.zeros((n_total + 2,), bool)
    metrics.get_sink().reset()
    inserts = InsertCount()
    reset_counts()
    sink_s = gen_s = 0.0
    lis, eds, start = [], [], 0
    extra = wire_extra_data(stream)
    for i in range(chunks):
        t0 = time.perf_counter()
        li, ed, tof, ctr = sink_entries(stream, extra, SINK_BATCH,
                                        SINK_REPLAY)
        seen[ctr[~stream.filtered[tof]]] = True
        lis += li
        eds += ed
        t1 = time.perf_counter()
        # Whole pages, as a log serves them; the rest waits for the next
        # lanes (and goes as one short page at the end).
        n_pages = len(lis) // SINK_PAGE if i + 1 < chunks else -(
            -len(lis) // SINK_PAGE)
        for p in range(n_pages):
            page = slice(p * SINK_PAGE, (p + 1) * SINK_PAGE)
            sink.store_raw_batch(sync.RawBatch(
                lis[page], eds[page], start, "smoke-log"))
            start += len(lis[page])
        del lis[: n_pages * SINK_PAGE], eds[: n_pages * SINK_PAGE]
        sink_s += time.perf_counter() - t1
        gen_s += t1 - t0
    t1 = time.perf_counter()
    sink.close()
    torch.cuda.synchronize()
    sink_s += time.perf_counter() - t1
    launches = read_counts()
    insert_calls = inserts.close()
    snap = metrics.get_sink().snapshot()
    counters, samples = snap["counters"], snap["samples"]

    t0 = time.perf_counter()
    drained = agg.drain()
    drain_s = time.perf_counter() - t0
    counts, crls, dns = _oracle_snapshot(stream, seen)
    check(drained.counts == counts, f"sink {name}: drained counts differ "
          "from the oracle")
    check(drained.crls == crls and drained.dns == dns,
          f"sink {name}: drained CRL or DN sets differ from the oracle")
    check(drained.total == int(seen.sum()), f"sink {name}: total differs")
    check(insert_calls > 0, f"sink {name}: no bucket insert")
    check(launches["sha256_fp"] > 0, f"sink {name}: K1 never ran")
    check(name == "preparsed" or launches["der_walk"] > 0,
          f"sink {name}: K3 never ran")
    check(agg.capacity > cap0, f"sink {name}: the table never grew")
    h2d = counters.get("ingest.h2d_bytes", 0.0)
    pinned = counters.get("ingest.h2d_pinned_bytes", 0.0)
    if name != "preparsed":
        check(h2d > 0 and pinned == h2d,
              f"sink {name}: {h2d - pinned} of {h2d} copied bytes not pinned")
    pool = sink._row_bufs
    if name != "preparsed":
        # One buffer for each chunk or envelope in flight and one being
        # filled, all pinned, none made after the first fill.
        keep = (sink.staging_depth if sink.chunks_per_dispatch > 1
                else sink.device_queue_depth)
        check(1 <= pool.allocated == pool.live <= keep + 1,
              f"sink {name}: {pool.allocated} row buffers made, "
              f"{pool.live} kept; want at most {keep + 1}")
        check(all(b.is_pinned() for b in pool._free),
              f"sink {name}: a row buffer is not pinned")

    def p50(key):
        v = samples.get(key)
        return v["p50"] if v else None

    out = {
        "config": name, "sink_config": SINK_CONFIGS[name],
        "entries": n_total,
        "chunks": chunks, "unique_serials": int(seen.sum()),
        "entries_per_s": n_total / sink_s, "sink_s": sink_s,
        "gen_s": gen_s, "drain_s": drain_s,
        "capacity_start": cap0, "capacity_end": agg.capacity,
        "launches": launches, "insert_calls": insert_calls,
        "h2d_bytes": h2d, "h2d_pinned_bytes": pinned,
        "row_buffers": pool.allocated,
        "row_buffer_bytes": pool.capacity,
        "p50_s": {"decode": p50("ct-fetch.decodeBatch"),
                  "submit": p50("ct-fetch.storeCertificate"),
                  "h2d_enqueue": p50("ct-fetch.h2dSubmit"),
                  "complete": p50("ct-fetch.completeBatch")},
        "metrics": dict(agg.metrics),
        "_truth": (stream, seen),
    }
    print(f"phase 8 sink {name}: {n_total} entries as {SINK_PAGE}-entry "
          f"pages, {out['unique_serials']} unique, drain == oracle, table "
          f"{cap0} -> {agg.capacity} slots; launches "
          f"{launches['sha256_fp']} K1, {launches['der_walk']} K3, "
          f"{insert_calls} inserts; {out['entries_per_s']:.0f} entries/s "
          f"(p50 s a chunk: " + ", ".join(
              f"{k} {v:.4f}" for k, v in out["p50_s"].items()
              if v is not None)
          + f"); {pinned:.0f} of {h2d:.0f} copied bytes pinned", flush=True)
    return out, model, drained


# -- phase 9: checkpoints on the card -----------------------------------

def _ckpt_dir() -> str:
    path = os.path.join(HERE, "build", "smoke_ckpt")
    if os.path.isdir(path):
        for f in os.listdir(path):
            os.unlink(os.path.join(path, f))
    os.makedirs(path, exist_ok=True)
    return path


def checkpoints(device, staged_model, staged_drain, seed: int) -> dict:
    """(i) the staged sink's grown table saved as ck01 and as a ck02
    base, each loaded on the card and on the CPU to the same drain; (ii)
    an ``IngestModel`` with ``aggStatePath`` writing a ck02 base and two
    segments of one batch each; (iii) that chain restored on the card
    to the writer's digest; (iv) the restored model resuming to the
    oracle's drain."""
    import numpy as np

    from ct_mapreduce_tpu_torch.agg import ckpt
    from ct_mapreduce_tpu_torch.agg.aggregator import (
        TorchAggregator, ckpt_state_digest)
    from ct_mapreduce_tpu_torch.models.ingest_model import IngestModel
    from ct_mapreduce_tpu_torch.telemetry import metrics

    d = _ckpt_dir()
    out = {"saves": {}, "loads": {}}
    agg = staged_model.aggregator
    for mode in ("ck01", "ck02"):
        path = os.path.join(d, f"staged-{mode}.npz")
        agg.configure_checkpointing(mode=mode)
        t0 = time.perf_counter()
        agg.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        out["saves"][mode] = {"s": save_s, "bytes": os.path.getsize(path),
                              "slots": agg.capacity}
        check((mode == "ck02") == os.path.exists(ckpt.manifest_path(path)),
              f"{mode}: a manifest where there should be none, or none "
              "where there should be one")
        for dev in (device, "cpu"):
            t0 = time.perf_counter()
            r = TorchAggregator(capacity=1 << 10, device=dev)
            r.load_checkpoint(path)
            load_s = time.perf_counter() - t0
            check(r.drain() == staged_drain,
                  f"{mode} loaded on {dev}: the drain differs from the sink's")
            out["loads"][f"{mode}@{dev}"] = load_s
            if mode == "ck01" and dev == device:
                out["_restored"] = r  # phase 11 serves it
            del r
    print(f"phase 9 (i): the staged sink's {agg.capacity}-slot table saved "
          + ", ".join(f"{m} {v['bytes']} B in {v['s']:.2f} s"
                      for m, v in out["saves"].items())
          + "; loaded " + ", ".join(f"{k} in {v:.2f} s"
                                    for k, v in out["loads"].items())
          + "; every drain == the sink's", flush=True)
    # Phase 15 (c) loads the ck01 onto a mesh.
    keep = os.path.join(HERE, "build", "smoke_p15")
    os.makedirs(keep, exist_ok=True)
    out["_p9_path"] = os.path.join(keep, "phase9-ck01.npz")
    os.replace(os.path.join(d, "staged-ck01.npz"), out["_p9_path"])

    stream = Stream(seed + 1, cn_filter=True)
    path = os.path.join(d, "model.npz")
    cfg = _config(SINK_BATCH.bit_length() - 1, SINK_TABLE_BITS, False,
                  stream.cn_prefixes())
    cfg.agg_state_path = path
    cfg.checkpoint_mode = "ck02"
    writer = IngestModel.from_config(cfg, device=device)
    idx_of = stream.issuer_indices(writer)
    batches = [stream.batch(SINK_BATCH, 0.3) for _ in range(5)]
    seen = np.zeros((stream.next_counter + 1,), bool)
    metrics.get_sink().reset()
    tick_s = []
    for data, length, tof, ctr in batches[:3]:
        writer.ingest_packed(data, length, idx_of[tof],
                             np.ones((SINK_BATCH,), bool))
        seen[ctr[~stream.filtered[tof]]] = True
        t0 = time.perf_counter()
        writer.save()
        tick_s.append(time.perf_counter() - t0)
    written = metrics.get_sink().snapshot()["counters"].get(
        "ckpt.segments_written", 0)
    chain = ckpt.resolve_chain(path)
    check(written == 2 and len(chain.segments) == 2,
          f"ck02: {written} segments written, {len(chain.segments)} "
          "in the chain; want 2")
    want = ckpt_state_digest(writer.aggregator)
    t0 = time.perf_counter()
    restored = IngestModel.from_config(cfg, device=device)
    restore_s = time.perf_counter() - t0
    check(restored.aggregator.table.rows.is_cuda,
          "the restored table is not on the card")
    check(ckpt_state_digest(restored.aggregator) == want,
          "the restored chain's digest differs from the writer's")
    for data, length, tof, ctr in batches[3:]:
        restored.ingest_packed(data, length, idx_of[tof],
                               np.ones((SINK_BATCH,), bool))
        seen[ctr[~stream.filtered[tof]]] = True
    snap = restored.drain()
    counts, crls, dns = _oracle_snapshot(stream, seen)
    check(snap.counts == counts and snap.crls == crls and snap.dns == dns,
          "the resumed model's drain differs from the oracle")
    out.update({
        "base_s": tick_s[0], "segment_s": tick_s[1:], "restore_s": restore_s,
        "base_bytes": os.path.getsize(path),
        "segment_bytes": [os.path.getsize(ckpt.segment_path(path, i))
                          for i in (1, 2)],
        "segment_rows": [s[0]["devRows"] + s[0]["hostRows"]
                         for s in chain.segments],
    })
    print(f"phase 9 (ii-iv): ck02 base {out['base_bytes']} B in "
          f"{tick_s[0]:.2f} s, segments {out['segment_bytes']} B "
          f"({out['segment_rows']} rows) in "
          + ", ".join(f"{t:.3f}" for t in tick_s[1:])
          + f" s; restored on the card in {restore_s:.2f} s to the writer's "
          f"digest; resumed 2 batches to the oracle's drain", flush=True)
    for f in os.listdir(d):
        os.unlink(os.path.join(d, f))
    return out


# -- phase 10: ct-fetch on the card -------------------------------------

FETCH_CHUNK = SINK_BATCH  # entries the log server makes a stream call
# Entries in the served log: 12 chunks (32 before phase 12 came, 24 before
# phase 13, 16 before phase 13's edge lanes; cut so that the script
# stays under its time limit on slower hosts). Each run over it still
# grows its table once (about 625,000 unique serials against the grow
# load of 0.55 x 786,432 slots).
FETCH_ENTRIES = 12 * (1 << 16)
FETCH_TABLE_BITS = 19  # 786,432 slots: each run over the log grows once
# (d): the log at the first run, grown. Cut from (2^17, 2^18) so the
# script, phases 5b and 11 included, stays near half its time limit: the
# PEM tree's file writes are most of a (d) run. Both are multiples of
# FETCH_CHUNK, where fetch_oracle marks the truth.
RESUME_ENTRIES = (1 << 16, 1 << 17)
# The directives of each run over the whole log, beside the common ones.
FETCH_RUNS = {
    "a": {},
    "b": {"overlapWorkers": 2},
    "c": {"chunksPerDispatch": 8, "stagingDepth": 2},
}


def serve_logs(seed: int, conn) -> None:
    """The log server, in a process of its own (so its HTTP and JSON work
    does not share ct-fetch's interpreter): phase 8's stream as logs on
    127.0.0.1 — ``full``, FETCH_ENTRIES entries, and ``grow``, ``part``
    and ``dist``, its first RESUME_ENTRIES[0], SERVE_FETCH_ENTRIES and
    RESUME_ENTRIES[0] entries — each entry made by ``sink_entries`` in
    calls of FETCH_CHUNK lanes, so ``fetch_oracle`` regenerates the truth
    from the same seed. Sends the four URLs on ``conn``, then answers
    "grow" (``grow`` takes RESUME_ENTRIES[1] entries), "grow dist"
    (``dist`` takes SERVE_FETCH_ENTRIES, for phase 14), "starts" (the
    ``start`` of each get-entries request ``grow`` has answered since the
    last ask) and "stop". Two more logs, ``fleet-a`` and ``fleet-b``
    (FLEET_CHUNKS chunks), hold phase 15's fleet stream: another seed,
    its replays within a chunk, so no serial is in two logs or two
    stripes."""
    sys.path.insert(0, HERE)
    from ct_mapreduce_tpu_torch.utils.fakelog import FakeLog, LogServer

    stream = Stream(seed, cn_filter=True)
    extra = wire_extra_data(stream)
    full = FakeLog(url="https://ct.smoke.example/full")
    grow = FakeLog(url="https://ct.smoke.example/grow")
    part = FakeLog(url="https://ct.smoke.example/part")
    dist = FakeLog(url="https://ct.smoke.example/dist")
    for _ in range(FETCH_ENTRIES // FETCH_CHUNK):
        lis, eds, _, _ = sink_entries(stream, extra, FETCH_CHUNK, SINK_REPLAY)
        for li, ed in zip(lis, eds):
            full.add_raw(li, ed)
    for e in full.entries[:RESUME_ENTRIES[0]]:
        grow.add_raw(e["leaf_input"], e["extra_data"])
    for e in full.entries[:SERVE_FETCH_ENTRIES]:
        part.add_raw(e["leaf_input"], e["extra_data"])
    for e in full.entries[:RESUME_ENTRIES[0]]:
        dist.add_raw(e["leaf_input"], e["extra_data"])
    fstream = Stream(seed + FLEET_SEED, cn_filter=True)
    fextra = wire_extra_data(fstream)
    fleet = [FakeLog(url=f"https://ct.smoke.example/fleet-{c}")
             for c in "ab"]
    for log, chunks in zip(fleet, FLEET_CHUNKS):
        for _ in range(chunks):
            lis, eds, _, _ = sink_entries(fstream, fextra, FETCH_CHUNK,
                                          SINK_REPLAY, within_batch_only=True)
            for li, ed in zip(lis, eds):
                log.add_raw(li, ed)
    with LogServer(full) as s_full, LogServer(grow) as s_grow, \
            LogServer(part) as s_part, LogServer(dist) as s_dist, \
            LogServer(fleet[0]) as s_fa, LogServer(fleet[1]) as s_fb:
        conn.send((s_full.url, s_grow.url, s_part.url, s_dist.url,
                   s_fa.url, s_fb.url))
        while True:
            msg = conn.recv()
            if msg == "grow":
                for e in full.entries[len(grow.entries):RESUME_ENTRIES[1]]:
                    grow.add_raw(e["leaf_input"], e["extra_data"])
                conn.send(len(grow.entries))
            elif msg == "grow dist":
                for e in full.entries[len(dist.entries):SERVE_FETCH_ENTRIES]:
                    dist.add_raw(e["leaf_input"], e["extra_data"])
                conn.send(len(dist.entries))
            elif msg == "starts":
                conn.send([int(r.split("start=")[1].split("&")[0])
                           for r in grow.requests if "get-entries" in r])
                grow.requests.clear()
            else:
                break


class LogProcess:
    """``serve_logs`` in a spawned process (started before the earlier
    phases, so the log is made while they run); ``stop()`` ends it."""

    def __init__(self, seed: int) -> None:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=serve_logs, args=(seed, child),
                                name="smoke-log-server", daemon=True)
        self.proc.start()
        self.urls = None

    def wait_ready(self) -> tuple[str, ...]:
        """The logs' URLs (full, grow, part, dist, fleet-a, fleet-b),
        once the server has made them."""
        if self.urls is None:
            check(self._conn.poll(900), "the log server never came up")
            self.urls = self._conn.recv()
        return self.urls

    def ask(self, msg: str):
        self.wait_ready()
        self._conn.send(msg)
        return self._conn.recv()

    def stop(self) -> None:
        if self.proc.is_alive():
            try:
                self.wait_ready()
                self._conn.send("stop")
            except (OSError, EOFError):
                pass
            self.proc.join(10)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(10)


def fetch_oracle(seed: int, marks: tuple[int, ...]):
    """The served log's truth: the stream regenerated from ``seed`` by
    the same stream calls as ``serve_logs`` makes (without the base64),
    with the serials seen in the first ``m`` entries of the log for
    each ``m`` of ``marks``. Returns (stream, {m: seen})."""
    import numpy as np

    stream = Stream(seed, cn_filter=True)
    seen = np.zeros((FETCH_ENTRIES + 2,), bool)
    out = {}
    for i in range(FETCH_ENTRIES // FETCH_CHUNK):
        _, _, tof, ctr = stream.batch(FETCH_CHUNK, SINK_REPLAY)
        seen[ctr[~stream.filtered[tof]]] = True
        if (i + 1) * FETCH_CHUNK in marks:
            out[(i + 1) * FETCH_CHUNK] = seen.copy()
    return stream, out


def _fetch_ini(path: str, url: str, state: str, stream: Stream,
               extra: dict) -> str:
    """A ct-fetch ini: the log at ``url`` through the device pipeline,
    aggregates to ``state``, and ``extra``'s directives."""
    directives = {
        "logList": url, "backend": "tpu", "batchSize": SINK_BATCH,
        "tableBits": FETCH_TABLE_BITS, "deviceQueueDepth": 2,
        "issuerCNFilter": ",".join(stream.cn_prefixes()),
        "aggStatePath": state, "healthAddr": "",
    }
    directives.update(extra)
    with open(path, "w") as f:
        f.write("".join(f"{k} = {v}\n" for k, v in directives.items()))
    return path


def fetch_run(device, label: str, ini: str) -> dict:
    """One ``ct_fetch.main`` over ``ini`` on the card: its wall time, its
    kernel launches, the p50 of its stage samples, its pinned pool, and
    its model (the sink ``build_sink`` made, seen through a wrapper)."""
    import torch

    from ct_mapreduce_tpu_torch.cmd import ct_fetch
    from ct_mapreduce_tpu_torch.telemetry import metrics

    built = {}
    orig = ct_fetch.build_sink

    def spy(config, **kw):
        sink, model = orig(config, **kw)
        built.update(sink=sink, model=model, bound=sink.row_buffer_bound(),
                     cap0=model.aggregator.capacity)
        return sink, model

    ct_fetch.build_sink = spy
    inserts = InsertCount()
    reset_counts()
    t0 = time.perf_counter()
    try:
        rc = ct_fetch.main(["-config", ini, "-nobars"], device=device)
    finally:
        ct_fetch.build_sink = orig
        insert_calls = inserts.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    check(rc == 0, f"ct-fetch {label}: exit code {rc}")
    snap = metrics.get_sink().snapshot()
    samples, counters = snap["samples"], snap["counters"]
    sink, model = built["sink"], built["model"]
    pool = sink._row_bufs
    check(1 <= pool.allocated == pool.live <= built["bound"],
          f"ct-fetch {label}: {pool.allocated} row buffers made, "
          f"{pool.live} kept; want at most {built['bound']}")
    check(all(b.is_pinned() for b in pool._free),
          f"ct-fetch {label}: a row buffer is not pinned")
    h2d = counters.get("ingest.h2d_bytes", 0.0)
    check(h2d > 0 and counters.get("ingest.h2d_pinned_bytes", 0.0) == h2d,
          f"ct-fetch {label}: copied bytes not all pinned")
    check(launches["sha256_fp"] > 0 and launches["der_walk"] > 0,
          f"ct-fetch {label}: K1 or K3 never ran")

    def p50(key):
        v = samples.get(key)
        return v["p50"] if v else None

    entries = int(counters.get("ct-fetch.insertCertificate", 0)
                  + counters.get("ct-fetch.noChainError", 0)
                  + counters.get("ct-fetch.parseLeafError", 0))
    return {
        "label": label, "wall_s": wall, "entries": entries,
        "entries_per_s": entries / wall, "launches": launches,
        "insert_calls": insert_calls,
        "p50_s": {k: p50(f"ct-fetch.{k}") for k in (
            "decodeBatch", "storeCertificate", "completeBatch")},
        "get_entries_p50_s": next((v["p50"] for k, v in samples.items()
                                   if k.endswith("getRawEntries")), None),
        "row_buffers_made": pool.allocated, "row_buffers_kept": pool.live,
        "row_buffer_bound": built["bound"],
        "row_buffer_bytes": pool.capacity,
        "capacity_start": built["cap0"],
        "capacity_end": model.aggregator.capacity,
        "model": model,
    }


def _report(ini: str, verbosity: int) -> str:
    import contextlib
    import io

    from ct_mapreduce_tpu_torch.cmd import storage_statistics

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = storage_statistics.main(["-config", ini, "-v", str(verbosity)])
    check(rc == 0, f"storage-statistics -v {verbosity}: exit code {rc}")
    return buf.getvalue()


def check_report(text: str, counts: dict, what: str) -> None:
    """A ``-v 1``/``-v 2`` report's per-(issuer, expDate) lines and totals
    against the oracle's ``counts``."""
    import re

    got, issuer = {}, None
    for line in text.splitlines():
        m = re.match(r"Issuer: (\S+) ", line)
        if m:
            issuer = m.group(1)
        m = re.match(r"- (\S+) \((\d+) serials\)", line)
        if m:
            got[(issuer, m.group(1))] = int(m.group(2))
    check(got == counts, f"{what}: per-issuer counts differ from the oracle")
    total = re.search(r"overall totals: (\d+) issuers, (\d+) serials", text)
    check(total is not None and int(total.group(2)) == sum(counts.values())
          and int(total.group(1)) == len({i for i, _ in counts}),
          f"{what}: totals differ from the oracle")


def check_pems(root: str, stream: Stream, want: int) -> int:
    """The PEM tree under ``root``: one file per first-seen (serial,
    issuer, expiry date), ``want`` in all, each decoding to the leaf that
    its file name's serial (the stream's counter, stamped on a template)
    stands for, filed under that leaf's expiry date and issuer. The
    files are read by 16 threads. Returns the number of files."""
    import base64

    from ct_mapreduce_tpu_torch.core.types import ExpDate

    tpl = [(stream.rows[t, :stream.lens[t]].tobytes(),
            int(stream.ser_off[t]), int(stream.ser_len[t]),
            stream.truth[t]["issuer"],
            ExpDate.from_unix_hour(stream.truth[t]["hour"]).id())
           for t in range(len(stream.templates))]
    paths = []
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root).split(os.sep)
        if rel[0] != "state" and len(rel) == 2:
            paths += [(rel[0], rel[1], f, os.path.join(dirpath, f))
                      for f in files if not f.startswith(".")]

    def read(p):
        with open(p, "rb") as fh:
            return fh.read()

    head, tail = b"-----BEGIN CERTIFICATE-----\n", b"-----END CERTIFICATE-----\n"
    with ThreadPoolExecutor(max_workers=16) as pool:
        pems = pool.map(read, [p[3] for p in paths], chunksize=256)
        for (exp_id, issuer_id, name, _), pem in zip(paths, pems):
            check(pem.startswith(head) and pem.endswith(tail),
                  f"PEM {name}: not one CERTIFICATE block")
            leaf = base64.b64decode(pem[len(head):-len(tail)])
            sb = base64.urlsafe_b64decode(name)  # Serial.id() inverted
            counter = int.from_bytes(sb[max(1, len(sb) - 8):], "big")
            row, off, ln, issuer, exp = tpl[int(stream.template_of[counter])]
            row = bytearray(row)
            for i in range(min(8, ln - 1)):  # as _counter_tail stamps
                row[off + ln - 1 - i] = (counter >> (8 * i)) & 0xFF
            check(leaf == row and bytes(row[off:off + ln]) == sb
                  and issuer_id == issuer and exp_id == exp,
                  f"PEM {exp_id}/{issuer_id}/{name} does not decode to its "
                  "leaf")
    check(len(paths) == want,
          f"{len(paths)} PEM files, want one per first-seen serial ({want})")
    return len(paths)


def fetch_phase(device, logs: LogProcess, seed: int) -> dict:
    """Phase 10: ct-fetch on the card through ``cmd/ct_fetch.main`` and
    ``cmd/storage_statistics.main``, from inis this phase writes."""
    import shutil

    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator

    full_url, grow_url = logs.wait_ready()[:2]
    stream, seen = fetch_oracle(seed, (RESUME_ENTRIES[0], RESUME_ENTRIES[1],
                                       SERVE_FETCH_ENTRIES, FETCH_ENTRIES))
    d = os.path.join(HERE, "build", "smoke_fetch")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    counts, crls, dns = _oracle_snapshot(stream, seen[FETCH_ENTRIES])
    out, drains = {}, {}
    for name, extra in FETCH_RUNS.items():
        state = os.path.join(d, f"{name}.npz")
        ini = _fetch_ini(os.path.join(d, f"{name}.ini"), full_url, state,
                         stream, extra)
        run = fetch_run(device, name, ini)
        model = run.pop("model")
        check(run["entries"] == FETCH_ENTRIES,
              f"ct-fetch {name}: {run['entries']} entries stored, want "
              f"{FETCH_ENTRIES}")
        check(run["capacity_end"] > run["capacity_start"],
              f"ct-fetch {name}: the table never grew")
        snap = model.drain()
        check(snap.counts == counts and snap.crls == crls and snap.dns == dns,
              f"ct-fetch {name}: the drain differs from the oracle")
        r = TorchAggregator(capacity=1 << 10, device="cpu")
        r.load_checkpoint(state)
        check(r.drain() == snap,
              f"ct-fetch {name}: the checkpoint drains differently")
        drains[name] = snap
        if name == "a":
            for v in (1, 2):
                check_report(_report(ini, v), counts, f"report -v {v}")
        del model, r
        out[name] = run
        print(f"phase 10 ({name}) ct-fetch {extra or 'unstaged'}: "
              f"{run['entries']} entries from the loopback log in "
              f"{run['wall_s']:.1f} s, {run['entries_per_s']:.0f} entries/s; "
              f"drain == oracle"
              + (", reports -v 1/-v 2 == oracle" if name == "a" else "")
              + f"; table {run['capacity_start']} -> {run['capacity_end']} "
              f"slots; launches {run['launches']['sha256_fp']} K1, "
              f"{run['launches']['der_walk']} K3, {run['insert_calls']} "
              f"bucket inserts (K2); p50 s: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in run["p50_s"].items()
                  if v is not None)
              + f", a get-entries page {run['get_entries_p50_s']:.4f}"
              + f"; pinned buffers made {run['row_buffers_made']}, kept "
              f"{run['row_buffers_kept']} (bound {run['row_buffer_bound']})",
              flush=True)
    check(drains["a"] == drains["b"] == drains["c"],
          "ct-fetch (a), (b) and (c) drain differently")

    # (d) PEMs and resume: the first run over RESUME_ENTRIES[0] entries,
    # the log grows, the second run resumes from both cursors.
    certs = os.path.join(d, "certs")
    state = os.path.join(d, "d.npz")
    ini = _fetch_ini(os.path.join(d, "d.ini"), grow_url, state, stream,
                     {"certPath": certs})
    cursor_file = None
    d_runs = []
    for k, n_log in enumerate(RESUME_ENTRIES):
        if k:
            check(logs.ask("grow") == n_log, "the log did not grow")
        logs.ask("starts")  # forget the requests before this run
        run = fetch_run(device, f"d{k + 1}", ini)
        model = run.pop("model")
        starts = logs.ask("starts")
        check(bool(starts) and starts[0] == (RESUME_ENTRIES[0] if k else 0),
              f"ct-fetch d{k + 1}: first get-entries at {starts[:1]}, want "
              f"{RESUME_ENTRIES[0] if k else 0}")
        state_dir = os.path.join(certs, "state")
        cursor_file = os.path.join(state_dir, os.listdir(state_dir)[0])
        with open(cursor_file) as f:
            cursor = json.load(f)["MaxEntry"]
        check(cursor == n_log, f"ct-fetch d{k + 1}: cursor {cursor}, want "
              f"{n_log}")
        want = _oracle_snapshot(stream, seen[n_log])
        snap = model.drain()
        check((snap.counts, snap.crls, snap.dns) == want,
              f"ct-fetch d{k + 1}: the drain differs from the oracle")
        run["cursor"] = cursor
        run["segments"] = sorted(f for f in os.listdir(d)
                                 if f.startswith("d.npz.ckseg-"))
        d_runs.append(run)
        del model
        print(f"phase 10 (d{k + 1}) ct-fetch with certPath: {run['entries']} "
              f"entries in {run['wall_s']:.1f} s, "
              f"{run['entries_per_s']:.0f} entries/s; cursor {cursor}; drain "
              f"== oracle; launches {run['launches']['sha256_fp']} K1, "
              f"{run['launches']['der_walk']} K3; ck02 segments "
              f"{run['segments']}; pinned buffers made "
              f"{run['row_buffers_made']}, kept {run['row_buffers_kept']}",
              flush=True)
    t0 = time.perf_counter()
    n_pems = check_pems(certs, stream, sum(want[0].values()))
    pem_check_s = time.perf_counter() - t0
    check_report(_report(ini, 1), want[0], "report (d) -v 1")
    # One uninterrupted run over the grown log, from an empty state.
    one = _fetch_ini(os.path.join(d, "one.ini"), grow_url,
                     os.path.join(d, "one.npz"), stream, {})
    run = fetch_run(device, "d-one", one)
    one_model = run.pop("model")
    check(one_model.drain() == snap,
          "ct-fetch (d): the resumed drain differs from one uninterrupted run")
    del one_model
    out["d"] = {"runs": d_runs, "one": run, "pems": n_pems,
                "pem_check_s": pem_check_s}
    out["_oracle"] = (stream, seen[SERVE_FETCH_ENTRIES])  # 11 (iii), 14 (a)
    print(f"phase 10 (d): resumed drain == one run over {RESUME_ENTRIES[1]} "
          f"entries == oracle; {n_pems} PEM files, one per first-seen "
          f"serial, each decoding to its leaf (checked in "
          f"{pem_check_s:.1f} s)", flush=True)
    shutil.rmtree(d, ignore_errors=True)
    return out


# -- phase 5b: the open-addressing table on the card ---------------------

OPEN_BATCHES = 2  # walker-main's first two batches: the open table grows


def open_layout(device, seed: int, bucket_drain) -> dict:
    """Phase 5b: with ``CTMR_TABLE=open``, walker-main's first
    OPEN_BATCHES batches from ``tableBits`` 21 (2,097,152 slots of 20 B,
    growing once) through the walker lane, then the pre-parsed lane;
    each drain held to the oracle and to phase 5's bucket drain over the
    same batches. The walker lane's open table is then saved as ck01 on
    the card and loaded into a CPU aggregator, to the same drain and
    ``ckpt_state_digest``. Keeps that model and its truth for phase 11
    (``_model``, ``_truth``)."""
    import numpy as np
    import torch

    from ct_mapreduce_tpu_torch.agg.aggregator import (
        TorchAggregator, ckpt_state_digest)
    from ct_mapreduce_tpu_torch.ops import hashtable

    prev = os.environ.get("CTMR_TABLE")
    os.environ["CTMR_TABLE"] = "open"
    try:
        lanes = {}
        for preparsed in (False, True):
            out = main_path(device, Stream(seed, cn_filter=True),
                            OPEN_BATCHES, BATCH_LOG2, TABLE_BITS, 0.5,
                            preparsed, keep=not preparsed)
            check(out["layout"] == "open",
                  f"{out['lane']}: CTMR_TABLE=open built another layout")
            check(out.pop("snapshot") == bucket_drain,
                  f"{out['lane']}: the drain differs from phase 5's bucket "
                  "drain over the same batches")
            lanes[out["lane"]] = out
            torch.cuda.empty_cache()
    finally:
        if prev is None:
            os.environ.pop("CTMR_TABLE", None)
        else:
            os.environ["CTMR_TABLE"] = prev
    walker = lanes["walker-open"]
    agg = walker["_model"].aggregator
    check(isinstance(agg.table, hashtable.TableState)
          and agg.table.rows.is_cuda, "the open table is not on the card")
    path = os.path.join(_ckpt_dir(), "open.npz")
    agg.configure_checkpointing(mode="ck01")
    t0 = time.perf_counter()
    agg.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    with np.load(path, allow_pickle=True) as z:
        check(str(z["layout"]) == "open"
              and z["keys"].shape[0] == agg.capacity,
              "the open table's checkpoint is not an open-layout ck01")
    t0 = time.perf_counter()
    r = TorchAggregator(capacity=1 << 10, device="cpu")
    r.load_checkpoint(path)
    load_s = time.perf_counter() - t0
    check(isinstance(r.table, hashtable.TableState),
          "the open ck01 loaded into another layout")
    check(r.drain() == agg.drain(),
          "the open ck01 loaded on the CPU drains differently")
    check(ckpt_state_digest(r) == ckpt_state_digest(agg),
          "the open ck01 loaded on the CPU has another digest")
    ck = {"slots": agg.capacity, "bytes": os.path.getsize(path),
          "save_s": save_s, "load_cpu_s": load_s}
    os.unlink(path)
    del r
    print(f"phase 5b: open layout drains == oracle == phase 5's bucket "
          f"drain over {OPEN_BATCHES} batches, in both lanes; the "
          f"{ck['slots']}-slot open table saved as ck01 ({ck['bytes']} B) in "
          f"{save_s:.2f} s, loaded on the CPU in {load_s:.2f} s to the same "
          f"drain and digest", flush=True)
    return {"lanes": lanes, "ckpt": ck}


# -- phase 11: the serve plane on the card -------------------------------

SERVE_QUERIES = 1 << 15  # queries a served table answers over HTTP
SERVE_POST = 1 << 10  # queries a POST
SERVE_CLIENTS = 4  # client threads posting at once
SERVE_REPLICAS = 2
SERVE_CACHE = 4096
SERVE_LONG_SERIALS = 64  # never-logged serials past the fingerprint window
FETCH_PROBES = 1 << 12  # (iii): the query set the client cycles through
SERVE_FETCH_ENTRIES = 1 << 17  # (iii): the entries of the log it ingests


def _swap_samples(since: int) -> tuple[int, dict]:
    """The ``serve.replica_swap_s`` samples (a capture and pin of one
    replica, under the aggregator's fold and table locks for the copy)
    recorded after the first ``since``: (how many there are now, their
    count, p50 and max in ms)."""
    from ct_mapreduce_tpu_torch.telemetry import metrics

    vals = list(metrics.get_sink().samples.get("serve.replica_swap_s", []))
    new = sorted(vals[since:])
    return len(vals), {"count": len(new),
                       "p50_ms": median(new) * 1e3 if new else None,
                       "max_ms": new[-1] * 1e3 if new else None}


class RoundClock:
    """Patches ``ct_fetch.LogSyncEngine`` while in use, so that the
    seconds from ``__enter__`` to the end of ct-fetch's first sync round
    (its engine's ``stop``) are ``round_s`` and ``done`` is set then; the
    engines made are kept to stop a ``runForever`` run."""

    def __enter__(self) -> "RoundClock":
        import threading

        from ct_mapreduce_tpu_torch.cmd import ct_fetch

        self.engines, self.done, self.round_s = [], threading.Event(), None
        self.rounds = 0  # sync rounds ended so far
        self._base = base = ct_fetch.LogSyncEngine
        clock = self

        class Engine(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                clock.engines.append(self)

            def stop(self):
                super().stop()
                if clock.round_s is None:
                    clock.round_s = time.perf_counter() - clock.t0
                clock.rounds += 1
                clock.done.set()

        ct_fetch.LogSyncEngine = Engine
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        from ct_mapreduce_tpu_torch.cmd import ct_fetch

        ct_fetch.LogSyncEngine = self._base


def serve_queries(stream: Stream, truth, n: int, seed: int):
    """``n`` /query objects over ``stream``'s templates with their
    answers: half serials the stream holds (``truth`` by counter; all of
    the long-CN issuer's host-lane serials held are among them), half
    serials never logged under the same issuers (SERVE_LONG_SERIALS of
    them longer than the fingerprint window). Returns (queries, want,
    fingerprints of the lanes the device can answer, those lanes)."""
    import numpy as np

    from ct_mapreduce_tpu_torch.core import packing
    from ct_mapreduce_tpu_torch.core.types import ExpDate

    rng = np.random.default_rng(seed)
    held = np.nonzero(truth[: stream.template_of.shape[0]])[0]
    long_t = len(stream.templates) - 1 if stream.cn_filter else -1
    held_long = held[stream.template_of[held] == long_t]
    n_known = n // 2
    k_long = min(len(held_long), n_known // 16)
    known = np.concatenate([
        rng.choice(held_long, k_long, replace=False),
        rng.choice(held, n_known - k_long,
                   replace=len(held) < n_known - k_long)])
    passing = np.nonzero(~stream.filtered)[0]
    ghost = stream.next_counter + 1 + np.arange(n - n_known, dtype=np.int64)
    ctr = np.concatenate([known, ghost])
    tof = np.concatenate([stream.template_of[known],
                          rng.choice(passing, n - n_known)])
    ser, ln = stream.serial_bytes(tof, ctr)
    exp_ids = [ExpDate.from_unix_hour(t["hour"]).id() for t in stream.truth]
    serials = [ser[i, : ln[i]].tobytes() for i in range(n)]
    for i in range(n - SERVE_LONG_SERIALS, n):
        serials[i] = b"\x4d" + rng.bytes(49)  # 50 bytes, never logged
    want = np.arange(n) < n_known
    order = rng.permutation(n)
    queries = [{"issuer": stream.truth[tof[i]]["issuer"],
                "expDate": exp_ids[tof[i]], "serial": serials[i].hex()}
               for i in order]
    want = want[order]
    fits = np.array([len(serials[i]) <= packing.MAX_SERIAL_BYTES
                     for i in order])
    return queries, want, order, tof[order], ctr[order], fits


def _post_all(addr: str, queries: list, clients: int):
    """``queries`` as POSTs of SERVE_POST from ``clients`` threads:
    (known flags in order, seconds of each POST, wall seconds)."""
    import numpy as np

    from ct_mapreduce_tpu_torch.serve.client import QueryClient

    posts = [queries[i:i + SERVE_POST]
             for i in range(0, len(queries), SERVE_POST)]

    def post(i):
        t0 = time.perf_counter()
        resp = QueryClient(addr, timeout_s=120).query(posts[i])
        return [r["known"] for r in resp["results"]], \
            time.perf_counter() - t0, resp["epoch"]

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=clients) as pool:
        res = list(pool.map(post, range(len(posts))))
    wall = time.perf_counter() - t0
    known = np.array([k for r in res for k in r[0]], bool)
    return known, [r[1] for r in res], wall, [r[2] for r in res]


def serve_table(device, label: str, agg, stream: Stream, truth,
                seed: int) -> dict:
    """Phase 11 (i)/(ii): a QueryServer on port 0 over ``agg`` on the
    card (device views, SERVE_REPLICAS replicas, a SERVE_CACHE cache)
    answers SERVE_QUERIES queries over HTTP, each against the host
    oracle; then the pinned ``contains`` at 1,024 and at SERVE_QUERIES
    keys (CUDA events, keys on the card) beside ``contains_np`` on the
    host and its byte bound."""
    import numpy as np
    import torch

    from ct_mapreduce_tpu_torch.core import packing
    from ct_mapreduce_tpu_torch.ops import buckettable, hashtable, pipeline
    from ct_mapreduce_tpu_torch.serve.server import QueryServer
    from ct_mapreduce_tpu_torch.serve.snapshot import _place

    queries, want, _order, tof, ctr, fits = serve_queries(
        stream, truth, SERVE_QUERIES, seed)
    swaps0, _ = _swap_samples(0)
    srv = QueryServer(agg, 0, host="127.0.0.1", device=True,
                      replicas=SERVE_REPLICAS, cache_size=SERVE_CACHE).start()
    try:
        t0 = time.perf_counter()
        pool = srv.oracle.snapshots.warm()
        warm_s = time.perf_counter() - t0
        for v in pool._replicas:
            check(v._device and v.pinned_device is not None
                  and v.pinned_device.type == "cuda",
                  f"serve {label}: a replica's rows are not pinned on cuda")
        got, post_s, wall, _epochs = _post_all(
            f"127.0.0.1:{srv.port}", queries, SERVE_CLIENTS)
        check(np.array_equal(got, want),
              f"serve {label}: {int((got != want).sum())} answers differ "
              "from the host oracle")
        v = pool._replicas[0]
        layout = v.layout
        # The device-answerable lanes' fingerprints, as lookup makes them.
        idx = np.array([agg.registry.index_of_issuer_id(
            stream.truth[t]["issuer"]) for t in tof], np.int64)
        eh = np.array([stream.truth[t]["hour"] for t in tof], np.int64)
        ser, ln = stream.serial_bytes(tof[fits], ctr[fits])
        fps = packing.fingerprints_np(idx[fits], eh[fits], ser, ln)
        rows = v._dev_rows
        zero = torch.zeros((), dtype=torch.int64, device=rows.device)
        state = (buckettable.BucketTable(rows, zero) if layout == "bucket"
                 else hashtable.TableState(rows, zero))
        timing = {}
        for n in (1 << 10, fps.shape[0]):
            keys = _place(fps[:n], rows.device)
            dev = pipeline.table_contains(state, keys, max_probes=v.max_probes)
            host = v._contains_host(fps[:n])
            check(np.array_equal(dev.cpu().numpy(), host),
                  f"serve {label}: device contains differs from contains_np "
                  f"at {n} keys")
            ms = cuda_times(lambda: pipeline.table_contains(
                state, keys, max_probes=v.max_probes), TIMED_REPS)
            host_ms = []
            for _ in range(5):
                t1 = time.perf_counter()
                v._contains_host(fps[:n])
                host_ms.append((time.perf_counter() - t1) * 1e3)
            if layout == "bucket":
                home = buckettable._home_bucket(buckettable._desentinel(keys),
                                                state.n_buckets)
                row_bytes = buckettable.ROW_WORDS * 4
            else:
                home = hashtable._home_slot(hashtable._desentinel(keys),
                                            state.capacity)
                row_bytes = hashtable.ROW_WORDS * 4
            moved = int(torch.unique(home).numel()) * row_bytes + n * (16 + 1)
            timing[n] = {"device_ms": median(ms), "device_ms_min": min(ms),
                         "host_ms": median(host_ms),
                         "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                         "bound_by": "bytes"}
        stats = srv.oracle.stats()
    finally:
        srv.stop()
    _, swaps = _swap_samples(swaps0)
    post_sorted = sorted(post_s)
    out = {"label": label, "layout": layout, "slots": agg.capacity,
           "queries": SERVE_QUERIES, "posts": len(post_s),
           "clients": SERVE_CLIENTS, "replicas": SERVE_REPLICAS,
           "cache": SERVE_CACHE, "warm_s": warm_s, "wall_s": wall,
           "queries_per_s": SERVE_QUERIES / wall,
           "post_p50_ms": median(post_s) * 1e3,
           "post_p99_ms": post_sorted[int(0.99 * (len(post_sorted) - 1))] * 1e3,
           "known": int(want.sum()), "host_lane_queries": int(
               ((tof == len(stream.templates) - 1) & want).sum()),
           "contains": {str(k): t for k, t in timing.items()},
           "cache_hits": stats.get("cache_hits"),
           "replica_device": stats["replica_device"], "replica_swaps": swaps}
    t1, tn = timing[1 << 10], timing[fps.shape[0]]
    print(f"phase 11 ({label}): {SERVE_QUERIES} queries over HTTP to a "
          f"{out['slots']}-slot {layout} table in {len(post_s)} POSTs of "
          f"{SERVE_POST} from {SERVE_CLIENTS} clients, every answer == the "
          f"host oracle; {out['queries_per_s']:.0f} queries/s, p50 "
          f"{out['post_p50_ms']:.1f} ms, p99 {out['post_p99_ms']:.1f} ms a "
          f"POST; {SERVE_REPLICAS} replicas pinned on cuda; contains on the "
          f"card {t1['device_ms']:.3f} ms / 1024 keys, "
          f"{tn['device_ms']:.3f} ms / {fps.shape[0]} (bound "
          f"{tn['bound_ms']:.4f} ms), contains_np {t1['host_ms']:.3f} / "
          f"{tn['host_ms']:.2f} ms; {swaps['count']} replica swaps, p50 "
          f"{swaps['p50_ms']:.2f} ms, max {swaps['max_ms']:.2f} ms", flush=True)
    return out


def serve_fetch(device, part_url: str, stream: Stream, truth,
                seed: int) -> dict:
    """Phase 11 (iii): ct-fetch with ``queryPort`` (``runForever``, so
    the plane outlives the first round) over the SERVE_FETCH_ENTRIES-entry
    log, while this thread cycles FETCH_PROBES queries through /query:
    no never-logged serial may ever answer known, and a serial answered
    known at some epoch stays known at every later epoch. After the
    round, ``ct-query-torch`` and ``ct-getcert-torch -queryAddr`` (as
    processes) run against the plane; the getcert PEM equals the log's
    entry fetched directly. Then every logged serial of the set must
    answer known, and the run is stopped. First, the same ingest without
    ``queryPort``: the two rounds' seconds are what the plane's replica
    swaps and queries cost ingest."""
    import io
    import socket
    import threading

    import numpy as np

    from ct_mapreduce_tpu_torch.cmd import ct_fetch, ct_getcert
    from ct_mapreduce_tpu_torch.serve.client import QueryClient
    from ct_mapreduce_tpu_torch.telemetry import metrics

    d = os.path.join(HERE, "build", "smoke_serve")
    os.makedirs(d, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ini = _fetch_ini(os.path.join(d, "serve.ini"), part_url,
                     os.path.join(d, "serve.npz"), stream, {
                         "queryPort": port, "serveReplicas": SERVE_REPLICAS,
                         "serveCacheSize": -1, "runForever": "true",
                         "pollingDelayMean": "1h"})
    queries, want, _o, _t, _c, _f = serve_queries(stream, truth, FETCH_PROBES,
                                                  seed)
    plain = _fetch_ini(os.path.join(d, "plain.ini"), part_url,
                       os.path.join(d, "plain.npz"), stream, {})
    metrics.get_sink().reset()
    with RoundClock() as clock:
        plain_run = fetch_run(device, "serve-plain", plain)
    plain_run.pop("model")
    check(plain_run["entries"] == SERVE_FETCH_ENTRIES,
          f"serve (iii): the run without queryPort stored "
          f"{plain_run['entries']}")
    plain_round_s = clock.round_s
    result = {}

    def run():
        try:
            result["rc"] = ct_fetch.main(["-config", ini, "-nobars"],
                                         device=device)
        except BaseException as err:  # reported by the main thread
            result["err"] = err

    metrics.get_sink().reset()
    with RoundClock() as clock:
        engines, round_done = clock.engines, clock.done
        reset_counts()
        t0 = time.perf_counter()
        fetch = threading.Thread(target=run, name="smoke-serve-fetch")
        fetch.start()
        addr = f"127.0.0.1:{port}"
        client = QueryClient(addr, timeout_s=60)
        answers = [[] for _ in queries]  # (epoch, known) per query

        def ask(lo: int) -> np.ndarray:
            part = queries[lo:lo + SERVE_POST]
            resp = client.query(part)
            got = np.array([r["known"] for r in resp["results"]], bool)
            for j, k in enumerate(got):
                answers[lo + j].append((resp["epoch"], bool(k)))
            return got

        try:
            deadline = time.time() + 300
            while True:
                try:
                    client.healthz()
                    break
                except OSError:
                    check(fetch.is_alive() and time.time() < deadline,
                          f"serve (iii): the query plane never came up "
                          f"({result.get('err')!r})")
                    time.sleep(0.02)
            posts_during = 0
            lo = 0
            while not round_done.is_set():
                check(fetch.is_alive(), f"serve (iii): ct-fetch ended early "
                      f"({result.get('err')!r}, rc {result.get('rc')})")
                ask(lo)
                posts_during += 1
                lo = (lo + SERVE_POST) % len(queries)
            ingest_s = time.perf_counter() - t0
            # The CLIs, as processes, against the live plane.
            k = int(np.nonzero(want)[0][0])
            q = queries[k]
            ghost = queries[int(np.nonzero(~want)[0][0])]
            clis = {}
            for name, qq, rc_want in (("known", q, 0), ("ghost", ghost, 1)):
                res = subprocess.run(
                    [sys.executable, "-m", "ct_mapreduce_tpu_torch.cmd.ct_query",
                     "-addr", addr, "-issuer", qq["issuer"], "-expDate",
                     qq["expDate"], "-serial", qq["serial"]],
                    cwd=HERE, capture_output=True, text=True, timeout=300)
                check(res.returncode == rc_want,
                      f"ct-query-torch ({name}): exit {res.returncode}, want "
                      f"{rc_want}: {res.stderr[-400:]}")
                clis[f"ct_query_{name}"] = json.loads(res.stdout)
            index = SERVE_FETCH_ENTRIES // 3
            res = subprocess.run(
                [sys.executable, "-m", "ct_mapreduce_tpu_torch.cmd.ct_getcert",
                 "-log", part_url, "-index", str(index), "-queryAddr", addr],
                cwd=HERE, capture_output=True, text=True, timeout=300)
            check(res.returncode == 0,
                  f"ct-getcert-torch: exit {res.returncode}: {res.stderr[-400:]}")
            direct = io.StringIO()
            check(ct_getcert.main(["-log", part_url, "-index", str(index)],
                                  out=direct) == 0, "direct getcert failed")
            check(res.stdout == direct.getvalue() and res.stdout.startswith(
                "-----BEGIN CERTIFICATE-----"),
                "ct-getcert-torch through /getcert differs from the log's entry")
            # Every logged serial of the set answers known once a view
            # captured after the round serves.
            deadline = time.time() + 60
            while True:
                got = np.concatenate([ask(lo)
                                      for lo in range(0, len(queries), SERVE_POST)])
                if np.array_equal(got, want):
                    break
                check(time.time() < deadline and not (got & ~want).any(),
                      "serve (iii): the logged serials never all answered known")
                time.sleep(0.2)
            health = client.healthz()
        finally:
            for e in engines:
                e.signal_stop()
            fetch.join(timeout=600)
    launches = read_counts()
    _, swaps = _swap_samples(0)
    check(not fetch.is_alive() and result.get("rc") == 0,
          f"serve (iii): ct-fetch exit {result.get('rc')} "
          f"({result.get('err')!r})")
    check(launches["sha256_fp"] > 0 and launches["der_walk"] > 0,
          "serve (iii): K1 or K3 never ran")
    n_answers = sum(len(a) for a in answers)
    for i, a in enumerate(answers):
        known_at = [e for e, k in a if k]
        if not want[i]:
            check(not known_at, f"serve (iii): a never-logged serial "
                  f"answered known at epoch {known_at[:1]}")
        elif known_at:
            first = min(known_at)
            check(all(k for e, k in a if e >= first),
                  f"serve (iii): a serial known at epoch {first} answered "
                  "unknown at a later epoch")
    check(all(health["replica_device"]) and health["replicas"]
          == SERVE_REPLICAS, f"serve (iii): replicas not on the card: "
          f"{health}")
    check(health["device_fallback_total"] == 0,
          "serve (iii): a replica fell back to the host")
    out = {"entries": SERVE_FETCH_ENTRIES, "ingest_s": ingest_s,
           "round_s": clock.round_s, "plain_round_s": plain_round_s,
           "plain_entries_per_s": SERVE_FETCH_ENTRIES / plain_round_s,
           "entries_per_s": SERVE_FETCH_ENTRIES / clock.round_s,
           "replica_swaps": swaps, "plain_run": plain_run,
           "posts_during_ingest": posts_during, "answers": n_answers,
           "epochs": health["snapshot_epoch"], "launches": launches,
           "ct_query": clis, "getcert_index": index}
    print(f"phase 11 (iii): ct-fetch with queryPort over "
          f"{SERVE_FETCH_ENTRIES} entries, a round of {clock.round_s:.2f} s "
          f"({plain_round_s:.2f} s without queryPort) while "
          f"{posts_during} POSTs of {SERVE_POST} queried it; "
          f"{swaps['count']} replica swaps, p50 {swaps['p50_ms']:.2f} ms, max "
          f"{swaps['max_ms']:.2f} ms; {n_answers} "
          f"answers over {health['snapshot_epoch']} epochs: no ghost known, "
          f"no known serial lost; ct-query-torch and ct-getcert-torch "
          f"-queryAddr == the log's entry; launches "
          f"{launches['sha256_fp']} K1, {launches['der_walk']} K3", flush=True)
    return out


def serve_phase(device, restored, staged_truth, open_model, open_truth,
                part_url: str, fetch_truth, seed: int) -> dict:
    """Phase 11: (i) phase 9's restored bucket table, (ii) phase 5b's
    open table, (iii) ct-fetch with ``queryPort``; ``serve.device_fallback``
    must stay 0 throughout."""
    from ct_mapreduce_tpu_torch.telemetry import metrics

    out = {"bucket": serve_table(device, "i", restored, *staged_truth, seed),
           "open": serve_table(device, "ii", open_model.aggregator,
                               *open_truth, seed + 1)}
    fallbacks = metrics.get_sink().snapshot()["counters"].get(
        "serve.device_fallback", 0)
    check(fallbacks == 0, f"serve: {fallbacks} device fallbacks")
    out["fetch"] = serve_fetch(device, part_url, *fetch_truth, seed + 2)
    fallbacks = metrics.get_sink().snapshot()["counters"].get(
        "serve.device_fallback", 0)
    check(fallbacks == 0, f"serve (iii): {fallbacks} device fallbacks")
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


def _profiled(run, path: str) -> tuple[float, float, dict]:
    """torch.profiler around ``run()`` (synchronised at the end); its
    Chrome trace goes to ``path``. Returns (wall s, device busy s, per
    kernel name its total us and count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    busy_us, by_kernel = device_busy(path)
    return wall, busy_us / 1e6, by_kernel


def profile_step(device, stream: Stream, batch_log2: int, table_bits: int,
                 preparsed: bool, out_dir: str) -> dict:
    """torch.profiler over one warm batch of a lane: device time by
    kernel, and the device's busy share of the call's wall time."""
    import numpy as np

    from ct_mapreduce_tpu_torch.models.ingest_model import IngestModel

    lane = "preparsed" if preparsed else "walker"
    model = IngestModel.from_config(
        _config(batch_log2, table_bits, preparsed, stream.cn_prefixes()),
        device=device)
    idx_of = stream.issuer_indices(model)
    n = 1 << batch_log2
    batches = [stream.batch(n, 0.5) for _ in range(2)]
    data, length, tof, _ = batches[0]
    model.ingest_packed(data, length, idx_of[tof], np.ones((n,), bool))
    data, length, tof, _ = batches[1]
    wall, busy_s, by_kernel = _profiled(
        lambda: model.ingest_packed(data, length, idx_of[tof],
                                    np.ones((n,), bool)),
        os.path.join(out_dir, f"{lane}_step_trace.json"))
    rows = sorted(((t, k, c) for k, (t, c) in by_kernel.items()),
                  reverse=True)
    out = {"lane": lane, "wall_s": wall, "device_busy_s": busy_s,
           "device_idle_share": 1.0 - busy_s / wall,
           "top_device_us": [[k, round(t, 1), c] for t, k, c in rows[:15]],
           "kernel_device_us": {name: [v for k, v in by_kernel.items()
                                       if name in k]
                                for name in ("sha256_fp", "der_walk")}}
    print(f"profile {lane}: one batch of {n}: wall {wall:.3f} s, device "
          f"busy {busy_s:.4f} s (idle share {out['device_idle_share']:.3f})",
          flush=True)
    return out


def profile_sink(device, name: str, seed: int, out_dir: str) -> dict:
    """torch.profiler over one sink configuration taking 8 chunks of
    whole pages (one staged envelope) after 8 chunks of warm-up, closed
    at the end: the device's busy share of the sink's wall time."""
    from ct_mapreduce_tpu_torch.ingest import sync

    stream = Stream(seed, cn_filter=True)
    sink, _ = sync.build_sink(sink_config(name, stream), device=device)
    extra = wire_extra_data(stream)
    n = 8 * -(-SINK_BATCH // SINK_PAGE) * SINK_PAGE

    def feed(lis, eds):
        for p in range(0, len(lis), SINK_PAGE):
            sink.store_raw_batch(sync.RawBatch(
                lis[p:p + SINK_PAGE], eds[p:p + SINK_PAGE], p, "smoke-log"))
        sink.close()

    feed(*sink_entries(stream, extra, n, SINK_REPLAY)[:2])
    lis, eds = sink_entries(stream, extra, n, SINK_REPLAY)[:2]
    wall, busy_s, by_kernel = _profiled(
        lambda: feed(lis, eds),
        os.path.join(out_dir, f"sink_{name}_trace.json"))
    rows = sorted(((t, k, c) for k, (t, c) in by_kernel.items()),
                  reverse=True)
    out = {"config": name, "entries": n, "wall_s": wall,
           "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / wall,
           "top_device_us": [[k, round(t, 1), c] for t, k, c in rows[:8]]}
    print(f"profile sink {name}: {n} entries: wall {wall:.3f} s, device "
          f"busy {busy_s:.4f} s (idle share {out['device_idle_share']:.3f})",
          flush=True)
    return out


# -- phase 12: filter emission on the card --------------------------------

FILTER_BATCHES = 2  # walker-main's first two batches (about 1M serials)
FILTER_FP = 0.01  # the target false-positive rate (the default)
FILTER_GHOSTS = 1 << 15  # never-logged serials queried per artifact
SCALE_SERIALS = 1 << 24  # (c): serials in the streamed fl02 build
SCALE_ISSUERS, SCALE_HOURS = 64, 16  # (c): 1,024 (issuer, hour) groups
SCALE_CHUNK = 1 << 20  # (c): serials a streamed key block


def _filter_dir() -> str:
    d = os.path.join(HERE, "build", "smoke_filter")
    os.makedirs(d, exist_ok=True)
    return d


def _fresh(*paths: str) -> None:
    """Remove earlier runs' files (and any ck02 chain beside them)."""
    import glob

    for p in paths:
        for f in [p] + glob.glob(p + ".ck*"):
            if os.path.exists(f):
                os.unlink(f)


def bloom_bound(lanes: int, probes: int, arena_words: int) -> dict:
    """K5's least time for ``lanes`` keys making ``probes`` probes into
    an arena of ``arena_words`` words: the bytes it must move (each key
    and group id read once, the arena read and written once; the group
    vectors are a few KB) over the HBM rate, against its least integer
    operations over the INT32 rate. ``sector_ms`` is a second yardstick,
    not the bound: every probe as one 32-byte sector read-modify-write
    out of device memory, as if no arena word stayed in L2."""
    from ct_mapreduce_tpu_torch.ops import bloom

    byte_ms = (lanes * 20 + arena_words * 8) / HBM_BYTES_PER_S * 1e3
    op_ms = ((lanes * bloom.OPS_PER_LANE + probes * bloom.OPS_PER_PROBE)
             / INT32_OPS_PER_S * 1e3)
    return {"bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "bytes_bound_ms": byte_ms, "ops_bound_ms": op_ms,
            "sector_ms": (lanes * 20 + probes * 32) / HBM_BYTES_PER_S * 1e3}


def bloom_check(device, seed: int) -> dict:
    """Phase 12 (0): K5 against its plain version at its timed shapes
    (``tools/kernel_times.k5_shapes``: one layer of 2^20 keys, a fused
    round of 2^20 keys in 1,024 Zipf groups laid out group by group, and
    filter-scale's first 2^20-lane dispatch into its round's arena), bit
    for bit on an arena non-zero on entry, then both timed with CUDA
    events in turns, and each of K5's phases timed as the difference of
    two prefixes of its one launch."""
    import torch

    from ct_mapreduce_tpu_torch.ops import bloom, bloom_cuda
    from ct_mapreduce_tpu_torch.tools import kernel_times as kt

    out = {}
    layer = 7
    for form, shape in kt.k5_shapes(device, seed).items():
        t = kt.args_of(shape)
        n, kmax = int(shape["keys"].shape[0]), shape["kmax"]
        n_words = shape["total_bits"] // 32
        gen = torch.Generator(device=device).manual_seed(seed)
        start = torch.randint(-(1 << 31), 1 << 31, (n_words,), device=device,
                              dtype=torch.int64, generator=gen)
        start = (start * (torch.rand((n_words,), device=device,
                                     generator=gen) < 0.05)).to(torch.int32)
        got, want = start.clone(), start.clone()
        bloom_cuda.scatter(got, *t, layer, kmax)
        bloom.bloom_scatter_plain(want, *t, layer)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        check(torch.equal(got, want),
              f"K5 ({form}) != plain on {n} lanes (max abs err {err})")
        kernel_ms, plain_ms = [], []
        for _ in range(2):  # in turns: kernel, plain, kernel, plain
            kernel_ms += cuda_times(
                lambda: bloom_cuda.scatter(got, *t, layer, kmax), TIMED_REPS,
                KERNEL_CALLS_PER_TIMING)
            plain_ms += cuda_times(
                lambda: bloom.bloom_scatter_plain(want, *t, layer),
                PLAIN_REPS, warmup=1)
        prefix = [0.0]
        for phases in range(1, len(bloom_cuda.PHASES) + 1):
            prefix.append(median(cuda_times(
                lambda: bloom_cuda.scatter_phases(got, *t, layer, kmax,
                                                  phases=phases),
                TIMED_REPS, KERNEL_CALLS_PER_TIMING)))
        check(torch.equal(got, want), f"K5 ({form}) changed on a rerun")
        # The words the dispatch must read and write: its groups' layers.
        reached = torch.unique(shape["gid"])
        touched = int((shape["ms"][reached].to(torch.int64) // 32).sum())
        st = dict(bloom_bound(n, shape["probes"], touched), lanes=n,
                  groups=shape["groups"],
                  groups_reached=shape["groups_reached"],
                  probes=shape["probes"], arena_bits=shape["total_bits"],
                  touched_words=touched, kmax=kmax,
                  region_bits=bloom.region_bits(n_words),
                  scratch_bytes=bloom.scratch_bytes(n, kmax, n_words,
                                                    shape["groups"]),
                  max_abs_err=err, kernel_ms=median(kernel_ms),
                  kernel_ms_min=min(kernel_ms), kernel_ms_max=max(kernel_ms),
                  plain_ms=median(plain_ms), timings=2 * TIMED_REPS,
                  phase_ms={name: prefix[i + 1] - prefix[i]
                           for i, name in enumerate(bloom_cuda.PHASES)})
        st["share_of_bound"] = st["bound_ms"] / st["kernel_ms"]
        out[form] = st
        print(f"phase 12 (0): K5 {form} == plain on {n} lanes ({st['groups']} "
              f"groups, {st['groups_reached']} reached, {st['probes']} "
              f"probes, arena non-zero on entry); kernel "
              f"{st['kernel_ms']:.4f} ms, plain {st['plain_ms']:.3f} ms, "
              f"bound {st['bound_ms']:.4f} ms ({st['bound_by']}), "
              f"{st['share_of_bound']:.1%} of bound; every probe a sector "
              f"RMW {st['sector_ms']:.4f} ms; scratch {st['scratch_bytes']} B; "
              "phases " + ", ".join(f"{k} {v:.4f}" for k, v in
                                    st["phase_ms"].items()) + " ms",
              flush=True)
        del got, want, start
    torch.cuda.empty_cache()
    return out


def _oracle_serials(stream: Stream, seen) -> dict:
    """{(issuerID, expHour): set of serial bytes} of the ``seen``
    counters: the stream's own truth, independent of the port."""
    import numpy as np

    ctr = np.nonzero(seen)[0]
    tof = stream.template_of[ctr]
    ser, ln = stream.serial_bytes(tof, ctr)
    out: dict = {}
    for t in np.unique(tof):
        sel = np.nonzero(tof == t)[0]
        tr = stream.truth[t]
        rows, lens = ser[sel], ln[sel]
        out.setdefault((tr["issuer"], tr["hour"]), set()).update(
            rows[i, :lens[i]].tobytes() for i in range(sel.size))
    return out


def _ghost_rate(art, stream: Stream, device, seed: int) -> dict:
    """False-positive share of FILTER_GHOSTS never-logged serials (fresh
    counters past the stream's) under the kept issuers' groups."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kept = np.nonzero(~stream.filtered)[0]
    tof = rng.choice(kept, FILTER_GHOSTS).astype(np.int32)
    ctr = stream.next_counter + 1 + np.arange(FILTER_GHOSTS, dtype=np.int64)
    ser, ln = stream.serial_bytes(tof, ctr)
    hits = 0
    for t in np.unique(tof):
        tr = stream.truth[t]
        g = art.group_for(tr["issuer"], tr["hour"])
        sel = np.nonzero(tof == t)[0]
        hits += int(art.query_group(g, [ser[i, :ln[i]].tobytes()
                                        for i in sel], device=device).sum())
    return {"ghosts": FILTER_GHOSTS, "false_positives": hits,
            "rate": hits / FILTER_GHOSTS}


def filter_main(device, seed: int, plain_batch_s: list) -> dict:
    """Phase 12 (a): walker-main's first FILTER_BATCHES batches through an
    ``IngestModel`` with ``aggStatePath`` (ck01) and filter emission
    (fl02); ``save()`` writes the checkpoint and the artifact. Then fl01
    over the same capture. Each artifact's bytes must equal the host
    lane's (``CTMR_FILTER_DEVICE=0``), ``build_artifact`` over the
    oracle's own serial sets, and a build from the ck01 restored on a
    CPU aggregator; every captured serial answers known, never-logged
    ones at most twice the target rate; ``filter.emit_error`` stays 0."""
    import numpy as np
    import torch

    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.filter import (
        FilterArtifact, build_artifact, build_from_aggregator, stream as fst)
    from ct_mapreduce_tpu_torch.filter.artifact import capture_by_identity
    from ct_mapreduce_tpu_torch.models.ingest_model import IngestModel
    from ct_mapreduce_tpu_torch.telemetry import metrics

    d = _filter_dir()
    state = os.path.join(d, "main.npz")
    fpath = state + ".filter"
    _fresh(state, fpath)
    stream = Stream(seed, cn_filter=True)
    cfg = _config(BATCH_LOG2, TABLE_BITS, False, stream.cn_prefixes())
    cfg.agg_state_path = state
    model = IngestModel.from_config(cfg, device=device)
    agg = model.aggregator
    agg.configure_checkpointing(mode="ck01")
    agg.configure_filter_emission(fpath, FILTER_FP, fmt="fl02")
    idx_of = stream.issuer_indices(model)
    n = 1 << BATCH_LOG2
    seen = np.zeros((stream.next_counter + FILTER_BATCHES * n + 1,), bool)
    batch_s = []
    reset_counts()
    for _ in range(FILTER_BATCHES):
        data, length, tof, ctr = stream.batch(n, 0.5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = model.ingest_packed(data, length, idx_of[tof],
                                  np.ones((n,), bool))
        batch_s.append(time.perf_counter() - t0)
        passing = ~stream.filtered[tof]
        fresh = np.unique(ctr[passing])
        check(int(res.was_unknown.sum()) == int((~seen[fresh]).sum()),
              "filter-main: unknown lanes differ from the oracle")
        seen[fresh] = True
    ingest_launches = read_counts()
    oracle = _oracle_serials(stream, seen)
    check(capture_by_identity(agg.filter_capture, agg.registry) == oracle,
          "filter-main: the capture differs from the oracle's serial sets")
    sink = metrics.get_sink()
    errors0 = sink.snapshot()["counters"].get("filter.emit_error", 0)
    reset_counts()
    rss0 = fst._rss_bytes()
    t0 = time.perf_counter()
    model.save()
    save_s = time.perf_counter() - t0
    launches = {"fl02": read_counts()}
    snap = sink.snapshot()
    check(snap["counters"].get("filter.emit_error", 0) == errors0,
          "filter-main: the emission failed (filter.emit_error)")
    check(os.path.exists(fpath), "filter-main: no artifact beside the state")
    build_s = {"fl02": snap["samples"]["filter.build_s"]["max"]}
    with open(fpath, "rb") as f:
        blobs = {"fl02": f.read()}
    reset_counts()
    t0 = time.perf_counter()
    blobs["fl01"] = build_from_aggregator(agg, fp_rate=FILTER_FP,
                                          fmt="fl01").to_bytes()
    build_s["fl01"] = time.perf_counter() - t0
    launches["fl01"] = read_counts()
    peak_rss = max(fst._rss_bytes(), int(sink.snapshot()["gauges"].get(
        "filter.build_rss_bytes", 0)))
    for fmt, c in launches.items():
        check(c["sha256_fp"] > 0 and c["bloom_scatter"] > 0,
              f"filter-main ({fmt}): K1 or K5 never ran")
    host_s, oracle_s = {}, {}
    prev = os.environ.get("CTMR_FILTER_DEVICE")
    os.environ["CTMR_FILTER_DEVICE"] = "0"
    try:
        reset_counts()
        for fmt in blobs:
            t0 = time.perf_counter()
            host = build_from_aggregator(agg, fp_rate=FILTER_FP,
                                         fmt=fmt).to_bytes()
            host_s[fmt] = time.perf_counter() - t0
            check(host == blobs[fmt],
                  f"filter-main ({fmt}): the card's bytes != the host lane's")
        c = read_counts()
        check(c["sha256_fp"] == c["bloom_scatter"] == 0,
              "filter-main: the host lane launched a kernel")
    finally:
        if prev is None:
            os.environ.pop("CTMR_FILTER_DEVICE", None)
        else:
            os.environ["CTMR_FILTER_DEVICE"] = prev
    for fmt in blobs:
        t0 = time.perf_counter()
        ref = build_artifact(oracle, fp_rate=FILTER_FP, fmt=fmt,
                             device=device).to_bytes()
        oracle_s[fmt] = time.perf_counter() - t0
        check(ref == blobs[fmt],
              f"filter-main ({fmt}): != build_artifact over the oracle's sets")
    t0 = time.perf_counter()
    r = TorchAggregator(capacity=1 << 10, device="cpu")
    r.load_checkpoint(state)
    restore_s = time.perf_counter() - t0
    check(r.filter_capture == agg.filter_capture,
          "filter-main: the ck01 restored on the CPU has another capture")
    for fmt in blobs:
        check(build_from_aggregator(r, fp_rate=FILTER_FP, fmt=fmt,
                                    device=device).to_bytes() == blobs[fmt],
              f"filter-main ({fmt}): the CPU-restored rebuild differs")
    del r
    queries = {}
    for fmt, blob in blobs.items():
        art = FilterArtifact.from_bytes(blob)
        check(art.fmt == fmt and len(art.groups) == len(oracle),
              f"filter-main ({fmt}): {len(art.groups)} groups, want "
              f"{len(oracle)}")
        t0 = time.perf_counter()
        for (iss, hour), serials in sorted(oracle.items()):
            g = art.group_for(iss, hour)
            check(g is not None and g.n == len(serials)
                  and bool(art.query_group(g, sorted(serials),
                                           device=device).all()),
                  f"filter-main ({fmt}): a captured serial answers unknown")
        member_s = time.perf_counter() - t0
        ghosts = _ghost_rate(art, stream, device, seed + 12)
        check(ghosts["rate"] <= 2 * FILTER_FP,
              f"filter-main ({fmt}): never-logged serials false-positive at "
              f"{ghosts['rate']:.4f}, over twice {FILTER_FP}")
        queries[fmt] = dict(ghosts, member_query_s=member_s,
                            bits_per_entry=art.bits_per_entry(),
                            max_layers=art.max_layers())
    out = {
        "batches": FILTER_BATCHES, "batch": n,
        "serials": int(seen.sum()), "groups": len(oracle),
        "batch_s_capture": batch_s,
        "batch_s_no_capture": list(plain_batch_s[:FILTER_BATCHES]),
        "capture_cost_s": sum(batch_s) - sum(plain_batch_s[:FILTER_BATCHES]),
        "ingest_launches": ingest_launches, "save_s": save_s,
        "build_s": build_s, "host_lane_s": host_s, "oracle_build_s": oracle_s,
        "cpu_restore_s": restore_s, "launches": launches,
        "artifact_bytes": {f: len(b) for f, b in blobs.items()},
        "rss_before_save": rss0, "peak_rss": peak_rss, "queries": queries,
    }
    print(f"phase 12 (a) filter-main: {out['serials']} serials in "
          f"{out['groups']} groups over {FILTER_BATCHES} batches of {n}; "
          f"batches {sum(batch_s):.2f} s with capture, "
          f"{sum(plain_batch_s[:FILTER_BATCHES]):.2f} s without (phase 5); "
          f"save {save_s:.2f} s (fl02 build {build_s['fl02']:.2f} s), fl01 "
          f"{build_s['fl01']:.2f} s; launches fl02 "
          f"{launches['fl02']['sha256_fp']} K1 / "
          f"{launches['fl02']['bloom_scatter']} K5, fl01 "
          f"{launches['fl01']['sha256_fp']} K1 / "
          f"{launches['fl01']['bloom_scatter']} K5; bytes fl02 "
          f"{len(blobs['fl02'])} fl01 {len(blobs['fl01'])} == host lane == "
          f"oracle build == CPU restore; every serial known; ghosts "
          + ", ".join(f"{f} {q['rate']:.4f}" for f, q in queries.items())
          + f"; peak RSS {peak_rss / 2**30:.2f} GiB", flush=True)
    model = agg = None
    torch.cuda.empty_cache()
    return out


def filter_fetch(device, part_url: str, stream: Stream, truth) -> dict:
    """Phase 12 (b): ct-fetch with ``emitFilter`` over phase 11 (iii)'s
    SERVE_FETCH_ENTRIES-entry log; ``ct-filter-torch build`` over its
    ``aggStatePath`` reproduces the emitted file byte for byte,
    ``inspect -json`` counts its groups, and ``ct-filter-torch query``
    (a process) exits 0 on a logged serial and 1 on a never-logged one."""
    import io

    import numpy as np

    from ct_mapreduce_tpu_torch.cmd import ct_filter
    from ct_mapreduce_tpu_torch.filter import read_artifact
    from ct_mapreduce_tpu_torch.core.types import ExpDate
    from ct_mapreduce_tpu_torch.telemetry import metrics

    d = _filter_dir()
    state = os.path.join(d, "fetch.npz")
    fpath = state + ".filter"
    rebuilt = os.path.join(d, "rebuilt.filter")
    _fresh(state, fpath, rebuilt)
    ini = _fetch_ini(os.path.join(d, "fetch.ini"), part_url, state, stream,
                     {"emitFilter": "true"})
    metrics.get_sink().reset()
    run = fetch_run(device, "filter-fetch", ini)
    run.pop("model")
    check(metrics.get_sink().snapshot()["counters"].get(
        "filter.emit_error", 0) == 0, "filter-fetch: the emission failed")
    check(run["launches"]["bloom_scatter"] > 0,
          "filter-fetch: K5 never ran")
    oracle = _oracle_serials(stream, truth)
    art = read_artifact(fpath)
    check(sorted(((g.issuer, g.exp_hour), g.n) for g in art.groups.values())
          == sorted((k, len(v)) for k, v in oracle.items()),
          "filter-fetch: the artifact's groups differ from the oracle's")
    buf = io.StringIO()
    t0 = time.perf_counter()
    check(ct_filter.main(["build", "-state", state, "-out", rebuilt],
                         out=buf, device=device) == 0,
          "filter-fetch: ct-filter build failed")
    cli_build_s = time.perf_counter() - t0
    with open(fpath, "rb") as a, open(rebuilt, "rb") as b:
        emitted = a.read()
        check(emitted == b.read(),
              "filter-fetch: ct-filter build != the emitted artifact")
    buf = io.StringIO()
    check(ct_filter.main(["inspect", "-artifact", fpath, "-json"],
                         out=buf) == 0, "filter-fetch: inspect failed")
    check(json.loads(buf.getvalue())["groups"] == len(art.groups)
          == len(oracle), "filter-fetch: inspect -json counts other groups")
    (iss, hour), serials = sorted(oracle.items())[0]
    known = sorted(serials)[0]
    ghost = b"\x7f" + known  # one byte longer: never logged
    check(ghost not in serials, "filter-fetch: the ghost serial was logged")
    exits = {}
    for name, sb, want in (("known", known, 0), ("ghost", ghost, 1)):
        res = subprocess.run(
            [sys.executable, "-m", "ct_mapreduce_tpu_torch.cmd.ct_filter",
             "query", "-artifact", fpath, "-issuer", iss, "-expDate",
             ExpDate.from_unix_hour(hour).id(), "-serial", sb.hex()],
            cwd=HERE, capture_output=True, text=True, timeout=300)
        if name == "ghost" and res.returncode == 0:
            # A false positive is allowed; a different ghost must miss.
            ghost = b"\x7e\x01" + known
            res = subprocess.run(
                [sys.executable, "-m", "ct_mapreduce_tpu_torch.cmd.ct_filter",
                 "query", "-artifact", fpath, "-issuer", iss, "-expDate",
                 ExpDate.from_unix_hour(hour).id(), "-serial", ghost.hex()],
                cwd=HERE, capture_output=True, text=True, timeout=300)
        check(res.returncode == want,
              f"ct-filter-torch query ({name}): exit {res.returncode}, want "
              f"{want}: {res.stderr[-400:]}")
        exits[name] = res.returncode
    out = dict(run, serials=int(np.count_nonzero(truth)),
               groups=len(art.groups), artifact_bytes=len(emitted),
               cli_build_s=cli_build_s, query_exits=exits)
    print(f"phase 12 (b) filter-fetch: ct-fetch with emitFilter over "
          f"{run['entries']} entries in {run['wall_s']:.2f} s; "
          f"{out['serials']} serials in {out['groups']} groups, "
          f"{len(emitted)} B; ct-filter-torch build == emitted "
          f"({cli_build_s:.2f} s), inspect -json groups == "
          f"{len(art.groups)}, query exits 0 / 1; launches "
          f"{run['launches']['sha256_fp']} K1, {run['launches']['der_walk']} "
          f"K3, {run['launches']['bloom_scatter']} K5", flush=True)
    return out


def _scale_sources(seed: int):
    """(c)'s corpus: SCALE_SERIALS serials in SCALE_ISSUERS x SCALE_HOURS
    groups of Zipf(1.1) sizes, as PackedGroupSources whose providers make
    each chunk from the group's own seed: lengths 8..20, random bytes,
    the last 4 a big-endian counter, so serials are unique in a group."""
    import numpy as np

    from ct_mapreduce_tpu_torch.core.packing import MAX_SERIAL_BYTES
    from ct_mapreduce_tpu_torch.filter import PackedGroupSource
    from ct_mapreduce_tpu_torch.utils import syncerts

    groups = SCALE_ISSUERS * SCALE_HOURS
    rng = np.random.default_rng(seed + 1200)
    sizes = rng.multinomial(SCALE_SERIALS - groups,
                            syncerts.zipf_weights(groups, 1.1)) + 1
    rng.shuffle(sizes)
    col = np.arange(MAX_SERIAL_BYTES)[None, :]

    def provider(chunk_size, g, n):
        r = np.random.default_rng([seed, g])
        for s0 in range(0, n, chunk_size):
            c = min(chunk_size, n - s0)
            lens = r.integers(8, 21, c)
            mat = r.integers(0, 256, (c, MAX_SERIAL_BYTES), dtype=np.uint8)
            ctr = np.arange(s0, s0 + c, dtype=np.int64)
            rows = np.arange(c)
            for b in range(4):
                mat[rows, lens - 1 - b] = (ctr >> (8 * b)) & 0xFF
            mat[col >= lens[:, None]] = 0
            yield lens, mat, []

    sources = []
    for g in range(groups):
        iss, hour = divmod(g, SCALE_HOURS)
        n = int(sizes[g])
        sources.append(PackedGroupSource(
            f"scale-issuer-{iss:02d}", 500_000 + 24 * hour, n,
            lambda cs, g=g, n=n: provider(cs, g, n)))
    return sources


def _members_on_card(art, sources, device) -> int:
    """Members among every source's keys (K1 again, after the build's
    counts were read) by the probe arithmetic in plain torch on the card:
    every key of a one-layer fl02 group must hit all its k bits."""
    import torch

    from ct_mapreduce_tpu_torch.filter import stream as fst
    from ct_mapreduce_tpu_torch.filter.cascade import keys_tensor
    from ct_mapreduce_tpu_torch.ops.bloom import M32

    hits = 0
    for src in sources:
        g = art.group_for(src.issuer, src.exp_hour)
        layer = g.cascade.layers[0]
        words = torch.from_numpy(layer.words.view("<i4")).to(device)
        w = words.to(torch.int64) & M32
        k = keys_tensor(fst.collect_keys(src, 0, SCALE_CHUNK, use_device=True,
                                         device=device), device)
        k = k.to(torch.int64) & M32
        # Layer 0: the layer mixes (0 * _GOLD, 0 * _MIX) are 0.
        a = (k[:, 0] + k[:, 2]) & M32
        b = ((k[:, 1] + k[:, 3]) & M32) | 1
        ok = torch.ones_like(a, dtype=torch.bool)
        for i in range(layer.k):
            pos = ((a + i * b) & M32) % layer.m
            ok &= ((w[pos >> 5] >> (pos & 31)) & 1).bool()
        hits += int(ok.sum())
    return hits


def filter_scale(device, seed: int) -> dict:
    """Phase 12 (c): a streamed fl02 build through ``PackedGroupSource`` at
    SCALE_SERIALS serials in 1,024 groups on the card (the device lane
    forced, so every block hashes through K1 and every segment scatters
    through K5). Every K5 launch is checked on its dispatch against the
    plain version on a copy of its arena; each K1 and K5 launch is
    timed with CUDA events (keys/s); every key is a member."""
    import torch

    from ct_mapreduce_tpu_torch.filter import build_artifact_from_sources
    from ct_mapreduce_tpu_torch.filter import stream as fst
    from ct_mapreduce_tpu_torch.ops import bloom, sha256

    sources = _scale_sources(seed)
    timed = {"k1": [0.0, 0], "k5": [0.0, 0]}
    orig_fp, orig_scatter = sha256.sha256_fingerprint64, bloom.bloom_scatter

    def events(name, fn, lanes):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        timed[name][0] += start.elapsed_time(end) / 1e3
        timed[name][1] += lanes
        return out

    dispatches = []

    def fp(ii, eh, ser, ln):
        return events("k1", lambda: orig_fp(ii, eh, ser, ln), int(ln.shape[0]))

    def scatter(words, keys, gid, offs, ms, ks, layer, kmax=None):
        want = bloom.bloom_scatter_plain(words.clone(), keys, gid, offs, ms,
                                         ks, layer)
        got = events("k5", lambda: orig_scatter(words, keys, gid, offs, ms,
                                                ks, layer, kmax),
                     int(keys.shape[0]))
        check(torch.equal(got, want), f"filter-scale: K5 != plain on "
              f"dispatch {len(dispatches)} ({int(keys.shape[0])} lanes)")
        dispatches.append(int(keys.shape[0]))
        return got

    sha256.sha256_fingerprint64, bloom.bloom_scatter = fp, scatter
    reset_counts()
    rss0 = fst._rss_bytes()
    t0 = time.perf_counter()
    try:
        art = build_artifact_from_sources(
            sources, fp_rate=FILTER_FP, use_device=True, fmt="fl02",
            stream_chunk=SCALE_CHUNK, device=device)
    finally:
        sha256.sha256_fingerprint64, bloom.bloom_scatter = orig_fp, orig_scatter
    wall = time.perf_counter() - t0
    launches = read_counts()
    check(launches["sha256_fp"] > 0 and launches["bloom_scatter"] ==
          len(dispatches) > 0, "filter-scale: K1 or K5 never ran")
    check(art.n_serials == SCALE_SERIALS
          and len(art.groups) == len(sources),
          f"filter-scale: {art.n_serials} serials in {len(art.groups)} groups")
    t0 = time.perf_counter()
    members = _members_on_card(art, sources, device)
    member_s = time.perf_counter() - t0
    check(members == SCALE_SERIALS,
          f"filter-scale: {SCALE_SERIALS - members} keys are not members")
    out = {"serials": SCALE_SERIALS, "groups": len(art.groups),
           "wall_s": wall, "launches": launches, "dispatches": dispatches,
           "k1_s": timed["k1"][0], "k5_s": timed["k5"][0],
           "k1_keys_per_s": timed["k1"][1] / timed["k1"][0],
           "k5_keys_per_s": timed["k5"][1] / timed["k5"][0],
           "artifact_bytes": len(art.to_bytes()),
           "bits_per_entry": art.bits_per_entry(), "member_check_s": member_s,
           "rss_before": rss0, "peak_rss": fst._rss_bytes()}
    print(f"phase 12 (c) filter-scale: {SCALE_SERIALS} serials in "
          f"{out['groups']} groups, fl02 {out['artifact_bytes']} B "
          f"({out['bits_per_entry']:.2f} bits/serial) in {wall:.1f} s "
          f"(plain K5 checks included); K1 {out['k1_keys_per_s']:.3e} keys/s "
          f"over {launches['sha256_fp']} launches, K5 "
          f"{out['k5_keys_per_s']:.3e} keys/s over {len(dispatches)} "
          f"dispatches, each == plain; every key a member "
          f"({member_s:.1f} s)", flush=True)
    return out


def filter_phase(device, seed: int, plain_batch_s: list, part_url: str,
                 fetch_truth) -> dict:
    """Phase 12: (0) K5 against its plain version; (a) filter-main; (b)
    filter-fetch; (c) filter-scale."""
    import torch

    out = {"k5": bloom_check(device, seed)}
    out["main"] = filter_main(device, seed, plain_batch_s)
    out["fetch"] = filter_fetch(device, part_url, *fetch_truth)
    torch.cuda.empty_cache()
    out["scale"] = filter_scale(device, seed)
    torch.cuda.empty_cache()
    return out


# -- phase 13: signature verification on the card ------------------------

K6_WIDTHS = (1 << 10, 1 << 16)  # verifyBatch's default; a card-filling batch
# Widths that cut a thread group or a block of K6 (checked, not timed).
K6_EDGE_WIDTHS = (1, 3, 31, 127, 129, 1023, 1025)
K6_KEYS = 4  # log keys a curve in (0)'s corpus
K6_NONCES = 8  # fixed nonces a key (see FixedNonceSigner)
K6_HOST_SAMPLE = 16  # lanes of each curve held to verify_ecdsa
VERIFY_ENTRIES = 1 << 17  # (a), (b): entries of the SCT stream
VERIFY_BATCH = 1 << 16  # batchSize of (a) and (b)
VERIFY_TABLE_BITS = 18
VERIFY_RSA_DISTINCT = 64  # distinct RSA-signed leaves; replayed after
# The stream's mix of (a), (b): each entry's embedded SCT.
VERIFY_MIX = (("p256-a", 0.35), ("p256-b", 0.35), ("p384", 0.10),
              ("rsa", 0.05), ("unregistered", 0.05), ("none", 0.10))
# The same logs' P-256 SCTs alone: the lane's cost where K6 takes every
# lane.
VERIFY_MIX_P256 = (("p256-a", 0.5), ("p256-b", 0.5))
VERIFY_CORRUPT = 0.01  # ECDSA signatures with a flipped bit
VERIFY_ISSUERS = 4


def _fixed_nonce_signer():
    """A fixture log signer that signs fast: K6_NONCES fixed nonces, r =
    (kG).x computed once a nonce, s = k⁻¹(z + r·d) mod n one product a
    signature. Distinct digests still give distinct u1 and u2, so every
    signature is a full verify. Not a secure signer."""
    from ct_mapreduce_tpu_torch.verify import host
    from ct_mapreduce_tpu_torch.verify import sct as sctlib

    class FixedNonceSigner(sctlib.EcSctSigner):
        def __init__(self, seed: str, curve=host.P256):
            super().__init__(seed, curve)
            self.nonces = []
            for j in range(K6_NONCES):
                k = host.derive_nonce(seed, bytes([j]), curve)
                pt = host._point_mul(curve, k, (curve.gx, curve.gy))
                self.nonces.append((pt[0] % curve.n, pow(k, -1, curve.n)))

        def sign_rs(self, digest: bytes) -> tuple[int, int]:
            r, kinv = self.nonces[digest[0] % K6_NONCES]
            z = host.digest_to_z(self.curve, digest)
            return r, kinv * (z + r * self.d) % self.curve.n

        def sign(self, digest: bytes) -> bytes:
            return sctlib._fixed_ecdsa_der(*self.sign_rs(digest),
                                           self.curve.byte_len)

    return FixedNonceSigner


_K6_SIGNERS: dict = {}


def _k6_signers(curve) -> list:
    """The K6_KEYS fixed-nonce signers of (0)'s corpora for ``curve``,
    made once."""
    if curve.name not in _K6_SIGNERS:
        signer_cls = _fixed_nonce_signer()
        _K6_SIGNERS[curve.name] = [signer_cls(f"k6-{curve.name}-{k}", curve)
                                   for k in range(K6_KEYS)]
    return _K6_SIGNERS[curve.name]


def k6_corpus(curve, n: int, seed: int):
    """(0)'s lanes for ``curve``: about 80% valid signatures under
    K6_KEYS keys, the rest mutated — r or s 0 or n, s + 1, a key off the
    curve, qx >= p, a wrong digest — and padding lanes (valid false).
    Returns the byte rows, valid, the key slot of each lane (0 for a key
    that fails its checks), the keys, and per lane (kind, d, r, s, x,
    y) as ints for the host checks and the bound's count."""
    import numpy as np

    signers = _k6_signers(curve)
    rng = np.random.default_rng(seed + 1300 + curve.byte_len)
    bl = curve.byte_len
    digests = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    kinds = rng.choice(10, n, p=[0.80] + [0.2 / 9] * 9)
    lanes = []
    for i in range(n):
        sg = signers[i % K6_KEYS]
        dg = digests[i].tobytes()
        r, s = sg.sign_rs(dg)
        x, y = sg.q
        k = int(kinds[i])
        if k == 1:
            r = 0
        elif k == 2:
            s = curve.n
        elif k == 3:
            s = (s + 1) % curve.n
        elif k == 4:
            y ^= 1  # off the curve
        elif k == 5:
            x = curve.p + (x & 0xFFFF)  # a coordinate >= p
        elif k == 6:
            dg = bytes([dg[0] ^ 0x80]) + dg[1:]  # the digest of another body
        elif k == 7:
            s = 0
        elif k == 8:
            r = curve.n
        lanes.append((k, dg, r, s, x, y))
    key_idx = [i % K6_KEYS if lanes[i][0] not in (4, 5) else 0
               for i in range(n)]
    return (*_k6_rows(curve, lanes, key_idx), [sg.q for sg in signers],
            lanes)


def _k6_rows(curve, lanes, key_idx):
    """Byte rows (digest left-padded, r, s, qx, qy), valid (kind 9 is a
    padding lane) and key slots of (kind, d, r, s, x, y) lanes."""
    import numpy as np

    n, bl = len(lanes), curve.byte_len
    lim = 1 << (8 * bl)

    def rows(vals):
        return np.frombuffer(b"".join((v % lim).to_bytes(bl, "big")
                                      for v in vals),
                             np.uint8).reshape(n, bl).copy()

    digest = np.zeros((n, bl), np.uint8)
    digest[:, bl - 32:] = np.frombuffer(b"".join(ln[1] for ln in lanes),
                                        np.uint8).reshape(n, 32)
    out = [digest] + [rows([ln[j] for ln in lanes]) for j in (2, 3, 4, 5)]
    valid = np.array([ln[0] != 9 for ln in lanes])
    return out, valid, np.array(key_idx, np.int32)


def k6_edge_corpus(curve, seed: int, block: int = 0):
    """The edge lanes of (0) for ``curve``, in runs of ``block`` lanes
    (by default K6's widest block, so that a run covers whole blocks of
    either ladder): (i) every lane fails a check (r or s 0 or n, keys off
    the curve, past p or (0, 0), padding); (ii) one good lane among s =
    0, r = n and off-curve lanes; then (at most 32 lanes each) (iii)
    results at infinity, Q = G and r = -e mod n, and (iv) Q = G and r =
    e mod n (u1 G = u2 Q, the sum a doubling), between good lanes. Returns what
    k6_corpus does; key slot K6_KEYS is G."""
    import numpy as np

    from ct_mapreduce_tpu_torch.ops import ecdsa_cuda
    from ct_mapreduce_tpu_torch.verify import host

    signers = _k6_signers(curve)
    rng = np.random.default_rng(seed + 1400 + curve.byte_len)
    b = block or max(ecdsa_cuda.block_lanes(w) for w in (8, 0))
    bad = (1, 2, 4, 5, 7, 8, 9, 12)  # 12: the key (0, 0)
    kinds = ([bad[i % len(bad)] for i in range(b)]
             + [(7, 8, 4)[i % 3] for i in range(b)])
    kinds[b + b // 3] = 0
    kinds += [10 if i % 2 else 0 for i in range(min(b, 32))]
    kinds += [11 if i % 2 else 0 for i in range(min(b, 32))]
    lanes, key_idx = [], []
    for i, k in enumerate(kinds):
        sg = signers[i % K6_KEYS]
        dg = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        r, s = sg.sign_rs(dg)
        x, y = sg.q
        slot = i % K6_KEYS
        if k in (10, 11):
            e = host.digest_to_z(curve, dg) % curve.n
            r = (-e if k == 10 else e) % curve.n or 1
            s = int(rng.integers(1, 1 << 62))
            x, y, slot = curve.gx, curve.gy, K6_KEYS
        elif k == 1:
            r = 0
        elif k == 2:
            s = curve.n
        elif k == 4:
            y ^= 1
        elif k == 5:
            x = curve.p + (x & 0xFFFF)
        elif k == 7:
            s = 0
        elif k == 8:
            r = curve.n
        elif k == 12:
            x = y = 0
        lanes.append((k, dg, r, s, x, y))
        key_idx.append(slot)
    keys = [sg.q for sg in signers] + [(curve.gx, curve.gy)]
    return (*_k6_rows(curve, lanes, key_idx), keys, lanes)


def k6_bound(ops, window: int, lanes, valid) -> dict:
    """K6's least time on these lanes: the multiply instructions that the
    function it replaces needs for this data (ecdsa_cuda.products a lane:
    s and Z by batch inversion, one Fermat chain each a batch) over the
    INT32 rate, against the bytes it must move (the five rows, valid,
    key index and verdict of each lane, and the G table once) over the
    HBM rate. The products K6's own loops execute are counted beside it:
    the same a lane, and its product trees a block
    (ecdsa_cuda.block_products), whose roots it inverts by binary GCD
    (ecdsa_cuda.block_gcds); every live lane counted as a result not at
    infinity."""
    import numpy as np

    from ct_mapreduce_tpu_torch.ops import ecdsa_cuda
    from ct_mapreduce_tpu_torch.verify import host

    c = ops.curve
    need = 0
    live = np.zeros(len(lanes), bool)
    for i, ((_k, dg, r, s, x, y), v) in enumerate(zip(lanes, valid)):
        lim = 1 << (8 * c.byte_len)
        r, s, x, y = r % lim, s % lim, x % lim, y % lim
        if not v or not (0 < r < c.n and 0 < s < c.n and x < c.p
                         and y < c.p and (x or y)):
            continue
        on = (y * y - x * x * x + 3 * x - c.b) % c.p == 0
        if not on:
            need += ecdsa_cuda.products(ops, window, False)
            continue
        w = pow(s, -1, c.n)
        z = host.digest_to_z(c, dg) % c.n
        need += ecdsa_cuda.products(ops, window, True, z * w % c.n,
                                    r * w % c.n)
        live[i] = True
    run = need + ecdsa_cuda.block_products(ops, window, live, live)
    gcds = ecdsa_cuda.block_gcds(window, live, live)
    if live.any():
        need += ecdsa_cuda.batch_products_needed(ops)
    muls = ecdsa_cuda.muls_per_product(ops)
    ops_ms = need * muls / INT32_OPS_PER_S * 1e3
    entries = 1 << window if window else 0
    gtab_bytes = (ops.nbits // window) * entries * 2 * ops.byte_len if window else 0
    byte_ms = (len(lanes) * (5 * ops.byte_len + 1 + 4 + 1) + gtab_bytes) \
        / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, byte_ms),
            "bound_by": "operations" if ops_ms >= byte_ms else "bytes",
            "ops_bound_ms": ops_ms, "bytes_bound_ms": byte_ms,
            "products": need, "executed_products": run, "gcd_inversions": gcds,
            "executed_ops_ms": run * muls / INT32_OPS_PER_S * 1e3}


def k6_edge_check(ops, device, seed: int) -> dict:
    """K6 on k6_edge_corpus's lanes at windows 8 and 0: every verdict
    equal to the plain version's and to verify_ecdsa's."""
    import torch

    from ct_mapreduce_tpu_torch.ops import ecdsa, ecdsa_cuda
    from ct_mapreduce_tpu_torch.verify import host

    c = ops.curve
    rows, valid, key_idx, keys, lanes = k6_edge_corpus(c, seed)
    lim = 1 << (8 * c.byte_len)
    truth = [bool(v) and host.verify_ecdsa(c, dg, r % lim, s % lim,
                                           x % lim, y % lim)
             for v, (_k, dg, r, s, x, y) in zip(valid, lanes)]
    args = [torch.from_numpy(a).to(device) for a in rows] + [
        torch.from_numpy(valid).to(device)]
    err = 0
    for window in (8, 0):
        if window:
            gtab, _ = ecdsa.fixed_base_table(ops, window, device)
            qtab = ecdsa.zero_qtable(len(keys), ops.nbits // window,
                                     1 << window, ops.mod_p.nlimb, device)
            for slot, (x, y) in enumerate(keys):
                ecdsa.qtable_slot_set(qtab, slot, ecdsa.point_table_cached(
                    ops, window, x, y)[0])
            extra = [torch.from_numpy(key_idx).to(device), gtab, qtab]
            got = ecdsa_cuda.verify_windowed(ops, *args, *extra)
            want = ecdsa._verify_windowed(ops, *args, *extra)
        else:
            got = ecdsa_cuda.verify_jacobian(ops, *args)
            want = ecdsa._verify_jacobian(ops, *args)
        torch.cuda.synchronize()
        e = int((got != want).sum())
        check(e == 0, f"K6 {c.name} w{window} on the edge lanes: {e} "
              "verdicts differ from the plain version")
        check(want.cpu().tolist() == truth, f"K6 {c.name} w{window}: the "
              "plain version differs from verify_ecdsa on the edge lanes")
        err += e
    print(f"phase 13 (0): K6 {c.name} windows 8 and 0 == plain == "
          f"verify_ecdsa on {len(lanes)} edge lanes ({sum(truth)} verified: "
          "a block of failed checks, one good lane among bad ones, results "
          "at infinity, u1 G = u2 Q)", flush=True)
    return {"lanes": len(lanes), "max_abs_err": err,
            "verified": sum(truth)}


def k6_check(device, seed: int) -> dict:
    """Phase 13 (0): K6 against its plain version, verdict for verdict,
    for P-256 and P-384 at windows 8 and 0, at K6_WIDTHS lanes: the plain
    version runs once on the wide batch, whose first K6_WIDTHS[0] lanes
    are the narrow batch. A sample of lanes held to verify_ecdsa. K6
    timed with CUDA events at both widths, the plain version once."""
    import numpy as np
    import torch

    from ct_mapreduce_tpu_torch.ops import ecdsa, ecdsa_cuda
    from ct_mapreduce_tpu_torch.verify import host

    out = {}
    wide = K6_WIDTHS[-1]
    for window in (8, 0):
        check(ecdsa_cuda.lanes_per_block(window)
              == ecdsa_cuda.block_lanes(window),
              f"K6's signatures a block at window {window} differ from the "
              "count's ecdsa_cuda.block_lanes")
    for ops in (ecdsa.P256_OPS, ecdsa.P384_OPS):
        c = ops.curve
        t0 = time.perf_counter()
        rows, valid, key_idx, keys, lanes = k6_corpus(c, wide, seed)
        gen_s = time.perf_counter() - t0
        dev_rows = [torch.from_numpy(a).to(device) for a in rows]
        dev_valid = torch.from_numpy(valid).to(device)
        dev_keys = torch.from_numpy(key_idx).to(device)
        host_want = {}
        for i in range(K6_HOST_SAMPLE):
            _k, dg, r, s, x, y = lanes[i]
            lim = 1 << (8 * c.byte_len)
            host_want[i] = bool(valid[i]) and host.verify_ecdsa(
                c, dg, r % lim, s % lim, x % lim, y % lim)
        for window in (8, 0):
            if window:
                gtab, _ = ecdsa.fixed_base_table(ops, window, device)
                qtab = ecdsa.zero_qtable(32, ops.nbits // window,
                                         1 << window, ops.mod_p.nlimb, device)
                for slot, (x, y) in enumerate(keys):
                    ecdsa.qtable_slot_set(qtab, slot, ecdsa.point_table_cached(
                        ops, window, x, y)[0])

                def run(n, fn):
                    return fn(ops, *[a[:n] for a in dev_rows], dev_valid[:n],
                              dev_keys[:n], gtab, qtab)

                kern, plain = ecdsa_cuda.verify_windowed, ecdsa._verify_windowed
            else:
                def run(n, fn):
                    return fn(ops, *[a[:n] for a in dev_rows], dev_valid[:n])

                kern, plain = ecdsa_cuda.verify_jacobian, ecdsa._verify_jacobian
            if not out:
                # The plain version's first call pays its kernels' first
                # launches; later calls reuse the same kernels.
                run(32, plain)
                torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = run(wide, plain)
            end.record()
            end.synchronize()
            plain_ms = start.elapsed_time(end)
            got_host = want[:K6_HOST_SAMPLE].cpu().tolist()
            check(got_host == [host_want[i] for i in range(K6_HOST_SAMPLE)],
                  f"K6 {c.name} w{window}: the plain version differs from "
                  "verify_ecdsa")
            for n in K6_EDGE_WIDTHS:
                got = run(n, kern)
                torch.cuda.synchronize()
                err = int((got != want[:n]).sum())
                check(err == 0, f"K6 {c.name} w{window} at {n} lanes: {err} "
                      "verdicts differ from the plain version")
            for n in K6_WIDTHS:
                got = run(n, kern)
                torch.cuda.synchronize()
                err = int((got != want[:n]).sum())
                check(err == 0, f"K6 {c.name} w{window} at {n} lanes: {err} "
                      "verdicts differ from the plain version")
                times = []
                calls = 10 if n <= 1024 else (3 if window else 1)
                for _ in range(2):
                    times += cuda_times(lambda: run(n, kern), 10, calls)
                st = dict(k6_bound(ops, window, lanes[:n], valid[:n]),
                          lanes=n, max_abs_err=err,
                          kernel_ms=median(times), kernel_ms_min=min(times),
                          kernel_ms_max=max(times),
                          valid_share=float(got.float().mean()))
                if n == wide:
                    st.update(plain_ms=plain_ms, gen_s=gen_s)
                st["share_of_bound"] = st["bound_ms"] / st["kernel_ms"]
                out[f"{c.name}_w{window}_{n}"] = st
                print(f"phase 13 (0): K6 {c.name} window {window} == plain "
                      f"on {n} lanes ({st['valid_share']:.1%} verified); "
                      f"kernel {st['kernel_ms']:.3f} ms, bound "
                      f"{st['bound_ms']:.3f} ms ({st['bound_by']}, "
                      f"{st['share_of_bound']:.1%}); K6 executes "
                      f"{st['executed_products'] / st['products']:.2f}x the "
                      "products needed"
                      + (f", plain {plain_ms:.0f} ms" if n == wide else ""),
                      flush=True)
            del want
        del dev_rows
        out[f"{c.name}_edge"] = k6_edge_check(ops, device, seed)
    # The plain version at the lane's width, P-256 window 8 (the default).
    ops = ecdsa.P256_OPS
    rows, valid, key_idx, keys, _lanes = k6_corpus(ops.curve, K6_WIDTHS[0],
                                                   seed)
    gtab, _ = ecdsa.fixed_base_table(ops, 8, device)
    qtab = ecdsa.zero_qtable(32, 32, 256, 16, device)
    for slot, (x, y) in enumerate(keys):
        ecdsa.qtable_slot_set(qtab, slot, ecdsa.point_table_cached(
            ops, 8, x, y)[0])
    args = [torch.from_numpy(a).to(device) for a in rows] + [
        torch.from_numpy(valid).to(device),
        torch.from_numpy(key_idx).to(device), gtab, qtab]
    times = cuda_times(lambda: ecdsa._verify_windowed(ops, *args), 2,
                       warmup=1)
    out[f"p256_w8_{K6_WIDTHS[0]}"]["plain_ms"] = median(times)
    torch.cuda.empty_cache()
    return out


def verify_stream(seed: int, n: int, mix=VERIFY_MIX):
    """(a), (b)'s stream: ``n`` leaves under VERIFY_ISSUERS CAs, each
    carrying the embedded SCT of ``mix``'s log (or none), as raw
    get-entries pages; VERIFY_CORRUPT of the ECDSA signatures corrupted.
    A template certificate a (CA, log) pair gets its SCT by DER surgery
    once; each entry restamps the template's serial, computes its RFC
    6962 digest from the template's reconstructed TBS with the new
    serial, and patches in its signature (RSA leaves: VERIFY_RSA_DISTINCT
    of them, replayed). Returns (leaf inputs, extra datas, the keys'
    registry JSON, the truth: {issuer DER: [verified, failed]} and the
    lane counts by class)."""
    import base64
    import datetime as dt
    import hashlib

    import numpy as np

    from ct_mapreduce_tpu_torch.ingest import leaf as leaflib
    from ct_mapreduce_tpu_torch.utils import minicert
    from ct_mapreduce_tpu_torch.verify import host
    from ct_mapreduce_tpu_torch.verify import lane as vlane
    from ct_mapreduce_tpu_torch.verify import sct as sctlib

    future = dt.datetime(2031, 6, 15, tzinfo=dt.timezone.utc)
    signer_cls = _fixed_nonce_signer()
    signers = {"p256-a": signer_cls("smoke-p256-a"),
               "p256-b": signer_cls("smoke-p256-b"),
               "p384": signer_cls("smoke-p384", host.P384),
               "rsa": sctlib.RsaSctSigner(),
               "unregistered": signer_cls("smoke-unregistered")}
    reg = vlane.LogKeyRegistry()
    for name in ("p256-a", "p256-b", "p384", "rsa"):
        reg.register_signer(signers[name])
    issuers = [minicert.make_cert(serial=1, issuer_cn=f"Verify CA {k}",
                                  is_ca=True, not_after=future)
               for k in range(VERIFY_ISSUERS)]
    marker = 0x5A5A5A5A5A5A5A5A5A5A5A5A5A5A
    templates = {}
    for k, iss in enumerate(issuers):
        base = minicert.make_cert(serial=marker, issuer_cn=f"Verify CA {k}",
                                  subject_cn=f"verify{k}.example",
                                  not_after=future)
        ser = marker.to_bytes(15, "big")
        for name, _share in mix:
            ts = 1_700_000_000_000 + k
            cert = base if name == "none" else sctlib.attach_sct(
                base, signers[name], ts, issuer_der=iss)
            t = {"der": cert, "ser_off": cert.index(ser), "ts": ts}
            if name != "none":
                win = sctlib.find_sct_extension(cert)
                t["sig_off"] = win[2] + 51
                tbs = sctlib.reconstruct_precert_tbs(cert)
                t["tbs"] = (tbs[: tbs.index(ser)],
                            tbs[tbs.index(ser) + 15:])
                t["head"] = (b"\x00\x00" + ts.to_bytes(8, "big") + b"\x00\x01"
                             + sctlib.issuer_key_hash_of(iss)
                             + len(tbs).to_bytes(3, "big"))
                t["tail"] = b"\x00\x00"  # no SCT extensions
            templates[(k, name)] = t
    rng = np.random.default_rng(seed + 1313)
    names = [m[0] for m in mix]
    cls = rng.choice(len(names), n, p=[m[1] for m in mix])
    iss_of = rng.integers(0, VERIFY_ISSUERS, n)
    corrupt = rng.random(n) < VERIFY_CORRUPT
    truth = {iss: [0, 0] for iss in issuers}
    counts = {name: 0 for name in names}
    extra = [base64.b64encode(leaflib.encode_extra_data([iss])).decode()
             for iss in issuers]
    lis, eds = [], []
    rsa_cache: dict = {}
    for i in range(n):
        name = names[cls[i]]
        k = int(iss_of[i])
        counts[name] += 1
        t = templates[(k, name)]
        serial = (n + i % VERIFY_RSA_DISTINCT if name == "rsa" else i) + 1
        ser = (serial + (k << 100)).to_bytes(15, "big")
        key = (k, serial) if name == "rsa" else None
        cert = rsa_cache.get(key) if key else None
        bad = bool(corrupt[i]) and name not in ("rsa", "none")
        if cert is None:
            der = bytearray(t["der"])
            der[t["ser_off"]: t["ser_off"] + 15] = ser
            if name != "none":
                digest = hashlib.sha256(t["head"] + t["tbs"][0] + ser
                                        + t["tbs"][1] + t["tail"]).digest()
                sig = bytearray(signers[name].sign(digest))
                if bad:
                    sig[-1] ^= 0x01
                der[t["sig_off"]: t["sig_off"] + len(sig)] = sig
            cert = bytes(der)
            if key:
                rsa_cache[key] = cert
        if name not in ("unregistered", "none"):
            truth[issuers[k]][1 if bad else 0] += 1
        lis.append(base64.b64encode(leaflib.encode_leaf_input(
            cert, timestamp_ms=1_700_000_000_000 + i)).decode())
        eds.append(extra[k])
    return lis, eds, reg.to_json(), truth, counts


def _verify_keys_file(keys_json: str) -> str:
    d = os.path.join(HERE, "build", "smoke_verify")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "keys.json")
    with open(path, "w") as f:
        f.write(keys_json)
    return path


def _check_verify_truth(agg, truth, what: str) -> None:
    for iss, (v, f) in truth.items():
        idx = agg.registry.get_or_assign(iss)
        got = (int(agg.verify_verified[idx]), int(agg.verify_failed[idx]))
        check(got == (v, f), f"{what}: issuer {idx} verified/failed {got}, "
              f"want {(v, f)}")


def verify_sink(device, stream, p256_stream) -> dict:
    """Phase 13 (a): the stream through an ``AggregatorSink`` that
    ``build_sink`` makes with ``verifySignatures`` and ``verifyLogKeys``
    (K6 on the card), against the generator's truth; then the same pages
    through a sink without the lane, for its cost. The same pair of runs
    over ``p256_stream`` (P-256 SCTs only, one chunk) gives the lane's
    cost where every lane goes to K6 (no P-384 re-extraction, no RSA
    host verify)."""
    out = {}
    for label, st_in in (("", stream), ("p256_", p256_stream)):
        for lane in (True, False):
            out[f"{label}{'lane' if lane else 'no_lane'}"] = _verify_sink_run(
                device, st_in, lane, label or "verify-sink")
    lis, counts = stream[0], stream[4]
    print(f"phase 13 (a) verify-sink: {len(lis)} entries ({counts}); "
          f"verdicts == truth per issuer ({out['lane']['verified']} verified, "
          f"{out['lane']['failed']} failed), {out['lane']['stats']['device_lanes']} "
          f"device lanes in {out['lane']['launches']['ecdsa_verify']} K6 "
          f"launches, {out['lane']['stats']['host_lanes']} host lanes; "
          f"{out['lane']['chunk_s']:.3f} s a {VERIFY_BATCH}-entry chunk with "
          f"the lane, {out['no_lane']['chunk_s']:.3f} s without; P-256 only "
          f"({len(p256_stream[0])} entries, {out['p256_lane']['verified']} "
          f"verified, {out['p256_lane']['failed']} failed == truth): "
          f"{out['p256_lane']['chunk_s']:.3f} s a chunk with the lane, "
          f"{out['p256_no_lane']['chunk_s']:.3f} s without", flush=True)
    return out


def _verify_sink_run(device, stream, lane: bool, what: str) -> dict:
    """One run of (a): ``stream``'s pages through a sink with or without
    the verify lane, timed from the first page to the sink's close."""
    import dataclasses

    import torch

    from ct_mapreduce_tpu_torch.config import CTConfig
    from ct_mapreduce_tpu_torch.ingest import sync

    lis, eds, keys_json, truth, counts = stream
    keys = _verify_keys_file(keys_json)
    cfg = dataclasses.replace(
        CTConfig(batch_size=VERIFY_BATCH, table_bits=VERIFY_TABLE_BITS),
        backend="tpu", verify_signatures=lane,
        verify_log_keys=keys if lane else "")
    sink, model = sync.build_sink(cfg, device=device)
    prebuild_s = 0.0
    if lane:
        # The log keys' window tables build on the verifier's prebuild
        # thread; the timed run starts once they are in the process
        # cache, as a long-running ct-fetch finds them.
        t0 = time.perf_counter()
        sink.verifier._prebuild_thread.join()
        prebuild_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    for p in range(0, len(lis), SINK_PAGE):
        sink.store_raw_batch(sync.RawBatch(
            lis[p: p + SINK_PAGE], eds[p: p + SINK_PAGE], p, "verify"))
    sink.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    run = {"wall_s": wall, "launches": launches, "prebuild_s": prebuild_s,
           "entries": len(lis),
           "chunk_s": wall / -(-len(lis) // VERIFY_BATCH)}
    if lane:
        st = dict(sink.verifier.stats)
        ecdsa_keys = [k for k in ("p256-a", "p256-b", "p384")
                      if counts.get(k, 0)]
        ecdsa_lanes = sum(counts[k] for k in ecdsa_keys)
        check(st["device_lanes"] == ecdsa_lanes,
              f"{what}: {st['device_lanes']} device lanes, want "
              f"{ecdsa_lanes}")
        check(st["host_lanes"] == counts.get("rsa", 0),
              f"{what}: {st['host_lanes']} host lanes, want the "
              f"{counts.get('rsa', 0)} RSA lanes")
        check(st["no_key"] == counts.get("unregistered", 0)
              and st["no_sct"] == counts.get("none", 0),
              f"{what}: no_key/no_sct {st['no_key']}/{st['no_sct']}")
        check(st["qtable_misses"] == len(ecdsa_keys),
              f"{what}: {st['qtable_misses']} Q-table misses, want one a "
              f"distinct ECDSA log key ({len(ecdsa_keys)})")
        check(launches["ecdsa_verify"] > 0, f"{what}: K6 never ran")
        _check_verify_truth(model.aggregator, truth, what)
        run.update(stats=st, verified=st["verified"], failed=st["failed"])
    del sink, model
    torch.cuda.empty_cache()
    return run


def verify_fetch(device, stream) -> dict:
    """Phase 13 (b): the stream served as a log on 127.0.0.1 (a thread of
    this process), ct-fetch with ``verifySignatures`` and
    ``verifyLogKeys``, then ``storage-statistics -json``: totals equal
    the truth."""
    import contextlib
    import io

    from ct_mapreduce_tpu_torch.cmd import storage_statistics
    from ct_mapreduce_tpu_torch.utils.fakelog import FakeLog, LogServer

    lis, eds, keys_json, truth, _counts = stream
    keys = _verify_keys_file(keys_json)
    d = os.path.join(HERE, "build", "smoke_verify")
    state = os.path.join(d, "fetch.npz")
    _fresh(state)
    log = FakeLog(url="https://ct.smoke.example/verify")
    for li, ed in zip(lis, eds):
        log.add_raw(li, ed)
    ini = os.path.join(d, "fetch.ini")
    with LogServer(log) as srv:
        with open(ini, "w") as f:
            f.write(f"logList = {srv.url}\nbackend = tpu\n"
                    f"batchSize = {VERIFY_BATCH}\n"
                    f"tableBits = {VERIFY_TABLE_BITS}\naggStatePath = {state}\n"
                    f"healthAddr = \nverifySignatures = true\n"
                    f"verifyLogKeys = {keys}\n")
        run = fetch_run(device, "verify-fetch", ini)
    model = run.pop("model")
    check(run["launches"]["ecdsa_verify"] > 0, "verify-fetch: K6 never ran")
    _check_verify_truth(model.aggregator, truth, "verify-fetch")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = storage_statistics.main(["-config", ini, "-json"])
    check(rc == 0, f"verify-fetch: storage-statistics exit code {rc}")
    totals = json.loads(buf.getvalue())["totals"]
    want_v = sum(v for v, _ in truth.values())
    want_f = sum(f for _, f in truth.values())
    check((totals.get("sctsVerified"), totals.get("sctsFailed"))
          == (want_v, want_f),
          f"verify-fetch: report totals {totals.get('sctsVerified')}/"
          f"{totals.get('sctsFailed')}, want {want_v}/{want_f}")
    print(f"phase 13 (b) verify-fetch: ct-fetch with verifySignatures over "
          f"{run['entries']} entries in {run['wall_s']:.2f} s; "
          f"storage-statistics {want_v} verified, {want_f} failed == truth; "
          f"{run['launches']['ecdsa_verify']} K6 launches", flush=True)
    return run


def verify_phase(device, seed: int) -> dict:
    """Phase 13: (0) K6 against its plain version; (a) verify-sink; (b)
    verify-fetch."""
    out = {"k6": k6_check(device, seed)}
    t0 = time.perf_counter()
    stream = verify_stream(seed, VERIFY_ENTRIES)
    out["stream_gen_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p256_stream = verify_stream(seed + 1, VERIFY_BATCH, VERIFY_MIX_P256)
    out["p256_stream_gen_s"] = time.perf_counter() - t0
    out["sink"] = verify_sink(device, stream, p256_stream)
    out["fetch"] = verify_fetch(device, stream)
    return out


# -- phase 14: the distribution plane and the audit on the card ----------

DIST_POLL_S = "2s"  # (a): ct-fetch's pollingDelayMean between rounds
DIST_GHOSTS = 1 << 12  # (a): never-logged serials the containers answer
AUDIT_TILE = 128  # (b): tiles of the 1,024-entry recorded shard
AUDIT_FLUSH = 4096  # (b): the audit sink's flush and the aggregator's batch
AUDIT_MUTANTS = 8192  # (b): structured mutants beside the shard's DERs
AUDIT_SHARD = os.path.join(HERE, "tests", "data", "recorded_shard.json.gz")


def _http_get(url: str, headers=None):
    """(status, headers, body) of a GET; a 304 or an error is an answer,
    not an exception."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers, err.read()


def _dist_query_items(agg, queries: list):
    """The /query objects as the oracle's (issuer index, hour, serial)."""
    from ct_mapreduce_tpu_torch.core.types import ExpDate

    out = []
    for q in queries:
        idx = agg.registry.index_of_issuer_id(q["issuer"])
        out.append((-1 if idx is None else idx,
                    ExpDate.parse(q["expDate"]).unix_hour(),
                    bytes.fromhex(q["serial"])))
    return out


def _answers_match(art, other, groups: dict, ghosts: dict, device) -> int:
    """Both artifacts answer every serial of ``groups`` and ``ghosts``
    ({(issuerID, hour): [serial]}) the same, every logged serial known
    in both; returns the answers compared."""
    import numpy as np

    n = 0
    for key in sorted(set(groups) | set(ghosts)):
        g, h = art.group_for(*key), other.group_for(*key)
        check((g is None) == (h is None), f"distrib-fetch: group {key} "
              "in one artifact only")
        if g is None:
            continue
        logged = sorted(groups.get(key, ()))
        probe = logged + list(ghosts.get(key, ()))
        a = art.query_group(g, probe, device=device)
        b = other.query_group(h, probe, device=device)
        check(np.array_equal(a, b), f"distrib-fetch: the answers of group "
              f"{key} differ")
        check(bool(a[:len(logged)].all()), f"distrib-fetch: a logged serial "
              f"of {key} answers unknown")
        n += len(probe)
    return n


def distrib_fetch(device, dist_url: str, logs, stream: Stream, truth,
                  seed: int) -> dict:
    """Phase 14 (a), distrib-fetch: ct-fetch with ``queryPort``,
    ``emitFilter``, ``runForever`` and ``distribHistory`` 4 over the
    ``dist`` log, which holds RESUME_ENTRIES[0] entries and grows to
    SERVE_FETCH_ENTRIES between two rounds, so that two epochs publish
    through ``refresh_serve_filter``. While it runs a client posts the
    smoke mix (no never-logged serial may answer known). Then, over HTTP:
    ``/filter`` equals the emitted artifact after the final save, a
    conditional GET answers 304, gzip decodes to the same bytes, the
    manifest validates its links, the delta bundle e1 → e2 applied by
    the client turns e1's bytes into e2's, both containers decode to
    artifacts answering as fl02 does on every logged serial and
    DIST_GHOSTS never-logged ones; the filter-first plane answers the
    smoke mix with no false negative and as the table oracle does, with
    the tier armed, K5 launched and ``serve.filter_negative`` above 0.
    Last, ``ct-filter-torch delta``, ``apply`` and ``container`` as
    processes round-trip the two epochs."""
    import gzip
    import shutil
    import socket
    import threading

    import numpy as np

    from ct_mapreduce_tpu_torch import distrib
    from ct_mapreduce_tpu_torch.cmd import ct_fetch
    from ct_mapreduce_tpu_torch.filter import FilterArtifact
    from ct_mapreduce_tpu_torch.serve import server as serve_server
    from ct_mapreduce_tpu_torch.serve.client import QueryClient
    from ct_mapreduce_tpu_torch.telemetry import metrics

    d = os.path.join(HERE, "build", "smoke_distrib")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    state = os.path.join(d, "dist.npz")
    fpath = state + ".filter"
    ini = _fetch_ini(os.path.join(d, "dist.ini"), dist_url, state, stream, {
        "queryPort": port, "serveReplicas": SERVE_REPLICAS,
        "serveCacheSize": -1, "emitFilter": "true", "runForever": "true",
        "pollingDelayMean": DIST_POLL_S, "distribHistory": 4})
    queries, want, _o, _t, _c, _f = serve_queries(stream, truth, FETCH_PROBES,
                                                  seed)
    result, servers, built = {}, [], {}
    orig_start, orig_sink = serve_server.QueryServer.start, ct_fetch.build_sink

    def start(self):
        servers.append(self)
        return orig_start(self)

    def sink_spy(config, **kw):
        sink, model = orig_sink(config, **kw)
        built["model"] = model
        return sink, model

    def run():
        try:
            result["rc"] = ct_fetch.main(["-config", ini, "-nobars"],
                                         device=device)
        except BaseException as err:  # reported by the main thread
            result["err"] = err

    base = f"http://127.0.0.1:{port}"
    client = QueryClient(f"127.0.0.1:{port}", timeout_s=60)
    lo = [0]

    def ask() -> None:
        """One POST of the smoke mix: no never-logged serial known."""
        part = queries[lo[0]:lo[0] + SERVE_POST]
        got = [r["known"] for r in client.query(part)["results"]]
        w = want[lo[0]:lo[0] + SERVE_POST]
        check(not any(k and not ww for k, ww in zip(got, w)),
              "distrib-fetch: a never-logged serial answered known")
        lo[0] = (lo[0] + SERVE_POST) % len(queries)

    def published(what: str, min_rounds: int, deadline_s: float = 300):
        """Polls until ct-fetch has ended ``min_rounds`` rounds and the
        store's latest epoch is the artifact on disk; (epoch, bytes)."""
        deadline = time.time() + deadline_s
        while True:
            check(fetch.is_alive(), f"distrib-fetch: ct-fetch ended early "
                  f"({result.get('err')!r}, rc {result.get('rc')})")
            if clock.rounds >= min_rounds and os.path.exists(fpath):
                with open(fpath, "rb") as f:
                    blob = f.read()
                code, _, body = _http_get(base + "/filter/manifest")
                man = json.loads(body) if code == 200 else {}
                if man.get("latestSha256") == hashlib.sha256(blob).hexdigest():
                    return man["latestEpoch"], blob
            check(time.time() < deadline, f"distrib-fetch: {what} was never "
                  "published")
            ask()
            time.sleep(0.05)

    metrics.get_sink().reset()
    serve_server.QueryServer.start = start
    ct_fetch.build_sink = sink_spy
    t0 = time.perf_counter()
    try:
        with RoundClock() as clock:
            reset_counts()
            fetch = threading.Thread(target=run, name="smoke-distrib-fetch")
            fetch.start()
            try:
                deadline = time.time() + 300
                while True:
                    try:
                        client.healthz()
                        break
                    except OSError:
                        check(fetch.is_alive() and time.time() < deadline,
                              f"distrib-fetch: the query plane never came "
                              f"up ({result.get('err')!r})")
                        time.sleep(0.02)
                e1, blob1 = published("the first round's artifact", 1)
                e1_s = time.perf_counter() - t0
                check(logs.ask("grow dist") == SERVE_FETCH_ENTRIES,
                      "distrib-fetch: the log did not grow")
                rounds_before = clock.rounds
                e2, blob2 = published("the grown log's artifact",
                                      rounds_before + 1)
                while FilterArtifact.from_bytes(blob2).n_serials \
                        < int(np.count_nonzero(truth)):
                    e2, blob2 = published("the grown log's artifact",
                                          clock.rounds + 1)
                e2_s = time.perf_counter() - t0
                check(e2 > e1 and blob2 != blob1,
                      "distrib-fetch: the second epoch did not publish")
                # The smoke mix through the filter-first plane, every
                # answer held to the oracle and to the table tier.
                got, _, _, _ = _post_all(f"127.0.0.1:{port}", queries,
                                         SERVE_CLIENTS)
                srv = servers[0]
                oracle = srv.oracle
                health = client.healthz()
                code, hdr, full = _http_get(base + "/filter")
                etag = hdr["ETag"]
                c304 = _http_get(base + "/filter", {"If-None-Match": etag})
                gz = _http_get(base + "/filter", {"Accept-Encoding": "gzip"})
                mcode, _, mbody = _http_get(base + "/filter/manifest")
                dcode, dhdr, bundle = _http_get(
                    f"{base}/filter/delta/{e1}/{e2}")
                conts = {k: _http_get(f"{base}/filter/container/{k}")
                         for k in distrib.CONTAINER_KINDS}
                snap = metrics.get_sink().snapshot()["counters"]
            finally:
                for e in clock.engines:
                    e.signal_stop()
                fetch.join(timeout=600)
    finally:
        serve_server.QueryServer.start = orig_start
        ct_fetch.build_sink = orig_sink
    wall = time.perf_counter() - t0
    launches = read_counts()
    check(not fetch.is_alive() and result.get("rc") == 0,
          f"distrib-fetch: ct-fetch exit {result.get('rc')} "
          f"({result.get('err')!r})")
    with open(fpath, "rb") as f:
        final = f.read()
    check(code == 200 and full == final == blob2,
          "distrib-fetch: /filter differs from the artifact of the final save")
    check(etag == '"' + hashlib.sha256(final).hexdigest() + '"',
          "distrib-fetch: the ETag is not the artifact's SHA-256")
    check(c304[0] == 304 and c304[2] == b"",
          f"distrib-fetch: the conditional GET answered {c304[0]}")
    check(gz[0] == 200 and gz[1]["Content-Encoding"] == "gzip"
          and gzip.decompress(gz[2]) == final,
          "distrib-fetch: the gzip body differs")
    man = json.loads(mbody)
    check(mcode == 200 and dcode == 200, f"distrib-fetch: manifest "
          f"{mcode}, delta {dcode}")
    links = distrib.split_bundle(bundle)
    distrib.ChainManifest.from_json(man).validate_chain(e1, e2, links)
    check(distrib.apply_chain(blob1, links) == blob2,
          "distrib-fetch: the delta bundle does not replay e1 to e2")
    check(man["format"] == "CTMRDL02" and "immutable"
          in dhdr["Cache-Control"], f"distrib-fetch: manifest {man['format']}")
    # The tier is armed, and it answered negatives itself.
    check(health["filter_first"] is True and "filter_epoch" in health
          and health["filter_serials"] == int(np.count_nonzero(truth)),
          f"distrib-fetch: the filter tier is not armed: {health}")
    check(oracle.filter_tier is not None and launches["bloom_scatter"] > 0,
          "distrib-fetch: the tier was built without K5")
    check(snap.get("serve.filter_negative", 0) > 0,
          "distrib-fetch: the filter tier answered no negative")
    check(snap.get("serve.device_fallback", 0) == 0,
          "distrib-fetch: a replica fell back to the host")
    check(np.array_equal(got, want), "distrib-fetch: the filter-first plane "
          "answered the smoke mix wrong (a false negative or positive)")
    from ct_mapreduce_tpu_torch.serve.server import MembershipOracle

    table = MembershipOracle(built["model"].aggregator, filter_first=False,
                             replicas=1, cache_size=-1)
    try:
        tab = np.array([r[0] for r in table.query_raw(
            _dist_query_items(built["model"].aggregator, queries))], bool)
    finally:
        table.close()
    check(np.array_equal(tab, got), "distrib-fetch: the filter-first answers "
          "differ from the table oracle's")
    # Both containers against fl02, on every logged serial and ghosts.
    art = FilterArtifact.from_bytes(final)
    groups = {k: v for k, v in _oracle_serials(stream, truth).items()}
    rng = np.random.default_rng(seed + 14)
    keys = sorted(groups)
    ghosts: dict = {}
    for i in range(DIST_GHOSTS):
        key = keys[i % len(keys)]
        ghosts.setdefault(key, []).append(b"\x7e" + rng.bytes(12))
    compared = {}
    for kind, (ccode, chdr, cblob) in conts.items():
        check(ccode == 200, f"distrib-fetch: /filter/container/{kind} "
              f"answered {ccode}")
        back = distrib.decode_container(cblob)
        check(back.to_bytes() == final, f"distrib-fetch: the {kind} "
              "container does not decode to fl02's bytes")
        compared[kind] = _answers_match(art, back, groups, ghosts, device)
    # The offline plane as processes over the two epochs.
    p1, p2 = os.path.join(d, "e1.filter"), os.path.join(d, "e2.filter")
    with open(p1, "wb") as f:
        f.write(blob1)
    with open(p2, "wb") as f:
        f.write(blob2)
    cli = [sys.executable, "-m", "ct_mapreduce_tpu_torch.cmd.ct_filter"]
    procs = {
        "delta": subprocess.Popen(
            cli + ["delta", "-base", p1, "-target", p2, "-out",
                   os.path.join(d, "e1-e2.delta"), "-fromEpoch", str(e1),
                   "-toEpoch", str(e2)], cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        **{f"container_{k}": subprocess.Popen(
            cli + ["container", "-artifact", p2, "-kind", k, "-out",
                   os.path.join(d, f"e2.{k}")], cwd=HERE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
           for k in distrib.CONTAINER_KINDS}}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"ct-filter-torch {name}: exit "
              f"{proc.returncode}: {err[-400:]}")
    res = subprocess.run(cli + ["apply", "-base", p1, "-delta",
                                os.path.join(d, "e1-e2.delta"), "-out",
                                os.path.join(d, "replayed.filter")],
                         cwd=HERE, capture_output=True, text=True, timeout=300)
    check(res.returncode == 0, f"ct-filter-torch apply: exit "
          f"{res.returncode}: {res.stderr[-400:]}")
    with open(os.path.join(d, "e1-e2.delta"), "rb") as f:
        check(f.read() == distrib.compute_delta(blob1, blob2, e1, e2),
              "ct-filter-torch delta differs from the plane's link")
    with open(os.path.join(d, "replayed.filter"), "rb") as f:
        check(f.read() == blob2, "ct-filter-torch apply does not replay e2")
    for k in distrib.CONTAINER_KINDS:
        with open(os.path.join(d, f"e2.{k}"), "rb") as f:
            check(f.read() == conts[k][2], f"ct-filter-torch container {k} "
                  "differs from the served container")
    out = {"entries": SERVE_FETCH_ENTRIES, "wall_s": wall,
           "first_epoch_s": e1_s, "second_epoch_s": e2_s,
           "epochs": [e1, e2], "epochs_held": man["epochsHeld"],
           "artifact_bytes": [len(blob1), len(blob2)],
           "bundle_bytes": len(bundle), "gzip_bytes": len(gz[2]),
           "container_bytes": {k: len(v[2]) for k, v in conts.items()},
           "answers_compared": compared, "serials": art.n_serials,
           "filter_negative": snap.get("serve.filter_negative", 0),
           "filter_forward": snap.get("serve.filter_forward", 0),
           "filter_refresh": snap.get("serve.filter_refresh", 0),
           "http_304": snap.get("distrib.http_304", 0),
           "launches": launches}
    print(f"phase 14 (a) distrib-fetch: ct-fetch with queryPort + emitFilter "
          f"over {RESUME_ENTRIES[0]} then {SERVE_FETCH_ENTRIES} entries, "
          f"epochs {e1} and {e2} published at {e1_s:.1f} and {e2_s:.1f} s "
          f"({wall:.1f} s in all); /filter == the final artifact "
          f"({len(final)} B), 304, gzip {len(gz[2])} B, bundle "
          f"{len(bundle)} B replays e1 to e2, mlbf and clubcard answer as "
          f"fl02 on {compared['mlbf']} serials; the smoke mix through the "
          f"filter tier == oracle == table ({out['filter_negative']:.0f} "
          f"filter negatives); ct-filter-torch delta/apply/container "
          f"round-trip; launches {launches['sha256_fp']} K1, "
          f"{launches['der_walk']} K3, {launches['bloom_scatter']} K5, "
          f"{launches['ecdsa_verify']} K6; {card_line()}", flush=True)
    shutil.rmtree(d, ignore_errors=True)
    return out


def _audit_json(argv: list, device) -> tuple[int, dict]:
    """The port's audit entry point in this process, ``--json``."""
    import contextlib
    import io

    from ct_mapreduce_tpu_torch.tools import audit as audit_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = audit_cli.main(argv + ["--json"], device=device)
    return rc, json.loads(buf.getvalue())


def audit_shard(device, seed: int) -> dict:
    """Phase 14 (b), audit-shard: the checked-in recorded shard (1,024
    entries) through the port's audit entry point on the card, at tile 1
    and at tile AUDIT_TILE (131,072 entries, the verify lane on): the
    tiled report is AUDIT_TILE times the tile-1 one and each verdict
    count what the shard's mix implies; the quarantine spool (a
    temporary directory) replays as many records as the report counts;
    the ``--emit-filter`` artifact loads in ``ct-filter-torch inspect`` (a
    process). Then ``classify_corpus`` on the card over the shard's DERs
    and AUDIT_MUTANTS structured mutants: no verdict mismatch, buckets
    equal to the same corpus through the plain walker, the trend written
    to a temporary file."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from ct_mapreduce_tpu_torch.audit import driver as drvlib
    from ct_mapreduce_tpu_torch.audit import fixture as fxlib
    from ct_mapreduce_tpu_torch.audit import quarantine as quarlib
    from ct_mapreduce_tpu_torch.core import divergence
    from ct_mapreduce_tpu_torch.filter import read_artifact

    tmp = tempfile.mkdtemp(prefix="smoke-audit-")
    try:
        flags = ["--recorded", AUDIT_SHARD, "--flush-size", str(AUDIT_FLUSH),
                 "--batch-size", str(AUDIT_FLUSH)]
        t0 = time.perf_counter()
        rc1, one = _audit_json(flags + ["--quarantine-dir",
                                        os.path.join(tmp, "q1")], device)
        one_s = time.perf_counter() - t0
        check(rc1 == 0, f"audit-shard: tile 1 exit {rc1}")
        fpath = os.path.join(tmp, "audit.filter")
        qdir = os.path.join(tmp, "spool")
        reset_counts()
        t0 = time.perf_counter()
        rc, rep = _audit_json(flags + ["--tile", str(AUDIT_TILE),
                                       "--quarantine-dir", qdir,
                                       "--emit-filter", fpath], device)
        tile_s = time.perf_counter() - t0
        launches = read_counts()
        check(rc == 0, f"audit-shard: tile {AUDIT_TILE} exit {rc}")
        check(launches["der_walk"] > 0 and launches["sha256_fp"] > 0
              and launches["ecdsa_verify"] > 0,
              f"audit-shard: a kernel of the sink never ran: {launches}")
        scaled = ("entries", "sct_lanes", "no_sct", "unknown_log", "retired",
                  "out_of_interval", "verified", "failed", "verifier_no_sct",
                  "verifier_no_key", "device_lanes", "host_lanes",
                  "decode_failed", "quarantined")
        for k in scaled:
            check(rep[k] == AUDIT_TILE * one[k], f"audit-shard: {k} "
                  f"{rep[k]} != {AUDIT_TILE} x {one[k]}")
        check(rep["perIssuer"] == {i: [AUDIT_TILE * v, AUDIT_TILE * f]
                                   for i, (v, f) in one["perIssuer"].items()},
              "audit-shard: the per-issuer folds do not scale with the tile")
        check(rep["perLog"] == {k: AUDIT_TILE * v
                                for k, v in one["perLog"].items()},
              "audit-shard: the per-log lanes do not scale with the tile")
        mix = drvlib.load_recorded(AUDIT_SHARD)["mix"]
        want = {"verified": mix["p256_valid"] + mix["p384_retired"]
                + mix["rsa"] + mix["out_of_interval"],
                "failed": mix["p256_corrupt"],
                "verifier_no_key": mix["unknown_log"],
                "unknown_log": mix["unknown_log"],
                "retired": mix["p384_retired"],
                "out_of_interval": mix["out_of_interval"],
                "no_sct": mix["no_sct"], "host_lanes": mix["rsa"]}
        check(fxlib.expected_tallies()["verified"] == want["verified"],
              "audit-shard: the mix disagrees with the generator's tallies")
        for k, v in want.items():
            check(rep[k] == AUDIT_TILE * v, f"audit-shard: {k} {rep[k]}, "
                  f"the mix implies {AUDIT_TILE * v}")
        spool = quarlib.QuarantineSpool(qdir)
        check(len(spool.replay()) == rep["quarantined"] == 0
              and rep["divergence_measured"],
              f"audit-shard: quarantined {rep['quarantined']}, spool "
              f"{len(spool.replay())}")
        res = subprocess.run(
            [sys.executable, "-m", "ct_mapreduce_tpu_torch.cmd.ct_filter",
             "inspect", "-artifact", fpath, "-json"], cwd=HERE,
            capture_output=True, text=True, timeout=300)
        check(res.returncode == 0, f"ct-filter-torch inspect: exit "
              f"{res.returncode}: {res.stderr[-400:]}")
        inspected = json.loads(res.stdout)
        check(inspected["serials"] == 1024 == read_artifact(fpath).n_serials
              and inspected["groups"] == fxlib.N_ISSUERS,
              f"audit-shard: the emitted filter holds {inspected['serials']} "
              f"serials in {inspected['groups']} groups")
        # The parser-divergence harness on the card.
        ders = fxlib.shard_ders(drvlib.load_recorded(AUDIT_SHARD))
        corpus = ders + divergence.grammar_mutants(
            ders, np.random.default_rng(seed + 140), AUDIT_MUTANTS)
        reset_counts()
        t0 = time.perf_counter()
        card = divergence.classify_corpus(corpus, device=device)
        classify_s = time.perf_counter() - t0
        classify_launches = read_counts()
        t0 = time.perf_counter()
        plain = divergence.classify_corpus(corpus, device="cpu")
        plain_s = time.perf_counter() - t0
        check(classify_launches["der_walk"] == 1,
              f"audit-shard: classify_corpus launched K3 "
              f"{classify_launches['der_walk']} times")
        check(card.verdict_mismatch == 0, "audit-shard: verdict mismatch "
              f"{card.verdict_mismatch}: {card.details[:2]}")
        check(dataclasses.asdict(card) == dataclasses.asdict(plain),
              "audit-shard: the card's buckets differ from the plain "
              "walker's")
        trend = divergence.record_trend(card, os.path.join(tmp, "trend.json"),
                                        corpus="fuzz")
        check(trend["runs"][-1]["total"] == len(corpus),
              "audit-shard: the trend did not record the run")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"entries": rep["entries"], "tile": AUDIT_TILE,
           "tile1_s": one_s, "tile_s": tile_s,
           "entries_per_s": rep["entries"] / tile_s,
           "report": {k: rep[k] for k in scaled},
           "launches": launches, "classify": dataclasses.asdict(card),
           "classify_s": classify_s, "classify_plain_s": plain_s,
           "classify_launches": classify_launches}
    print(f"phase 14 (b) audit-shard: the recorded shard at tile "
          f"{AUDIT_TILE}, {rep['entries']} entries in {tile_s:.1f} s "
          f"(tile 1: {one_s:.1f} s) == {AUDIT_TILE} x tile 1 == the mix "
          f"(verified {rep['verified']}, failed {rep['failed']}, unknown "
          f"log {rep['unknown_log']}, out of interval "
          f"{rep['out_of_interval']}, retired {rep['retired']}), quarantined "
          f"0 (spool empty), the filter inspects; launches "
          f"{launches['sha256_fp']} K1, {launches['der_walk']} K3, "
          f"{launches['bloom_scatter']} K5, {launches['ecdsa_verify']} K6; "
          f"classify_corpus over {len(corpus)} DERs in {classify_s:.2f} s "
          f"(plain walker {plain_s:.2f} s): no verdict mismatch, buckets == "
          f"the plain walker's, launches {classify_launches['der_walk']} K3; "
          f"{card_line()}", flush=True)
    return out


# -- phase 15: the sharded dedup, the fleet and a global mesh ------------

MESH_SHARDS = 4  # (a)-(d): shard:4, every visible card or 4 over cuda:0
MESH_BATCHES = MAIN_BATCHES  # (a): walker-main's batches, as phase 5
FLEET_SEED = 15  # (e): the fleet stream's seed offset
FLEET_CHUNKS = (2, 1)  # (e): FETCH_CHUNK chunks of fleet-a and fleet-b
FLEET_PERIOD = "1s"  # (e): the workers' checkpointPeriod
FLEET_TIMEOUT = 300  # (e), (f): seconds a child process may take
GLOBAL_LANES = 1 << 18  # (f): lanes a process brings to the global mesh


def phase15_mesh(n: int):
    """A ``shard:n`` mesh over every visible card (n of them), or n
    shards over cuda:0 when fewer are visible."""
    import torch

    from ct_mapreduce_tpu_torch.parallel import make_mesh

    cards = torch.cuda.device_count()
    devs = ([torch.device("cuda", i) for i in range(n)] if cards >= n
            else [torch.device("cuda", 0)] * n)
    return make_mesh(f"shard:{n}", devs)


def sharded_walker(device, seed: int, walker_wu: list, bucket_at) -> dict:
    """15 (a): walker-main's first MESH_BATCHES batches through
    ``IngestModel`` on a MESH_SHARDS-shard mesh: every batch's
    ``was_unknown`` == phase 5's and the oracle's, the drain == the
    oracle's (and after OPEN_BATCHES == phase 5's), one step's K7
    replayed beside its bound. Keeps the model and truth (``_model``,
    ``_truth``) for (c) and (d)."""
    import numpy as np

    mesh = phase15_mesh(MESH_SHARDS)
    out = main_path(device, Stream(seed, cn_filter=True), MESH_BATCHES,
                    BATCH_LOG2, TABLE_BITS, 0.5, False,
                    drain_after=OPEN_BATCHES, keep=True, mesh=mesh,
                    keep_wu=True)
    wu = out.pop("_wu")
    for i, (got, want) in enumerate(zip(wu, walker_wu)):
        check(np.array_equal(got, want),
              f"15 (a): batch {i}'s was_unknown differs from phase 5's")
    check(out.pop("drain_at") == bucket_at,
          f"15 (a): the drain after {OPEN_BATCHES} batches differs from "
          "phase 5's")
    dedup = out["_model"].aggregator.dedup
    out.update(mesh=[str(d) for d in mesh.devices.flat],
               exchange=dedup.exchange_route(),
               dispatch_spill=out["metrics"]["dispatch_spill"])
    k7 = out["insert"]
    print(f"phase 15 (a) sharded-walker: mesh {out['mesh']}, exchange by "
          f"{out['exchange']}; every batch's was_unknown == phase 5's; "
          f"dispatch_spill {out['dispatch_spill']}; K1 "
          f"{out['launches']['sha256_fp']}, K3 {out['launches']['der_walk']} "
          f"launches; K7 one step {k7['ms']:.2f} ms (cap {k7['cap']}), bound "
          f"{k7['bound_ms']:.4f} ms (bytes)", flush=True)
    return out


def sharded_preparsed(device, seed: int, mesh_at) -> dict:
    """15 (b): the first OPEN_BATCHES batches through the pre-parsed
    lane on a fresh mesh (routed on the host): drain == (a)'s after the
    same batches."""
    out = main_path(device, Stream(seed, cn_filter=True), OPEN_BATCHES,
                    BATCH_LOG2, TABLE_BITS, 0.5, True,
                    mesh=phase15_mesh(MESH_SHARDS), cost=False)
    check(out.pop("snapshot") == mesh_at,
          "15 (b): the pre-parsed drain differs from (a)'s")
    print(f"phase 15 (b) sharded-preparsed: {OPEN_BATCHES} batches, drain "
          f"== (a)'s; K1 {out['launches']['sha256_fp']} launches",
          flush=True)
    return out


def _tpu_report(spec: str):
    """(JSON report without the log status, -v 1 text) of storage-
    statistics over the checkpoints ``spec`` names, read on the CPU."""
    import io

    from ct_mapreduce_tpu_torch.cmd import storage_statistics
    from ct_mapreduce_tpu_torch.config import CTConfig

    cfg = CTConfig.load(argv=[], env={})
    cfg.backend, cfg.agg_state_path = "tpu", spec
    text = io.StringIO()
    check(storage_statistics.report_from_tpu_snapshot(cfg, text, 1) == 0,
          f"storage-statistics over {spec} failed")
    rep = storage_statistics.collect_tpu_report(cfg)
    return {k: rep[k] for k in ("issuers", "totals")}, text.getvalue()


def sharded_ckpt(device, model, p9_path: str, p9_drain) -> dict:
    """15 (c): (a)'s table saved as ck01 and as a ck02 base, each loaded
    into a one-device aggregator and a shard:2 mesh, and reported by
    storage-statistics; phase 9's one-device ck01 loaded into a
    MESH_SHARDS-shard mesh. Every drain and report == the source's."""
    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.agg.sharded_agg import ShardedAggregator

    agg = model.aggregator
    drain = model.drain()
    d = os.path.join(HERE, "build", "smoke_p15")
    os.makedirs(d, exist_ok=True)
    out = {"saves": {}, "loads": {}}
    reports = []
    for mode in ("ck01", "ck02"):
        path = os.path.join(d, f"mesh-{mode}.npz")
        agg.configure_checkpointing(mode=mode)
        t0 = time.perf_counter()
        agg.save_checkpoint(path)
        out["saves"][mode] = {"s": time.perf_counter() - t0,
                              "bytes": os.path.getsize(path)}
        for name, make in (
                ("one", lambda: TorchAggregator(capacity=1 << 10,
                                                device=device)),
                ("shard2", lambda: ShardedAggregator(
                    phase15_mesh(2), capacity=1 << 10))):
            t0 = time.perf_counter()
            r = make()
            r.load_checkpoint(path)
            out["loads"][f"{mode}@{name}"] = time.perf_counter() - t0
            check(r.drain() == drain,
                  f"15 (c): {mode} loaded into {name}: the drain differs")
            del r
        t0 = time.perf_counter()
        reports.append(_tpu_report(path))
        out["loads"][f"{mode}@report"] = time.perf_counter() - t0
    check(reports[0] == reports[1],
          "15 (c): the ck01 and ck02 reports differ")
    check_report(reports[0][1], drain.counts, "15 (c) report")
    t0 = time.perf_counter()
    r = ShardedAggregator(phase15_mesh(MESH_SHARDS), capacity=1 << 10)
    r.load_checkpoint(p9_path)
    out["loads"]["phase9@shard4"] = time.perf_counter() - t0
    check(r.drain() == p9_drain,
          "15 (c): phase 9's checkpoint on the mesh drains differently")
    del r
    for f in os.listdir(d):
        if os.path.isfile(os.path.join(d, f)):
            os.unlink(os.path.join(d, f))
    print("phase 15 (c) sharded-ckpt: (a)'s table saved " + ", ".join(
        f"{m} {v['bytes']} B in {v['s']:.2f} s"
        for m, v in out["saves"].items()) + "; loaded " + ", ".join(
        f"{k} in {v:.2f} s" for k, v in out["loads"].items())
        + "; every drain and report == the source's", flush=True)
    return out


def sharded_serve(device, agg, stream: Stream, truth, seed: int) -> dict:
    """15 (d): a QueryServer over (a)'s sharded views answers the smoke
    mix as the oracle does; each replica pins each shard's row block on
    that shard's card."""
    import numpy as np
    import torch

    from ct_mapreduce_tpu_torch.serve.server import QueryServer
    from ct_mapreduce_tpu_torch.serve.snapshot import _concrete

    queries, want, *_ = serve_queries(stream, truth, SERVE_QUERIES, seed)
    srv = QueryServer(agg, 0, host="127.0.0.1", device=True,
                      replicas=SERVE_REPLICAS, cache_size=SERVE_CACHE).start()
    try:
        pool = srv.oracle.snapshots.warm()
        shard_devs = [_concrete(d) for d in agg.dedup.devices]
        for v in pool._replicas:
            check(v._dev_blocks is not None and v._dev_rows is None
                  and v.pinned_devices == shard_devs
                  and all(d.type == torch.device(device).type
                          for d in v.pinned_devices),
                  "15 (d): a replica's shard blocks are not pinned on their "
                  "shards' cards")
        got, post_s, wall, _ = _post_all(f"127.0.0.1:{srv.port}", queries,
                                         SERVE_CLIENTS)
        check(np.array_equal(got, want),
              f"15 (d): {int((got != want).sum())} answers differ from the "
              "oracle")
    finally:
        srv.stop()
    torch.cuda.synchronize()
    out = {"queries": SERVE_QUERIES, "wall_s": wall,
           "queries_per_s": SERVE_QUERIES / wall,
           "post_p50_ms": median(post_s) * 1e3,
           "blocks": [str(d) for d in shard_devs]}
    print(f"phase 15 (d) sharded-serve: {SERVE_QUERIES} queries, every "
          f"answer == the oracle, {out['queries_per_s']:.0f} queries/s; each "
          f"replica's {len(shard_devs)} blocks pinned on {out['blocks']}",
          flush=True)
    return out


def fleet_oracle(seed: int):
    """The fleet logs' truth: fleet-a's and fleet-b's stream regenerated
    from the seed (the same calls as ``serve_logs``); per log the seen
    counters. Returns (stream, [seen of fleet-a, seen of fleet-b])."""
    import numpy as np

    stream = Stream(seed + FLEET_SEED, cn_filter=True)
    n = sum(FLEET_CHUNKS) * FETCH_CHUNK + 2
    seen = []
    for chunks in FLEET_CHUNKS:
        s = np.zeros((n,), bool)
        for _ in range(chunks):
            _, _, tof, ctr = stream.batch(FETCH_CHUNK, SINK_REPLAY, True)
            s[ctr[~stream.filtered[tof]]] = True
        seen.append(s)
    return stream, seen


def _child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("MASTER_ADDR", "WORLD_SIZE", "CTMR_NUM_WORKERS",
              "CTMR_WORKER_ID", "CTMR_COORDINATOR", "CTMR_CHECKPOINT_PERIOD"):
        env.pop(k, None)
    return env


def _children(cmds: list) -> list[str]:
    """Run ``cmds`` as processes at once; their outputs, each checked for
    exit code 0 within FLEET_TIMEOUT (all killed past it)."""
    procs = [subprocess.Popen([sys.executable, *c], cwd=HERE,
                              env=_child_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=FLEET_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for c, p, o in zip(cmds, procs, outs):
        check(p.returncode == 0,
              f"{' '.join(c)}: exit code {p.returncode}\n{o[-3000:]}")
    return outs


def fleet_fetch(device, logs: LogProcess, seed: int) -> dict:
    """15 (e): two ct-fetch-torch processes on the card, ``numWorkers``
    2, ``coordinatorBackend = redis`` against a MiniRedis on 127.0.0.1,
    ``checkpointPeriod`` and ``emitFilter``: round one over fleet-a and
    fleet-b (the rendezvous partition), round two over fleet-a alone
    (its entries in two stripes). Each round's storage-statistics over
    both workers' states == a serial ct-fetch over the same logs == the
    oracle. The fleet filter the leader leaves (folded on the card after
    both workers' final saves) was built without error, equals a fresh
    ``build_from_merged`` of the final states byte for byte, and answers
    every logged serial."""
    import re

    import numpy as np

    from ct_mapreduce_tpu_torch.agg.merge import load_checkpoints
    from ct_mapreduce_tpu_torch.cmd import ct_fetch
    from ct_mapreduce_tpu_torch.filter.artifact import (
        build_from_merged, read_artifact)
    from ct_mapreduce_tpu_torch.utils.miniredis import MiniRedis

    urls = logs.wait_ready()
    stream, seen = fleet_oracle(seed)
    out = {}
    for rnd, picks in (("partition", (0, 1)), ("stripes", (0,))):
        # Each round is a new fleet on a Redis of its own: on one Redis
        # the first round's leader lease would outlive it (its renewal
        # TTL), and the second round would start with no leader.
        redis = MiniRedis().start()
        try:
            d = os.path.join(HERE, "build", "smoke_p15", rnd)
            os.makedirs(d, exist_ok=True)
            for f in os.listdir(d):
                os.unlink(os.path.join(d, f))
            log_list = ",".join(urls[4 + i] for i in picks)
            inis = [_fetch_ini(
                os.path.join(d, f"w{w}.ini"), log_list,
                os.path.join(d, "agg.npz"), stream, {
                    "numWorkers": 2, "workerId": w,
                    "coordinatorBackend": "redis",
                    "redisHost": redis.address,
                    "checkpointPeriod": FLEET_PERIOD, "emitFilter": "true",
                    "nobars": "true"}) for w in range(2)]
            t0 = time.perf_counter()
            texts = _children([["-m", "ct_mapreduce_tpu_torch.cmd.ct_fetch",
                                "-config", ini] for ini in inis])
            fleet_s = time.perf_counter() - t0
            for w, text in enumerate(texts):
                check(f"fleet worker {w}/2" in text
                      and ", rejoined" not in text,
                      f"15 (e) {rnd}: worker {w} ran no new fleet")
            serial_ini = _fetch_ini(
                os.path.join(d, "serial.ini"), log_list,
                os.path.join(d, "serial.npz"), stream, {"nobars": "true"})
            reset_counts()
            t0 = time.perf_counter()
            check(ct_fetch.main(["-config", serial_ini], device=device) == 0,
                  f"15 (e) {rnd}: the serial ct-fetch failed")
            serial_s = time.perf_counter() - t0
            serial_launches = read_counts()
            paths = [os.path.join(d, f"agg.w{w}.npz") for w in range(2)]
            fleet_rep = _tpu_report(",".join(paths))
            serial_rep = _tpu_report(os.path.join(d, "serial.npz"))
            check(fleet_rep == serial_rep,
                  f"15 (e) {rnd}: the workers' merged report differs from "
                  "the serial run's")
            want = np.zeros_like(seen[0])
            for i in picks:
                want |= seen[i]
            counts, _crls, _dns = _oracle_snapshot(stream, want)
            check_report(fleet_rep[1], counts, f"15 (e) {rnd}")
            # The leader's fleet filter: its end-of-run build, after both
            # workers' final saves.
            for w, text in enumerate(texts):
                check("fleet filter emission failed" not in text,
                      f"15 (e) {rnd}: worker {w}'s fleet filter build "
                      f"failed\n{text[-3000:]}")
            folded = [m for t in texts for m in re.findall(
                r"fleet filter: 2 worker snapshot\(s\) folded into \S+ on "
                r"(\S+) \(K1 (\d+), K5 (\d+) launches\)", t)]
            check(len(folded) == 1,
                  f"15 (e) {rnd}: {len(folded)} leaders folded the final "
                  "fleet filter (want 1)")
            leader = os.path.join(d, "agg.npz.filter")
            check(os.path.exists(leader),
                  f"15 (e) {rnd}: the leader left no fleet filter")
            art = read_artifact(leader)
            reset_counts()
            fresh = build_from_merged(load_checkpoints(paths),
                                      allow_partial=True, device=device)
            check_launches = read_counts()
            check(art.to_bytes() == fresh.to_bytes(),
                  f"15 (e) {rnd}: the leader's fleet filter differs from a "
                  "fresh build of the final checkpoints")
            ctr = np.nonzero(want)[0]
            tof = stream.template_of[ctr]
            ser, ln = stream.serial_bytes(tof, ctr)
            miss = 0
            for t in np.unique(tof):  # a template is one (issuer, hour)
                sel = np.nonzero(tof == t)[0]
                g = art.group_for(stream.truth[t]["issuer"],
                                  stream.truth[t]["hour"])
                miss += sel.size if g is None else int(
                    (~art.query_group(g, [ser[i, : ln[i]].tobytes()
                                          for i in sel],
                                      device=device)).sum())
            check(miss == 0, f"15 (e) {rnd}: the leader's fleet filter "
                             f"misses {miss} logged serials")
            on, k1, k5 = folded[0]
            out[rnd] = {"logs": len(picks), "serials": int(want.sum()),
                        "fleet_s": fleet_s, "serial_s": serial_s,
                        "serial_launches": serial_launches,
                        "leader_device": on,
                        "leader_final_launches": {"sha256_fp": int(k1),
                                                  "bloom_scatter": int(k5)},
                        "check_launches": check_launches,
                        "filter_bytes": len(art.to_bytes())}
            print(f"phase 15 (e) fleet-fetch {rnd}: 2 workers over "
                  f"{len(picks)} log(s) in {fleet_s:.1f} s (serial "
                  f"{serial_s:.1f} s); merged report == serial == oracle "
                  f"({out[rnd]['serials']} serials); the leader's fleet filter "
                  f"(folded on {on} after both final saves, K1 {k1}, K5 {k5} "
                  f"launches in that build) == a fresh build (K1 "
                  f"{check_launches['sha256_fp']}, K5 "
                  f"{check_launches['bloom_scatter']}) and answers every "
                  f"logged serial", flush=True)
        finally:
            redis.stop()
    return out


def global_mesh_phase(device, seed: int) -> dict:
    """15 (f): two processes join through ``initialize_multihost`` and
    take one ``ShardedDedup`` step of GLOBAL_LANES lanes each on a
    2-shard global mesh (``tools/global_mesh.py``): NCCL with two or
    more cards, else gloo with the exchange staged through host memory.
    The drain and each rank's ``was_unknown`` == a one-process 2-shard
    mesh on the same lanes."""
    import socket

    import numpy as np

    from ct_mapreduce_tpu_torch.tools import global_mesh

    d = os.path.join(HERE, "build", "smoke_p15", "global")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmds = [["-m", "ct_mapreduce_tpu_torch.tools.global_mesh", "--rank",
             str(r), "--world", "2", "--addr", f"127.0.0.1:{port}",
             "--lanes", str(GLOBAL_LANES), "--seed", str(seed), "--out",
             os.path.join(d, "two")] for r in range(2)]
    t0 = time.perf_counter()
    texts = _children(cmds)
    wall = time.perf_counter() - t0
    recs = [json.loads(t.strip().splitlines()[-1]) for t in texts]
    reset_counts()
    one = global_mesh.run(0, 1, "", 2, GLOBAL_LANES, seed, device,
                          os.path.join(d, "one"))
    launches = read_counts()
    want = np.load(os.path.join(d, "one", "rank0.npz"))
    for r in range(2):
        got = np.load(os.path.join(d, "two", f"rank{r}.npz"))
        lo = int(got["lo"])
        check(np.array_equal(got["keys"], want["keys"])
              and np.array_equal(got["meta"], want["meta"])
              and np.array_equal(got["was_unknown"],
                                 want["was_unknown"][lo:lo + GLOBAL_LANES]),
              f"15 (f): rank {r}'s drain or verdicts differ from the "
              "one-process mesh's")
    check(recs[0]["total"] == one["total"] > 0, "15 (f): totals differ")
    out = {"exchange": recs[0]["exchange"], "devices": recs[0]["devices"],
           "lanes": recs[0]["lanes"], "total": one["total"],
           "step_s": [r["step_s"] for r in recs], "one_step_s": one["step_s"],
           "wall_s": wall, "launches": launches}
    print(f"phase 15 (f) global-mesh: 2 processes x {GLOBAL_LANES} lanes on "
          f"{out['devices']}, exchange by {out['exchange']}; drain and "
          f"verdicts == the one-process 2-shard mesh's ({one['total']} keys); "
          f"steps {out['step_s'][0]:.2f}, {out['step_s'][1]:.2f} s (one "
          f"process {one['step_s']:.2f} s)", flush=True)
    return out


def kernels_line(k1: dict, k3: dict, probe: dict, walker: dict,
                 preparsed: dict, sinks: dict, fetch: dict,
                 extra_paths: dict, k5: dict, k6: dict) -> dict:
    """The ``{"kernels": [...]}`` record: every kernel of the port with
    its launches on each main path and this run's measurements."""
    from ct_mapreduce_tpu_torch.tools import mosaic_probe as mp

    paths = {"walker": walker["launches"], "preparsed": preparsed["launches"],
             "probe": probe["ladder_launches"]}
    paths.update(extra_paths)
    paths.update({f"sink_{name}": sinks[name]["launches"]
                  for name in SINK_CONFIGS})
    paths.update({f"fetch_{name}": fetch[name]["launches"]
                  for name in FETCH_RUNS})
    paths.update({f"fetch_{r['label']}": r["launches"]
                  for r in fetch["d"]["runs"] + [fetch["d"]["one"]]})

    def by_path(key, i=None):
        return {p: (c[key] if i is None else c[key][i]) for p, c in paths.items()}

    rows = [{
        "name": "sha256_fp", "route": "cuda",
        "source": "ct_mapreduce_tpu_torch/csrc/sha256_fp.cu",
        "replaces": "ct_mapreduce_tpu/ops/pallas_sha256.py:68",
        "launches": paths["walker"]["sha256_fp"],
        "launches_by_path": by_path("sha256_fp"),
        "max_abs_err": k1["max_abs_err"], "ms": k1["kernel_ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
    }, {
        "name": "der_walk", "route": "cuda",
        "source": "ct_mapreduce_tpu_torch/csrc/der_walk.cu",
        "replaces": "ct_mapreduce_tpu/ops/der_kernel.py:650",
        "launches": paths["walker"]["der_walk"],
        "launches_by_path": by_path("der_walk"),
        "max_abs_err": k3["max_abs_err"], "ms": k3["kernel_ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": None,
    }, {
        # The fused form (the one the grouped build launches); the
        # one-layer form's and filter-scale's dispatch's ride beside it.
        "name": "bloom_scatter", "route": "cuda",
        "source": "ct_mapreduce_tpu_torch/csrc/bloom_scatter.cu",
        "replaces": "ct_mapreduce_tpu/filter/fused.py:122",
        "launches": paths["filter_main"]["bloom_scatter"],
        "launches_by_path": by_path("bloom_scatter"),
        "max_abs_err": max(f["max_abs_err"] for f in k5.values()),
        "ms": k5["fused"]["kernel_ms"], "plain_ms": k5["fused"]["plain_ms"],
        "bound_ms": k5["fused"]["bound_ms"],
        "bound_by": k5["fused"]["bound_by"], "library_ms": None,
        "scratch_bytes": k5["fused"]["scratch_bytes"],
        "phase_ms": k5["fused"]["phase_ms"],
        **{form: {key: k5[form][key] for key in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "scratch_bytes", "phase_ms")} for form in ("layer", "scale_dispatch")},
    }, {
        # P-256 at window 8 on 2^16 lanes; the other configurations and
        # the lane's width (1,024) ride beside it.
        "name": "ecdsa_verify", "route": "cuda",
        "source": "ct_mapreduce_tpu_torch/csrc/ecdsa_verify.cu",
        "replaces": "ct_mapreduce_tpu/ops/ecdsa.py:549",
        "launches": paths["verify_sink"]["ecdsa_verify"],
        "launches_by_path": by_path("ecdsa_verify"),
        "max_abs_err": max(c["max_abs_err"] for c in k6.values()),
        "ms": k6[f"p256_w8_{K6_WIDTHS[-1]}"]["kernel_ms"],
        "plain_ms": k6[f"p256_w8_{K6_WIDTHS[-1]}"]["plain_ms"],
        "bound_ms": k6[f"p256_w8_{K6_WIDTHS[-1]}"]["bound_ms"],
        "bound_by": k6[f"p256_w8_{K6_WIDTHS[-1]}"]["bound_by"],
        "library_ms": None,
        "configurations": {name: {key: c.get(key) for key in (
            "lanes", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "products", "executed_products", "max_abs_err")}
            for name, c in k6.items()},
    }]
    for i, st in enumerate(probe["stages"]):
        rows.append({
            "name": f"probe_{st['name']}", "route": "cuda",
            "source": "ct_mapreduce_tpu_torch/csrc/mosaic_probe.cu",
            "replaces": f"tools/mosaic_probe.py:{PROBE_REPLACES[i]}",
            "launches": paths["probe"]["probe"][i],
            "launches_by_path": by_path("probe", i),
            "max_abs_err": st["max_abs_err"], "ms": st["kernel_ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": st["library_ms"],
        })
    check(len(rows) == 4 + len(mp.STAGES), "a kernel is missing from the line")
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20261017,
                    help="seed of every input the run makes")
    ap.add_argument("--profile", default="",
                    help="also profile one batch of each lane and 8 chunks "
                         "of each sink configuration with torch.profiler; "
                         "the traces go to this directory")
    ap.add_argument("--sass", default="",
                    help="also report each kernel library's registers "
                         "(-Xptxas -v) and SASS opcode counts (cuobjdump); "
                         "the outputs go to this directory")
    ap.add_argument("--out", default="",
                    help="also write the run's full details as JSON here")
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
    # Phase 10's log server makes its log while the earlier phases run.
    logs = LogProcess(args.seed)
    try:
        return run_phases(args, device, logs, t_start)
    finally:
        logs.stop()


def run_phases(args, device, logs: LogProcess, t_start: float) -> int:
    import torch

    card = card_line()
    print(card, flush=True)
    phase_s, t_lap = {}, [t_start]

    def lap(name: str) -> None:
        """Seconds of the phase that just ended, into ``phase_s``."""
        now = time.perf_counter()
        phase_s[name] = now - t_lap[0]
        t_lap[0] = now

    builds = build_all()
    print("phase 1: built " + ", ".join(
        f"{k[:-8]} in {v:.1f} s" for k, v in builds.items()), flush=True)

    sass = sass_report(args.sass) if args.sass else None
    lap("1")
    k1 = kernel_check(device, 1 << BATCH_LOG2, args.seed, TIMED_REPS)
    lap("2")
    k3 = walker_check(device, args.seed)
    torch.cuda.empty_cache()
    lap("3")
    probe = probe_check(device, args.seed)
    torch.cuda.empty_cache()
    lap("4")
    lanes = {}
    for preparsed in (False, True):  # the same batches through each lane
        out = main_path(device, Stream(args.seed, cn_filter=True),
                        MAIN_BATCHES, BATCH_LOG2, TABLE_BITS, 0.5, preparsed,
                        drain_after=OPEN_BATCHES, keep_wu=not preparsed)
        lanes[out["lane"]] = out
        torch.cuda.empty_cache()
    walker_wu = lanes["walker"].pop("_wu")  # phase 15 (a) is held to it
    check(lanes["walker"].pop("snapshot") == lanes["preparsed"].pop("snapshot"),
          "the walker lane's drain differs from the pre-parsed lane's")
    bucket_at = lanes["walker"].pop("drain_at")
    check(lanes["preparsed"].pop("drain_at") == bucket_at,
          f"the lanes drain differently after {OPEN_BATCHES} batches")
    print("phase 6: the walker and pre-parsed lanes drain the same", flush=True)
    lap("5-6")
    opened = open_layout(device, args.seed, bucket_at)
    open_model = opened["lanes"]["walker-open"].pop("_model")
    open_truth = opened["lanes"]["walker-open"].pop("_truth")
    torch.cuda.empty_cache()
    lap("5b")
    big = deployment_state(device, Stream(args.seed), BIG_TABLE_BITS,
                           BATCH_LOG2, 0.5, args.seed)
    torch.cuda.empty_cache()
    lap("7")
    sinks, drains = {}, {}
    for name in SINK_CONFIGS:
        out, model, drains[name] = sink_run(device, name, SINK_CHUNKS,
                                            args.seed)
        sinks[name] = out
        truth = out.pop("_truth")
        if name == "staged":
            staged_model, staged_truth = model, truth
        else:
            del model
        torch.cuda.empty_cache()
    check(drains["unstaged"] == drains["staged"] == drains["preparsed"],
          "the three sink configurations drain differently")
    # One sink chunk: the whole pages that reach the flush size.
    sinks["h2d_chunk"] = h2d_costs(
        device, -(-SINK_BATCH // SINK_PAGE) * SINK_PAGE, Stream.PAD)
    print("phase 8: the three sink configurations drain the same; one "
          "chunk's rows to the card: " + ", ".join(
              f"{k} {v:.3f}" for k, v in sinks["h2d_chunk"].items()
              if k != "bytes"), flush=True)
    lap("8")
    ckpts = checkpoints(device, staged_model, drains["staged"], args.seed)
    restored = ckpts.pop("_restored")
    p9_path = ckpts.pop("_p9_path")
    del staged_model
    torch.cuda.empty_cache()
    lap("9")
    fetch = fetch_phase(device, logs, args.seed)
    fetch_truth = fetch.pop("_oracle")
    torch.cuda.empty_cache()
    lap("10")
    serve = serve_phase(device, restored, staged_truth, open_model,
                        open_truth, logs.wait_ready()[2], fetch_truth,
                        args.seed)
    del restored, open_model
    torch.cuda.empty_cache()
    lap("11")
    filt = filter_phase(device, args.seed,
                        lanes["walker"]["ingest_s_per_batch"],
                        logs.wait_ready()[2], fetch_truth)
    lap("12")
    torch.cuda.empty_cache()
    verify = verify_phase(device, args.seed)
    lap("13")
    torch.cuda.empty_cache()
    dist = distrib_fetch(device, logs.wait_ready()[3], logs, *fetch_truth,
                         args.seed)
    lap("14a")
    print(f"phase 14 (a): {phase_s['14a']:.1f} s on {card}", flush=True)
    torch.cuda.empty_cache()
    audit = audit_shard(device, args.seed)
    lap("14b")
    print(f"phase 14 (b): {phase_s['14b']:.1f} s on {card}", flush=True)
    torch.cuda.empty_cache()
    p15 = {"walker": sharded_walker(device, args.seed, walker_wu,
                                    bucket_at)}
    mesh_model = p15["walker"].pop("_model")
    mesh_stream, mesh_truth = p15["walker"].pop("_truth")
    p15["walker"].pop("snapshot")
    # (a)'s drain after OPEN_BATCHES batches was held equal to bucket_at.
    p15["preparsed"] = sharded_preparsed(device, args.seed, bucket_at)
    torch.cuda.empty_cache()
    p15["ckpt"] = sharded_ckpt(device, mesh_model, p9_path, drains["staged"])
    p15["serve"] = sharded_serve(device, mesh_model.aggregator, mesh_stream,
                                 mesh_truth, args.seed)
    del mesh_model
    torch.cuda.empty_cache()
    p15["fleet"] = fleet_fetch(device, logs, args.seed)
    logs.stop()
    torch.cuda.empty_cache()
    p15["global"] = global_mesh_phase(device, args.seed)
    lap("15")
    print(f"phase 15: {phase_s['15']:.1f} s on {card}", flush=True)
    prof = None
    if args.profile:
        torch.cuda.empty_cache()
        prof = [profile_step(device, Stream(args.seed, cn_filter=True),
                             BATCH_LOG2, TABLE_BITS, pre, args.profile)
                for pre in (False, True)]
        for name in SINK_CONFIGS:
            torch.cuda.empty_cache()
            prof.append(profile_sink(device, name, args.seed, args.profile))
    details = {"card": card, "builds": builds, "fingerprint": k1,
               "walker_kernel": k3, "probe": probe, "lanes": lanes,
               "open_layout": opened, "big_table": big, "sinks": sinks,
               "checkpoints": ckpts, "fetch": fetch, "serve": serve,
               "filter": filt, "verify": verify, "distrib": dist,
               "audit": audit, "phase15": p15, "profile": prof, "sass": sass,
               "phase_s": phase_s,
               "wall_s": time.perf_counter() - t_start}
    print("phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_s.items())
        + f"; the script {details['wall_s']:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(details, f, indent=1)
    print(json.dumps(details), flush=True)
    extra_paths = {"walker_open": opened["lanes"]["walker-open"]["launches"],
                   "preparsed_open":
                       opened["lanes"]["preparsed-open"]["launches"],
                   "serve_fetch": serve["fetch"]["launches"],
                   "filter_main": filt["main"]["launches"]["fl02"],
                   "filter_main_fl01": filt["main"]["launches"]["fl01"],
                   "filter_fetch": filt["fetch"]["launches"],
                   "filter_scale": filt["scale"]["launches"],
                   "verify_sink": verify["sink"]["lane"]["launches"],
                   "verify_sink_off": verify["sink"]["no_lane"]["launches"],
                   "verify_sink_p256": verify["sink"]["p256_lane"]["launches"],
                   "verify_sink_p256_off":
                       verify["sink"]["p256_no_lane"]["launches"],
                   "verify_fetch": verify["fetch"]["launches"],
                   "distrib_fetch": dist["launches"],
                   "audit_shard": audit["launches"],
                   "audit_classify": audit["classify_launches"],
                   "sharded_walker": p15["walker"]["launches"],
                   "sharded_preparsed": p15["preparsed"]["launches"],
                   "fleet_serial_partition":
                       p15["fleet"]["partition"]["serial_launches"],
                   "fleet_serial_stripes":
                       p15["fleet"]["stripes"]["serial_launches"],
                   "fleet_filter_check_partition":
                       p15["fleet"]["partition"]["check_launches"],
                   "fleet_filter_check_stripes":
                       p15["fleet"]["stripes"]["check_launches"],
                   "global_mesh_one": p15["global"]["launches"]}
    print(json.dumps(kernels_line(k1, k3, probe, lanes["walker"],
                                  lanes["preparsed"], sinks, fetch,
                                  extra_paths, filt["k5"], verify["k6"])),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
