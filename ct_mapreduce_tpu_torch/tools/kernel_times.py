"""The yardstick of the port's short kernels, K5's timed shapes, and K5
and the probe stages timed by them in any revision of the port.

:func:`cuda_ms` times launches with CUDA events queued behind a spin of
the card, so that a short kernel's time is the card's and not its
wrapper's host time between launches. :func:`k5_shapes` makes the
inputs at which ``chip_smoke.py`` phase 12 (0) times the Bloom
bit-scatter K5: one layer of 2^20 keys at a 1% false-positive rate; a
fused round of 2^20 keys over 1,024 groups of Zipf(1.1) sizes, laid out
group by group; and the first 2^20-lane dispatch of filter-scale's
streamed build (2^24 keys in 1,024 groups, the whole round's arena, the
dispatch's lanes over the groups it reaches).

Run as a script, it holds K5 at those shapes, probe stage 9 at 2^20
certificate rows and probe stages 1, 2, 3, 4, 7 and 8 at 2^20 random
rows to their plain versions, bit for bit, then times them with
:func:`cuda_ms`, for the package under ``--tree`` (default: the checkout
this file is in), stage 2's two floors (:func:`dyn_floors`) and the
floors of stages 1 and 7 (:func:`word_floors`).
An older revision of the port unpacked into a directory (it needs
``ops/bloom_cuda.scatter`` and the probe ladder's
``tools/mosaic_probe.py``, as since K5 was first ported) is so timed by
this file's yardstick at this file's shapes::

    python3 ct_mapreduce_tpu_torch/tools/kernel_times.py [--tree DIR] [--out FILE]

Nothing of the package is imported at import time, so that ``--tree``
decides where the kernels come from. Prints one line a kernel, the
card's name and power limit, then a JSON line; exit code 0 iff every
kernel matched its plain version.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: Clock cycles the card spins before a timing's first event (~2 ms),
#: while the host queues the timing's launches.
QUEUE_CYCLES = 4_000_000

LANES = 1 << 20  # K5's timed lanes, in each shape
GROUPS = 1024  # groups of the fused shape
FP_RATE = 0.01  # the filter build's default target
SCALE_KEYS = 1 << 24  # filter-scale's corpus, whose first dispatch is timed
REPS, CALLS = 25, 20  # CUDA-event timings a turn, launches a timing
DYN_WRAP = 252  # probe offsets wrap modulo the row's 256 bytes less 4


def cuda_ms(fn, reps: int = REPS, calls: int = CALLS,
            warmup: int = 3) -> list[float]:
    """``reps`` CUDA-event timings of ``fn()`` in milliseconds, each the
    mean of ``calls`` back-to-back calls between one pair of events,
    queued behind a spin of QUEUE_CYCLES, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


def _zipf_sizes(rng, total: int, groups: int) -> np.ndarray:
    from ct_mapreduce_tpu_torch.utils import syncerts

    return rng.multinomial(total - groups,
                           syncerts.zipf_weights(groups, 1.1)) + 1


def k5_shapes(device, seed: int) -> dict:
    """name -> dict(keys, gid, offs, ms, ks, total_bits, kmax, groups,
    groups_reached, probes): the tensors on ``device`` (int32 keys and
    gid, int64 offsets, int32 m and k) and the host facts of each
    shape."""
    from ct_mapreduce_tpu_torch.filter.cascade import keys_tensor, layer_params

    rng = np.random.default_rng(seed + 12)
    n = LANES
    raw = rng.integers(0, 2**32, (n, 4), np.uint32)
    m, k = layer_params(n, FP_RATE)
    sizes = _zipf_sizes(rng, n, GROUPS)
    params = np.array([layer_params(int(c), FP_RATE) for c in sizes])
    forms = {
        "layer": (np.zeros((n,), np.int32), np.array([0]), np.array([m]),
                  np.array([k])),
        "fused": (np.repeat(np.arange(GROUPS), sizes).astype(np.int32),
                  np.concatenate(([0], np.cumsum(params[:, 0])[:-1])),
                  params[:, 0], params[:, 1]),
    }
    # filter-scale's corpus sizes (chip_smoke._scale_sources), the round's
    # arena over all of them, and the first dispatch of LANES lanes.
    srng = np.random.default_rng(seed + 1200)
    ssizes = _zipf_sizes(srng, SCALE_KEYS, GROUPS)
    srng.shuffle(ssizes)
    sparams = np.array([layer_params(int(c), FP_RATE) for c in ssizes])
    take = np.minimum(ssizes, np.maximum(
        0, n - np.concatenate(([0], np.cumsum(ssizes)[:-1]))))
    forms["scale_dispatch"] = (
        np.repeat(np.arange(GROUPS), take).astype(np.int32),
        np.concatenate(([0], np.cumsum(sparams[:, 0])[:-1])),
        sparams[:, 0], sparams[:, 1])
    out = {}
    keys = keys_tensor(raw, device)
    for name, (gid, offs, ms, ks) in forms.items():
        out[name] = {
            "keys": keys, "gid": torch.from_numpy(gid).to(device),
            "offs": torch.from_numpy(offs.astype(np.int64)).to(device),
            "ms": torch.from_numpy(ms.astype(np.int32)).to(device),
            "ks": torch.from_numpy(ks.astype(np.int32)).to(device),
            "total_bits": int(offs[-1] + ms[-1]), "kmax": int(ks.max()),
            "groups": int(len(ms)), "groups_reached": int(len(np.unique(gid))),
            "probes": int(ks[gid].sum())}
    return out


def args_of(shape: dict) -> tuple:
    """(keys, gid, offs, ms, ks) of a shape."""
    return tuple(shape[x] for x in ("keys", "gid", "offs", "ms", "ks"))


def dyn_word_index(words: np.ndarray) -> np.ndarray:
    """int64[1, n]: the word probe stage 2's second read takes in each
    lane of uint32[64, n] words, ((byte 0) % 252) // 4."""
    return ((words[0] >> 24).astype(np.int64) % DYN_WRAP >> 2)[None, :]


def no_scatter_words(words: np.ndarray, seed: int) -> np.ndarray:
    """``words`` with each lane's byte 0 drawn from 0-3 and 252-255, so
    that probe stage 2's second read falls in word 0, the word its first
    read holds."""
    rng = np.random.default_rng(seed)
    top = rng.choice(np.array([0, 1, 2, 3, 252, 253, 254, 255], np.uint32),
                     words.shape[1])
    out = words.copy()
    out[0] = (out[0] & np.uint32(0x00FFFFFF)) | (top << np.uint32(24))
    return out


def dyn_floors(mp, words: np.ndarray, w: torch.Tensor, seed: int) -> dict:
    """Probe stage 2's two floors at ``words`` (uint32[64, n], ``w`` the
    same on the card), each held to what it stands in for, then timed
    with :func:`cuda_ms`: (a) ``torch.gather`` of the words its scattered
    read takes, a yardstick of the card's own library that reads the
    same scattered words plus 8 B of index a lane; (b) the stage's kernel
    on rows whose second read falls in word 0, its time without any
    scattered read."""
    idx = torch.from_numpy(dyn_word_index(words)).to(w.device)
    lanes = torch.arange(w.shape[1], device=w.device)
    same = torch.equal(torch.gather(w, 0, idx)[0], w[idx[0], lanes])
    gather = cuda_ms(lambda: torch.gather(w, 0, idx))
    ns = mp.to_tensor(no_scatter_words(words, seed), w.device)
    same &= torch.equal(mp.kernel_stage(2, ns), mp.plain_stage(2, ns))
    no_scatter = cuda_ms(lambda: mp.kernel_stage(2, ns))
    return {"scatter_floor_ms": float(np.median(gather)),
            "no_scatter_ms": float(np.median(no_scatter)),
            "equal": bool(same)}


def onehot_library(w: torch.Tensor) -> torch.Tensor:
    """Probe stage 1 as one PyTorch call over int32[WORDS, n] words
    (uint32 bits): byte 17 of a row is bits 16-23 of its big-endian word
    4, byte 2 of that int32 in the little-endian memory of the card and
    of the host. int32[1, n]."""
    return w[4].view(torch.uint8)[2::4].to(torch.int32)[None, :]


def word_floors(mp, w: torch.Tensor) -> dict:
    """Floors of probe stages 1 and 7, which read one coalesced word and
    store 4 B a lane, at ``w`` (int32[WORDS, n] on the card), each timed
    with :func:`cuda_ms`: (a) an empty launch at one lane a thread in
    blocks of mp.LANES (the stages' first grid), at the stages' grid
    (``mp.word_grid``) and of one block, where the tree has
    ``mp.empty_launch``; (b) stage
    1's library call (:func:`onehot_library`), held equal to the stage's
    kernel; (c) torch's copy of word 4 into 4 B a lane,
    ``out.copy_(w[4])``, a yardstick for both stages."""
    n = int(w.shape[1])
    out = torch.empty((n,), dtype=torch.int32, device=w.device)
    doc = {"onehot_library_equal": torch.equal(onehot_library(w),
                                               mp.kernel_stage(1, w)),
           "onehot_library_ms": float(np.median(cuda_ms(
               lambda: onehot_library(w)))),
           "copy_ms": float(np.median(cuda_ms(lambda: out.copy_(w[4]))))}
    if hasattr(mp, "empty_launch"):
        for key, grid in (("lane_grid", (-(-n // mp.LANES), mp.LANES)),
                          ("stage_grid", mp.word_grid(n)),
                          ("one_block", (1, mp.LANES))):
            doc[f"empty_{key}"] = list(grid)
            doc[f"empty_{key}_ms"] = float(np.median(cuda_ms(
                lambda: mp.empty_launch(*grid, w.device))))
    return doc


def _summary(times: list[float]) -> dict:
    return {"ms": float(np.median(times)), "ms_min": min(times),
            "ms_max": max(times)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose package is timed")
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the kernels run only on the card",
              file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import ct_mapreduce_tpu_torch as pkg

    if not os.path.abspath(pkg.__file__).startswith(tree + os.sep):
        print(f"the package came from {pkg.__file__}, not from {tree}: run "
              "this file by its path", file=sys.stderr)
        return 2
    from ct_mapreduce_tpu_torch.ops import bloom, bloom_cuda
    from ct_mapreduce_tpu_torch.tools import mosaic_probe as mp

    dev = torch.device("cuda")
    bloom_cuda.LIB.get()
    mp.LIB.get()
    layer, ok = 7, True
    # K5's first design (one atomic a probe) took no kmax.
    takes_kmax = "kmax" in inspect.signature(bloom_cuda.scatter).parameters
    doc = {"tree": tree, "k5": {}}
    for name, shape in k5_shapes(dev, args.seed).items():
        t = args_of(shape)
        kw = {"kmax": shape["kmax"]} if takes_kmax else {}
        want = torch.zeros((shape["total_bits"] // 32,), dtype=torch.int32,
                           device=dev)
        got = torch.zeros_like(want)
        bloom.bloom_scatter_plain(want, *t, layer)
        bloom_cuda.scatter(got, *t, layer, **kw)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        ok &= same
        doc["k5"][name] = dict(
            _summary(cuda_ms(lambda: bloom_cuda.scatter(got, *t, layer, **kw))),
            equal=same)
        print(f"K5 {name}: {'==' if same else '!='} plain, "
              f"{doc['k5'][name]['ms']:.4f} ms", flush=True)
        del got, want
    torch.cuda.empty_cache()
    words, _ = mp.stage_inputs(mp.SERIAL_STAGE, mp.TIMED_TILES * mp.LANES)
    w = mp.to_tensor(words, dev)
    same = torch.equal(mp.kernel_stage(mp.SERIAL_STAGE, w),
                       mp.plain_stage(mp.SERIAL_STAGE, w))
    ok &= same
    doc["stage9"] = dict(_summary(cuda_ms(
        lambda: mp.kernel_stage(mp.SERIAL_STAGE, w))), equal=same,
        lanes=int(w.shape[1]))
    print(f"stage 9: {'==' if same else '!='} plain, "
          f"{doc['stage9']['ms']:.4f} ms", flush=True)
    del w
    words = mp.random_words(args.seed, mp.TIMED_TILES * mp.LANES)
    w = mp.to_tensor(words, dev)
    for stage in (1, 2, 3, 4, 7, 8):
        same = torch.equal(mp.kernel_stage(stage, w),
                           mp.plain_stage(stage, w))
        ok &= same
        doc[f"stage{stage}"] = dict(_summary(cuda_ms(
            lambda: mp.kernel_stage(stage, w))), equal=same,
            lanes=int(w.shape[1]))
        print(f"stage {stage}: {'==' if same else '!='} plain, "
              f"{doc[f'stage{stage}']['ms']:.4f} ms", flush=True)
    doc["stage2_floors"] = floors = dyn_floors(mp, words, w, args.seed)
    ok &= floors["equal"]
    print(f"stage 2 floors: torch.gather {floors['scatter_floor_ms']:.4f} ms,"
          f" no scattered read {floors['no_scatter_ms']:.4f} ms", flush=True)
    doc["word_floors"] = floors = word_floors(mp, w)
    ok &= floors["onehot_library_equal"]
    print("stages 1 and 7 floors: " + ", ".join(
        f"{k} {v:.5f} ms" for k, v in floors.items() if k.endswith("_ms")),
        flush=True)
    doc["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    doc["ok"] = bool(ok)
    print(doc["card"], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps(doc), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
