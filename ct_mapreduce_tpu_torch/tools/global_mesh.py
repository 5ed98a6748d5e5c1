"""One sharded dedup step over a mesh whose shards span processes.

    python -m ct_mapreduce_tpu_torch.tools.global_mesh --rank R --world W \\
        --addr 127.0.0.1:PORT --lanes N --out DIR [--device cpu]

Each of the ``W`` processes joins the process group
(``parallel.distributed.initialize_multihost``), brings ``--shards``
shards on its device to one global mesh, makes the same batch of
``W * shards * N`` leaf rows from ``--seed`` (four issuers, a quarter of
the lanes replaying an earlier serial), and takes one
``ShardedDedup.step`` on it, then a replay step, which must find every
key known. The exchange runs over NCCL when every rank has a card of its
own, else over gloo through host memory. Rank ``R`` writes
``DIR/rank{R}.npz``: the drain (every shard's keys and meta, gathered
from all ranks) and its own lanes' ``was_unknown``; and prints one JSON
line with the exchange route and the step's seconds. ``--world 1
--shards 2`` runs the same lanes on a one-process mesh, the yardstick a
global mesh is held to.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time

import numpy as np

#: "Now" of the step's expiry filter: every leaf expires after it.
NOW = datetime.datetime(2025, 1, 1, tzinfo=datetime.timezone.utc)
PAD = 1024  # row width of the leaves


def make_lanes(n: int, seed: int):
    """``n`` walker lanes from ``seed``: (data uint8[n, PAD], length,
    issuer index, valid), the same in every process."""
    from ct_mapreduce_tpu_torch.utils import syncerts

    rng = np.random.default_rng(seed)
    templates = [syncerts.make_template(issuer_cn=f"Global Mesh CA {i}",
                                        serial_len=10 + 2 * i)
                 for i in range(4)]
    tof = rng.integers(0, len(templates), n)
    counters = np.arange(1, n + 1, dtype=np.int64)
    replay = rng.random(n) < 0.25
    counters[replay] = rng.integers(1, n + 1, int(replay.sum()))
    data = np.zeros((n, PAD), np.uint8)
    length = np.zeros((n,), np.int32)
    for t, tpl in enumerate(templates):
        sel = np.flatnonzero(tof == t)
        if sel.size == 0:
            continue
        rows, ln = syncerts.stamp_batch_array(tpl, 0, sel.size, PAD)
        # Restamp each lane's serial with its counter (the template's
        # low serial bytes, big-endian), as stamp_batch_array does.
        off, slen = tpl.serial_off, tpl.serial_len
        for i in range(min(8, slen - 1)):
            rows[:, off + slen - 1 - i] = (counters[sel] >> (8 * i)) & 0xFF
        data[sel], length[sel] = rows, ln
    return data, length, tof.astype(np.int32), np.ones((n,), bool)


def run(rank: int, world: int, addr: str, shards: int, lanes: int,
        seed: int, device, out_dir: str) -> dict:
    import torch

    from ct_mapreduce_tpu_torch.agg.sharded import ShardedDedup, mesh_capacity
    from ct_mapreduce_tpu_torch.parallel import distributed, make_mesh

    if world > 1:
        distributed.initialize_multihost(addr, world, rank)
    dev = distributed.local_device(device)
    devices, ranks = distributed.global_mesh_devices([dev] * shards)
    n_shards = len(devices)
    mesh = make_mesh(f"shard:{n_shards}", devices, ranks)
    n = n_shards * lanes
    dedup = ShardedDedup(mesh, capacity=mesh_capacity(n_shards, 2 * n))
    data, length, issuer, valid = make_lanes(n, seed)
    now_hour = int(NOW.timestamp()) // 3600
    distributed.device_barrier("global-mesh start")
    t0 = time.perf_counter()
    out = dedup.step(data, length, issuer, valid, now_hour)
    wu = out.was_unknown.cpu().numpy()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    total = dedup.total_count()
    host = int(out.host_lane.sum())
    replay = dedup.step(data, length, issuer, valid, now_hour)
    if int(replay.was_unknown.sum()) or dedup.total_count() != total:
        raise RuntimeError("the replay step inserted a key")
    keys, meta = dedup.drain_np()
    lo = dedup.local[0] * lanes
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), keys=keys,
             meta=meta, was_unknown=wu, lo=np.int64(lo))
    rec = {"rank": rank, "world": world, "shards": n_shards,
           "lanes": n, "devices": [str(d) for d in devices],
           "exchange": dedup.exchange_route(), "total": total,
           "unknown_here": int(wu.sum()), "host_lane_here": host,
           "dispatch_spill_here": int(out.dispatch_dropped.sum()),
           "step_s": step_s}
    distributed.device_barrier("global-mesh end")
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--addr", default="127.0.0.1:29500",
                    help="host:port of rank 0's store")
    ap.add_argument("--shards", type=int, default=1,
                    help="shards each process brings to the mesh")
    ap.add_argument("--lanes", type=int, default=1 << 10,
                    help="lanes a shard")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="this process's device (default: its card)")
    ap.add_argument("--out", required=True, help="output directory")
    args = ap.parse_args(argv)
    rec = run(args.rank, args.world, args.addr, args.shards, args.lanes,
              args.seed, args.device, args.out)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
