"""The port's multi-process scale-out, on the CPU, in real processes.

1. **A global mesh:** two processes join one gloo process group
   (``parallel.distributed.initialize_multihost`` with explicit
   arguments), bring one ``cpu`` shard each to a 2-shard mesh and take
   one ``ShardedDedup`` step through ``tools/global_mesh.py``; the drain
   and each rank's ``was_unknown`` equal a one-process 2-shard mesh on
   the same lanes (exact equality).
2. **An ingest fleet:** two ``ct-fetch-torch`` worker processes
   (``numWorkers`` 2, ``coordinatorBackend = redis`` against a
   ``MiniRedis`` on 127.0.0.1, ``checkpointPeriod``, ``emitFilter``) over
   logs served from this process on 127.0.0.1: over three logs (the
   rendezvous partition) their merged state equals a serial run's
   ``storage-statistics`` report, and the fleet filter the leader leaves
   at the end of its run equals the merged build of both workers' final
   checkpoints, in both packages, and the serial run's bytes; over one
   log (stripes), a worker killed at its first
   checkpoint and started again resumes, and the merged state again
   equals the serial run's.

Every child ends within ``TIMEOUT`` seconds (``communicate(timeout=)``;
on expiry all children are killed and the test fails).
"""

import datetime
import io
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest

from ct_mapreduce_tpu.agg import merge as jmerge
from ct_mapreduce_tpu.filter import build_from_merged as jfrom_merged
from ct_mapreduce_tpu_torch.cmd import ct_fetch, storage_statistics
from ct_mapreduce_tpu_torch.config import CTConfig
from ct_mapreduce_tpu_torch.tools import global_mesh
from ct_mapreduce_tpu_torch.utils import minicert
from ct_mapreduce_tpu_torch.utils.fakelog import FakeLog, LogServer
from ct_mapreduce_tpu_torch.utils.miniredis import MiniRedis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60
FUTURE = datetime.datetime(2031, 6, 15, tzinfo=datetime.timezone.utc)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("MASTER_ADDR", "WORLD_SIZE", "CTMR_CKPT_KILL",
              "CTMR_NUM_WORKERS", "CTMR_WORKER_ID", "CTMR_COORDINATOR",
              "CTMR_CHECKPOINT_PERIOD"):
        env.pop(k, None)
    env.update(extra)
    return env


def _spawn(args, env) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(procs) -> list[str]:
    """Each child's output; kills them all and fails past TIMEOUT."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"a child outlived {TIMEOUT} s")
    return outs


def test_two_process_gloo_global_mesh(tmp_path):
    port = _free_port()
    procs = [_spawn(["-m", "ct_mapreduce_tpu_torch.tools.global_mesh",
                     "--rank", str(r), "--world", "2",
                     "--addr", f"127.0.0.1:{port}", "--lanes", "256",
                     "--seed", "7", "--device", "cpu",
                     "--out", str(tmp_path / "two")], _env())
             for r in range(2)]
    one = global_mesh.run(0, 1, "", 2, 256, 7, "cpu", str(tmp_path / "one"))
    outs = _finish(procs)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
        assert '"exchange": "gloo through host memory"' in out
    want = np.load(tmp_path / "one" / "rank0.npz")
    assert one["total"] == len(want["keys"]) > 0
    for r in range(2):
        got = np.load(tmp_path / "two" / f"rank{r}.npz")
        np.testing.assert_array_equal(got["keys"], want["keys"])
        np.testing.assert_array_equal(got["meta"], want["meta"])
        lo = int(got["lo"])
        np.testing.assert_array_equal(
            got["was_unknown"], want["was_unknown"][lo:lo + 256])


def _logs(n_logs: int, per: int, dupes: int) -> list[FakeLog]:
    cas = [minicert.make_cert(serial=1, issuer_cn=f"Fleet CA {k}",
                              is_ca=True, not_after=FUTURE)
           for k in range(2)]
    logs = []
    for i in range(n_logs):
        log = FakeLog(url=f"https://ct.fleet.example/log{i}")
        log.max_batch = 16
        for s in range(per):
            u = s % (per - dupes)
            k = u % 2
            leaf = minicert.make_cert(
                serial=10_000 * (i + 1) + u, issuer_cn=f"Fleet CA {k}",
                subject_cn=f"w{i}-{u}.example", not_after=FUTURE,
                crl_dps=(f"http://crl{k}.fleet.example/x.crl",))
            log.add_cert(leaf, cas[k], timestamp_ms=1700000000000 + s)
        logs.append(log)
    return logs


def _write_ini(path, urls, state, extra="") -> str:
    path.write_text(
        "backend = tpu\nbatchSize = 32\ntableBits = 10\nhealthAddr = \n"
        f"nobars = true\nlogList = {','.join(urls)}\n"
        f"aggStatePath = {state}\nemitFilter = true\n" + extra)
    return str(path)


def _report(spec: str):
    cfg = CTConfig.load(argv=[], env={})
    cfg.backend, cfg.agg_state_path = "tpu", spec
    text = io.StringIO()
    assert storage_statistics.report_from_tpu_snapshot(cfg, text, 1) == 0
    return storage_statistics.collect_tpu_report(cfg), text.getvalue()


def _worker(ini: str, env) -> subprocess.Popen:
    return _spawn(["-m", "ct_mapreduce_tpu_torch.cmd.ct_fetch", "-config",
                   ini, "-device", "cpu"], env)


def _fleet_ini(tmp_path, w, urls, redis) -> str:
    return _write_ini(
        tmp_path / f"w{w}.ini", urls, tmp_path / "fleet" / "agg.npz",
        f"numWorkers = 2\nworkerId = {w}\ncoordinatorBackend = redis\n"
        f"redisHost = {redis.address}\ncheckpointPeriod = 300ms\n")


def _serial(tmp_path, urls):
    (tmp_path / "serial").mkdir()
    ini = _write_ini(tmp_path / "serial.ini", urls,
                     tmp_path / "serial" / "agg.npz")
    assert ct_fetch.main(["-config", ini], device="cpu") == 0
    return str(tmp_path / "serial" / "agg.npz")


def _filter_bytes(paths) -> bytes:
    from ct_mapreduce_tpu_torch.agg.merge import load_checkpoints
    from ct_mapreduce_tpu_torch.filter.artifact import build_from_merged

    return build_from_merged(load_checkpoints(paths),
                             device="cpu").to_bytes()


def test_fleet_two_workers_match_a_serial_run(tmp_path):
    logs = _logs(3, 40, 8)
    servers = [LogServer(log).start() for log in logs]
    redis = MiniRedis().start()
    try:
        urls = [s.url for s in servers]
        (tmp_path / "fleet").mkdir()
        procs = [_worker(_fleet_ini(tmp_path, w, urls, redis), _env())
                 for w in range(2)]
        outs = _finish(procs)
        serial = _serial(tmp_path, urls)
    finally:
        redis.stop()
        for s in servers:
            s.stop()
    for w, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {w}:\n{out[-3000:]}"
        assert f"fleet worker {w}/2" in out
    paths = [str(tmp_path / "fleet" / f"agg.w{w}.npz") for w in range(2)]
    assert all(os.path.exists(p) for p in paths)
    merged, merged_text = _report(",".join(paths))
    want, want_text = _report(serial)
    assert merged == want and merged_text == want_text
    assert want["totals"]["serials"] == 3 * 32
    # The leader's own artifact, folded after both final saves.
    assert not any("fleet filter emission failed" in o for o in outs)
    assert sum("fleet filter: 2 worker snapshot(s) folded" in o
               for o in outs) == 1
    leader = (tmp_path / "fleet" / "agg.npz.filter").read_bytes()
    assert leader == _filter_bytes(paths) == _filter_bytes([serial])
    assert leader == jfrom_merged(jmerge.load_checkpoints(paths)).to_bytes()


def test_fleet_stripes_kill_and_resume(tmp_path):
    log = _logs(1, 96, 0)[0]
    server = LogServer(log).start()
    redis = MiniRedis().start()
    try:
        urls = [server.url]
        (tmp_path / "fleet").mkdir()
        inis = [_fleet_ini(tmp_path, w, urls, redis) for w in range(2)]
        procs = [_worker(inis[0], _env(CTMR_CKPT_KILL="base-post-rename")),
                 _worker(inis[1], _env())]
        outs = _finish(procs)
        assert procs[0].returncode == -signal.SIGKILL, outs[0][-3000:]
        assert procs[1].returncode == 0, outs[1][-3000:]
        state0 = tmp_path / "fleet" / "agg.w0.npz"
        assert state0.exists()  # the base landed before the kill
        again = _worker(inis[0], _env())
        out = _finish([again])[0]
        assert again.returncode == 0, out[-3000:]
        assert "rejoined" in out
        serial = _serial(tmp_path, urls)
    finally:
        redis.stop()
        server.stop()
    merged, _ = _report(f"{tmp_path}/fleet/agg.w*.npz")
    want, _ = _report(serial)
    assert merged == want
    assert want["totals"]["serials"] == 96
