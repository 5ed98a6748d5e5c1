"""The port's fleet units (``ct_mapreduce_tpu_torch/ingest/fleet.py``,
``cmd/ct_fetch.py::fleet_assignments``), on the CPU: the cases of
``tests/test_fleet.py`` on the port's modules — the deterministic
partitioner, the FleetCoordinator protocol over the mock cache and a
live miniredis-backed RedisCache, the process-group coordinator's
one-process fallback, the FleetService checkpoint cadence and the
per-worker aggregate merge — plus parity: partition maps, takeover
maps, stripes and per-worker paths equal the JAX package's for the
same inputs (exact equality).

The multi-process contracts (two workers against a serial run,
kill-and-resume, a global mesh) live in
``tests/test_torch_multiprocess.py``."""

import threading
import time

import pytest

from ct_mapreduce_tpu.ingest import fleet as jfleet
from ct_mapreduce_tpu_torch.ingest import fleet
from ct_mapreduce_tpu_torch.storage.mockcache import MockRemoteCache

URLS = [f"https://log{i}.example.com/2026" for i in range(12)]


# -- partitioner --------------------------------------------------------


@pytest.mark.parametrize("w", [1, 2, 3, 5, 8])
def test_partition_maps_and_stripes_match_jax(w):
    assert fleet.partition_map(URLS, w) == jfleet.partition_map(URLS, w)
    alive = list(range(1, w)) or [0]
    assert (fleet.partition_map(URLS, w, alive=alive)
            == jfleet.partition_map(URLS, w, alive=alive))
    for i in range(w):
        assert (fleet.partition_logs(URLS, i, w)
                == jfleet.partition_logs(URLS, i, w))
        for tree in (0, 1, 7, 1003, 131072):
            assert (fleet.partition_range(tree, i, w)
                    == jfleet.partition_range(tree, i, w))
        for path in ("/s/agg.npz", "/s/state", ""):
            assert (fleet.worker_state_path(path, i, w)
                    == jfleet.worker_state_path(path, i, w))
        assert (fleet.rendezvous_owner(URLS[i % len(URLS)], w)
                == jfleet.rendezvous_owner(URLS[i % len(URLS)], w))


def test_partition_disjoint_covering_deterministic():
    for w in (1, 2, 3, 5):
        owners = fleet.partition_map(URLS, w)
        assert owners == fleet.partition_map(URLS, w)  # pure function
        assert set(owners.values()) <= set(range(w))
        parts = [fleet.partition_logs(URLS, i, w) for i in range(w)]
        flat = [u for p in parts for u in p]
        assert sorted(flat) == sorted(URLS)  # covering
        assert len(flat) == len(set(flat))  # disjoint


def test_partition_takeover_moves_only_dead_owners_logs():
    owners = fleet.partition_map(URLS, 4)
    dead = 0
    alive = [w for w in range(4) if w != dead]
    reassigned = fleet.partition_map(URLS, 4, alive=alive)
    for url in URLS:
        if owners[url] == dead:
            assert reassigned[url] in alive  # re-homed to a live worker
        else:
            assert reassigned[url] == owners[url]  # never moved


def test_partition_range_stripes_cover_tree():
    for tree in (0, 1, 7, 1003):
        for w in (1, 2, 5):
            stripes = [fleet.partition_range(tree, i, w) for i in range(w)]
            assert stripes[0][0] == 0
            pos = 0
            for off, lim in stripes:
                assert off == pos  # contiguous, disjoint
                pos += lim
            assert pos == tree  # covering


def test_worker_state_path():
    assert fleet.worker_state_path("/s/agg.npz", 2, 4) == "/s/agg.w2.npz"
    assert fleet.worker_state_path("/s/agg.npz", 0, 1) == "/s/agg.npz"
    assert fleet.worker_state_path("", 2, 4) == ""
    assert fleet.worker_state_path("/s/state", 1, 2) == "/s/state.w1"


def test_resolve_fleet_env_layering(monkeypatch):
    for k in ("CTMR_NUM_WORKERS", "CTMR_WORKER_ID",
              "CTMR_CHECKPOINT_PERIOD", "CTMR_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    assert fleet.resolve_fleet() == (1, 0, "", "")
    # Explicit beats env.
    monkeypatch.setenv("CTMR_NUM_WORKERS", "8")
    monkeypatch.setenv("CTMR_WORKER_ID", "3")
    monkeypatch.setenv("CTMR_CHECKPOINT_PERIOD", "30s")
    monkeypatch.setenv("CTMR_COORDINATOR", "jax")
    assert fleet.resolve_fleet(4, 1, "10s", "redis") == (4, 1, "10s", "redis")
    # Explicit workerId = 0 is a real id (every fleet needs exactly one
    # worker 0), NOT the unset sentinel — it must beat the env too.
    assert fleet.resolve_fleet(4, 0, "10s", "redis")[1] == 0
    # Env fills the gaps.
    assert fleet.resolve_fleet() == (8, 3, "30s", "jax")
    # Unparseable env ints are ignored.
    monkeypatch.setenv("CTMR_NUM_WORKERS", "banana")
    assert fleet.resolve_fleet()[0] == 1


# -- coordinators -------------------------------------------------------


def _elect_pair(cache, **kw):
    c0 = fleet.CacheFleetCoordinator(cache, "t", 0, 2, **kw)
    c1 = fleet.CacheFleetCoordinator(cache, "t", 1, 2, **kw)
    results = {}

    def go(c, i):
        results[i] = c.start()
        c.barrier(timeout_s=10)

    ts = [threading.Thread(target=go, args=(c, i))
          for i, c in enumerate((c0, c1))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(15)
    assert not any(t.is_alive() for t in ts), "barrier did not release"
    assert sorted(results.values()) == [False, True], results
    return c0, c1, results


def test_cache_coordinator_election_barrier_epoch_shutdown():
    cache = MockRemoteCache()
    c0, c1, results = _elect_pair(cache)
    leader = c0 if results[0] else c1
    follower = c1 if results[0] else c0
    assert sorted(leader.alive_workers()) == [0, 1]
    leader.publish_epoch(1)
    leader.publish_epoch(2)  # last-writer-wins value slot
    assert follower.current_epoch() == 2
    assert follower.shutdown_requested() is None
    leader.request_shutdown("drain")
    assert follower.shutdown_requested() == "drain"
    c0.close()
    c1.close()


def test_stale_shutdown_broadcast_not_replayed():
    """A stop broadcast left in a PERSISTENT cache by a previous
    (signal-stopped) run must not self-terminate the next run: the
    key is TTL'd at publish and cleared when a coordinator starts."""
    from datetime import timedelta

    cache = MockRemoteCache()
    old = fleet.CacheFleetCoordinator(cache, "t", 0, 1)
    assert old.start() is True
    old.request_shutdown("leader signal 15")
    assert old.shutdown_requested() == "leader signal 15"
    old.close()
    # The broadcast key carries a TTL (a persistent Redis must not
    # keep it forever even if no successor run ever starts).
    assert cache._expirations.get(fleet.STOP_KEY_PREFIX + "t") is not None
    # Simulate the restart: the stale lease is still live (fresh cache
    # state, no time passed), but start() absorbs the stale broadcast.
    fresh = fleet.CacheFleetCoordinator(cache, "t", 0, 1)
    fresh.start()
    assert fresh.shutdown_requested() is None
    svc = fleet.FleetService(fresh, heartbeat_period_s=0.05,
                             on_shutdown=lambda r: pytest.fail(
                                 f"stale broadcast replayed: {r}"))
    svc.start(timeout_s=5, await_barrier=False)
    time.sleep(0.3)  # several observation rounds
    svc.stop()
    # A FRESH broadcast still works after the clear.
    fresh.request_shutdown("real stop")
    assert fresh.shutdown_requested() == "real stop"


def test_claim_log_exclusive_lease():
    """The per-log fetch lease: one holder at a time, re-affirmable by
    the holder (and by its same-id restart), transferable only after
    release or TTL expiry — the guard against takeover/warm-restart
    double-fetch."""
    cache = MockRemoteCache()
    c0 = fleet.CacheFleetCoordinator(cache, "t", 0, 2)
    c1 = fleet.CacheFleetCoordinator(cache, "t", 1, 2)
    url = URLS[0]
    assert c0.claim_log(url) is True
    assert c1.claim_log(url) is False  # held
    assert c0.claim_log(url) is True  # holder re-affirms (TTL refresh)
    c1.release_log(url)  # non-holder release is a no-op
    assert c1.claim_log(url) is False
    c0.release_log(url)
    assert c1.claim_log(url) is True  # transferred after release
    # A restart with the holder's id re-affirms the old incarnation's
    # lease instead of deadlocking against itself.
    c1b = fleet.CacheFleetCoordinator(cache, "t", 1, 2)
    assert c1b.claim_log(url) is True
    for c in (c0, c1, c1b):
        c.close()


def test_fleet_service_claims_filter_and_release():
    cache = MockRemoteCache()
    svc = fleet.FleetService(
        fleet.CacheFleetCoordinator(cache, "cl", 0, 2))
    peer = fleet.CacheFleetCoordinator(cache, "cl", 1, 2)
    taken = URLS[0]
    assert peer.claim_log(taken)
    assert svc.claim(taken) is False
    free = URLS[1]
    assert svc.claim(free) is True
    assert svc.stats()["claims"] == [free]
    svc.release_claims()
    assert svc.stats()["claims"] == []
    assert peer.claim_log(free) is True  # released → claimable
    peer.close()
    svc.coordinator.close()


def test_fleet_assignments_sth_failure_contained(monkeypatch):
    """Stripe mode resolves the tree size with one STH fetch inside
    the main run loop; a transient failure there must land in the
    engine's per-round error list (empty round, retried next poll),
    not propagate and kill the worker process."""
    from ct_mapreduce_tpu_torch.cmd import ct_fetch
    from ct_mapreduce_tpu_torch.ingest import ctclient

    class BoomClient:
        def __init__(self, url):
            pass

        def get_sth(self):
            raise OSError("connection refused")

    monkeypatch.setattr(ctclient, "CTLogClient", BoomClient)
    svc = fleet.FleetService(
        fleet.CacheFleetCoordinator(MockRemoteCache(), "sth", 0, 2))
    errors = []
    out = ct_fetch.fleet_assignments(
        svc, ["https://log.example/a"], errors=errors)
    assert out == []
    assert len(errors) == 1 and "STH fetch" in errors[0]
    svc.coordinator.close()


def test_fleet_assignments_skips_leased_logs():
    """A log whose fetch lease another worker still holds (takeover
    survivor vs. the owner's restart) is excluded from this round's
    assignments and picked up again once the lease is released."""
    from ct_mapreduce_tpu_torch.cmd import ct_fetch

    cache = MockRemoteCache()
    svc = fleet.FleetService(
        fleet.CacheFleetCoordinator(cache, "as", 0, 2))
    peer = fleet.CacheFleetCoordinator(cache, "as", 1, 2)
    mine = fleet.partition_logs(URLS, 0, 2)
    assert len(mine) >= 2
    held = mine[0]
    assert peer.claim_log(held)  # survivor mid-fetch of our log
    urls = [u for (u, _, _, _) in ct_fetch.fleet_assignments(svc, URLS)]
    assert held not in urls
    assert urls == [u for u in mine if u != held]
    svc.release_claims()
    peer.release_log(held)
    urls = [u for (u, _, _, _) in ct_fetch.fleet_assignments(svc, URLS)]
    assert urls == mine  # re-contended and won next round
    svc.release_claims()
    peer.close()
    svc.coordinator.close()


def test_rejoin_skips_barrier_and_republishes_start():
    """A restarted worker rejoining a running fleet must not block on
    the start barrier: a follower behind the incumbent's published
    start key detects the rejoin itself; a worker that inherited an
    expired lease (or one asserting local checkpoint evidence via
    ``rejoin=True``) re-publishes the start key instead of waiting for
    membership that may never re-form."""
    cache = MockRemoteCache()
    c0, c1, results = _elect_pair(cache)  # running fleet, barrier done
    # Case 1: respawn as a FOLLOWER behind the still-live lease — the
    # incumbent's started key marks the fleet as already running.
    re0 = fleet.CacheFleetCoordinator(cache, "t", 0, 2)
    svc = fleet.FleetService(re0)
    t0 = time.monotonic()
    svc.start(timeout_s=30)  # must not wait anywhere near timeout
    assert time.monotonic() - t0 < 5.0
    assert svc.rejoined is True
    assert re0.fleet_started() is True
    assert svc.stats()["rejoined"] is True
    svc.stop()
    # Case 2: caller-asserted rejoin on a LEADER (fresh cache simulates
    # the expired-lease takeover; peers finished, membership will never
    # re-form): start() returns immediately and the start key is
    # re-published so any polling follower is released.
    from ct_mapreduce_tpu_torch.coordinator.coordinator import STARTED_KEY_PREFIX

    cache2 = MockRemoteCache()
    lead = fleet.CacheFleetCoordinator(cache2, "t", 0, 2)
    svc2 = fleet.FleetService(lead)
    t0 = time.monotonic()
    assert svc2.start(timeout_s=30, rejoin=True) is True
    assert time.monotonic() - t0 < 5.0, "rejoining leader blocked"
    assert cache2.exists(STARTED_KEY_PREFIX + lead._coord.identifier)
    svc2.stop()
    c0.close()
    c1.close()


def test_cache_coordinator_liveness_and_promotion():
    from datetime import timedelta

    cache = MockRemoteCache()
    c0, c1, results = _elect_pair(
        cache, liveness_timeout_s=0.2,
        key_life_initial=timedelta(seconds=0.2),
        key_life_renewal=timedelta(seconds=0.2))
    leader = c0 if results[0] else c1
    follower = c1 if results[0] else c0
    # Leader dies: its heartbeat AND election lease expire; the
    # follower's next heartbeat round promotes it (elastic failover,
    # the reference's lease-expiry semantics).
    leader._coord._stop_renewal.set()  # simulate process death
    deadline = time.monotonic() + 5.0
    promoted = False
    while time.monotonic() < deadline and not promoted:
        time.sleep(0.1)
        follower.heartbeat()
        assert leader.worker_id not in follower.alive_workers() or True
        promoted = follower.maybe_promote()
    assert promoted, "follower never inherited the expired lease"
    assert follower.is_leader
    # The dead leader's heartbeat is gone from the liveness view.
    assert leader.worker_id not in follower.alive_workers()
    c0.close()
    c1.close()


def test_cache_coordinator_over_live_miniredis():
    """The same protocol over the real socket client + miniredis —
    pins RemoteCache.put/get on the RESP path."""
    from ct_mapreduce_tpu_torch.storage.rediscache import RedisCache
    from ct_mapreduce_tpu_torch.utils.miniredis import MiniRedis

    server = MiniRedis().start()
    try:
        cache = RedisCache(server.address)
        c = fleet.CacheFleetCoordinator(cache, "mr", 0, 1,
                                        liveness_timeout_s=5.0)
        assert c.start() is True  # sole contender wins
        c.barrier(timeout_s=5)
        assert sorted(c.alive_workers()) == [0]
        c.publish_epoch(7)
        assert c.current_epoch() == 7
        cache.put("fleet-ttl-probe", "x")
        assert cache.get("fleet-ttl-probe") == "x"
        c.request_shutdown("bye")
        assert c.shutdown_requested() == "bye"
        c.close()
        cache.close()
    finally:
        server.stop()


def test_jax_coordinator_single_process_fallback():
    """``coordinatorBackend = jax`` without a process group: leadership
    is rank 0, the barrier a no-op, epoch/shutdown degrade to local
    values (no store to carry them)."""
    c = fleet.build_coordinator("jax", None, "t", 0, 1)
    assert isinstance(c, fleet.DistFleetCoordinator)
    assert c.num_workers == 1 and c.worker_id == 0
    assert c.start() is True
    c.barrier(timeout_s=1)
    c.publish_epoch(3)
    assert c.current_epoch() == 3
    c.request_shutdown("x")
    assert c.shutdown_requested() == "x"
    assert c.done_workers() == set()
    c.mark_done()
    assert c.done_workers() == {0}
    c.close()


def test_done_markers_and_leader_finish():
    """End of a run: each worker marks its final save done; the leader's
    ``finish`` returns once every live peer is done, and does not wait
    for a peer whose heartbeat lapsed. A stale marker from an earlier
    run is cleared when the worker starts again."""
    from datetime import timedelta

    solo = fleet.SoloFleetCoordinator()
    assert solo.done_workers() == set()
    solo.mark_done()
    assert solo.done_workers() == {0}

    cache = MockRemoteCache()
    c0, c1, results = _elect_pair(cache, liveness_timeout_s=30)
    leader, follower = (c0, c1) if results[0] else (c1, c0)
    svc = fleet.FleetService(leader)
    svc.is_leader = True
    assert svc.finish(timeout_s=0.2) == [follower.worker_id]  # still live
    assert leader.done_workers() == {leader.worker_id}
    released = []
    waiter = threading.Thread(
        target=lambda: released.append(svc.finish(timeout_s=10)))
    waiter.start()
    time.sleep(0.1)
    assert waiter.is_alive()  # waits on the live, unfinished follower
    assert fleet.FleetService(follower).finish() == []  # a follower
    waiter.join(5)
    assert released == [[]]
    assert follower.done_workers() == {0, 1}
    follower.start()  # a later run of the same worker
    assert follower.worker_id not in leader.done_workers()
    # A peer that died without marking done is waited for only until
    # its heartbeat lapses.
    cache2 = MockRemoteCache()
    d0, d1, res2 = _elect_pair(cache2, liveness_timeout_s=0.3,
                               key_life_initial=timedelta(seconds=5))
    lead2 = d0 if res2[0] else d1
    svc2 = fleet.FleetService(lead2)
    svc2.is_leader = True
    t0 = time.monotonic()
    assert svc2.finish(timeout_s=10) == []
    assert time.monotonic() - t0 < 5
    for c in (c0, c1, d0, d1):
        c.close()


def test_build_coordinator_selection():
    cache = MockRemoteCache()
    assert isinstance(fleet.build_coordinator("", None, "t", 0, 1),
                      fleet.SoloFleetCoordinator)
    assert isinstance(fleet.build_coordinator("", cache, "t", 0, 2),
                      fleet.CacheFleetCoordinator)
    assert isinstance(fleet.build_coordinator("redis", cache, "t", 0, 1),
                      fleet.CacheFleetCoordinator)
    with pytest.raises(ValueError):
        fleet.build_coordinator("zookeeper", cache, "t", 0, 2)
    with pytest.raises(ValueError):
        fleet.build_coordinator("redis", None, "t", 0, 2)


# -- the service loop ---------------------------------------------------


def test_fleet_service_checkpoint_cadence_and_stats():
    hits = []
    svc = fleet.FleetService(
        fleet.SoloFleetCoordinator("s"), heartbeat_period_s=0.05,
        checkpoint_period_s=0.1, on_checkpoint=hits.append)
    assert svc.start(timeout_s=5) is True
    deadline = time.monotonic() + 5.0
    while len(hits) < 3 and time.monotonic() < deadline:
        time.sleep(0.05)
    svc.stop()
    assert len(hits) >= 3, hits
    assert hits == sorted(hits)  # epochs advance monotonically
    st = svc.stats()
    assert st["role"] == "leader"
    assert st["workers_alive"] == [0]
    assert st["checkpoints_run"] == len(hits)
    assert st["checkpoint_epoch"] >= hits[-1]


def test_fleet_service_shutdown_broadcast_and_partition():
    cache = MockRemoteCache()
    coord = fleet.CacheFleetCoordinator(cache, "b", 0, 2,
                                        liveness_timeout_s=5.0)
    seen = []
    svc = fleet.FleetService(coord, heartbeat_period_s=0.05,
                             on_shutdown=seen.append)
    # Peer heartbeat so the (leader) barrier releases.
    peer = fleet.CacheFleetCoordinator(cache, "b", 1, 2,
                                       liveness_timeout_s=5.0)
    peer.heartbeat()
    svc.start(timeout_s=5)
    mine = svc.partition(URLS)
    assert mine == fleet.partition_logs(URLS, 0, 2)
    assert svc.stats()["partition"] == fleet.partition_map(URLS, 2)
    peer.request_shutdown("peer says stop")
    deadline = time.monotonic() + 5.0
    while not seen and time.monotonic() < deadline:
        time.sleep(0.02)
    svc.stop()
    peer.close()
    assert seen == ["peer says stop"]


def test_engine_checkpoint_now_fans_out():
    """checkpoint_now: live downloaders get a save request; with none
    in flight the aggregate hook runs directly (idle workers persist
    at the fleet cadence too)."""
    from ct_mapreduce_tpu_torch.ingest.sync import LogSyncEngine

    hook_runs = []
    engine = LogSyncEngine(sink=None, database=None,
                           checkpoint_hook=lambda: hook_runs.append(1))
    engine.checkpoint_now()
    assert hook_runs == [1]  # idle → direct hook

    class FakeWorker:
        def __init__(self):
            self.saves = 0

        def request_save(self):
            self.saves += 1

    w = FakeWorker()
    engine._active_workers.append(w)
    engine.checkpoint_now()
    assert w.saves == 1
    assert hook_runs == [1]  # the downloader's save runs the hook


# -- merge --------------------------------------------------------------


def test_merge_snapshots_sums_and_unions():
    from ct_mapreduce_tpu_torch.agg.aggregator import AggregateSnapshot
    from ct_mapreduce_tpu_torch.agg.merge import merge_snapshots

    a = AggregateSnapshot(
        counts={("i1", "d1"): 3, ("i1", "d2"): 1},
        crls={"i1": {"u1"}}, dns={"i1": {"CN=A"}},
        total=4, verified={"i1": 2}, failed={})
    b = AggregateSnapshot(
        counts={("i1", "d1"): 2, ("i2", "d1"): 5},
        crls={"i1": {"u2"}, "i2": {"u3"}}, dns={"i2": {"CN=B"}},
        total=7, verified={"i1": 1}, failed={"i2": 4})
    m = merge_snapshots([a, b])
    assert m.counts == {("i1", "d1"): 5, ("i1", "d2"): 1, ("i2", "d1"): 5}
    assert m.total == 11
    assert m.crls == {"i1": {"u1", "u2"}, "i2": {"u3"}}
    assert m.dns == {"i1": {"CN=A"}, "i2": {"CN=B"}}
    assert m.verified == {"i1": 3} and m.failed == {"i2": 4}


def test_expand_state_paths(tmp_path):
    from ct_mapreduce_tpu_torch.agg.merge import expand_state_paths

    for w in range(3):
        (tmp_path / f"agg.w{w}.npz").write_bytes(b"x")
    spec = f"{tmp_path}/agg.w*.npz"
    assert expand_state_paths(spec) == [
        str(tmp_path / f"agg.w{w}.npz") for w in range(3)]
    assert expand_state_paths("a.npz, b.npz") == ["a.npz", "b.npz"]
    assert expand_state_paths("") == []


def test_merged_checkpoints_match_single_aggregator(tmp_path):
    """Two workers' checkpoints fold into the same view one aggregator
    ingesting everything produces (disjoint serial ranges, one issuer
    shared so the registry remap is exercised), and storage-statistics
    over the glob reports the fleet as that one view, text and JSON."""
    import io

    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.agg.merge import load_checkpoints
    from ct_mapreduce_tpu_torch.cmd import storage_statistics
    from ct_mapreduce_tpu_torch.config import CTConfig
    from ct_mapreduce_tpu_torch.utils import minicert

    shared = minicert.make_cert(serial=2, issuer_cn="Shared CA", is_ca=True)
    own = [minicert.make_cert(serial=3 + w, issuer_cn=f"CA {w}", is_ca=True)
           for w in range(2)]
    batches = []
    for w in range(2):
        entries = []
        for e in range(12):
            leaf = minicert.make_cert(
                serial=10_000 * (w + 1) + e,
                issuer_cn="Shared CA" if e % 3 == 0 else f"CA {w}",
                subject_cn=f"m{w}-{e}.example",
                crl_dps=(f"http://crl.example/{w}.crl",))
            entries.append((leaf, shared if e % 3 == 0 else own[w]))
        entries.append(entries[0])  # intra-worker duplicate
        batches.append(entries)

    paths = []
    for w, entries in enumerate(batches):
        agg = TorchAggregator(capacity=1 << 10, batch_size=64, device="cpu")
        agg.ingest(entries)
        path = str(tmp_path / f"agg.w{w}.npz")
        agg.save_checkpoint(path)
        paths.append(path)
    ref = TorchAggregator(capacity=1 << 10, batch_size=64, device="cpu")
    ref.ingest(batches[0] + batches[1])
    merged = load_checkpoints(paths)
    assert merged.drain() == ref.drain()
    ids = {merged.registry.issuer_at(i).id()
           for i in range(len(merged.registry))}
    assert len(ids) == 3

    ref_path = str(tmp_path / "ref.npz")
    ref.save_checkpoint(ref_path)

    def config_for(state_spec):
        cfg = CTConfig.load(argv=[], env={})
        cfg.backend = "tpu"
        cfg.agg_state_path = state_spec
        return cfg

    def report_text(state_spec):
        out = io.StringIO()
        assert storage_statistics.report_from_tpu_snapshot(
            config_for(state_spec), out, 1) == 0
        return out.getvalue()

    merged_text = report_text(f"{tmp_path}/agg.w*.npz")
    assert merged_text == report_text(ref_path)
    assert "overall totals" in merged_text
    assert (storage_statistics.collect_tpu_report(
                config_for(f"{tmp_path}/agg.w*.npz"))
            == storage_statistics.collect_tpu_report(config_for(ref_path)))


def test_merge_counts_a_serial_twice_when_two_workers_log_it():
    """The reduce sums per-worker counts, in both packages: a serial that
    two workers' logs (or two stripes of one log) both carry counts
    twice in the merged view, once in a serial run (ROADMAP queue 3)."""
    from ct_mapreduce_tpu.agg.aggregator import AggregateSnapshot as JSnap
    from ct_mapreduce_tpu.agg.merge import merge_snapshots as jmerge
    from ct_mapreduce_tpu_torch.agg.aggregator import TorchAggregator
    from ct_mapreduce_tpu_torch.agg.merge import merge_snapshots
    from ct_mapreduce_tpu_torch.utils import minicert

    ca = minicert.make_cert(serial=2, issuer_cn="Twice CA", is_ca=True)
    leaf = minicert.make_cert(serial=77, issuer_cn="Twice CA")
    snaps = []
    for _ in range(2):
        agg = TorchAggregator(capacity=1 << 10, batch_size=64, device="cpu")
        agg.ingest([(leaf, ca)])
        snaps.append(agg.drain())
    serial = TorchAggregator(capacity=1 << 10, batch_size=64, device="cpu")
    serial.ingest([(leaf, ca), (leaf, ca)])
    assert serial.drain().total == 1
    assert merge_snapshots(snaps).total == 2
    jsnaps = [JSnap(counts=s.counts, crls=s.crls, dns=s.dns, total=s.total,
                    verified=s.verified, failed=s.failed) for s in snaps]
    assert jmerge(jsnaps).total == 2


@pytest.mark.parametrize("backend", ["solo", "jax"])
def test_ct_fetch_runs_a_one_worker_fleet(tmp_path, monkeypatch, backend):
    """ct-fetch-torch accepts ``coordinatorBackend`` (``solo``, and
    ``jax`` over a process group it joins only with MASTER_ADDR and
    WORLD_SIZE set, so here one local worker) and ``checkpointPeriod``:
    the worker leads, ticks and drains as a run without them."""
    import contextlib
    import io

    from ct_mapreduce_tpu_torch.agg.merge import load_checkpoints
    from ct_mapreduce_tpu_torch.cmd import ct_fetch
    from ct_mapreduce_tpu_torch.ingest import ctclient
    from ct_mapreduce_tpu_torch.utils import minicert
    from ct_mapreduce_tpu_torch.utils.fakelog import FakeLog

    for k in ("MASTER_ADDR", "WORLD_SIZE", "CTMR_NUM_WORKERS",
              "CTMR_WORKER_ID", "CTMR_COORDINATOR", "CTMR_CHECKPOINT_PERIOD"):
        monkeypatch.delenv(k, raising=False)
    log = FakeLog()
    ca = minicert.make_cert(serial=1, issuer_cn="Solo CA", is_ca=True)
    for s in range(40):
        log.add_cert(minicert.make_cert(serial=500 + s % 30,
                                        issuer_cn="Solo CA"), ca)
    monkeypatch.setattr(ctclient, "_urllib_transport", log.transport)
    drains = []
    for name, extra in (("plain", ""), ("fleet",
                        f"coordinatorBackend = {backend}\n"
                        "checkpointPeriod = 50ms\n")):
        ini = tmp_path / f"{name}.ini"
        state = tmp_path / f"{name}.npz"
        ini.write_text(f"logList = {log.url}\nbackend = tpu\nbatchSize = 32\n"
                       f"tableBits = 10\nhealthAddr = \nnobars = true\n"
                       f"aggStatePath = {state}\n" + extra)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert ct_fetch.main(["-config", str(ini)], device="cpu") == 0
        if name == "fleet":
            assert "fleet worker 0/1 (leader" in err.getvalue()
        drains.append(load_checkpoints([str(state)]).drain())
    assert drains[0] == drains[1] and drains[0].total == 30
