"""The port's coordinator (``ct_mapreduce_tpu_torch/coordinator``), on
the CPU: the cases of ``tests/test_coordinator.py`` — election under
contention, the start barrier, lease renewal and failover, simulated as
many threads sharing one cache, as the reference simulates multi-node
with goroutines sharing one Redis (reference
coordinator/coordinator_test.go:61-220) — plus the same election over
the JAX package's coordinator on a shared cache: one winner either
way, and both packages write the same keys."""

import threading
import time
from datetime import timedelta

from ct_mapreduce_tpu.coordinator import Coordinator as JCoordinator
from ct_mapreduce_tpu_torch.coordinator import Coordinator
from ct_mapreduce_tpu_torch.storage.mockcache import MockRemoteCache


def _elect(n: int, cache: MockRemoteCache) -> list[Coordinator]:
    coords = [Coordinator(cache, "test") for _ in range(n)]
    results = [None] * n
    threads = []

    def contend(i):
        results[i] = coords[i].await_leader()

    for i in range(n):
        t = threading.Thread(target=contend, args=(i,))
        threads.append(t)
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(1 for r in results if r) == 1, f"expected one leader, got {results}"
    return coords


def test_two_contenders_one_winner():
    _elect(2, MockRemoteCache())


def test_forty_contenders_one_winner():
    # coordinator_test.go:61-104
    _elect(40, MockRemoteCache())


def test_start_barrier_with_followers():
    # coordinator_test.go:137-177: 16 followers unblock on leader start
    cache = MockRemoteCache()
    coords = _elect(16, cache)
    leader = next(c for c in coords if c.is_leader)
    followers = [c for c in coords if not c.is_leader]
    for f in followers:
        f.await_sleep_period_s = 0.01

    released = []
    threads = [
        threading.Thread(target=lambda f=f: (f.await_start(timeout_s=5), released.append(f)))
        for f in followers
    ]
    for t in threads:
        t.start()
    time.sleep(0.05)
    assert not released  # nobody through before start
    leader.send_start()
    for t in threads:
        t.join(timeout=5)
    assert len(released) == len(followers)
    for c in coords:
        c.close()


def test_follower_misuse_raises():
    cache = MockRemoteCache()
    c = Coordinator(cache, "misuse")
    try:
        c.await_start()
        assert False, "should raise before await_leader"
    except RuntimeError:
        pass
    assert c.await_leader() is True
    try:
        c.await_start()
        assert False, "leader must not await_start"
    except RuntimeError:
        pass
    c.close()


def test_lease_renewal_keeps_leadership():
    # coordinator_test.go:179-220, at high speed: initial lease is short,
    # renewal keeps the key alive past it
    cache = MockRemoteCache()
    c = Coordinator(
        cache,
        "renewal",
        key_life_initial=timedelta(milliseconds=80),
        key_life_renewal=timedelta(milliseconds=200),
        renewal_period_s=0.05,
    )
    assert c.await_leader() is True
    time.sleep(0.3)  # well past the initial 80ms lease
    assert cache.exists("leader-renewal"), "renewal thread should keep the lease"
    c.close()


def test_failover_after_lease_expiry():
    # Elastic failover: once the lease lapses with no renewal, a new
    # contender wins (coordinator.go:57,71-81 behavior)
    cache = MockRemoteCache()
    first = Coordinator(
        cache,
        "fo",
        key_life_initial=timedelta(milliseconds=50),
        key_life_renewal=timedelta(milliseconds=50),
        renewal_period_s=999,
    )
    assert first.await_leader() is True
    first.close()
    # Null out the renewal the close() above stopped, let lease lapse
    time.sleep(0.12)
    second = Coordinator(cache, "fo")
    assert second.await_leader() is True
    second.close()


def test_keys_match_jax_coordinator():
    """The port's leader key and started key are the JAX package's: a
    port follower waits on a JAX leader's barrier in one cache."""
    cache = MockRemoteCache()
    leader = JCoordinator(cache, "mixed")
    follower = Coordinator(cache, "mixed")
    assert leader.await_leader() is True
    assert follower.await_leader() is False
    assert follower.identifier == leader.identifier  # the winner's id
    done = threading.Event()

    def wait():
        follower.await_start(timeout_s=10)
        done.set()

    t = threading.Thread(target=wait)
    t.start()
    leader.send_start()
    t.join(10)
    assert done.is_set()
    leader.close()
    follower.close()
