"""Multi-process coordination: leader election and a start barrier over
the RemoteCache fabric (a copy of ``ct_mapreduce_tpu.coordinator``; the
port imports nothing of the JAX package).

Reference coordinator/coordinator.go: SETNX-based election on
`leader-<name>` with a background lease-renewal thread (:44-85),
followers polling `started-<leaderID>` (:87-106), the leader publishing
it (:108-138). Lease expiry gives elastic leader failover.

For multi-process jobs the same contract is also available over the
process group: ct_mapreduce_tpu_torch.parallel.distributed maps
leadership to rank 0 with the barrier as a collective; this
Redis-parity coordinator remains for drop-in use alongside reference
deployments.
"""

from __future__ import annotations

import random
import socket
import threading
import time
from datetime import timedelta

from ct_mapreduce_tpu_torch.storage.interfaces import RemoteCache

LEADER_KEY_PREFIX = "leader-"
STARTED_KEY_PREFIX = "started-"


class Coordinator:
    def __init__(
        self,
        cache: RemoteCache,
        name: str,
        key_life_initial: timedelta = timedelta(minutes=5),
        key_life_renewal: timedelta = timedelta(minutes=2),
        renewal_period_s: float = 60.0,
        await_sleep_period_s: float = 0.25,
    ):
        self.cache = cache
        self.name = name
        self.is_leader = False
        self.identifier = ""
        self.key_life_initial = key_life_initial
        self.key_life_renewal = key_life_renewal
        self.renewal_period_s = renewal_period_s
        self.await_sleep_period_s = await_sleep_period_s
        self._stop_renewal = threading.Event()
        self._renewal_threads: list[threading.Thread] = []

    def _start_renewal(self, key: str) -> None:
        def renew():
            while not self._stop_renewal.wait(self.renewal_period_s):
                try:
                    self.cache.expire_in(key, self.key_life_renewal)
                except Exception:
                    pass  # transient cache failures must not kill renewal

        # First renewal immediately, as the reference does (coordinator.go:71-79)
        self.cache.expire_in(key, self.key_life_renewal)
        t = threading.Thread(target=renew, name=f"renew-{key}", daemon=True)
        t.start()
        self._renewal_threads.append(t)

    def await_leader(self) -> bool:
        """Contend for leadership; returns True iff this process won
        (coordinator.go:44-85)."""
        our_identifier = f"{socket.gethostname()}-{random.getrandbits(63):X}"
        leader_key = LEADER_KEY_PREFIX + self.name
        result = self.cache.try_set(leader_key, our_identifier, self.key_life_initial)
        self.identifier = result
        self.is_leader = result == our_identifier
        if self.is_leader:
            self._start_renewal(leader_key)
        return self.is_leader

    def await_start(self, timeout_s: float | None = None) -> None:
        """Follower: poll until the leader publishes start
        (coordinator.go:87-106)."""
        if not self.identifier:
            raise RuntimeError("Must not call before await_leader completes")
        if self.is_leader:
            raise RuntimeError("Must not call unless we're a follower")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            if self.cache.exists(STARTED_KEY_PREFIX + self.identifier):
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError("start barrier")
            time.sleep(self.await_sleep_period_s)

    def send_start(self) -> None:
        """Leader: publish the start barrier (coordinator.go:108-138)."""
        if not self.identifier:
            raise RuntimeError("Must not call before await_leader completes")
        if not self.is_leader:
            raise RuntimeError("Must not call unless we're leader")
        started_key = STARTED_KEY_PREFIX + self.identifier
        result = self.cache.try_set(
            started_key, self.identifier, self.key_life_initial
        )
        if result != self.identifier:
            raise RuntimeError(
                f"TrySet should have succeeded, put {self.identifier} got {result}"
            )
        self._start_renewal(started_key)

    def close(self) -> None:
        self._stop_renewal.set()
