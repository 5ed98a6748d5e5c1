"""Hot-serial result cache: the layer in FRONT of the micro-batcher.

Real membership traffic is zipf-shaped — a small set of serials (the
big CDNs' current certificates, a crawler's working set) accounts for
most probes — so the cheapest batch is the one never formed. The cache
memoizes whole answers ``(known, epoch, capture_wall)`` keyed on the
query identity tuple ``(issuer_idx, exp_hour, serial_bytes)``. That
tuple is the exact preimage of the 128-bit table fingerprint (one
identity ⇒ one fingerprint, modulo the collision odds the dedup table
itself already accepts), so caching on it is equivalent to caching on
``(epoch, fingerprint)`` while skipping the SHA-256 pass entirely on a
hit — the point of the cache is to do no per-lane work at all.

Validity is epoch-floored, not TTL'd: an entry computed at epoch ``e``
may be served only while ``e >= floor_epoch`` — the minimum epoch
across the replica pool's live views. Serving such an entry is
indistinguishable from the round-robin dispatch having picked the
pool's stalest replica, which is always legal; once every replica has
refreshed past ``e`` the entry can never be served again (ghost
answers across epochs are impossible BY KEY, not by timer). A bump of
the pool's floor therefore invalidates by construction — there is no
explicit flush path to forget.

Membership is monotone (serials are never deleted), so a cached
``known=True`` can never flip; a cached ``known=False`` can become
stale-true, which is exactly the staleness the pool already exposes —
the hit carries its view's epoch and capture wall so the response's
``staleness_s`` stays honest.

A copy of ``ct_mapreduce_tpu.serve.cache`` on the port's
``telemetry``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

from ct_mapreduce_tpu_torch.telemetry.metrics import set_gauge


class CacheEntry:
    __slots__ = ("known", "epoch", "created_wall")

    def __init__(self, known: bool, epoch: int, created_wall: float) -> None:
        self.known = known
        self.epoch = epoch
        self.created_wall = created_wall


class HotSerialCache:
    """Bounded LRU of membership answers, epoch-floor validated.

    Thread-safe (query_raw runs on every HTTP handler thread); all
    operations are O(1) dict moves. ``capacity <= 0`` disables —
    every ``get`` misses and ``put`` is a no-op — so callers need no
    branching."""

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, CacheEntry] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: tuple, floor_epoch: int) -> Optional[CacheEntry]:
        """The entry for ``key`` if one exists at epoch >= the pool's
        floor; an entry every replica has refreshed past is evicted on
        probe (it could answer staler than anything the pool would)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            if e.epoch < floor_epoch:
                del self._entries[key]
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return e

    def put(self, key: tuple, known: bool, epoch: int,
            created_wall: float) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.epoch > epoch:
                return  # never downgrade to an older view's answer
            self._entries[key] = CacheEntry(known, epoch, created_wall)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
            size = len(self._entries)
        set_gauge("serve", "cache_size", value=float(size))

    def stats(self) -> dict:
        with self._lock:
            return {
                "cache_size": len(self._entries),
                "cache_cap": self.capacity,
                "cache_hits": self.hits,
                "cache_misses": self.misses,
            }
