"""In-memory RemoteCache for tests and single-process runs.

Parity with the reference's MockRemoteCache
(reference storage/mockcache.go): sorted-set semantics, lazily
honored TTLs, and a `duplicate` fidelity knob that replays members to
simulate Redis SSCAN duplication (mockcache.go:14-36,109-118) — the
behavior the client-side dedup in KnownCertificates.Known() exists to
absorb. Unlike the reference's mock, queues are implemented (the
reference leaves them unimplemented, mockcache.go:140-150; the real
RedisCache has them, so ours does too for coordinator tests).

A copy of ``ct_mapreduce_tpu.storage.mockcache``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import fnmatch
import threading
import time
from bisect import bisect_left, insort
from datetime import datetime, timedelta, timezone
from typing import Iterator, Optional

from ct_mapreduce_tpu_torch.core.types import CertificateLog
from ct_mapreduce_tpu_torch.storage.interfaces import RemoteCache


class MockRemoteCache(RemoteCache):
    def __init__(self, duplicate: int = 0):
        # duplicate: replay each streamed member this many extra times
        self.duplicate = duplicate
        self._sets: dict[str, list[str]] = {}
        self._lists: dict[str, list[str]] = {}
        self._kv: dict[str, str] = {}
        self._expirations: dict[str, datetime] = {}
        self._lock = threading.RLock()

    # -- expiry ----------------------------------------------------------
    def _now(self) -> datetime:
        return datetime.now(timezone.utc)

    def cleanup_expiry(self) -> None:
        """Lazily drop expired keys (mockcache.go:28-36)."""
        with self._lock:
            now = self._now()
            expired = [k for k, t in self._expirations.items() if t <= now]
            for k in expired:
                self._sets.pop(k, None)
                self._lists.pop(k, None)
                self._kv.pop(k, None)
                del self._expirations[k]

    # -- sets ------------------------------------------------------------
    def exists(self, key: str) -> bool:
        self.cleanup_expiry()
        with self._lock:
            return key in self._sets or key in self._lists or key in self._kv

    def set_insert(self, key: str, entry: str) -> bool:
        self.cleanup_expiry()
        with self._lock:
            members = self._sets.setdefault(key, [])
            idx = bisect_left(members, entry)
            if idx < len(members) and members[idx] == entry:
                return False
            members.insert(idx, entry)
            return True

    def set_remove(self, key: str, entry: str) -> bool:
        self.cleanup_expiry()
        with self._lock:
            members = self._sets.get(key, [])
            idx = bisect_left(members, entry)
            if idx < len(members) and members[idx] == entry:
                members.pop(idx)
                return True
            return False

    def set_contains(self, key: str, entry: str) -> bool:
        self.cleanup_expiry()
        with self._lock:
            members = self._sets.get(key, [])
            idx = bisect_left(members, entry)
            return idx < len(members) and members[idx] == entry

    def set_list(self, key: str) -> list[str]:
        self.cleanup_expiry()
        with self._lock:
            return list(self._sets.get(key, []))

    def set_to_iter(self, key: str) -> Iterator[str]:
        self.cleanup_expiry()
        with self._lock:
            members = list(self._sets.get(key, []))
        for m in members:
            yield m
            for _ in range(self.duplicate):
                yield m

    def set_cardinality(self, key: str) -> int:
        self.cleanup_expiry()
        with self._lock:
            return len(self._sets.get(key, []))

    # -- TTLs ------------------------------------------------------------
    def expire_at(self, key: str, exp_time: datetime) -> None:
        if exp_time.tzinfo is None:
            exp_time = exp_time.replace(tzinfo=timezone.utc)
        with self._lock:
            self._expirations[key] = exp_time

    def expire_in(self, key: str, duration: timedelta) -> None:
        with self._lock:
            self._expirations[key] = self._now() + duration

    # -- queues ----------------------------------------------------------
    def queue(self, key: str, identifier: str) -> int:
        self.cleanup_expiry()
        with self._lock:
            lst = self._lists.setdefault(key, [])
            lst.append(identifier)
            return len(lst)

    def pop(self, key: str) -> str:
        self.cleanup_expiry()
        with self._lock:
            lst = self._lists.get(key)
            if not lst:
                raise KeyError(key)
            return lst.pop(0)

    def queue_length(self, key: str) -> int:
        self.cleanup_expiry()
        with self._lock:
            return len(self._lists.get(key, []))

    def blocking_pop_copy(self, key: str, dest: str, timeout: timedelta) -> str:
        deadline = time.monotonic() + timeout.total_seconds()
        while True:
            with self._lock:
                lst = self._lists.get(key)
                if lst:
                    value = lst.pop()  # BRPOPLPUSH pops from the tail
                    self._lists.setdefault(dest, []).insert(0, value)
                    return value
            if time.monotonic() >= deadline:
                raise TimeoutError(key)
            time.sleep(0.005)

    def list_remove(self, key: str, value: str) -> None:
        with self._lock:
            lst = self._lists.get(key, [])
            self._lists[key] = [v for v in lst if v != value]

    # -- SETNX / scan / log state ---------------------------------------
    def try_set(self, key: str, value: str, life: timedelta) -> str:
        self.cleanup_expiry()
        with self._lock:
            if key in self._kv:
                return self._kv[key]
            self._kv[key] = value
            self._expirations[key] = self._now() + life
            return value

    def put(self, key: str, value: str,
            life: Optional[timedelta] = None) -> None:
        self.cleanup_expiry()
        with self._lock:
            self._kv[key] = value
            if life is None:
                self._expirations.pop(key, None)
            else:
                self._expirations[key] = self._now() + life

    def get(self, key: str) -> Optional[str]:
        self.cleanup_expiry()
        with self._lock:
            return self._kv.get(key)

    def keys_matching(self, pattern: str) -> Iterator[str]:
        self.cleanup_expiry()
        with self._lock:
            keys = list(self._sets) + list(self._lists) + list(self._kv)
        for k in keys:
            if fnmatch.fnmatchcase(k, pattern):
                yield k

    def store_log_state(self, log: CertificateLog) -> None:
        with self._lock:
            self._kv[f"log::{log.short_url}"] = log.to_json()

    def load_log_state(self, short_url: str) -> Optional[CertificateLog]:
        with self._lock:
            raw = self._kv.get(f"log::{short_url}")
        return CertificateLog.from_json(raw) if raw else None
