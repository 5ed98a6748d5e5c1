"""Redis-backed RemoteCache over a dependency-free RESP2 socket client.

Parity with the reference's RedisCache
(reference storage/rediscache.go): client-side retry (10
attempts, capped backoff, :22-28), an advisory check that
maxmemory_policy=noeviction (:44-55), hard failure on Redis OOM
(:57-65), set/TTL/queue/SETNX/scan operations, and log-state JSON KV
under `log::<shortURL>` (:180-204). Implemented directly on the RESP
protocol because no redis client library ships in this environment.

A copy of ``ct_mapreduce_tpu.storage.rediscache``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import socket
import threading
import time
from datetime import datetime, timedelta, timezone
from typing import Iterator, Optional

from ct_mapreduce_tpu_torch.core.types import CertificateLog
from ct_mapreduce_tpu_torch.storage.interfaces import RemoteCache
from ct_mapreduce_tpu_torch.telemetry import metrics


class RedisFatalError(RuntimeError):
    """Unrecoverable Redis condition (e.g. OOM with noeviction)."""


class RespClient:
    """Minimal RESP2 client: one socket, thread-safe command execution."""

    def __init__(self, host: str, port: int, timeout_s: float = 5.0):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._buf = b""

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout_s
        )
        self._buf = b""

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n:]
        return data

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode("latin-1")
        if kind == b"-":
            msg = rest.decode("latin-1", "replace")
            if msg.startswith("OOM"):
                # Reference fatals the process on OOM (rediscache.go:57-65)
                raise RedisFatalError(msg)
            raise RuntimeError(f"redis error: {msg}")
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = self._read_exact(n)
            self._read_exact(2)  # trailing \r\n
            return data.decode("latin-1")
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RuntimeError(f"unexpected RESP type {line!r}")

    def execute(self, *args: str | bytes | int, retries: int = 10):
        """Run one command with reconnect-and-retry (rediscache.go:22-28)."""
        payload_parts = [f"*{len(args)}\r\n".encode()]
        for a in args:
            if isinstance(a, int):
                a = str(a).encode()
            elif isinstance(a, str):
                a = a.encode("latin-1")
            payload_parts.append(b"$%d\r\n%s\r\n" % (len(a), a))
        payload = b"".join(payload_parts)

        backoff = 0.05
        last_exc: Exception = RuntimeError("unreachable")
        for _ in range(max(retries, 1)):
            try:
                with self._lock:
                    if self._sock is None:
                        self._connect()
                    self._sock.sendall(payload)
                    return self._read_reply()
            except RedisFatalError:
                raise
            except (OSError, ConnectionError) as exc:
                last_exc = exc
                self.close()
                time.sleep(backoff)
                backoff = min(backoff * 2, 5.0)  # 5s max (rediscache.go:24)
        raise last_exc


class RedisCache(RemoteCache):
    def __init__(self, host_port: str, timeout_s: float = 5.0):
        host, _, port = host_port.partition(":")
        self.client = RespClient(host, int(port or 6379), timeout_s)
        if self.client.execute("PING") != "PONG":
            raise ConnectionError(f"redis at {host_port} did not PONG")
        if not self.memory_policy_correct():
            import sys

            print(
                "WARNING: Redis maxmemory_policy should be noeviction "
                "(rediscache.go:44-55 parity warning)",
                file=sys.stderr,
            )

    def close(self) -> None:
        self.client.close()

    def memory_policy_correct(self) -> bool:
        info = self.client.execute("INFO", "memory") or ""
        for line in str(info).splitlines():
            if line.startswith("maxmemory_policy:"):
                return line.split(":", 1)[1].strip() == "noeviction"
        return True

    # -- sets ------------------------------------------------------------
    def exists(self, key: str) -> bool:
        return bool(self.client.execute("EXISTS", key))

    def set_insert(self, key: str, entry: str) -> bool:
        with metrics.measure("RedisCache", "SetInsert"):
            return self.client.execute("SADD", key, entry) == 1

    def set_remove(self, key: str, entry: str) -> bool:
        return self.client.execute("SREM", key, entry) == 1

    def set_contains(self, key: str, entry: str) -> bool:
        return self.client.execute("SISMEMBER", key, entry) == 1

    def set_list(self, key: str) -> list[str]:
        return list(self.client.execute("SMEMBERS", key) or [])

    def set_to_iter(self, key: str) -> Iterator[str]:
        cursor = "0"
        while True:
            cursor, members = self.client.execute("SSCAN", key, cursor, "COUNT", 512)
            yield from members
            if cursor == "0":
                break

    def set_cardinality(self, key: str) -> int:
        return int(self.client.execute("SCARD", key))

    # -- TTLs ------------------------------------------------------------
    def expire_at(self, key: str, exp_time: datetime) -> None:
        if exp_time.tzinfo is None:
            exp_time = exp_time.replace(tzinfo=timezone.utc)
        self.client.execute("EXPIREAT", key, int(exp_time.timestamp()))

    def expire_in(self, key: str, duration: timedelta) -> None:
        self.client.execute("EXPIRE", key, max(int(duration.total_seconds()), 1))

    # -- queues ----------------------------------------------------------
    def queue(self, key: str, identifier: str) -> int:
        return int(self.client.execute("RPUSH", key, identifier))

    def pop(self, key: str) -> str:
        result = self.client.execute("LPOP", key)
        if result is None:
            raise KeyError(key)
        return result

    def queue_length(self, key: str) -> int:
        return int(self.client.execute("LLEN", key))

    def blocking_pop_copy(self, key: str, dest: str, timeout: timedelta) -> str:
        result = self.client.execute(
            "BRPOPLPUSH", key, dest, max(int(timeout.total_seconds()), 1)
        )
        if result is None:
            raise TimeoutError(key)
        return result

    def list_remove(self, key: str, value: str) -> None:
        self.client.execute("LREM", key, 0, value)

    # -- SETNX / scan / log state ---------------------------------------
    def try_set(self, key: str, value: str, life: timedelta) -> str:
        # SET NX then GET (rediscache.go:171-178)
        self.client.execute(
            "SET", key, value, "NX", "PX", max(int(life.total_seconds() * 1000), 1)
        )
        current = self.client.execute("GET", key)
        return current if current is not None else value

    def put(self, key: str, value: str,
            life: Optional[timedelta] = None) -> None:
        if life is None:
            self.client.execute("SET", key, value)
        else:
            self.client.execute(
                "SET", key, value, "PX",
                max(int(life.total_seconds() * 1000), 1),
            )

    def get(self, key: str) -> Optional[str]:
        return self.client.execute("GET", key)

    def keys_matching(self, pattern: str) -> Iterator[str]:
        cursor = "0"
        while True:
            cursor, keys = self.client.execute(
                "SCAN", cursor, "MATCH", pattern, "COUNT", 512
            )
            yield from keys
            if cursor == "0":
                break

    def store_log_state(self, log: CertificateLog) -> None:
        self.client.execute("SET", f"log::{log.short_url}", log.to_json())

    def load_log_state(self, short_url: str) -> Optional[CertificateLog]:
        raw = self.client.execute("GET", f"log::{short_url}")
        return CertificateLog.from_json(raw) if raw else None
