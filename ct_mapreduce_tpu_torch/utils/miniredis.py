"""A minimal in-process RESP2 server for exercising the socket client
(a copy of ``ct_mapreduce_tpu.utils.miniredis``).

The reference gates its Redis tier on a real server being present
(reference storage/rediscache_test.go:16-28); where no redis-server is
installed that tier would never run. This server implements exactly the
command surface RedisCache (ct_mapreduce_tpu_torch/storage/rediscache.py)
speaks — sets, TTLs, queues with blocking pop, SET NX PX, SCAN/SSCAN
cursors, INFO memory — with REAL Redis semantics (BRPOPLPUSH pops the
source tail and pushes the destination head; SADD returns the number of
new members; expiry is lazy), so the live tier runs by default and a
genuine server can still be swapped in via ``RedisHost``.

Test-support knobs the real server can't offer:
- ``scan_duplicate=True`` replays one member per SSCAN page, modeling
  Redis's documented may-return-duplicates contract
  (reference storage/knowncertificates.go:66-68).
- ``set_oom(True)`` makes every allocating write return ``-OOM ...``,
  driving the client's fatal-on-OOM path (rediscache.go:57-65 parity).
- ``stop()``/``start()`` on the same port drives reconnect-after-kill.

NOT a Redis replacement: single-node, no persistence, no pub/sub, no
cluster, string-typed values only.
"""

from __future__ import annotations

import bisect
import fnmatch
import socket
import threading
import time


class _Conn:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""

    def read_line(self) -> bytes:
        while b"\r\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("client closed")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def read_exact(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("client closed")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def read_command(self) -> list[str]:
        line = self.read_line()
        if not line.startswith(b"*"):
            raise ConnectionError(f"expected array, got {line!r}")
        n = int(line[1:])
        args = []
        for _ in range(n):
            hdr = self.read_line()
            if not hdr.startswith(b"$"):
                raise ConnectionError(f"expected bulk, got {hdr!r}")
            ln = int(hdr[1:])
            args.append(self.read_exact(ln).decode("latin-1"))
            self.read_exact(2)
        return args


def _bulk(s: str | None) -> bytes:
    if s is None:
        return b"$-1\r\n"
    raw = s.encode("latin-1")
    return b"$%d\r\n%s\r\n" % (len(raw), raw)


def _array(items: list[bytes]) -> bytes:
    return b"*%d\r\n%s" % (len(items), b"".join(items))


# Commands denied under OOM: real Redis only rejects commands flagged
# may-use-memory; memory-FREEING commands (DEL, SREM, LPOP, LREM,
# EXPIRE...) always succeed so clients can dig themselves out.
_OOM_DENIED = {"SADD", "RPUSH", "SET", "BRPOPLPUSH"}


class MiniRedis:
    def __init__(self, port: int = 0, scan_duplicate: bool = False,
                 maxmemory_policy: str = "noeviction"):
        self.port = port
        self.scan_duplicate = scan_duplicate
        self.maxmemory_policy = maxmemory_policy
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._data: dict[str, object] = {}  # str | set[str] | list[str]
        self._expiry: dict[str, float] = {}
        self._oom = False
        self._listener: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self._running = False

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "MiniRedis":
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", self.port))
        self.port = self._listener.getsockname()[1]
        self._listener.listen(64)
        self._running = True
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="miniredis-accept")
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        """Kill the listener and every live connection (keeps data, so a
        later start() on the same port models a server restart)."""
        self._running = False
        if self._listener is not None:
            try:
                # Wake the thread blocked in accept() (plain close()
                # leaves it blocked and the port in LISTEN forever).
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        for sock in self._conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._conns.clear()
        with self._cond:
            self._cond.notify_all()

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def set_oom(self, value: bool) -> None:
        self._oom = value

    # -- internals -------------------------------------------------------

    def _accept_loop(self) -> None:
        listener = self._listener
        while self._running and listener is not None:
            try:
                sock, _ = listener.accept()
            except OSError:
                return
            self._conns.append(sock)
            t = threading.Thread(target=self._serve, args=(sock,),
                                 daemon=True, name="miniredis-conn")
            t.start()
            self._threads.append(t)

    def _serve(self, sock: socket.socket) -> None:
        conn = _Conn(sock)
        try:
            while self._running:
                args = conn.read_command()
                sock.sendall(self._dispatch(args))
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _purge(self, key: str) -> None:
        exp = self._expiry.get(key)
        if exp is not None and time.time() >= exp:
            self._data.pop(key, None)
            self._expiry.pop(key, None)

    def _peek(self, key: str, kind: type) -> object:
        """Read without materializing (real Redis never creates a key
        on a read path): missing → fresh empty container NOT stored."""
        self._purge(key)
        val = self._data.get(key)
        if val is None:
            return kind()
        if not isinstance(val, kind):
            raise TypeError(key)
        return val

    def _mutate(self, key: str, kind: type) -> object:
        """Write path: materialize the container in _data."""
        self._purge(key)
        val = self._data.get(key)
        if val is None:
            val = kind()
            self._data[key] = val
        if not isinstance(val, kind):
            raise TypeError(key)
        return val

    def _drop_if_empty(self, key: str) -> None:
        """Real Redis deletes sets/lists that become empty."""
        val = self._data.get(key)
        if isinstance(val, (set, list)) and not val:
            del self._data[key]
            self._expiry.pop(key, None)

    def _dispatch(self, args: list[str]) -> bytes:
        cmd = args[0].upper()
        if self._oom and cmd in _OOM_DENIED:
            return (b"-OOM command not allowed when used memory > "
                    b"'maxmemory'.\r\n")
        with self._lock:
            try:
                return self._run(cmd, args[1:])
            except TypeError as err:
                return (b"-WRONGTYPE Operation against a key holding "
                        b"the wrong kind of value (%s)\r\n"
                        % str(err).encode("latin-1"))

    def _run(self, cmd: str, a: list[str]) -> bytes:  # noqa: C901
        if cmd == "PING":
            return b"+PONG\r\n"
        if cmd == "INFO":
            body = (f"# Memory\r\nused_memory:{len(self._data)}\r\n"
                    f"maxmemory_policy:{self.maxmemory_policy}\r\n")
            return _bulk(body)
        if cmd == "EXISTS":
            self._purge(a[0])
            return b":%d\r\n" % (1 if a[0] in self._data else 0)
        if cmd == "DEL":
            n = 0
            for key in a:
                self._purge(key)
                if self._data.pop(key, None) is not None:
                    n += 1
                self._expiry.pop(key, None)
            return b":%d\r\n" % n

        # -- sets --------------------------------------------------------
        if cmd == "SADD":
            s = self._mutate(a[0], set)
            added = sum(1 for m in a[1:] if m not in s)
            s.update(a[1:])
            return b":%d\r\n" % added
        if cmd == "SREM":
            s = self._peek(a[0], set)
            removed = sum(1 for m in a[1:] if m in s)
            s.difference_update(a[1:])
            self._drop_if_empty(a[0])
            return b":%d\r\n" % removed
        if cmd == "SISMEMBER":
            return b":%d\r\n" % (1 if a[1] in self._peek(a[0], set) else 0)
        if cmd == "SMEMBERS":
            return _array([_bulk(m) for m in sorted(self._peek(a[0], set))])
        if cmd == "SCARD":
            return b":%d\r\n" % len(self._peek(a[0], set))
        if cmd == "SSCAN":
            members = sorted(self._peek(a[0], set))
            return self._scan_page(members, a[1], a[2:])

        # -- TTLs --------------------------------------------------------
        if cmd == "EXPIRE":
            return self._set_expiry(a[0], time.time() + int(a[1]))
        if cmd == "EXPIREAT":
            return self._set_expiry(a[0], int(a[1]))

        # -- lists / queues ---------------------------------------------
        if cmd == "RPUSH":
            lst = self._mutate(a[0], list)
            lst.extend(a[1:])
            self._cond.notify_all()
            return b":%d\r\n" % len(lst)
        if cmd == "LPOP":
            lst = self._peek(a[0], list)
            if not lst:
                return _bulk(None)
            val = lst.pop(0)
            self._drop_if_empty(a[0])
            return _bulk(val)
        if cmd == "LLEN":
            return b":%d\r\n" % len(self._peek(a[0], list))
        if cmd == "LREM":
            lst = self._peek(a[0], list)
            # count 0: remove all occurrences (the only form the client uses)
            kept = [x for x in lst if x != a[2]]
            if a[0] in self._data:
                self._data[a[0]] = kept
            self._drop_if_empty(a[0])
            return b":%d\r\n" % (len(lst) - len(kept))
        if cmd == "BRPOPLPUSH":
            deadline = time.time() + float(a[2])
            while True:
                src = self._peek(a[0], list)
                if src:
                    # Real semantics: source TAIL → destination HEAD.
                    val = src.pop()
                    self._drop_if_empty(a[0])
                    self._mutate(a[1], list).insert(0, val)
                    return _bulk(val)
                if not self._running:
                    return _bulk(None)
                remaining = deadline - time.time()
                if remaining <= 0:
                    return _bulk(None)
                self._cond.wait(min(remaining, 0.25))

        # -- strings / SETNX / scan -------------------------------------
        if cmd == "SET":
            key, value, opts = a[0], a[1], [o.upper() for o in a[2:]]
            self._purge(key)
            if "NX" in opts and key in self._data:
                return _bulk(None)
            self._data[key] = value
            self._expiry.pop(key, None)
            for i, o in enumerate(opts):
                if o == "PX":
                    self._expiry[key] = time.time() + int(a[2 + i + 1]) / 1e3
                elif o == "EX":
                    self._expiry[key] = time.time() + int(a[2 + i + 1])
            return b"+OK\r\n"
        if cmd == "GET":
            self._purge(a[0])
            val = self._data.get(a[0])
            if val is not None and not isinstance(val, str):
                raise TypeError(a[0])
            return _bulk(val)
        if cmd == "SCAN":
            pattern = "*"
            rest = a[1:]
            for i, o in enumerate(rest):
                if o.upper() == "MATCH":
                    pattern = rest[i + 1]
            for key in list(self._data):
                self._purge(key)
            keys = sorted(k for k in self._data
                          if fnmatch.fnmatchcase(k, pattern))
            return self._scan_page(keys, a[0], a[1:])

        return b"-ERR unknown command '%s'\r\n" % cmd.encode("latin-1")

    def _set_expiry(self, key: str, when: float) -> bytes:
        self._purge(key)
        if key not in self._data:
            return b":0\r\n"
        self._expiry[key] = when
        return b":1\r\n"

    def _scan_page(self, items: list[str], cursor: str,
                   opts: list[str]) -> bytes:
        count = 10
        for i, o in enumerate(opts):
            if o.upper() == "COUNT":
                count = int(opts[i + 1])
        if self.scan_duplicate:
            # Force multi-page cursoring so the duplicate replay below
            # actually happens regardless of the client's COUNT hint
            # (COUNT is advisory in Redis anyway).
            count = min(count, 16)
        # The cursor names the last member returned ("1:<member>"), not a
        # numeric index: a deletion between pages must not shift later
        # members past the cursor (Redis guarantees elements present for
        # the whole scan are returned at least once). Clients treat the
        # cursor as opaque, comparing only against "0" — as real Redis
        # requires.
        if cursor == "0":
            start, prev = 0, None
        else:
            prev = cursor[2:]
            start = bisect.bisect_right(items, prev)
        page = items[start:start + count]
        next_cursor = "0" if not page or start + count >= len(items) \
            else "1:" + page[-1]
        if self.scan_duplicate and prev is not None and items:
            # Model Redis's may-return-duplicates contract: replay the
            # last member of the previous page at the head of this one.
            page = [prev] + page
        return _array([_bulk(next_cursor),
                       _array([_bulk(m) for m in page])])
