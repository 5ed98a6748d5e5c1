"""CT log v1 HTTP API client.

Mirrors the reference's use of certificate-transparency-go's
``client.New`` + ``GetSTH`` + ``GetRawEntries``
(reference cmd/ct-fetch/ct-fetch.go:249-274,416-424):

- entries are fetched in ranges of up to 1000 per request
  (ct-fetch.go:417); the server may return fewer — callers advance by
  what they got, and the client remembers the server's observed page
  size so later windows ask for what the log actually serves (real
  logs cap get-entries far below the spec maximum);
- HTTP 429 AND transient 5xx (500/502/503/504 — real logs shed load
  with these at least as often as with 429) trigger a jittered
  exponential backoff of 500 ms – 5 min and a retry of the same range
  (ct-fetch.go:409-437), honoring Retry-After when present; retries
  are counted under ``ingest.retry.*`` by status;
- other HTTP errors raise and are handled by the caller's
  log-level error policy.

The transport is injectable — ``transport(url) -> (status, headers,
body)`` — so tests and the zero-egress benchmark environment can serve
synthetic logs without sockets; the default uses urllib.

A copy of ``ct_mapreduce_tpu.ingest.ctclient``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Callable, Optional

from ct_mapreduce_tpu_torch.telemetry.metrics import incr_counter, measure
from ct_mapreduce_tpu_torch.utils.backoff import JitteredBackoff

BATCH_SIZE = 1000  # entries per get-entries request (ct-fetch.go:417)

# Statuses retried with backoff instead of raised: rate limiting plus
# the transient 5xx family production logs answer under load.
RETRYABLE_STATUSES = frozenset({429, 500, 502, 503, 504})

Transport = Callable[[str], tuple[int, dict, bytes]]


def short_url(url: str) -> str:
    """Log URL without scheme or trailing slash — the reference's
    ShortURL identity (storage/types.go checkpoint keying)."""
    for prefix in ("https://", "http://"):
        if url.startswith(prefix):
            url = url[len(prefix) :]
            break
    return url.rstrip("/")


def _urllib_transport(url: str) -> tuple[int, dict, bytes]:
    req = urllib.request.Request(
        url, headers={"User-Agent": "ct-mapreduce-tpu/0.1"}
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers or {}), err.read()


@dataclass
class SignedTreeHead:
    tree_size: int
    timestamp_ms: int
    sha256_root_hash: str = ""
    tree_head_signature: str = ""


@dataclass
class RawEntry:
    index: int
    leaf_input: str  # base64, as served
    extra_data: str


class CTClientError(RuntimeError):
    def __init__(self, url: str, status: int, body: bytes):
        super().__init__(f"HTTP {status} from {url}: {body[:200]!r}")
        self.status = status


class CTLogClient:
    """One CT log endpoint, normalized to ``https://`` when no scheme
    is given (the reference's config takes full URLs)."""

    def __init__(
        self,
        log_url: str,
        transport: Optional[Transport] = None,
        sleep: Callable[[float], None] = time.sleep,
        max_retries: int = 100,
    ):
        if "://" not in log_url:
            log_url = "https://" + log_url
        self.log_url = log_url.rstrip("/")
        self.short_url = short_url(log_url)
        self.transport = transport or _urllib_transport
        self.sleep = sleep
        self.max_retries = max_retries
        # Adaptive get-entries window: starts at the spec maximum and
        # clamps down to the page size the server actually returns.
        self.page_size = BATCH_SIZE

    # -- plumbing --------------------------------------------------------
    def _get_json(self, path: str) -> dict:
        url = f"{self.log_url}/ct/v1/{path}"
        backoff = JitteredBackoff(min_s=0.5, max_s=300.0)
        status = 429
        for _ in range(self.max_retries):
            status, headers, body = self.transport(url)
            if status == 200:
                return json.loads(body)
            if status in RETRYABLE_STATUSES:
                # ct-fetch.go:426-437: jittered 500ms-5min, honor
                # Retry-After seconds when the server sends one. 5xx
                # takes the exact same lane — a 503 from an overloaded
                # log is rate limiting by another name.
                if status == 429:
                    incr_counter("LogWorker", self.short_url, "429")
                incr_counter("ingest", "retry", str(status))
                retry_after = next(
                    (v for k, v in headers.items()
                     if k.lower() == "retry-after"),
                    None,
                )
                if retry_after:
                    try:
                        # Clamp to the 500ms-5min window — a hostile value
                        # must neither stall the downloader for hours nor
                        # turn the retry loop into a zero-delay hammer.
                        delay = min(max(float(retry_after), backoff.min_s),
                                    backoff.max_s)
                    except ValueError:
                        delay = backoff.duration()
                else:
                    delay = backoff.duration()
                self.sleep(delay)
                continue
            raise CTClientError(url, status, body)
        incr_counter("ingest", "retry", "giveup")
        raise CTClientError(url, status, b"retry budget exhausted")

    # -- API -------------------------------------------------------------
    def get_sth(self) -> SignedTreeHead:
        with measure("LogWorker", self.short_url, "getSTH"):
            obj = self._get_json("get-sth")
        return SignedTreeHead(
            tree_size=int(obj["tree_size"]),
            timestamp_ms=int(obj.get("timestamp", 0)),
            sha256_root_hash=obj.get("sha256_root_hash", ""),
            tree_head_signature=obj.get("tree_head_signature", ""),
        )

    def get_raw_entries(self, start: int, end: int) -> list[RawEntry]:
        """Entries ``[start, end]`` inclusive, like ct-go's
        GetRawEntries; the server may truncate the range. The first
        truncated response clamps this client's window to the page
        size the server demonstrated, so every later request asks for
        exactly what the log serves instead of re-discovering the cap
        one oversized range at a time."""
        if end < start:
            return []
        end = min(end, start + self.page_size - 1)
        with measure("LogWorker", self.short_url, "getRawEntries"):
            obj = self._get_json(f"get-entries?start={start}&end={end}")
        entries = obj.get("entries", [])
        if 0 < len(entries) < end - start + 1:
            # Short page on a full-window ask: adopt the server's size.
            if len(entries) < self.page_size:
                self.page_size = len(entries)
                incr_counter("ingest", "window_clamp")
        return [
            RawEntry(
                index=start + i,
                leaf_input=e["leaf_input"],
                extra_data=e.get("extra_data", ""),
            )
            for i, e in enumerate(entries)
        ]

    def get_entry_and_proof(self, index: int, tree_size: int) -> dict:
        """ct-getcert's fetch path (get-entry-and-proof)."""
        return self._get_json(
            f"get-entry-and-proof?leaf_index={index}&tree_size={tree_size}"
        )
