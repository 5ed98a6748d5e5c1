"""Storage-layer interfaces.

Direct analogs of the reference's three seams
(reference storage/types.go:46-102): `StorageBackend` (durable
PEM/log-state storage), `RemoteCache` (shared-state fabric: sets,
queues, TTLs, SETNX, key scan), and `CertDatabase` (the facade the
ingest engine calls per certificate).

A copy of ``ct_mapreduce_tpu.storage.interfaces``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import abc
from datetime import datetime, timedelta
from typing import Callable, Iterable, Iterator, Optional

from ct_mapreduce_tpu_torch.core.types import (
    CertificateLog,
    ExpDate,
    Issuer,
    IssuerDate,
    Serial,
    UniqueCertIdentifier,
)


class RemoteCache(abc.ABC):
    """Shared mutable state fabric. Reference: storage/types.go:83-102.

    Set members and values are `str` (binary-safe via latin-1 where
    callers store raw serial bytes, matching Go's string-as-bytes).
    """

    @abc.abstractmethod
    def exists(self, key: str) -> bool: ...

    @abc.abstractmethod
    def set_insert(self, key: str, entry: str) -> bool:
        """Insert into a set; True iff the entry was newly added."""

    @abc.abstractmethod
    def set_remove(self, key: str, entry: str) -> bool: ...

    @abc.abstractmethod
    def set_contains(self, key: str, entry: str) -> bool: ...

    @abc.abstractmethod
    def set_list(self, key: str) -> list[str]: ...

    @abc.abstractmethod
    def set_to_iter(self, key: str) -> Iterator[str]:
        """Stream set members; may yield duplicates (Redis SSCAN
        semantics — the reference documents and tolerates this,
        storage/knowncertificates.go:66-68)."""

    @abc.abstractmethod
    def set_cardinality(self, key: str) -> int: ...

    @abc.abstractmethod
    def expire_at(self, key: str, exp_time: datetime) -> None: ...

    @abc.abstractmethod
    def expire_in(self, key: str, duration: timedelta) -> None: ...

    @abc.abstractmethod
    def queue(self, key: str, identifier: str) -> int:
        """RPUSH; returns resulting queue length."""

    @abc.abstractmethod
    def pop(self, key: str) -> str:
        """LPOP; raises KeyError when empty."""

    @abc.abstractmethod
    def queue_length(self, key: str) -> int: ...

    @abc.abstractmethod
    def blocking_pop_copy(self, key: str, dest: str, timeout: timedelta) -> str:
        """BRPOPLPUSH; raises TimeoutError on timeout."""

    @abc.abstractmethod
    def list_remove(self, key: str, value: str) -> None: ...

    @abc.abstractmethod
    def try_set(self, key: str, value: str, life: timedelta) -> str:
        """SETNX+GET: attempt to set; return the value now present
        (ours if we won, the incumbent's otherwise). Reference:
        storage/rediscache.go:171-178."""

    @abc.abstractmethod
    def put(self, key: str, value: str,
            life: Optional[timedelta] = None) -> None:
        """Unconditional SET, optionally with a TTL. The fleet
        coordinator's heartbeat/epoch primitives (ingest/fleet.py)
        need a last-writer-wins value slot — try_set (NX) can only
        publish a value once per key lifetime."""

    @abc.abstractmethod
    def get(self, key: str) -> Optional[str]:
        """Plain GET; None when absent or expired."""

    @abc.abstractmethod
    def keys_matching(self, pattern: str) -> Iterator[str]:
        """Stream keys matching a glob pattern (SCAN semantics)."""

    @abc.abstractmethod
    def store_log_state(self, log: CertificateLog) -> None: ...

    @abc.abstractmethod
    def load_log_state(self, short_url: str) -> Optional[CertificateLog]: ...


class StorageBackend(abc.ABC):
    """Durable storage. Reference: storage/types.go:46-68."""

    @abc.abstractmethod
    def mark_dirty(self, id_: str) -> None: ...

    @abc.abstractmethod
    def store_certificate_pem(
        self, serial: Serial, exp_date: ExpDate, issuer: Issuer, pem: bytes
    ) -> None: ...

    @abc.abstractmethod
    def store_log_state(self, log: CertificateLog) -> None: ...

    @abc.abstractmethod
    def store_known_certificate_list(
        self, issuer: Issuer, serials: list[Serial]
    ) -> None: ...

    @abc.abstractmethod
    def load_certificate_pem(
        self, serial: Serial, exp_date: ExpDate, issuer: Issuer
    ) -> bytes: ...

    @abc.abstractmethod
    def load_log_state(self, log_url: str) -> Optional[CertificateLog]: ...

    @abc.abstractmethod
    def allocate_exp_date_and_issuer(
        self, exp_date: ExpDate, issuer: Issuer
    ) -> None: ...

    @abc.abstractmethod
    def list_expiration_dates(self, not_before: datetime) -> list[ExpDate]: ...

    @abc.abstractmethod
    def list_issuers_for_expiration_date(self, exp_date: ExpDate) -> list[Issuer]: ...

    @abc.abstractmethod
    def list_serials_for_expiration_date_and_issuer(
        self, exp_date: ExpDate, issuer: Issuer
    ) -> list[Serial]: ...

    @abc.abstractmethod
    def stream_serials_for_expiration_date_and_issuer(
        self, exp_date: ExpDate, issuer: Issuer
    ) -> Iterator[UniqueCertIdentifier]: ...


class CertDatabase(abc.ABC):
    """The facade the sync engine stores through.

    Reference: storage/types.go:70-81.
    """

    @abc.abstractmethod
    def cleanup(self) -> None: ...

    @abc.abstractmethod
    def save_log_state(self, log: CertificateLog) -> None: ...

    @abc.abstractmethod
    def get_log_state(self, short_url: str) -> CertificateLog: ...

    @abc.abstractmethod
    def store(
        self,
        cert_der: bytes,
        issuer_der: bytes,
        log_url: str,
        entry_id: int,
    ) -> None:
        """Per-certificate map+reduce: dedup, metadata accumulation,
        allocation, PEM store, dirty-mark. Reference:
        storage/filesystemdatabase.go:158-211. Takes raw DER (the
        TPU-native framework's interchange format) rather than parsed
        objects."""

    @abc.abstractmethod
    def list_expiration_dates(self, not_before: datetime) -> list[ExpDate]: ...

    @abc.abstractmethod
    def list_issuers_for_expiration_date(self, exp_date: ExpDate) -> list[Issuer]: ...

    @abc.abstractmethod
    def get_known_certificates(
        self, exp_date: ExpDate, issuer: Issuer
    ) -> "KnownCertificates": ...

    @abc.abstractmethod
    def get_issuer_metadata(self, issuer: Issuer) -> "IssuerMetadata": ...

    @abc.abstractmethod
    def get_issuer_and_dates_from_cache(self) -> list[IssuerDate]: ...


def short_url_of(log_url: str) -> str:
    """Normalize a CT log URL to its short form (scheme stripped,
    trailing slash removed) — the reference keys log state by this
    (see cmd/ct-fetch/ct-fetch.go:253-257 usage of url.Host+url.Path)."""
    u = log_url.strip()
    for prefix in ("https://", "http://"):
        if u.startswith(prefix):
            u = u[len(prefix) :]
            break
    return u.rstrip("/")
