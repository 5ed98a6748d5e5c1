"""FilesystemDatabase: the host-path CertDatabase implementation.

Reference: reference storage/filesystemdatabase.go — per-cert
`store` orchestrates dedup → metadata accumulation → directory
allocation → PEM store → dirty-mark (:158-211); log state is
dual-written to cache and backend with cache-first reads (:110-139);
KnownCertificates handles are cached (8,192-entry ARC, :32 — here an
LRU); GetIssuerAndDatesFromCache enumerates `serials::*` keys
(:59-100).

This host path is the behavioral baseline the device pipeline is checked
against ("issuer-count parity"); the batched device path lives in
ct_mapreduce_tpu_torch.agg.aggregator.

A copy of ``ct_mapreduce_tpu.storage.certdb``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from datetime import datetime
from typing import Optional

from ct_mapreduce_tpu_torch.core import der as derlib
from ct_mapreduce_tpu_torch.core.types import (
    CertificateLog,
    ExpDate,
    Issuer,
    IssuerDate,
    Serial,
)
from ct_mapreduce_tpu_torch.storage.interfaces import (
    CertDatabase,
    RemoteCache,
    StorageBackend,
)
from ct_mapreduce_tpu_torch.storage.issuermetadata import IssuerMetadata
from ct_mapreduce_tpu_torch.storage.knowncerts import SERIALS_PREFIX, KnownCertificates
from ct_mapreduce_tpu_torch.telemetry import metrics

KNOWN_CERTS_CACHE_SIZE = 8192  # filesystemdatabase.go:32


class _LRU:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self._data: OrderedDict[str, KnownCertificates] = OrderedDict()
        self._lock = threading.Lock()

    def get_or_create(self, key: str, factory) -> KnownCertificates:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                return self._data[key]
            value = factory()
            self._data[key] = value
            if len(self._data) > self.capacity:
                self._data.popitem(last=False)
            return value


class FilesystemDatabase(CertDatabase):
    def __init__(self, backend: StorageBackend, ext_cache: RemoteCache):
        self.backend = backend
        self.ext_cache = ext_cache
        self._known_certs = _LRU(KNOWN_CERTS_CACHE_SIZE)
        self._issuer_metadata: dict[str, IssuerMetadata] = {}
        self._meta_lock = threading.RLock()
        # Distinct issuer certs are few; memoize DER -> Issuer so the
        # per-entry hot path doesn't re-walk the issuer TLV tree.
        self._issuer_by_der: dict[bytes, Issuer] = {}

    # -- log state ------------------------------------------------------
    def save_log_state(self, log: CertificateLog) -> None:
        # Dual write: cache + backend (filesystemdatabase.go:110-118)
        self.ext_cache.store_log_state(log)
        self.backend.store_log_state(log)

    def get_log_state(self, short_url: str) -> CertificateLog:
        # Cache first, backend fallback (filesystemdatabase.go:120-139)
        log = self.ext_cache.load_log_state(short_url)
        if log is None:
            log = self.backend.load_log_state(short_url)
        if log is None:
            log = CertificateLog(short_url=short_url)
        return log

    # -- the per-cert map+reduce ---------------------------------------
    def store(
        self, cert_der: bytes, issuer_der: bytes, log_url: str, entry_id: int
    ) -> None:
        with metrics.measure("FilesystemDatabase", "Store"):
            fields = derlib.parse_cert(cert_der)
            issuer = self._issuer_by_der.get(issuer_der)
            if issuer is None:
                issuer = Issuer.from_spki(derlib.parse_cert(issuer_der).spki)
                self._issuer_by_der[issuer_der] = issuer
            self.store_parsed(
                serial=Serial(fields.serial),
                exp_date=ExpDate.from_time(fields.not_after),
                issuer=issuer,
                issuer_dn=fields.issuer_dn,
                crl_dps=fields.crl_distribution_points,
                cert_der=cert_der,
            )

    def store_parsed(
        self,
        serial: Serial,
        exp_date: ExpDate,
        issuer: Issuer,
        issuer_dn: str,
        crl_dps: list[str],
        cert_der: Optional[bytes] = None,
    ) -> None:
        """The reduce step on already-extracted fields — the same
        sequencing as filesystemdatabase.go:158-211, callable directly
        by the batched pipeline's drain."""
        known_certs = self.get_known_certificates(exp_date, issuer)
        if known_certs.was_unknown(serial):
            meta = self.get_issuer_metadata(issuer)
            seen_exp_date_before = meta.accumulate(exp_date, issuer_dn, crl_dps)
            if not seen_exp_date_before:
                self.backend.allocate_exp_date_and_issuer(exp_date, issuer)
            if cert_der is not None:
                self.backend.store_certificate_pem(
                    serial, exp_date, issuer, derlib.der_to_pem(cert_der)
                )
            metrics.incr_counter("FilesystemDatabase", "StoreUnknown")
        # Dirty-mark the expiry day (filesystemdatabase.go:141-144,204-208)
        self.backend.mark_dirty(exp_date.date.strftime("%Y-%m-%d"))

    # -- handles --------------------------------------------------------
    def get_known_certificates(
        self, exp_date: ExpDate, issuer: Issuer
    ) -> KnownCertificates:
        key = f"{exp_date.id()}::{issuer.id()}"
        return self._known_certs.get_or_create(
            key, lambda: KnownCertificates(exp_date, issuer, self.ext_cache)
        )

    def get_issuer_metadata(self, issuer: Issuer) -> IssuerMetadata:
        with self._meta_lock:
            meta = self._issuer_metadata.get(issuer.id())
            if meta is None:
                meta = IssuerMetadata(issuer, self.ext_cache)
                self._issuer_metadata[issuer.id()] = meta
            return meta

    # -- enumeration ----------------------------------------------------
    def get_issuer_and_dates_from_cache(self) -> list[IssuerDate]:
        # Scan serials::<exp>::<issuer> keys (filesystemdatabase.go:59-100)
        grouped: dict[str, list[ExpDate]] = {}
        for key in self.ext_cache.keys_matching(f"{SERIALS_PREFIX}::*"):
            parts = key.split("::")
            if len(parts) != 3:
                continue
            try:
                exp = ExpDate.parse(parts[1])
            except ValueError:
                continue
            grouped.setdefault(parts[2], []).append(exp)
        return [
            IssuerDate(issuer=Issuer.from_string(issuer_id), exp_dates=sorted(dates))
            for issuer_id, dates in sorted(grouped.items())
        ]

    def list_expiration_dates(self, not_before: datetime) -> list[ExpDate]:
        return self.backend.list_expiration_dates(not_before)

    def list_issuers_for_expiration_date(self, exp_date: ExpDate) -> list[Issuer]:
        return self.backend.list_issuers_for_expiration_date(exp_date)

    def cleanup(self) -> None:
        pass
