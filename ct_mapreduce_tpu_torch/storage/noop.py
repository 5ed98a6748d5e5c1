"""Null-object StorageBackend: stores succeed silently, loads fail.

Reference: reference storage/noopbackend.go (the default when no
certPath is configured — cache-only operation,
reference engine/engine.go:36-40).

A copy of ``ct_mapreduce_tpu.storage.noop``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from datetime import datetime
from typing import Iterator, Optional

from ct_mapreduce_tpu_torch.core.types import (
    CertificateLog,
    ExpDate,
    Issuer,
    Serial,
    UniqueCertIdentifier,
)
from ct_mapreduce_tpu_torch.storage.interfaces import StorageBackend


class NoopBackend(StorageBackend):
    def mark_dirty(self, id_: str) -> None:
        pass

    def store_certificate_pem(self, serial, exp_date, issuer, pem) -> None:
        pass

    def store_log_state(self, log: CertificateLog) -> None:
        pass

    def store_known_certificate_list(self, issuer, serials) -> None:
        pass

    def load_certificate_pem(self, serial, exp_date, issuer) -> bytes:
        raise NotImplementedError("NoopBackend does not store certificates")

    def load_log_state(self, log_url: str) -> Optional[CertificateLog]:
        return None

    def allocate_exp_date_and_issuer(self, exp_date, issuer) -> None:
        pass

    def list_expiration_dates(self, not_before: datetime) -> list[ExpDate]:
        return []

    def list_issuers_for_expiration_date(self, exp_date: ExpDate) -> list[Issuer]:
        return []

    def list_serials_for_expiration_date_and_issuer(
        self, exp_date: ExpDate, issuer: Issuer
    ) -> list[Serial]:
        return []

    def stream_serials_for_expiration_date_and_issuer(
        self, exp_date: ExpDate, issuer: Issuer
    ) -> Iterator[UniqueCertIdentifier]:
        return iter(())
