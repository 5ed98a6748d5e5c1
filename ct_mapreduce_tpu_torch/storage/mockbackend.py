"""In-memory StorageBackend for tests.

Reference: reference storage/mockbackend.go — maps for
expDate→issuers, (expDate, issuer)→serials, and a byte store.

A copy of ``ct_mapreduce_tpu.storage.mockbackend``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Iterator, Optional

from ct_mapreduce_tpu_torch.core.types import (
    CertificateLog,
    ExpDate,
    Issuer,
    Serial,
    UniqueCertIdentifier,
)
from ct_mapreduce_tpu_torch.storage.interfaces import StorageBackend


class MockBackend(StorageBackend):
    def __init__(self):
        self.dirty: set[str] = set()
        self.exp_dates: dict[str, ExpDate] = {}
        self.issuers: dict[str, set[str]] = {}  # expDate id -> issuer ids
        self.serials: dict[tuple[str, str], dict[str, Serial]] = {}
        self.pems: dict[tuple[str, str, str], bytes] = {}
        self.log_states: dict[str, str] = {}
        self.known_lists: dict[str, list[Serial]] = {}

    def mark_dirty(self, id_: str) -> None:
        self.dirty.add(id_)

    def store_certificate_pem(
        self, serial: Serial, exp_date: ExpDate, issuer: Issuer, pem: bytes
    ) -> None:
        self.allocate_exp_date_and_issuer(exp_date, issuer)
        self.serials.setdefault((exp_date.id(), issuer.id()), {})[serial.id()] = serial
        self.pems[(exp_date.id(), issuer.id(), serial.id())] = bytes(pem)

    def store_log_state(self, log: CertificateLog) -> None:
        self.log_states[log.short_url] = log.to_json()

    def store_known_certificate_list(
        self, issuer: Issuer, serials: list[Serial]
    ) -> None:
        self.known_lists[issuer.id()] = list(serials)

    def load_certificate_pem(
        self, serial: Serial, exp_date: ExpDate, issuer: Issuer
    ) -> bytes:
        try:
            return self.pems[(exp_date.id(), issuer.id(), serial.id())]
        except KeyError as exc:
            raise FileNotFoundError(str(exc)) from exc

    def load_log_state(self, short_url: str) -> Optional[CertificateLog]:
        raw = self.log_states.get(short_url)
        return CertificateLog.from_json(raw) if raw else None

    def allocate_exp_date_and_issuer(self, exp_date: ExpDate, issuer: Issuer) -> None:
        self.exp_dates[exp_date.id()] = exp_date
        self.issuers.setdefault(exp_date.id(), set()).add(issuer.id())
        self.serials.setdefault((exp_date.id(), issuer.id()), {})

    def list_expiration_dates(self, not_before: datetime) -> list[ExpDate]:
        if not_before.tzinfo is None:
            not_before = not_before.replace(tzinfo=timezone.utc)
        # Midnight truncation keeps same-day hour buckets (localdiskbackend.go:98)
        not_before = not_before.replace(hour=0, minute=0, second=0, microsecond=0)
        return sorted(
            (e for e in self.exp_dates.values() if not e.is_expired_at(not_before)),
        )

    def list_issuers_for_expiration_date(self, exp_date: ExpDate) -> list[Issuer]:
        return [
            Issuer.from_string(i) for i in sorted(self.issuers.get(exp_date.id(), ()))
        ]

    def list_serials_for_expiration_date_and_issuer(
        self, exp_date: ExpDate, issuer: Issuer
    ) -> list[Serial]:
        return sorted(self.serials.get((exp_date.id(), issuer.id()), {}).values())

    def stream_serials_for_expiration_date_and_issuer(
        self, exp_date: ExpDate, issuer: Issuer
    ) -> Iterator[UniqueCertIdentifier]:
        for serial in self.list_serials_for_expiration_date_and_issuer(
            exp_date, issuer
        ):
            yield UniqueCertIdentifier(exp_date=exp_date, issuer=issuer, serial=serial)
