"""Local-disk StorageBackend: one PEM file per certificate in a
date/issuer-sharded tree.

Reference: reference storage/localdiskbackend.go — layout
`<root>/<expDate>/<issuerID>/<serialID>` (:194-199), log state JSON at
`<root>/state/<base64url(shortURL)>` (:201-210), a dirty-marker file
per day directory (:89-91), listings by directory walk (:93-139).
Unlike the reference — whose serial streaming and PEM loading are
explicitly unimplemented (:172-182, :239-242) — this backend implements
both (the TPU drain path reads serials back for parity checks).

A copy of ``ct_mapreduce_tpu.storage.localdisk``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from datetime import datetime, timezone
from pathlib import Path
from typing import Iterator, Optional

from ct_mapreduce_tpu_torch.core.types import (
    CertificateLog,
    ExpDate,
    Issuer,
    Serial,
    UniqueCertIdentifier,
    certificate_log_id_from_short_url,
)
from ct_mapreduce_tpu_torch.storage.interfaces import StorageBackend

DIRTY_MARKER = ".dirty"
STATE_DIR = "state"


class LocalDiskBackend(StorageBackend):
    def __init__(self, root_path: str | os.PathLike, file_mode: int = 0o644):
        self.root = Path(root_path)
        self.file_mode = file_mode
        self.root.mkdir(parents=True, exist_ok=True)
        (self.root / STATE_DIR).mkdir(exist_ok=True)

    # -- paths ----------------------------------------------------------
    def _exp_dir(self, exp_date: ExpDate) -> Path:
        return self.root / exp_date.id()

    def _issuer_dir(self, exp_date: ExpDate, issuer: Issuer) -> Path:
        return self._exp_dir(exp_date) / issuer.id()

    def _cert_path(self, serial: Serial, exp_date: ExpDate, issuer: Issuer) -> Path:
        return self._issuer_dir(exp_date, issuer) / serial.id()

    # -- StorageBackend -------------------------------------------------
    def mark_dirty(self, id_: str) -> None:
        # id_ is a day-directory name (filesystemdatabase.go:141-144)
        target = self.root / id_
        target.mkdir(parents=True, exist_ok=True)
        (target / DIRTY_MARKER).touch()

    def store_certificate_pem(
        self, serial: Serial, exp_date: ExpDate, issuer: Issuer, pem: bytes
    ) -> None:
        path = self._cert_path(serial, exp_date, issuer)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(pem)
        path.chmod(self.file_mode)

    def store_log_state(self, log: CertificateLog) -> None:
        path = self.root / STATE_DIR / certificate_log_id_from_short_url(log.short_url)
        path.write_text(log.to_json())

    def store_known_certificate_list(
        self, issuer: Issuer, serials: list[Serial]
    ) -> None:
        path = self.root / f"known-{issuer.id()}.json"
        path.write_text("[" + ",".join(s.to_json() for s in serials) + "]")

    def load_certificate_pem(
        self, serial: Serial, exp_date: ExpDate, issuer: Issuer
    ) -> bytes:
        return self._cert_path(serial, exp_date, issuer).read_bytes()

    def load_log_state(self, short_url: str) -> Optional[CertificateLog]:
        path = self.root / STATE_DIR / certificate_log_id_from_short_url(short_url)
        if not path.exists():
            return None
        return CertificateLog.from_json(path.read_text())

    def allocate_exp_date_and_issuer(self, exp_date: ExpDate, issuer: Issuer) -> None:
        self._issuer_dir(exp_date, issuer).mkdir(parents=True, exist_ok=True)

    def list_expiration_dates(self, not_before: datetime) -> list[ExpDate]:
        if not_before.tzinfo is None:
            not_before = not_before.replace(tzinfo=timezone.utc)
        # Truncate to midnight so same-day hour buckets are kept
        # (localdiskbackend.go:98)
        not_before = not_before.replace(hour=0, minute=0, second=0, microsecond=0)
        out = []
        for entry in sorted(self.root.iterdir()):
            if not entry.is_dir() or entry.name == STATE_DIR:
                continue
            try:
                exp = ExpDate.parse(entry.name)
            except ValueError:
                continue
            if not exp.is_expired_at(not_before):
                out.append(exp)
        return out

    def list_issuers_for_expiration_date(self, exp_date: ExpDate) -> list[Issuer]:
        exp_dir = self._exp_dir(exp_date)
        if not exp_dir.is_dir():
            return []
        return [
            Issuer.from_string(d.name)
            for d in sorted(exp_dir.iterdir())
            if d.is_dir()
        ]

    def list_serials_for_expiration_date_and_issuer(
        self, exp_date: ExpDate, issuer: Issuer
    ) -> list[Serial]:
        issuer_dir = self._issuer_dir(exp_date, issuer)
        if not issuer_dir.is_dir():
            return []
        out = []
        for f in sorted(issuer_dir.iterdir()):
            if f.name == DIRTY_MARKER or not f.is_file():
                continue
            out.append(Serial.from_id_string(f.name))
        return out

    def stream_serials_for_expiration_date_and_issuer(
        self, exp_date: ExpDate, issuer: Issuer
    ) -> Iterator[UniqueCertIdentifier]:
        for serial in self.list_serials_for_expiration_date_and_issuer(
            exp_date, issuer
        ):
            yield UniqueCertIdentifier(
                exp_date=exp_date, issuer=issuer, serial=serial
            )
