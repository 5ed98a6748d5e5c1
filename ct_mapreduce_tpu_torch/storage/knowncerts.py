"""Per-(expDate, issuer) serial dedup set.

Reference: reference storage/knowncertificates.go. Key format
`serials::<expDate>::<issuerID>`; `was_unknown` is a set-insert whose
"newly added" result is the dedup bit; the key's TTL is set once to the
bucket's expiry time so Redis self-prunes expired buckets.

Serials are stored as raw bytes rendered latin-1 (Go stores the raw
byte string, knowncertificates.go:39).

A copy of ``ct_mapreduce_tpu.storage.knowncerts``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from ct_mapreduce_tpu_torch.core.types import ExpDate, Issuer, Serial
from ct_mapreduce_tpu_torch.storage.interfaces import RemoteCache

SERIALS_PREFIX = "serials"


def serials_key(exp_date: ExpDate, issuer: Issuer) -> str:
    return f"{SERIALS_PREFIX}::{exp_date.id()}::{issuer.id()}"


class KnownCertificates:
    def __init__(self, exp_date: ExpDate, issuer: Issuer, cache: RemoteCache):
        self.exp_date = exp_date
        self.issuer = issuer
        self.cache = cache
        self._expiry_set = False

    def id(self) -> str:
        return f"{self.exp_date.id()}::{self.issuer.id()}"

    def serial_id(self) -> str:
        return serials_key(self.exp_date, self.issuer)

    def was_unknown(self, serial: Serial) -> bool:
        """True iff this serial had not been seen before; subsequent
        calls with the same serial return False
        (knowncertificates.go:38-55)."""
        result = self.cache.set_insert(
            self.serial_id(), serial.binary_string().decode("latin-1")
        )
        if not self._expiry_set:
            self.cache.expire_at(self.serial_id(), self.exp_date.expire_time())
            self._expiry_set = True
        return result

    def count(self) -> int:
        return self.cache.set_cardinality(self.serial_id())

    def known(self) -> list[Serial]:
        """Drain the full serial set, re-deduplicating client-side
        because scans may replay members (knowncertificates.go:65-96)."""
        seen: set[str] = set()
        for member in self.cache.set_to_iter(self.serial_id()):
            seen.add(member)
        return [Serial.from_bytes(m.encode("latin-1")) for m in seen]
