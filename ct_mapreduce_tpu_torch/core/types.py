"""Identity and value types for the CT map/reduce domain: the issuer
identity and the expiration bucket, copied from
``ct_mapreduce_tpu.core.types`` (the other value types are not needed
by the ported path yet).

Behavioral contract mirrors the reference's value types
(reference storage/types.go:25-405): issuer identity is
base64url(SHA-256(SPKI)), serials preserve raw DER content bytes
(including leading zeros), expiration dates bucket to the hour (when
constructed from a time) or to day/day+hour (when parsed from strings),
and the composite string IDs are reproduced byte-for-byte so reports and
cache keys are interchangeable with the reference's.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import json
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Optional

EXPIRATION_FORMAT = "%Y-%m-%d"
EXPIRATION_FORMAT_WITH_HOUR = "%Y-%m-%d-%H"

_MS = timedelta(milliseconds=1)


def _b64url(data: bytes) -> str:
    """URL-safe base64 *with* padding (Go base64.URLEncoding parity)."""
    return base64.urlsafe_b64encode(data).decode("ascii")


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s)


@dataclass(frozen=True)
class SPKI:
    """Raw SubjectPublicKeyInfo bytes. Reference: storage/types.go:143-159."""

    spki: bytes

    def id(self) -> str:
        return _b64url(self.spki)

    def __str__(self) -> str:
        return binascii.hexlify(self.spki).decode("ascii")

    def sha256_digest_url_encoded_base64(self) -> str:
        return _b64url(hashlib.sha256(self.spki).digest())


@dataclass
class Issuer:
    """Issuer identity: lazy base64url(SHA-256(SPKI)).

    Reference: storage/types.go:104-141. Construct from an SPKI
    (`Issuer.from_spki`) or directly from an already-computed ID string
    (`Issuer.from_string`, the NewIssuerFromString analog).
    """

    _id: Optional[str] = None
    spki: Optional[SPKI] = None

    @classmethod
    def from_spki(cls, spki: bytes | SPKI) -> "Issuer":
        if isinstance(spki, bytes):
            spki = SPKI(spki)
        return cls(_id=None, spki=spki)

    @classmethod
    def from_string(cls, issuer_id: str) -> "Issuer":
        return cls(_id=issuer_id, spki=None)

    def id(self) -> str:
        if self._id is None:
            assert self.spki is not None, "Issuer has neither id nor SPKI"
            self._id = self.spki.sha256_digest_url_encoded_base64()
        return self._id

    def digest(self) -> bytes:
        """The raw 32-byte SHA-256(SPKI) — the device-side issuer key."""
        return _b64url_decode(self.id())

    def __hash__(self) -> int:
        return hash(self.id())

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Issuer) and self.id() == other.id()

    def __str__(self) -> str:
        return self.id()

    def to_json(self) -> str:
        return json.dumps(self.id())

    @classmethod
    def from_json(cls, raw: str) -> "Issuer":
        return cls.from_string(json.loads(raw))


@dataclass(frozen=True)
class ExpDate:
    """Expiration bucket: hour resolution when built from a time, hour or
    day resolution when parsed from a string.

    Reference: storage/types.go:333-384. `last_good` is the final instant
    still covered by the bucket (bucket end minus 1ms), used by
    IsExpiredAt.
    """

    date: datetime
    last_good: datetime = field(compare=False)
    hour_resolution: bool = True

    @classmethod
    def from_time(cls, t: datetime) -> "ExpDate":
        if t.tzinfo is None:
            t = t.replace(tzinfo=timezone.utc)
        t = t.astimezone(timezone.utc)
        trunc = t.replace(minute=0, second=0, microsecond=0)
        return cls(date=trunc, last_good=trunc - _MS, hour_resolution=True)

    @classmethod
    def parse(cls, s: str) -> "ExpDate":
        if len(s) > 10:
            try:
                t = datetime.strptime(s, EXPIRATION_FORMAT_WITH_HOUR).replace(
                    tzinfo=timezone.utc
                )
                return cls(
                    date=t, last_good=t + timedelta(hours=1) - _MS, hour_resolution=True
                )
            except ValueError:
                pass
        t = datetime.strptime(s, EXPIRATION_FORMAT).replace(tzinfo=timezone.utc)
        return cls(
            date=t, last_good=t + timedelta(hours=24) - _MS, hour_resolution=False
        )

    @classmethod
    def from_unix_hour(cls, hour: int) -> "ExpDate":
        """Build from the device-side int32 epoch-hour bucket."""
        t = datetime.fromtimestamp(hour * 3600, tz=timezone.utc)
        return cls(date=t, last_good=t - _MS, hour_resolution=True)

    def unix_hour(self) -> int:
        """The device-side int32 representation: hours since Unix epoch."""
        return int(self.date.timestamp()) // 3600

    def is_expired_at(self, t: datetime) -> bool:
        if t.tzinfo is None:
            t = t.replace(tzinfo=timezone.utc)
        return self.last_good < t

    def expire_time(self) -> datetime:
        return self.date

    def id(self) -> str:
        if self.hour_resolution:
            return self.date.strftime(EXPIRATION_FORMAT_WITH_HOUR)
        return self.date.strftime(EXPIRATION_FORMAT)

    def __str__(self) -> str:
        return self.id()

    def __hash__(self) -> int:
        return hash((self.date, self.hour_resolution))

    def __lt__(self, other: "ExpDate") -> bool:
        return self.date < other.date
