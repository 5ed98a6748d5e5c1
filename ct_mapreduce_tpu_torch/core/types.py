"""Identity and value types for the CT map/reduce domain.

Behavioral contract mirrors the reference's value types
(reference storage/types.go:25-405): issuer identity is
base64url(SHA-256(SPKI)), serials preserve raw DER content bytes
(including leading zeros), expiration dates bucket to the hour (when
constructed from a time) or to day/day+hour (when parsed from strings),
and the composite string IDs are reproduced byte-for-byte so reports and
cache keys are interchangeable with the reference's.

A copy of ``ct_mapreduce_tpu.core.types``: the port imports nothing of the JAX package.
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


def certificate_log_id_from_short_url(short_url: str) -> str:
    """Reference: storage/types.go:36-38 (CertificateLogIDFromShortURL)."""
    return _b64url(short_url.encode("utf-8"))


@dataclass
class CertificateLog:
    """Per-log ingestion checkpoint record.

    Reference: storage/types.go:25-42. Serialized as JSON with the same
    field names the Go struct produces, so checkpoints interoperate.
    """

    short_url: str
    max_entry: int = 0
    last_entry_time: Optional[datetime] = None
    last_update_time: Optional[datetime] = None

    def id(self) -> str:
        return certificate_log_id_from_short_url(self.short_url)

    def __str__(self) -> str:
        return (
            f"[{self.short_url}] MaxEntry={self.max_entry}, "
            f"LastEntryTime={self.last_entry_time} "
            f"LastUpdateTime={self.last_update_time}"
        )

    def to_json(self) -> str:
        def enc_time(t: Optional[datetime]) -> str:
            if t is None:
                return "0001-01-01T00:00:00Z"
            if t.tzinfo is None:
                t = t.replace(tzinfo=timezone.utc)  # naive means UTC everywhere here
            return t.astimezone(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f").rstrip(
                "0"
            ).rstrip(".") + "Z"

        return json.dumps(
            {
                "ShortURL": self.short_url,
                "MaxEntry": self.max_entry,
                "LastEntryTime": enc_time(self.last_entry_time),
                "LastUpdateTime": enc_time(self.last_update_time),
            }
        )

    @classmethod
    def from_json(cls, raw: str) -> "CertificateLog":
        obj = json.loads(raw)

        def dec_time(s: Optional[str]) -> Optional[datetime]:
            if not s or s.startswith("0001-01-01"):
                return None
            s = s.rstrip("Z")
            # Go marshals time.Time as RFC3339Nano (up to 9 fractional
            # digits); strptime %f accepts at most 6 — truncate.
            if "." in s:
                head, frac = s.split(".", 1)
                s = f"{head}.{frac[:6]}" if frac else head
            for fmt in ("%Y-%m-%dT%H:%M:%S.%f", "%Y-%m-%dT%H:%M:%S"):
                try:
                    return datetime.strptime(s, fmt).replace(tzinfo=timezone.utc)
                except ValueError:
                    continue
            return None

        return cls(
            short_url=obj["ShortURL"],
            max_entry=int(obj.get("MaxEntry", 0)),
            last_entry_time=dec_time(obj.get("LastEntryTime")),
            last_update_time=dec_time(obj.get("LastUpdateTime")),
        )


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

    def sha256_digest(self) -> bytes:
        return hashlib.sha256(self.spki).digest()


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
class Serial:
    """A certificate serial number as raw DER content bytes.

    Leading zeros are preserved (reference: storage/types.go:161-208 —
    NewSerial re-parses the TBSCertificate precisely so that serials
    like 00:AA:BB keep their leading 0x00 byte, which big-int based
    representations destroy; storage/types_test.go:81-101 is the spec).
    """

    serial: bytes

    @classmethod
    def from_bytes(cls, b: bytes) -> "Serial":
        return cls(bytes(b))

    @classmethod
    def from_hex(cls, s: str) -> "Serial":
        return cls(binascii.unhexlify(s))

    @classmethod
    def from_id_string(cls, s: str) -> "Serial":
        return cls(_b64url_decode(s))

    @classmethod
    def from_der_cert(cls, der: bytes) -> "Serial":
        from ct_mapreduce_tpu_torch.core import der as derlib

        return cls(derlib.raw_serial_bytes(der))

    def id(self) -> str:
        return _b64url(self.serial)

    def hex_string(self) -> str:
        return binascii.hexlify(self.serial).decode("ascii")

    def binary_string(self) -> bytes:
        return self.serial

    def as_int(self) -> int:
        return int.from_bytes(self.serial, "big") if self.serial else 0

    def cmp(self, other: "Serial") -> int:
        return (self.serial > other.serial) - (self.serial < other.serial)

    def __lt__(self, other: "Serial") -> bool:
        return self.serial < other.serial

    def __str__(self) -> str:
        return self.hex_string()

    def to_json(self) -> str:
        return json.dumps(self.hex_string())

    @classmethod
    def from_json(cls, raw: str) -> "Serial":
        s = json.loads(raw)
        if not isinstance(s, str):
            raise ValueError("Expected surrounding quotes")
        return cls.from_hex(s)


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


@dataclass(frozen=True)
class UniqueCertIdentifier:
    """Composite `<expDate>::<issuerID>::<serialID>` identity.

    Reference: storage/types.go:273-306.
    """

    exp_date: ExpDate
    issuer: Issuer
    serial: Serial

    @classmethod
    def parse(cls, s: str) -> "UniqueCertIdentifier":
        parts = s.split("::")
        if len(parts) != 3:
            raise ValueError(f"Expected 3 parts, got {len(parts)}")
        return cls(
            exp_date=ExpDate.parse(parts[0]),
            issuer=Issuer.from_string(parts[1]),
            serial=Serial.from_id_string(parts[2]),
        )

    def __str__(self) -> str:
        return f"{self.exp_date.id()}::{self.issuer.id()}::{self.serial.id()}"

    def __hash__(self) -> int:
        return hash(str(self))


@dataclass(frozen=True)
class IssuerAndDate:
    """Composite `<expDate>/<issuerID>`. Reference: storage/types.go:308-331."""

    exp_date: ExpDate
    issuer: Issuer

    @classmethod
    def parse(cls, s: str) -> "IssuerAndDate":
        parts = s.split("/")
        if len(parts) != 2:
            raise ValueError(f"Unexpected number of parts: {len(parts)} from {s}")
        return cls(exp_date=ExpDate.parse(parts[0]), issuer=Issuer.from_string(parts[1]))

    def __str__(self) -> str:
        return f"{self.exp_date.id()}/{self.issuer.id()}"

    def __hash__(self) -> int:
        return hash(str(self))


@dataclass
class IssuerDate:
    """An issuer together with the expiration buckets it appears in.

    Reference: storage/types.go:402-405.
    """

    issuer: Issuer
    exp_dates: list[ExpDate] = field(default_factory=list)
