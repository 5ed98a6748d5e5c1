"""Production log-list loader: the Google/Apple log-list v3 JSON
schema → the verify lane's trust anchors.

The CT ecosystem publishes its trusted logs as a versioned JSON
document (``https://www.gstatic.com/ct/log_list/v3/log_list.json``;
Apple ships the same schema): operators, each with logs carrying

- ``log_id`` — base64 of SHA-256 over the log's SubjectPublicKeyInfo
  DER (RFC 6962 §3.2's key id);
- ``key`` — base64 SPKI DER itself;
- ``state`` — exactly one of ``pending`` / ``qualified`` / ``usable``
  / ``readonly`` / ``retired`` / ``rejected``, keyed by name with a
  timestamp object;
- ``temporal_interval`` — optional shard window
  (``start_inclusive``/``end_exclusive``, RFC 3339): the shard only
  accepts certs expiring inside it, and an SCT should be checked
  against the shard that was accepting at its timestamp.

:func:`load_log_list` parses that schema into
:class:`AuditLogList`: every log's SPKI is decoded (EC P-256/P-384
and RSA — the only key types the ecosystem uses) into the
``LogKeyRegistry`` entry shape the verify lane already consumes, and
``log_id == SHA-256(SPKI)`` is enforced LOUDLY (a key/log_id mismatch
is a poisoned trust anchor, never a skippable row). Temporal-shard
routing and state flags ride each entry, surfaced through
:meth:`AuditLogList.route`.

Fixture side: :func:`spki_from_signer` + :func:`fixture_log_list`
emit the SAME production schema for the deterministic test signers,
with log_id properly derived from the SPKI — the recorded-shard
corpus (audit/driver.py) is signed by keys published exactly the way
production logs publish theirs.
"""

from __future__ import annotations

import base64
import hashlib
import json
from dataclasses import dataclass, field
from typing import Optional

from ct_mapreduce_tpu_torch.verify import host
from ct_mapreduce_tpu_torch.verify.lane import LogKeyRegistry

# DER OID content bytes.
_OID_EC_PUBKEY = bytes.fromhex("2a8648ce3d0201")  # 1.2.840.10045.2.1
_OID_P256 = bytes.fromhex("2a8648ce3d030107")  # 1.2.840.10045.3.1.7
_OID_P384 = bytes.fromhex("2b81040022")  # 1.3.132.0.34
_OID_RSA = bytes.fromhex("2a864886f70d010101")  # 1.2.840.113549.1.1.1

KNOWN_STATES = ("pending", "qualified", "usable", "readonly",
                "retired", "rejected")


def _tlv(der: bytes, off: int, end: int):
    """Same TLV acceptance as verify/sct.py (definite lengths, <= 4
    length octets)."""
    if off + 2 > end:
        return None
    tag = der[off]
    first = der[off + 1]
    off += 2
    if first < 0x80:
        length = first
    else:
        nb = first & 0x7F
        if nb == 0 or nb > 4 or off + nb > end:
            return None
        length = int.from_bytes(der[off:off + nb], "big")
        off += nb
    if off + length > end:
        return None
    return tag, off, length


def _wrap(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        return bytes([tag, n]) + content
    if n < 0x100:
        return bytes([tag, 0x81, n]) + content
    return bytes([tag, 0x82, n >> 8, n & 0xFF]) + content


def parse_spki(spki: bytes) -> dict:
    """SubjectPublicKeyInfo DER → a LogKeyRegistry-shaped key dict
    (without ``log_id``): ``{"alg": "p256"|"p384", "x", "y"}`` or
    ``{"alg": "rsa", "n", "e"}``. Raises ValueError on anything else
    — an undecodable trust anchor must never load silently."""
    n = len(spki)
    t = _tlv(spki, 0, n)
    if t is None or t[0] != 0x30 or t[1] + t[2] != n:
        raise ValueError("SPKI is not a DER SEQUENCE")
    off, end = t[1], t[1] + t[2]
    alg = _tlv(spki, off, end)
    if alg is None or alg[0] != 0x30:
        raise ValueError("SPKI missing AlgorithmIdentifier")
    a_off, a_end = alg[1], alg[1] + alg[2]
    oid = _tlv(spki, a_off, a_end)
    if oid is None or oid[0] != 0x06:
        raise ValueError("AlgorithmIdentifier missing OID")
    alg_oid = spki[oid[1]:oid[1] + oid[2]]
    bits = _tlv(spki, alg[1] + alg[2], end)
    if bits is None or bits[0] != 0x03 or bits[2] < 2 \
            or spki[bits[1]] != 0x00:
        raise ValueError("SPKI missing subjectPublicKey BIT STRING")
    key = spki[bits[1] + 1:bits[1] + bits[2]]
    if alg_oid == _OID_EC_PUBKEY:
        curve_oid = _tlv(spki, oid[1] + oid[2], a_end)
        if curve_oid is None or curve_oid[0] != 0x06:
            raise ValueError("EC SPKI missing namedCurve OID")
        curve_bytes = spki[curve_oid[1]:curve_oid[1] + curve_oid[2]]
        if curve_bytes == _OID_P256:
            curve = host.P256
        elif curve_bytes == _OID_P384:
            curve = host.P384
        else:
            raise ValueError(
                f"unsupported EC curve OID {curve_bytes.hex()}")
        w = curve.byte_len
        if len(key) != 1 + 2 * w or key[0] != 0x04:
            raise ValueError(
                f"EC point must be uncompressed 0x04‖X‖Y "
                f"({1 + 2 * w} bytes), got {len(key)}")
        return {
            "alg": curve.name,
            "x": hex(int.from_bytes(key[1:1 + w], "big")),
            "y": hex(int.from_bytes(key[1 + w:], "big")),
        }
    if alg_oid == _OID_RSA:
        t = _tlv(key, 0, len(key))
        if t is None or t[0] != 0x30:
            raise ValueError("RSA key is not a DER SEQUENCE")
        r_off, r_end = t[1], t[1] + t[2]
        nv = _tlv(key, r_off, r_end)
        if nv is None or nv[0] != 0x02:
            raise ValueError("RSA key missing modulus INTEGER")
        ev = _tlv(key, nv[1] + nv[2], r_end)
        if ev is None or ev[0] != 0x02:
            raise ValueError("RSA key missing exponent INTEGER")
        return {
            "alg": "rsa",
            "n": hex(int.from_bytes(key[nv[1]:nv[1] + nv[2]], "big")),
            "e": hex(int.from_bytes(key[ev[1]:ev[1] + ev[2]], "big")),
        }
    raise ValueError(f"unsupported SPKI algorithm OID {alg_oid.hex()}")


def encode_ec_spki(x: int, y: int, curve: host.Curve) -> bytes:
    """EC SubjectPublicKeyInfo DER (uncompressed point) — the fixture
    side of :func:`parse_spki`, used to publish deterministic test
    signers through the production schema."""
    curve_oid = _OID_P256 if curve.name == "p256" else _OID_P384
    w = curve.byte_len
    point = b"\x04" + x.to_bytes(w, "big") + y.to_bytes(w, "big")
    return _wrap(0x30,
                 _wrap(0x30, _wrap(0x06, _OID_EC_PUBKEY)
                       + _wrap(0x06, curve_oid))
                 + _wrap(0x03, b"\x00" + point))


def encode_rsa_spki(n: int, e: int) -> bytes:
    def _int(v: int) -> bytes:
        b = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
        if b[0] & 0x80:
            b = b"\x00" + b
        return _wrap(0x02, b)

    return _wrap(0x30,
                 _wrap(0x30, _wrap(0x06, _OID_RSA) + _wrap(0x05, b""))
                 + _wrap(0x03, b"\x00" + _wrap(0x30, _int(n) + _int(e))))


def parse_rfc3339_ms(ts: str) -> int:
    """RFC 3339 UTC timestamp → epoch milliseconds. The log-list
    schema uses Z-suffixed UTC exclusively."""
    import datetime as dt

    s = ts.replace("Z", "+00:00")
    d = dt.datetime.fromisoformat(s)
    if d.tzinfo is None:
        d = d.replace(tzinfo=dt.timezone.utc)
    return int(d.timestamp() * 1000)


@dataclass
class LogShard:
    """One log (= one temporal shard when the operator shards) from
    the list: the registry entry plus routing metadata."""

    log_id: bytes  # 32 raw bytes, == SHA-256(SPKI)
    entry: dict  # LogKeyRegistry shape (log_id hex + alg + coords)
    operator: str
    description: str
    url: str
    state: str  # one of KNOWN_STATES
    state_timestamp_ms: int
    interval_start_ms: Optional[int]  # inclusive, None = unsharded
    interval_end_ms: Optional[int]  # exclusive

    def accepts_at(self, timestamp_ms: int) -> bool:
        """Temporal-shard routing: inclusive start, exclusive end
        (the schema's ``start_inclusive``/``end_exclusive``)."""
        if self.interval_start_ms is not None \
                and timestamp_ms < self.interval_start_ms:
            return False
        if self.interval_end_ms is not None \
                and timestamp_ms >= self.interval_end_ms:
            return False
        return True


@dataclass
class RouteVerdict:
    """Where an SCT's (log_id, timestamp) lands against the list."""

    known: bool
    state: str = ""
    operator: str = ""
    in_interval: bool = False
    retired: bool = False


@dataclass
class AuditLogList:
    """The parsed list: shards by log_id + the registry the verify
    lane loads. ``route`` implements the audit policy — verify
    against the key regardless of state (a retired log's old SCTs
    are still cryptographically checkable), but FLAG retired logs and
    out-of-interval timestamps so the driver can count them."""

    shards: dict[bytes, LogShard] = field(default_factory=dict)
    version: str = ""
    log_list_timestamp: str = ""

    def registry(self) -> LogKeyRegistry:
        reg = LogKeyRegistry()
        for shard in self.shards.values():
            reg.register(shard.entry)
        return reg

    def route(self, log_id: bytes, timestamp_ms: int) -> RouteVerdict:
        shard = self.shards.get(log_id)
        if shard is None:
            return RouteVerdict(known=False)
        return RouteVerdict(
            known=True,
            state=shard.state,
            operator=shard.operator,
            in_interval=shard.accepts_at(timestamp_ms),
            retired=shard.state == "retired",
        )

    def __len__(self) -> int:
        return len(self.shards)


def _parse_log(raw: dict, operator: str) -> LogShard:
    key_b64 = raw.get("key", "")
    logid_b64 = raw.get("log_id", "")
    if not key_b64 or not logid_b64:
        raise ValueError(
            f"log {raw.get('description', '?')!r} ({operator}): "
            "missing key or log_id")
    spki = base64.b64decode(key_b64)
    log_id = base64.b64decode(logid_b64)
    computed = hashlib.sha256(spki).digest()
    if log_id != computed:
        # The loud rejection: a list whose key doesn't hash to its
        # log_id is corrupt or tampered — refusing the whole load is
        # the only safe behavior for a trust anchor.
        raise ValueError(
            f"log {raw.get('description', '?')!r} ({operator}): "
            f"log_id {log_id.hex()} != SHA-256(key) {computed.hex()}")
    entry = parse_spki(spki)
    entry["log_id"] = log_id.hex()
    entry["operator"] = operator
    state_raw = raw.get("state", {})
    state, state_ts = "", 0
    for name in KNOWN_STATES:
        if name in state_raw:
            state = name
            ts = state_raw[name].get("timestamp", "")
            state_ts = parse_rfc3339_ms(ts) if ts else 0
            break
    interval = raw.get("temporal_interval") or {}
    start = interval.get("start_inclusive")
    end = interval.get("end_exclusive")
    return LogShard(
        log_id=log_id,
        entry=entry,
        operator=operator,
        description=raw.get("description", ""),
        url=raw.get("url", ""),
        state=state,
        state_timestamp_ms=state_ts,
        interval_start_ms=parse_rfc3339_ms(start) if start else None,
        interval_end_ms=parse_rfc3339_ms(end) if end else None,
    )


def parse_log_list(doc: dict) -> AuditLogList:
    """Log-list v3 document → :class:`AuditLogList`. ``rejected`` and
    ``pending`` logs are skipped (their keys never signed anything the
    ecosystem accepted); every other state loads. Key/log_id
    mismatches raise."""
    out = AuditLogList(
        version=str(doc.get("version", "")),
        log_list_timestamp=str(doc.get("log_list_timestamp", "")),
    )
    for op in doc.get("operators", []):
        name = op.get("name", "")
        for raw in list(op.get("logs", [])) + list(
                op.get("tiled_logs", [])):
            shard = _parse_log(raw, name)
            if shard.state in ("rejected", "pending"):
                continue
            out.shards[shard.log_id] = shard
    return out


def load_log_list(path: str) -> AuditLogList:
    with open(path) as fh:
        return parse_log_list(json.load(fh))


# -- fixture side --------------------------------------------------------


def spki_from_signer(signer) -> bytes:
    """The SPKI DER of a fixture signer (EcSctSigner / RsaSctSigner) —
    what a production log would publish as its ``key``."""
    if hasattr(signer, "curve"):
        return encode_ec_spki(signer.q[0], signer.q[1], signer.curve)
    return encode_rsa_spki(signer.n, signer.e)


def production_log_id(signer) -> bytes:
    """RFC 6962 log id for a fixture signer: SHA-256 over its SPKI
    (NOT the ``ctmr-log-v1`` fixture id). Assigning this to
    ``signer.log_id`` makes the signer publishable through the
    production schema."""
    return hashlib.sha256(spki_from_signer(signer)).digest()


def adopt_production_id(signer):
    """Rewrite a fixture signer's log_id to the RFC derivation so its
    SCTs carry the id the production list maps to its key."""
    signer.log_id = production_log_id(signer)
    return signer


def fixture_log_list(logs: list[dict]) -> dict:
    """Build a production-schema v3 document for fixture signers.

    ``logs``: dicts with ``signer`` (already production-id adopted),
    ``operator``, ``description``, ``state`` (default "usable"),
    ``state_timestamp``, and optional ``interval`` =
    (start_inclusive, end_exclusive) RFC 3339 strings."""
    by_op: dict[str, list[dict]] = {}
    for spec in logs:
        signer = spec["signer"]
        spki = spki_from_signer(signer)
        log_id = hashlib.sha256(spki).digest()
        if signer.log_id != log_id:
            raise ValueError(
                "signer not production-id adopted "
                "(call adopt_production_id first)")
        raw = {
            "description": spec.get("description", "fixture log"),
            "log_id": base64.b64encode(log_id).decode(),
            "key": base64.b64encode(spki).decode(),
            "url": spec.get("url", "https://fixture.ct.example/"),
            "mmd": 86400,
            "state": {
                spec.get("state", "usable"): {
                    "timestamp": spec.get(
                        "state_timestamp", "2024-01-01T00:00:00Z"),
                },
            },
        }
        if spec.get("interval"):
            start, end = spec["interval"]
            raw["temporal_interval"] = {
                "start_inclusive": start,
                "end_exclusive": end,
            }
        by_op.setdefault(spec.get("operator", "Fixture Op"),
                         []).append(raw)
    return {
        "version": "3.99",
        "log_list_timestamp": "2026-01-01T00:00:00Z",
        "operators": [
            {"name": op, "email": [f"{op.lower().replace(' ', '-')}"
                                   "@ct.example"],
             "logs": logs_}
            for op, logs_ in sorted(by_op.items())
        ],
    }
