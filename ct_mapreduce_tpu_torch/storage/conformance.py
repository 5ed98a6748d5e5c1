"""Shared StorageBackend conformance suite.

Reference: reference storage/storagebackend_tests.go — the same
assertions run against every backend implementation (store/load,
listing, log state, hour-resolution listing). Call these from a test
module with any backend instance; they raise AssertionError on
contract violations.

A copy of ``ct_mapreduce_tpu.storage.conformance``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from datetime import datetime, timezone

from ct_mapreduce_tpu_torch.core.types import CertificateLog, ExpDate, Issuer, Serial
from ct_mapreduce_tpu_torch.storage.interfaces import StorageBackend


def backend_test_store_load(backend: StorageBackend) -> None:
    """storagebackend_tests.go:39-53."""
    exp = ExpDate.parse("2050-01-01")
    issuer = Issuer.from_string("aki")
    serial = Serial.from_hex("01020304")
    pem = b"-----BEGIN CERTIFICATE-----\nZm9v\n-----END CERTIFICATE-----\n"
    backend.store_certificate_pem(serial, exp, issuer, pem)
    loaded = backend.load_certificate_pem(serial, exp, issuer)
    assert loaded == pem, f"load mismatch: {loaded!r} != {pem!r}"


def backend_test_log_state(backend: StorageBackend) -> None:
    """storagebackend_tests.go:103-169."""
    assert backend.load_log_state("not/a/log") is None
    log = CertificateLog(
        short_url="log.example.com/2050",
        max_entry=42,
        last_entry_time=datetime(2049, 1, 2, 3, 4, 5, tzinfo=timezone.utc),
    )
    backend.store_log_state(log)
    restored = backend.load_log_state("log.example.com/2050")
    assert restored is not None
    assert restored.short_url == log.short_url
    assert restored.max_entry == 42
    assert restored.last_entry_time == log.last_entry_time
    # Overwrite advances
    log.max_entry = 99
    backend.store_log_state(log)
    assert backend.load_log_state("log.example.com/2050").max_entry == 99


def backend_test_listing(backend: StorageBackend) -> None:
    """storagebackend_tests.go:55-101,171-215: allocation + listing with
    day and hour resolution."""
    day = ExpDate.parse("2051-03-04")
    hour = ExpDate.parse("2051-03-04-05")
    iss_a = Issuer.from_string("issuerA")
    iss_b = Issuer.from_string("issuerB")
    backend.allocate_exp_date_and_issuer(day, iss_a)
    backend.allocate_exp_date_and_issuer(hour, iss_b)

    not_before = datetime(2051, 1, 1, tzinfo=timezone.utc)
    dates = backend.list_expiration_dates(not_before)
    ids = {d.id() for d in dates}
    assert "2051-03-04" in ids and "2051-03-04-05" in ids, ids

    # Expired buckets are filtered out
    later = datetime(2052, 1, 1, tzinfo=timezone.utc)
    assert all(
        not d.id().startswith("2051-03-04")
        for d in backend.list_expiration_dates(later)
    )

    issuers_day = {i.id() for i in backend.list_issuers_for_expiration_date(day)}
    assert issuers_day == {"issuerA"}
    issuers_hour = {i.id() for i in backend.list_issuers_for_expiration_date(hour)}
    assert issuers_hour == {"issuerB"}


def backend_test_serials(backend: StorageBackend) -> None:
    """Serial listing and streaming (implemented here even though the
    reference's localdisk leaves streaming unimplemented,
    localdiskbackend.go:172-182)."""
    exp = ExpDate.parse("2053-06-07")
    issuer = Issuer.from_string("serialIssuer")
    serials = [Serial.from_hex(h) for h in ("00aa", "01", "02ff")]
    for s in serials:
        backend.store_certificate_pem(s, exp, issuer, b"PEM" + s.binary_string())
    listed = backend.list_serials_for_expiration_date_and_issuer(exp, issuer)
    assert sorted(x.hex_string() for x in listed) == ["00aa", "01", "02ff"]
    streamed = list(
        backend.stream_serials_for_expiration_date_and_issuer(exp, issuer)
    )
    assert len(streamed) == 3
    for uci in streamed:
        assert uci.exp_date.id() == exp.id()
        assert uci.issuer.id() == issuer.id()


def run_full_conformance(backend: StorageBackend) -> None:
    backend_test_store_load(backend)
    backend_test_log_state(backend)
    backend_test_listing(backend)
    backend_test_serials(backend)
