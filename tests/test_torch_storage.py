"""The port's storage layer (``ct_mapreduce_tpu_torch/storage/``, a copy
of the JAX package's) against the JAX package's, on the cases of
``tests/test_storage.py``.

Each case is a function of one package's modules that returns what it
observed as plain values; it runs once on the JAX package and once on
the port, its own assertions hold on both, and the two records must be
equal. Certificates come from ``tests/certgen.py``. Tolerance: exact
equality.
"""

import importlib
import os
from datetime import datetime, timedelta, timezone
from types import SimpleNamespace

import pytest

from certgen import make_cert

UTC = timezone.utc


def _pkg(root: str) -> SimpleNamespace:
    storage = importlib.import_module(f"{root}.storage")
    types = importlib.import_module(f"{root}.core.types")
    return SimpleNamespace(
        name=root, storage=storage, types=types,
        der=importlib.import_module(f"{root}.core.der"),
        conformance=importlib.import_module(f"{root}.storage.conformance"),
        **{k: getattr(storage, k) for k in (
            "FilesystemDatabase", "IssuerMetadata", "KnownCertificates",
            "LocalDiskBackend", "MockBackend", "MockRemoteCache",
            "NoopBackend")},
        **{k: getattr(types, k) for k in (
            "CertificateLog", "ExpDate", "Issuer", "Serial")})


PKGS = [_pkg("ct_mapreduce_tpu"), _pkg("ct_mapreduce_tpu_torch")]


def both(case, *args):
    """Run ``case(pkg, *args)`` on both packages; the records match."""
    records = [case(m, *args) for m in PKGS]
    assert records[0] == records[1]
    return records[1]


def _tree(root) -> dict:
    """Relative path → bytes of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# -- MockRemoteCache ----------------------------------------------------


def test_set_semantics():
    def case(m):
        c = m.MockRemoteCache()
        rec = [c.set_insert("k", "a"), c.set_insert("k", "a"),
               c.set_insert("k", "b"), c.set_contains("k", "a"),
               c.set_contains("k", "z"), c.set_cardinality("k"),
               c.set_list("k"), c.set_remove("k", "a"),
               c.set_remove("k", "a"), c.set_cardinality("k")]
        assert rec == [True, False, True, True, False, 2, ["a", "b"], True,
                       False, 1]
        return rec
    both(case)


def test_ttl_expiry():
    def case(m):
        c = m.MockRemoteCache()
        c.set_insert("gone", "x")
        c.expire_at("gone", datetime.now(UTC) - timedelta(seconds=1))
        c.set_insert("stays", "x")
        c.expire_in("stays", timedelta(hours=1))
        rec = [c.exists("gone"), c.exists("stays")]
        assert rec == [False, True]
        return rec
    both(case)


def test_queue_semantics():
    def case(m):
        c = m.MockRemoteCache()
        rec = [c.queue("q", "one"), c.queue("q", "two"),
               c.queue_length("q"), c.pop("q")]
        with pytest.raises(KeyError):
            c.pop("empty")
        # BRPOPLPUSH pops the tail into dest's head
        c.queue("src", "a")
        c.queue("src", "b")
        rec += [c.blocking_pop_copy("src", "dst", timedelta(seconds=1)),
                c.pop("dst")]
        with pytest.raises(TimeoutError):
            c.blocking_pop_copy("empty", "dst", timedelta(milliseconds=20))
        assert rec == [1, 2, 2, "one", "b", "b"]
        return rec
    both(case)


def test_try_set_is_first_writer_wins():
    def case(m):
        c = m.MockRemoteCache()
        rec = [c.try_set("lock", "alice", timedelta(minutes=5)),
               c.try_set("lock", "bob", timedelta(minutes=5))]
        assert rec == ["alice", "alice"]
        return rec
    both(case)


def test_keys_matching():
    def case(m):
        c = m.MockRemoteCache()
        c.set_insert("serials::2050-01-01::issA", "x")
        c.set_insert("serials::2050-01-02::issB", "x")
        c.set_insert("crl::issA", "x")
        keys = sorted(c.keys_matching("serials::*"))
        assert keys == ["serials::2050-01-01::issA",
                        "serials::2050-01-02::issB"]
        return keys
    both(case)


def test_log_state_roundtrip():
    def case(m):
        c = m.MockRemoteCache()
        missing = c.load_log_state("nope")
        c.store_log_state(m.CertificateLog(short_url="l.example/x",
                                           max_entry=9))
        rec = [missing, c.load_log_state("l.example/x").max_entry,
               c.load_log_state("l.example/x").to_json()]
        assert rec[:2] == [None, 9]
        return rec
    both(case)


# -- KnownCertificates --------------------------------------------------


def test_was_unknown_dedups():
    def case(m):
        kc = m.KnownCertificates(m.ExpDate.parse("2050-01-01"),
                                 m.Issuer.from_string("i"),
                                 m.MockRemoteCache())
        s1, s2 = m.Serial.from_hex("00aa"), m.Serial.from_hex("bb")
        rec = [kc.was_unknown(s1), kc.was_unknown(s1), kc.was_unknown(s2),
               kc.count(), sorted(s.hex_string() for s in kc.known())]
        assert rec == [True, False, True, 2, ["00aa", "bb"]]
        return rec
    both(case)


def test_known_dedups_scan_duplicates():
    def case(m):
        cache = m.MockRemoteCache(duplicate=2)
        kc = m.KnownCertificates(m.ExpDate.parse("2050-01-01"),
                                 m.Issuer.from_string("i"), cache)
        kc.was_unknown(m.Serial.from_hex("01"))
        kc.was_unknown(m.Serial.from_hex("02"))
        rec = [len(list(cache.set_to_iter(kc.serial_id()))), len(kc.known())]
        assert rec == [6, 2]  # the duplicated stream, deduped client-side
        return rec
    both(case)


def test_serials_key_format():
    def case(m):
        kc = m.KnownCertificates(m.ExpDate.parse("2050-01-01-05"),
                                 m.Issuer.from_string("issuerX"),
                                 m.MockRemoteCache())
        assert kc.serial_id() == "serials::2050-01-01-05::issuerX"
        return kc.serial_id()
    both(case)


def test_expiry_set_once_to_bucket_expiry():
    def case(m):
        cache = m.MockRemoteCache()
        exp = m.ExpDate.parse("2050-01-01")
        kc = m.KnownCertificates(exp, m.Issuer.from_string("i"), cache)
        kc.was_unknown(m.Serial.from_hex("01"))
        assert cache._expirations[kc.serial_id()] == exp.expire_time()
        return cache._expirations[kc.serial_id()]
    both(case)


# -- IssuerMetadata -----------------------------------------------------


def test_accumulate_metadata():
    def case(m):
        meta = m.IssuerMetadata(m.Issuer.from_string("iss"),
                                m.MockRemoteCache())
        exp = m.ExpDate.parse("2050-01-01")
        rec = [meta.accumulate(exp, "CN=Foo CA,O=Foo",
                               ["http://crl.foo/x.crl"]),
               meta.accumulate(exp, "CN=Foo CA,O=Foo",
                               ["http://crl.foo/x.crl"]),
               meta.issuers(), meta.crls()]
        assert rec == [False, True, ["CN=Foo CA,O=Foo"],
                       ["http://crl.foo/x.crl"]]
        return rec
    both(case)


def test_crl_scheme_filtering():
    def case(m):
        meta = m.IssuerMetadata(m.Issuer.from_string("iss"),
                                m.MockRemoteCache())
        meta.accumulate(m.ExpDate.parse("2050-01-01"), "CN=X", [
            "http://ok.example/a.crl", "https://ok.example/b.crl",
            "ldap://dropped.example/x", "ldaps://dropped.example/y",
            "ftp://ignored.example/z"])
        crls = sorted(meta.crls())
        assert crls == ["http://ok.example/a.crl",
                        "https://ok.example/b.crl"]
        return crls
    both(case)


def test_metadata_keys():
    def case(m):
        cache = m.MockRemoteCache()
        meta = m.IssuerMetadata(m.Issuer.from_string("issuerQ"), cache)
        meta.accumulate(m.ExpDate.parse("2050-01-01"), "CN=Q",
                        ["http://q/crl"])
        rec = [cache.set_list("crl::issuerQ"),
               cache.set_list("issuer::issuerQ")]
        assert rec == [["http://q/crl"], ["CN=Q"]]
        return rec
    both(case)


# -- backends -----------------------------------------------------------


def test_mock_backend_conformance():
    def case(m):
        b = m.MockBackend()
        m.conformance.run_full_conformance(b)
        return sorted(b.dirty)
    both(case)


def test_localdisk_backend_conformance(tmp_path):
    def case(m):
        root = tmp_path / m.name
        m.conformance.run_full_conformance(m.LocalDiskBackend(root))
        return _tree(root)
    both(case)


def test_localdisk_layout(tmp_path):
    def case(m):
        # localdiskbackend.go:194-199: <root>/<expDate>/<issuerID>/<serialID>
        root = tmp_path / m.name
        b = m.LocalDiskBackend(root)
        serial = m.Serial.from_hex("0042")
        b.store_certificate_pem(serial, m.ExpDate.parse("2050-01-01"),
                                m.Issuer.from_string("issuerDir"), b"PEMDATA")
        b.mark_dirty("2050-01-01")
        assert ((root / "2050-01-01" / "issuerDir" / serial.id())
                .read_bytes() == b"PEMDATA")
        assert (root / "2050-01-01" / ".dirty").exists()
        return _tree(root)
    both(case)


def test_noop_backend():
    def case(m):
        b = m.NoopBackend()
        exp = m.ExpDate.parse("2050-01-01")
        issuer = m.Issuer.from_string("i")
        b.store_certificate_pem(m.Serial.from_hex("01"), exp, issuer, b"x")
        with pytest.raises(NotImplementedError):
            b.load_certificate_pem(m.Serial.from_hex("01"), exp, issuer)
        assert b.list_expiration_dates(datetime(2049, 1, 1)) == []
        return b.list_expiration_dates(datetime(2049, 1, 1))
    both(case)


# -- FilesystemDatabase -------------------------------------------------


def _db(m):
    return m.FilesystemDatabase(m.MockBackend(), m.MockRemoteCache())


def test_store_flow():
    issuer_der = make_cert(issuer_cn="Root CA", key_seed=1)
    not_after = datetime(2049, 6, 1, 12, 30, tzinfo=UTC)
    leaf = make_cert(serial=0x1001, issuer_cn="Root CA",
                     subject_cn="site.example", is_ca=False,
                     crl_dps=("http://crl.root/ca.crl",), not_after=not_after)

    def case(m):
        db = _db(m)
        db.store(leaf, issuer_der, "log.example/x", 1)
        db.store(leaf, issuer_der, "log.example/x", 2)  # duplicate
        issuer = m.Issuer.from_spki(m.der.parse_cert(issuer_der).spki)
        exp = m.ExpDate.from_time(not_after)
        serials = db.backend.list_serials_for_expiration_date_and_issuer(
            exp, issuer)
        rec = [db.get_known_certificates(exp, issuer).count(),
               db.get_issuer_metadata(issuer).crls(),
               "2049-06-01" in db.backend.dirty,
               [s.as_int() for s in serials],
               db.backend.load_certificate_pem(serials[0], exp, issuer)]
        assert rec[:4] == [1, ["http://crl.root/ca.crl"], True, [0x1001]]
        return rec
    both(case)


def test_issuer_and_dates_from_cache():
    issuer_der = make_cert(issuer_cn="Enum CA", key_seed=2)
    leaves = [make_cert(serial=0x2000 + i, issuer_cn="Enum CA", is_ca=False,
                        not_after=datetime(2049, 7, 1, hour, tzinfo=UTC))
              for i, hour in enumerate((1, 2))]

    def case(m):
        db = _db(m)
        for i, leaf in enumerate(leaves):
            db.store(leaf, issuer_der, "log.example/x", i)
        result = db.get_issuer_and_dates_from_cache()
        rec = [[(r.issuer.id(), [e.id() for e in r.exp_dates])
                for r in result]]
        assert len(result) == 1
        assert rec[0][0][1] == ["2049-07-01-01", "2049-07-01-02"]
        return rec
    both(case)


def test_log_state_dual_write():
    def case(m):
        db = _db(m)
        db.save_log_state(m.CertificateLog(short_url="log.example/y",
                                           max_entry=7))
        fresh = db.get_log_state("never.seen/log")
        rec = [db.ext_cache.load_log_state("log.example/y").max_entry,
               db.backend.load_log_state("log.example/y").max_entry,
               db.get_log_state("log.example/y").max_entry,
               fresh.max_entry, fresh.short_url]
        assert rec == [7, 7, 7, 0, "never.seen/log"]
        return rec
    both(case)


def test_pem_helpers_and_serial_identity():
    """The der/types helpers the storage layer added to the port: PEM
    round trips and the raw-serial identity of a certificate."""
    leaf = make_cert(serial=0x00F00D, issuer_cn="Pem CA", is_ca=False)

    def case(m):
        pem = m.der.der_to_pem(leaf)
        rec = [pem, m.der.pem_to_der(pem) == leaf,
               m.der.pem_to_der(b"text\n" + pem) == leaf,
               m.der.raw_serial_bytes(leaf),
               m.Serial.from_der_cert(leaf).id()]
        assert rec[1] and rec[2]
        return rec
    both(case)
