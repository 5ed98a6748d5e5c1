"""Per-issuer metadata accumulation: CRL distribution points and issuer
DNs, with local known-maps to skip cache round trips.

Reference: reference storage/issuermetadata.go. Keys
`crl::<issuerID>` and `issuer::<issuerID>`; CRL URLs are filtered to
http/https (ldap/ldaps silently dropped, unknown schemes ignored,
issuermetadata.go:48-73); `accumulate` returns whether this issuer had
already been seen with this expiration bucket — the caller uses that to
trigger directory allocation (filesystemdatabase.go:185-195).

A copy of ``ct_mapreduce_tpu.storage.issuermetadata``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
from typing import Iterable
from urllib.parse import urlparse

from ct_mapreduce_tpu_torch.core.types import ExpDate, Issuer
from ct_mapreduce_tpu_torch.storage.interfaces import RemoteCache

CRL_PREFIX = "crl"
ISSUERS_PREFIX = "issuer"


def crl_key(issuer: Issuer) -> str:
    return f"{CRL_PREFIX}::{issuer.id()}"


def issuers_key(issuer: Issuer) -> str:
    return f"{ISSUERS_PREFIX}::{issuer.id()}"


class IssuerMetadata:
    def __init__(self, issuer: Issuer, cache: RemoteCache):
        self.issuer = issuer
        self.cache = cache
        self._lock = threading.RLock()
        self._known_crl_dps: set[str] = set()
        self._known_issuer_dns: set[str] = set()
        self._known_exp_dates: set[str] = set()

    def id(self) -> str:
        return self.issuer.id()

    def _add_crl(self, crl: str) -> None:
        try:
            url = urlparse(crl.strip())
        except ValueError:
            return
        if url.scheme in ("ldap", "ldaps"):
            return
        if url.scheme not in ("http", "https"):
            return
        self.cache.set_insert(crl_key(self.issuer), url.geturl())

    def _add_issuer_dn(self, dn: str) -> None:
        self.cache.set_insert(issuers_key(self.issuer), dn)

    def accumulate(
        self, exp_date: ExpDate, issuer_dn: str, crl_dps: Iterable[str]
    ) -> bool:
        """Accumulate one certificate's metadata; must tolerate
        duplicates. Returns seen_exp_date_before
        (issuermetadata.go:92-138). Takes the already-extracted fields
        (the TPU pipeline extracts them in batch) rather than a parsed
        cert object."""
        exp_id = exp_date.id()
        with self._lock:
            seen_exp_date_before = exp_id in self._known_exp_dates
            seen_issuer_dn = issuer_dn in self._known_issuer_dns
            if not seen_exp_date_before:
                self._known_exp_dates.add(exp_id)
            new_dps = [dp for dp in crl_dps if dp not in self._known_crl_dps]
            self._known_crl_dps.update(new_dps)
            if not seen_issuer_dn:
                self._known_issuer_dns.add(issuer_dn)

        for dp in new_dps:
            self._add_crl(dp)
        if not seen_issuer_dn:
            self._add_issuer_dn(issuer_dn)
        return seen_exp_date_before

    def issuers(self) -> list[str]:
        return self.cache.set_list(issuers_key(self.issuer))

    def crls(self) -> list[str]:
        return self.cache.set_list(crl_key(self.issuer))
