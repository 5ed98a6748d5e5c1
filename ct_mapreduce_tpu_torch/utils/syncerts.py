"""Synthetic certificate streams for tests and the card smoke run.

A copy of the dependency-free half of ``ct_mapreduce_tpu.utils.syncerts``.
It builds ONE template per issuer with the hand-assembled
:mod:`~ct_mapreduce_tpu_torch.utils.minicert` builder (no
``cryptography`` package needed) and then stamps out arbitrarily many
structurally-valid variants by patching the serial INTEGER bytes in
place — the parse/filter/fingerprint/dedup pipeline never verifies
signatures, exactly like the reference's ingest path
(reference cmd/ct-fetch/ct-fetch.go:198-226 parses, never verifies
chains).

Serials are fixed-length with a constant positive first byte, so DER
lengths never change and every variant remains canonical DER.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np

from ct_mapreduce_tpu_torch.core import der as hostder
from ct_mapreduce_tpu_torch.utils import minicert

SERIAL_LEN = 16  # bytes of DER INTEGER content in the template


@dataclass
class CertTemplate:
    """A leaf template whose serial window can be restamped."""

    leaf_der: bytes
    issuer_der: bytes
    serial_off: int  # offset of the serial content bytes in leaf_der
    serial_len: int


def _build_pair_minicert(
    issuer_cn: str,
    not_after: datetime.datetime,
    crl_dp: str | None,
    key_type: str = "ec",
    serial_len: int = SERIAL_LEN,
    rich_extensions: bool = False,
) -> tuple[bytes, bytes]:
    if key_type not in ("ec", "rsa2048"):
        raise ValueError(f"unknown key_type {key_type!r} (ec | rsa2048)")
    # Size realism without a signer: RSA-2048 leaves carry ~550 B more
    # key+signature DER than P-256; the production extension load adds
    # ~700 B (SAN/AIA/KU/EKU/SKI/AKI/policies/SCTs) — pad with one
    # opaque extension so row-byte-proportional code paths see the
    # same regime.
    extra = 0
    if key_type == "rsa2048":
        extra += 550
    if rich_extensions:
        extra += 700
    issuer_der = minicert.make_cert(
        serial=1, issuer_cn=issuer_cn, is_ca=True, not_after=not_after)
    leaf_der = minicert.make_cert(
        serial=0, issuer_cn=issuer_cn, subject_cn="bench.example.com",
        is_ca=False, not_after=not_after,
        crl_dps=(crl_dp,) if crl_dp else (),
        serial_len=serial_len, extra_ext_bytes=extra)
    return leaf_der, issuer_der


def make_template(
    issuer_cn: str = "Bench Issuer CA",
    not_after: datetime.datetime | None = None,
    crl_dp: str | None = "http://crl.bench.example/latest.crl",
    key_type: str = "ec",
    serial_len: int = SERIAL_LEN,
    rich_extensions: bool = False,
) -> CertTemplate:
    if not 8 <= serial_len <= 20:
        # < 8 leaves no room for the epoch+lane counter fields the
        # stampers use; > 20 exceeds RFC 5280's serial bound.
        raise ValueError(f"serial_len {serial_len} outside 8..20")
    not_after = not_after or datetime.datetime(
        2031, 6, 15, tzinfo=datetime.timezone.utc
    )
    leaf_der, issuer_der = _build_pair_minicert(
        issuer_cn, not_after, crl_dp, key_type=key_type,
        serial_len=serial_len, rich_extensions=rich_extensions)
    fields = hostder.parse_cert(leaf_der)
    if fields.serial_len != serial_len:
        raise ValueError(
            f"template serial is {fields.serial_len} bytes, want {serial_len}")
    return CertTemplate(
        leaf_der=leaf_der,
        issuer_der=issuer_der,
        serial_off=fields.serial_off,
        serial_len=fields.serial_len,
    )


def stamp_serial(template: CertTemplate, counter: int) -> bytes:
    """One DER variant: template with serial content = 0x4D ‖ counter."""
    n = template.serial_len
    body = counter.to_bytes(n - 1, "big")
    der = bytearray(template.leaf_der)
    der[template.serial_off + 1 : template.serial_off + n] = body
    return bytes(der)


def stamp_batch_array(
    template: CertTemplate,
    start: int,
    batch: int,
    pad_len: int,
    rng_mix: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized restamp: uint8[batch, pad_len] data + int32 lengths.

    Serials are ``start..start+batch`` mixed with ``rng_mix`` so
    successive epochs produce disjoint serial spaces — no per-entry
    Python loop.
    """
    base = np.frombuffer(template.leaf_der, dtype=np.uint8)
    if base.size > pad_len:
        raise ValueError(f"template ({base.size}B) exceeds pad length {pad_len}")
    data = np.zeros((batch, pad_len), dtype=np.uint8)
    data[:, : base.size] = base[None, :]
    counters = (np.arange(start, start + batch, dtype=np.uint64)
                ^ np.uint64(rng_mix))
    # big-endian expansion of the counter into the low serial bytes
    # (8 of them, or serial_len - 1 for short serials — byte 0 stays
    # the fixed positive 0x4D either way)
    off = template.serial_off
    for i in range(min(8, template.serial_len - 1)):
        data[:, off + template.serial_len - 1 - i] = (
            (counters >> np.uint64(8 * i)) & np.uint64(0xFF)
        ).astype(np.uint8)
    lengths = np.full((batch,), base.size, dtype=np.int32)
    return data, lengths


def zipf_weights(n: int, s: float = 1.1) -> np.ndarray:
    """Zipf issuer split (CT reality: a handful of CAs dominate)."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()
