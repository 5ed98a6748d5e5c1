"""The port's DER walker (plain PyTorch version) against the JAX
package's ``ops/der_kernel.py``.

The same packed rows go through ``parse_certs_rows`` (with and without
the issuer-CN scan), ``gather_serials_rows`` and ``window_bytes_rows``
on both sides: the ``syncerts`` and ``tests/certgen.py`` corpora, at
least 200 ``core/divergence.py::grammar_mutants``, the leaves of
``tests/data/recorded_shard.json.gz``, the crafted edge cases of
``utils/dercases.py`` (issuer RDNs past ``MAX_RDNS``, extensions past
``MAX_EXTS``, long-form lengths 0x81-0x84, serials of 0..47 bytes,
lengths of at most 4 and past the row, and the boundary family that
puts each frame at every offset modulo 16) and byte-flip mutants. Two row
widths: 192 bytes (the JAX walker's flat window path, every
certificate cut short) and 2048 bytes (its two-level path). Tolerance:
exact equality.
"""

import datetime
import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_mapreduce_tpu.audit import fixture as audit_fixture
from ct_mapreduce_tpu.core import divergence
from ct_mapreduce_tpu.ops import der_kernel as jder
from ct_mapreduce_tpu_torch.ops import der_kernel as tder
from ct_mapreduce_tpu_torch.utils import dercases, syncerts

from certgen import make_cert

UTC = datetime.timezone.utc
CN_WINDOW = jder.MAX_FIXED_WINDOW_BYTES


def _certgen_bases():
    return [
        make_cert(serial=0xDEADBEEF),
        make_cert(serial=0x00AA00BB, issuer_cn="Leading Zero CA"),
        make_cert(serial=1),
        make_cert(serial=(1 << 152) - 5),
        make_cert(is_ca=True, subject_cn="ca.example.com"),
        make_cert(add_basic_constraints=False),
        make_cert(crl_dps=("http://crl.example.com/a.crl",
                           "https://crl2.example.com/b.crl")),
        make_cert(not_after=datetime.datetime(2055, 6, 1, 13, 37, tzinfo=UTC)),
        make_cert(not_after=datetime.datetime(2049, 12, 31, 23, 59, tzinfo=UTC)),
        make_cert(issuer_cn="日本語テストCA"),
    ]


def corpus_rows(pad: int = 2048):
    """Every corpus of this file packed at ``pad``: (uint8 rows, int32
    lengths)."""
    ders = []
    for i in range(6):
        t = syncerts.make_template(
            issuer_cn=f"Corpus Issuer {i}", serial_len=8 + 2 * i,
            key_type="rsa2048" if i % 2 else "ec", rich_extensions=i > 1,
            not_after=datetime.datetime(2026 + 20 * i, 5, 6, 7, tzinfo=UTC))
        ders += [t.leaf_der, t.issuer_der]
    bases = _certgen_bases()
    ders += bases
    ders += divergence.grammar_mutants(bases, np.random.default_rng(20261017),
                                       240)
    root = os.path.dirname(os.path.abspath(__file__))
    with gzip.open(os.path.join(root, "data", "recorded_shard.json.gz"),
                   "rt", encoding="utf-8") as fh:
        doc = json.load(fh)
    ders += audit_fixture.shard_ders(doc)
    pairs = [(d, None) for d in ders] + dercases.crafted()
    data, length = dercases.pack(pairs, pad)
    mut, mlen = dercases.mutate_rows(data, length, 400,
                                     np.random.default_rng(7))
    return np.concatenate([data, mut]), np.concatenate([length, mlen])


@pytest.fixture(scope="module")
def corpus():
    return corpus_rows()


@jax.jit
def _jax_walk(data, length, off):
    rows = jder.pack_rows(data)
    full = jder.parse_certs_rows(rows, length, scan_issuer_cn=True)
    no_cn = jder.parse_certs_rows(rows, length, scan_issuer_cn=False)
    serials = jder.gather_serials_rows(rows, full.serial_off, full.serial_len)
    cn = jder.window_bytes_rows(rows, full.issuer_cn_off, CN_WINDOW)
    at_off = jder.window_bytes_rows(rows, off, CN_WINDOW)
    return full, no_cn, serials, cn, at_off


@pytest.mark.parametrize("pad", [192, 2048])
def test_walker_matches_jax(corpus, pad):
    data, length = corpus
    data = np.ascontiguousarray(data[:, :pad])
    rng = np.random.default_rng(pad)
    off = rng.integers(-8, pad + 300, data.shape[0]).astype(np.int32)
    full, no_cn, (ser, fits), cn, at_off = _jax_walk(
        jnp.asarray(data), jnp.asarray(length), jnp.asarray(off))
    d, ln = torch.from_numpy(data), torch.from_numpy(length)
    for scan, want in ((True, full), (False, no_cn)):
        got = tder.walk(d, ln, scan, CN_WINDOW if scan else 0)
        for f in jder.ParsedCerts._fields:
            np.testing.assert_array_equal(
                getattr(got.parsed, f).numpy(), np.asarray(getattr(want, f)),
                err_msg=f"{f} (scan_issuer_cn={scan}, pad {pad})")
    np.testing.assert_array_equal(got.serials.numpy(), np.asarray(ser))
    np.testing.assert_array_equal(got.fits.numpy(), np.asarray(fits))
    got = tder.walk(d, ln, True, CN_WINDOW)
    np.testing.assert_array_equal(got.cn_window.numpy(),
                                  np.asarray(cn).astype(np.uint8))
    gs, gf = tder.gather_serials_rows(d, got.parsed.serial_off,
                                      got.parsed.serial_len)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ser))
    np.testing.assert_array_equal(
        tder.window_bytes_rows(d, torch.from_numpy(off), CN_WINDOW).numpy(),
        np.asarray(at_off))
    ok = np.asarray(full.ok)
    if pad > 256:
        # The corpus reaches the walker's paths: accepted and rejected
        # lanes, CA flags, CRLDP windows, found CNs, oversized serials.
        assert 0.5 < ok.mean() < 1
        assert np.asarray(full.is_ca).any() and np.asarray(full.has_crldp).any()
        assert (np.asarray(full.issuer_cn_len) > 0).any()
        assert not np.asarray(fits).all()
    else:  # every certificate runs past the narrow rows
        assert not ok.any()


def test_boundary_family_puts_frames_at_every_chunk_offset():
    """The boundary family keeps its purpose: the walker accepts every
    certificate of it, and the serial, issuer, issuer CN, SPKI and CRLDP
    offsets each take all 16 values modulo 16."""
    data, length = dercases.pack(dercases.boundary_family(), 2048)
    got = tder.walk(torch.from_numpy(data), torch.from_numpy(length), True,
                    CN_WINDOW)
    p = got.parsed
    assert p.ok.all() and p.has_crldp.all() and p.is_ca.any()
    for f in ("serial_off", "issuer_off", "issuer_cn_off", "spki_off",
              "crldp_off"):
        residues = set((getattr(p, f).numpy() % 16).tolist())
        assert residues == set(range(16)), f
