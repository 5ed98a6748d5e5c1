"""Pure-python signature verification — the exactness reference (a copy
of ``ct_mapreduce_tpu.verify.host``).

The batched verify (:mod:`ct_mapreduce_tpu_torch.ops.ecdsa`, and the
CUDA kernel K6 behind it) must produce verdicts bit-identical to
:func:`verify_ecdsa` on every input; the known-answer corpora in
tests/test_torch_verify.py pin that. This module is also the *fallback lane*:
signatures the extractor routes around the device kernel (odd curves,
RSA) verify here, so every SCT gets the same-math verdict regardless
of which lane decided it — the walker-fallback contract applied to
verification.

Dependency-free (python ints + hashlib): runs on hosts without the
``cryptography`` package, same degradation contract as the minicert
fixtures.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass


@dataclass(frozen=True)
class Curve:
    """Short-Weierstrass curve y² = x³ + ax + b over GF(p)."""

    name: str
    p: int
    n: int  # group order (prime)
    a: int
    b: int
    gx: int
    gy: int

    @property
    def byte_len(self) -> int:
        return (self.p.bit_length() + 7) // 8


P256 = Curve(
    name="p256",
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    a=-3,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)

P384 = Curve(
    name="p384",
    p=int("fffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
          "effffffff0000000000000000ffffffff", 16),
    n=int("ffffffffffffffffffffffffffffffffffffffffffffffffc7634d81f4372dd"
          "f581a0db248b0a77aecec196accc52973", 16),
    a=-3,
    b=int("b3312fa7e23ee7e4988e056be3f82d19181d9c6efe8141120314088f5013875a"
          "c656398d8a2ed19d2a85c8edd3ec2aef", 16),
    gx=int("aa87ca22be8b05378eb1c71ef320ad746e1d3b628ba79b9859f741e082542a3"
           "85502f25dbf55296c3a545e3872760ab7", 16),
    gy=int("3617de4a96262c6f5d9e98bf9292dc29f8f41dbd289a147ce9da3113b5f0b8c"
           "00a60b1ce1d7e819d7a431d7c90ea0e5f", 16),
)

CURVES = {c.name: c for c in (P256, P384)}


def _point_add(c: Curve, P, Q):
    """Affine group law; None is the point at infinity."""
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if (y1 + y2) % c.p == 0:
            return None
        lam = (3 * x1 * x1 + c.a) * pow(2 * y1, -1, c.p) % c.p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, c.p) % c.p
    x3 = (lam * lam - x1 - x2) % c.p
    return x3, (lam * (x1 - x3) - y1) % c.p


def _point_mul(c: Curve, k: int, P):
    R = None
    while k:
        if k & 1:
            R = _point_add(c, R, P)
        P = _point_add(c, P, P)
        k >>= 1
    return R


def digest_to_z(c: Curve, digest: bytes) -> int:
    """Leftmost min(hashbits, nbits) bits of the digest (SEC1 §4.1.4)."""
    z = int.from_bytes(digest, "big")
    excess = len(digest) * 8 - c.n.bit_length()
    if excess > 0:
        z >>= excess
    return z


def verify_ecdsa(c: Curve, digest: bytes, r: int, s: int,
                 x: int, y: int) -> bool:
    """The reference ECDSA verdict. Every check the device kernel
    makes, in the same semantics: range-check r/s, range- and
    curve-check the public key, compare r to x_R mod n."""
    if not (1 <= r < c.n and 1 <= s < c.n):
        return False
    if not (0 <= x < c.p and 0 <= y < c.p) or (x == 0 and y == 0):
        return False
    if (y * y - (x * x * x + c.a * x + c.b)) % c.p != 0:
        return False
    w = pow(s, -1, c.n)
    z = digest_to_z(c, digest)
    u1 = z * w % c.n
    u2 = r * w % c.n
    R = _point_add(
        c,
        _point_mul(c, u1, (c.gx, c.gy)),
        _point_mul(c, u2, (x, y)),
    )
    if R is None:
        return False
    return R[0] % c.n == r


def sign_ecdsa(c: Curve, digest: bytes, d: int, k: int) -> tuple[int, int]:
    """Deterministic-nonce signing for FIXTURES ONLY (the nonce is
    caller-supplied; nothing here is a secure signer). Returns (r, s);
    raises if the nonce degenerates (re-pick upstream)."""
    R = _point_mul(c, k, (c.gx, c.gy))
    if R is None:
        raise ValueError("degenerate nonce")
    r = R[0] % c.n
    s = pow(k, -1, c.n) * (digest_to_z(c, digest) + r * d) % c.n
    if r == 0 or s == 0:
        raise ValueError("degenerate signature")
    return r, s


# -- RSA PKCS#1 v1.5 (the fallback for RSA-signed SCTs) -----------------

_SHA256_DIGESTINFO = bytes.fromhex(
    "3031300d060960864801650304020105000420"
)


def verify_rsa_pkcs1_sha256(digest: bytes, sig: bytes,
                            n: int, e: int) -> bool:
    """RSA PKCS#1 v1.5 over a precomputed SHA-256 digest."""
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    m = pow(int.from_bytes(sig, "big"), e, n)
    em = m.to_bytes(k, "big")
    ps = k - len(_SHA256_DIGESTINFO) - len(digest) - 3
    expect = (b"\x00\x01" + b"\xff" * ps + b"\x00"
              + _SHA256_DIGESTINFO + digest)
    return em == expect


def sign_rsa_pkcs1_sha256(digest: bytes, n: int, d: int) -> bytes:
    """Fixture-only PKCS#1 v1.5 signing."""
    k = (n.bit_length() + 7) // 8
    ps = k - len(_SHA256_DIGESTINFO) - len(digest) - 3
    em = (b"\x00\x01" + b"\xff" * ps + b"\x00"
          + _SHA256_DIGESTINFO + digest)
    return pow(int.from_bytes(em, "big"), d, n).to_bytes(k, "big")


def derive_scalar(seed: str, c: Curve = P256) -> int:
    """Deterministic private scalar for fixture keys: d ∈ [1, n-1]."""
    h = int.from_bytes(
        hashlib.sha512(b"ctmr-log-key:" + seed.encode()).digest(), "big"
    )
    return h % (c.n - 1) + 1


def derive_nonce(seed: str, digest: bytes, c: Curve = P256) -> int:
    """Deterministic fixture nonce (NOT RFC 6979; test-only)."""
    h = int.from_bytes(
        hashlib.sha512(b"ctmr-k:" + seed.encode() + digest).digest(), "big"
    )
    return h % (c.n - 1) + 1
