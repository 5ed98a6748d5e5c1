"""Batched wide modular arithmetic on 16-bit limbs, in plain PyTorch (a
port of ``ct_mapreduce_tpu.ops.bigint``).

The plain version of the ECDSA verify kernel K6
(:mod:`~ct_mapreduce_tpu_torch.ops.ecdsa`, ``csrc/ecdsa_verify.cu``)
does its field arithmetic here: every lane is an independent big
integer over the P-256/P-384 primes and group orders, vectorised over a
batch axis.

Representation, as in the JAX package: an n·16-bit value is a tensor
``[..., n]`` of 16-bit limbs, little-endian (n = 16 for the 256-bit
curves, 24 for P-384), so every intermediate can be compared limb for
limb with the JAX function of the same name. The limbs ride in
``int64`` (torch's ``uint32`` lacks most arithmetic), and every result
is canonical: limbs < 2^16, values < the modulus where the JAX function
returns one.

Where the arithmetic departs from the JAX formulation (the values do
not): carries are not walked limb by limb. A column vector is first
folded (each column's high bits added into the next column) until every
column is at most 2^16, and the last carry is then resolved for all
columns at once by a carry-lookahead: the generate and propagate flags
of the columns, packed as bits of one ``int64`` per lane, are added as
two integers, and the carry into column k is bit k of the sum XOR
column k's propagate flag. Subtraction resolves its borrows the same
way. The Montgomery product forms the schoolbook and REDC columns as
``float64`` matrix products (16-bit limbs, at most 24 terms a column:
every partial sum is an integer below 2^53, so exact in any order) and
resolves them with two lookaheads. No step depends on the data, so no
step synchronises with the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NLIMB = 16  # 16 x 16-bit limbs = 256 bits (the P-256 width)
NLIMB384 = 24  # 24 x 16-bit limbs = 384 bits (the P-384 width)
RADIX = 16
MASK = 0xFFFF


def limbs_from_int(v: int, nlimb: int = NLIMB) -> np.ndarray:
    """Python int → uint32[nlimb] little-endian 16-bit limbs."""
    return np.array(
        [(v >> (RADIX * k)) & 0xFFFF for k in range(nlimb)], np.uint32
    )


def int_from_limbs(a) -> int:
    """[..., n] limbs (numpy or tensor) → python int (tests, debug)."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    return sum(int(a[..., k]) << (RADIX * k)
               for k in range(a.shape[-1]))


@dataclass(frozen=True)
class Mod:
    """One modulus' Montgomery constants (host numpy)."""

    n: np.ndarray  # uint32[nlimb] — the modulus
    n0p: np.uint32  # -n^-1 mod 2^16 (REDC quotient multiplier)
    r2: np.ndarray  # uint32[nlimb] — R^2 mod n (R = 2^(16·nlimb))
    one: np.ndarray  # uint32[nlimb] — plain 1 (from-Montgomery mult)
    one_m: np.ndarray  # uint32[nlimb] — R mod n (Montgomery 1)
    exp_inv_bits: np.ndarray  # uint32[16·nlimb] — bits of n-2, MSB
    # first (Fermat inversion exponent; n must be prime)
    n_int: int = 0  # the modulus as a python int
    np_full: int = 0  # -n^-1 mod R (the whole-width REDC multiplier)

    @property
    def nlimb(self) -> int:
        return int(self.n.shape[0])

    @classmethod
    def make(cls, n_int: int, nlimb: int = NLIMB) -> "Mod":
        bits_total = RADIX * nlimb
        r = 1 << bits_total
        n0p = (-pow(n_int, -1, 1 << RADIX)) % (1 << RADIX)
        e = n_int - 2
        bits = np.array(
            [(e >> (bits_total - 1 - i)) & 1 for i in range(bits_total)],
            np.uint32,
        )
        return cls(
            n=limbs_from_int(n_int, nlimb),
            n0p=np.uint32(n0p),
            r2=limbs_from_int(r * r % n_int, nlimb),
            one=limbs_from_int(1, nlimb),
            one_m=limbs_from_int(r % n_int, nlimb),
            exp_inv_bits=bits,
            n_int=n_int,
            np_full=(-pow(n_int, -1, r)) % r,
        )


# The field/order moduli of the P-256 and P-384 verifiers.
P256_P_INT = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
P256_N_INT = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
P384_P_INT = int(
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "effffffff0000000000000000ffffffff", 16)
P384_N_INT = int(
    "ffffffffffffffffffffffffffffffffffffffffffffffffc7634d81f4372dd"
    "f581a0db248b0a77aecec196accc52973", 16)

P256_P = Mod.make(P256_P_INT)
P256_N = Mod.make(P256_N_INT)
P384_P = Mod.make(P384_P_INT, NLIMB384)
P384_N = Mod.make(P384_N_INT, NLIMB384)

_CONSTS: dict = {}  # (what, key, device) → tensor


def _const(what: str, key, device: torch.device, make) -> torch.Tensor:
    k = (what, key, str(device))
    t = _CONSTS.get(k)
    if t is None:
        t = _CONSTS[k] = make().to(device)
    return t


def _limbs_t(v: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host limb constant as an int64 tensor on ``device`` (cached)."""
    return _const("limbs", v.tobytes(), device,
                  lambda: torch.from_numpy(v.astype(np.int64)))


def _weights(m: int, device: torch.device) -> torch.Tensor:
    """int64[m]: 2^k, the bit of column k in a packed flag word."""
    return _const("weights", m, device,
                  lambda: torch.tensor([1 << k for k in range(m)],
                                       dtype=torch.int64))


def _shifts(m: int, device: torch.device) -> torch.Tensor:
    return _const("shifts", m, device,
                  lambda: torch.arange(m, dtype=torch.int64))


def _lookahead(x: torch.Tensor, negative: bool):
    """Resolve one carry (or borrow) chain for all columns at once.

    ``x``: int64[..., m] with every column in [0, 2^16] (a carry) or in
    (-2^16, 2^16) (a borrow, ``negative``); overwritten. Returns the
    normalised limbs (x ± carry-in) mod 2^16 and the carry (borrow) out
    of the top column, int64[...] in {0, 1}. m stays below 63 (it is at
    most 49)."""
    m = x.shape[-1]
    w = _weights(m, x.device)
    if negative:
        gen = ((x < 0) * w).sum(-1)
    else:
        gen = ((x >> RADIX) * w).sum(-1)
    prop = ((x == (0 if negative else MASK)) * w).sum(-1)
    s = (gen | prop) + gen
    c = ((s ^ prop).unsqueeze(-1) >> _shifts(m, x.device)) & 1
    if negative:
        x -= c
    else:
        x += c
    x &= MASK
    return x, (s >> m) & 1


def _fold(x: torch.Tensor, passes: int) -> torch.Tensor:
    """Fold columns' high bits into the next column ``passes`` times, in
    place: int64[..., m] nonnegative → each column ≤ 2^16 once
    ``passes`` covers the input's magnitude. What leaves the top column
    is dropped (the caller leaves headroom, or wants the value mod
    2^(16m))."""
    for _ in range(passes):
        hi = x >> RADIX
        x &= MASK
        x[..., 1:] += hi[..., :-1]
    return x


def _passes(max_bits: int) -> int:
    """Fold passes after which columns below 2^max_bits are ≤ 2^16:
    a pass leaves column k at most 0xFFFF + (column k-1's bound >> 16)."""
    bound, n = (1 << max_bits) - 1, 0
    while bound > 1 << RADIX:
        bound = MASK + (bound >> RADIX)
        n += 1
    return n


def _normalize(x: torch.Tensor, max_bits: int, carry: bool = True):
    """Columns int64[..., m], each < 2^max_bits (overwritten) → (limbs,
    the carry word out of the top column; None when not ``carry``, the
    value then taken mod 2^(16m))."""
    if carry:  # one column of headroom holds the carry
        x = torch.nn.functional.pad(x, (0, 1))
    out, _ = _lookahead(_fold(x, _passes(max_bits)), False)
    if carry:
        return out[..., :-1], out[..., -1]
    return out, None


def bytes_to_limbs(b: torch.Tensor) -> torch.Tensor:
    """uint8[..., 2n] big-endian bytes → int64[..., n] limbs."""
    x = b.to(torch.int64).flip(-1)
    x = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return x[..., 0] | (x[..., 1] << 8)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """bool[...]: a == 0."""
    return (a == 0).all(-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool[...]: a == b limbwise."""
    return (a == b).all(-1)


def _carry_norm(a: torch.Tensor, n_out: int):
    """Propagate carries over ``a`` (int64[..., k], limbs < 2^31) into
    ``n_out`` normalised 16-bit limbs plus the final carry word; columns
    past ``n_out`` fold into the carry at its own position, as in the
    JAX function."""
    k = a.shape[-1]
    if k < n_out:
        a = torch.nn.functional.pad(a, (0, n_out - k))
    out, c = _normalize(a[..., :n_out].clone(), 31)
    if k > n_out:
        c = c + a[..., n_out:].sum(-1)
    return out, c


def sub_raw(a: torch.Tensor, b: torch.Tensor):
    """(a - b) mod 2^(16n) with the final borrow: (limbs, borrow[...])."""
    return _lookahead(a - b, True)


def geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool[...]: a >= b."""
    _, borrow = sub_raw(a, b)
    return borrow == 0


def _cond_sub_n(a: torch.Tensor, carry, mod: Mod) -> torch.Tensor:
    """a (< 2n, possibly with a 2^(16n) carry bit) → canonical a mod n."""
    sub, borrow = sub_raw(a, _limbs_t(mod.n, a.device))
    take = (carry != 0) | (borrow == 0)
    return torch.where(take.unsqueeze(-1), sub, a)


def _neg_limbs(mod: Mod, device: torch.device) -> torch.Tensor:
    """int64[nl]: the limbs of R - n (adding them subtracts n mod R)."""
    return _const("neg", mod.n_int, device, lambda: torch.from_numpy(
        limbs_from_int((1 << (RADIX * mod.nlimb)) - mod.n_int,
                       mod.nlimb).astype(np.int64)))


def _pick(rows: torch.Tensor, use_second: torch.Tensor) -> torch.Tensor:
    return torch.where(use_second.unsqueeze(-1), rows[1], rows[0])


def add_mod(a: torch.Tensor, b: torch.Tensor, mod: Mod) -> torch.Tensor:
    """(a + b) mod n for canonical a, b < n: a + b and a + b + (R - n)
    resolved in one stacked lookahead; the second row overflows R
    exactly when a + b ≥ n."""
    s = a + b
    rows = torch.stack((s, s + _neg_limbs(mod, a.device)))
    out, _ = _lookahead(_fold(torch.nn.functional.pad(rows, (0, 1)), 1),
                        False)
    return _pick(out[..., :-1], out[1, ..., -1] != 0)


def sub_mod(a: torch.Tensor, b: torch.Tensor, mod: Mod) -> torch.Tensor:
    """(a - b) mod n for canonical a, b < n: a + (R - 1 - b) + 1 = a - b
    + R, and that + n, resolved in one stacked lookahead; the first row
    overflows R exactly when a ≥ b."""
    d = a + (MASK - b)
    d[..., 0] += 1
    rows = torch.stack((d, d + _limbs_t(mod.n, a.device)))
    out, _ = _lookahead(_fold(torch.nn.functional.pad(rows, (0, 1)), 1),
                        False)
    return _pick(out[..., :-1], out[0, ..., -1] == 0)


def mod_reduce_once(a: torch.Tensor, mod: Mod) -> torch.Tensor:
    """a mod n for a < 2n (one conditional subtract) — enough for a
    256-bit SHA digest against the P-256 order, and for x_R mod n."""
    return _cond_sub_n(a, 0, mod)


def _diag_sum(nl: int, device: torch.device) -> torch.Tensor:
    """float64[nl·nl, 2nl]: sums the outer product's anti-diagonals
    (entry (i, j) into column i + j)."""
    def make():
        s = torch.zeros((nl * nl, 2 * nl), dtype=torch.float64)
        i = torch.arange(nl * nl)
        s[i, i // nl + i % nl] = 1.0
        return s
    return _const("diag", nl, device, make)


def _toeplitz(v: int, nl: int, cols: int, device: torch.device):
    """float64[nl, cols]: row i holds the limbs of ``v`` from column i,
    so ``x @ T`` gives the columns of the product x·v (cut at ``cols``)."""
    def make():
        limbs = limbs_from_int(v, nl).astype(np.float64)
        t = np.zeros((nl, cols), np.float64)
        for i in range(nl):
            w = min(nl, cols - i)
            if w > 0:
                t[i, i:i + w] = limbs[:w]
        return torch.from_numpy(t)
    return _const("toeplitz", (v, nl, cols), device, make)


def mont_mul(a: torch.Tensor, b: torch.Tensor, mod: Mod) -> torch.Tensor:
    """Montgomery product a·b·R^-1 mod n (R = 2^(16·nl)), canonical;
    broadcasts over leading dimensions, so independent products stack
    into one call.

    Preconditions, as in the JAX function: b < n; a < R. The columns of
    T = a·b stay unnormalised (each < 2^37); m = T·(-N^-1) mod R is
    formed from their 16-bit halves (two exact ``float64`` products)
    and normalised mod R; (T + m·N) / R < 2n is normalised and
    canonicalised by one conditional subtract."""
    nl = mod.nlimb
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    dev = a.device
    af = a.to(torch.float64).expand(*shape, nl)
    bf = b.to(torch.float64).expand(*shape, nl)
    outer = (af.unsqueeze(-1) * bf.unsqueeze(-2)).reshape(*shape, nl * nl)
    t_cols = (outer @ _diag_sum(nl, dev)).to(torch.int64)  # < 2^37
    low = t_cols[..., :nl]
    npt = _toeplitz(mod.np_full, nl, nl, dev)
    m_cols = ((low & MASK).to(torch.float64) @ npt).to(torch.int64)
    hi = ((low >> RADIX).to(torch.float64) @ npt).to(torch.int64)
    m_cols[..., 1:] += hi[..., :-1]  # the high halves sit a column up
    m, _ = _normalize(m_cols, 44, carry=False)  # m mod R
    u_cols = (m.to(torch.float64)
              @ _toeplitz(mod.n_int, nl, 2 * nl, dev)).to(torch.int64)
    u_cols = torch.nn.functional.pad(u_cols + t_cols, (0, 1))
    # Rows U and U + (R - n)·R, one lookahead: U/R < 2n, and the second
    # row's top limb is 1 exactly when U/R ≥ n, its high limbs then
    # U/R - n (the low nl limbs of both are 0 by construction).
    rows = torch.stack((u_cols, u_cols.clone()))
    rows[1, ..., nl:2 * nl] += _neg_limbs(mod, dev)
    out, _ = _lookahead(_fold(rows, _passes(39)), False)
    return _pick(out[..., nl:2 * nl], out[1, ..., 2 * nl] != 0)


def to_mont(a: torch.Tensor, mod: Mod) -> torch.Tensor:
    """a → a·R mod n (a any nl-limb value < R)."""
    return mont_mul(a, _limbs_t(mod.r2, a.device), mod)


def from_mont(a_m: torch.Tensor, mod: Mod) -> torch.Tensor:
    """a·R → a mod n."""
    return mont_mul(a_m, _limbs_t(mod.one, a_m.device), mod)


def mont_sqr(a: torch.Tensor, mod: Mod) -> torch.Tensor:
    return mont_mul(a, a, mod)


def mont_inv(a_m: torch.Tensor, mod: Mod) -> torch.Tensor:
    """Montgomery-domain inverse via Fermat: a^(n-2) (n prime), MSB
    first in fixed 4-bit windows over the constant exponent (a^0..a^15
    precomputed): the same value as the JAX bit-by-bit loop, in about
    2/3 of the products. a_m == 0 → 0 (the ECDSA caller masks those
    lanes out via its own validity flags)."""
    one = _limbs_t(mod.one_m, a_m.device).expand(a_m.shape)
    powers = [one, a_m]
    for _ in range(14):
        powers.append(mont_mul(powers[-1], a_m, mod))
    bits = mod.exp_inv_bits.tolist()
    acc = None
    for i in range(0, len(bits), 4):
        d = bits[i] << 3 | bits[i + 1] << 2 | bits[i + 2] << 1 | bits[i + 3]
        if acc is None:
            if d:
                acc = powers[d]
            continue
        for _ in range(4):
            acc = mont_sqr(acc, mod)
        if d:
            acc = mont_mul(acc, powers[d], mod)
    return one.clone() if acc is None else acc


def batch_inv_mont(a_m: torch.Tensor, mod: Mod) -> torch.Tensor:
    """Montgomery batch inversion across the batch dimension.

    ``a_m``: [B, nl] canonical Montgomery-domain values. Returns the
    per-lane Montgomery-domain inverses (bit-identical to
    :func:`mont_inv` lane by lane — the inverse is unique): an
    exclusive prefix product down the batch, one Fermat inversion of
    the total, and a reverse suffix unwind. Zero lanes are masked
    THROUGH the product — replaced by 1 before it and forced to 0 after
    — so an adversarial lane cannot poison a neighbour's inverse."""
    one_m = _limbs_t(mod.one_m, a_m.device)
    zero_lane = is_zero(a_m)
    safe = torch.where(zero_lane.unsqueeze(-1), one_m, a_m)
    n = int(a_m.shape[0])
    pre = []
    c = one_m
    for i in range(n):
        pre.append(c)
        c = mont_mul(c, safe[i], mod)
    tinv = mont_inv(c, mod)
    inv = [None] * n
    for i in range(n - 1, -1, -1):
        inv[i] = mont_mul(tinv, pre[i], mod)
        tinv = mont_mul(tinv, safe[i], mod)
    out = torch.stack(inv) if n else torch.zeros_like(a_m)
    return torch.where(zero_lane.unsqueeze(-1), torch.zeros_like(a_m), out)


def bit_at(a: torch.Tensor, k: int) -> torch.Tensor:
    """Bit ``k`` of a limb value: int64[...] in {0, 1}."""
    return (a[..., k >> 4] >> (k & 15)) & 1


def window_digit(a: torch.Tensor, j: int, w: int) -> torch.Tensor:
    """Window ``j``'s w-bit digit of a limb value: int64[...] in [0,
    2^w). ``w`` must divide 16 so a digit never straddles limbs."""
    bit = j * w
    return (a[..., bit >> 4] >> (bit & 15)) & ((1 << w) - 1)
