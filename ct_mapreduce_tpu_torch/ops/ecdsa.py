"""Batched ECDSA verification (P-256 + P-384): the plain PyTorch version
of the hand-written CUDA kernel K6, and the dispatch between the two (a
port of ``ct_mapreduce_tpu.ops.ecdsa``).

Two ladder formulations share one verdict contract — a lane's verdict
is the mathematical ECDSA verdict, bit-identical to the pure-python
reference verifier (:mod:`ct_mapreduce_tpu_torch.verify.host`) on EVERY
input, adversarial ones included:

- **Windowed precompute ladder (the default, ``window`` 2, 4 or 8).**
  u1·G reads a fixed-base window table of G and u2·Q a per-key window
  table of the log key (the verify lane caches those per key), so the
  dual-scalar multiplication is 2·(bits/w) COMPLETE projective mixed
  additions (Renes–Costello–Batina 2015, a = -3: no exceptional cases)
  and no doublings.
- **Jacobian Shamir ladder (window = 0).** A double and a select-based
  complete mixed addition of G, Q or G + Q a bit, MSB first.

:func:`verify_windowed` and :func:`verify_jacobian` run the kernel
(:mod:`~ct_mapreduce_tpu_torch.ops.ecdsa_cuda`) on CUDA tensors and the
plain versions :func:`_verify_windowed` / :func:`_verify_jacobian` on
CPU tensors; there is no fallback between the two.

Tables: :func:`point_table_np` builds a window table in the JAX
package's layout (16-bit limbs, Montgomery form, equal to the JAX
function's output). A table is shipped to a device once, packed to
32-bit limbs (``lo | hi << 16``, the same Montgomery R, since 2^(16·16)
= 2^(32·8)) as ``int32`` bit patterns: ``[nwin, 2^w, 2, nl/2]`` for the
G table and ``[K, nwin, 2^w, 2, nl/2]`` for the Q-table slots — the
kernel's layout, which the plain version unpacks per gathered entry.

Where the plain version departs from the JAX one (the values do not):
s⁻¹ and the final 1/Z are per-lane Fermat inversions
(:func:`bigint.mont_inv`) where the JAX windowed ladder runs
:func:`bigint.batch_inv_mont` across the batch; the inverse is unique
and zero inverts to zero in both, so every value is the same. The
Jacobian addition computes its doubling branch only when a lane needs
it.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ct_mapreduce_tpu_torch.device import resolve_device
from ct_mapreduce_tpu_torch.ops import bigint
from ct_mapreduce_tpu_torch.ops.bigint import (
    P256_N,
    P256_P,
    P384_N,
    P384_P,
    Mod,
    add_mod,
    bytes_to_limbs,
    eq,
    from_mont,
    geq,
    is_zero,
    mod_reduce_once,
    mont_inv,
    mont_mul,
    mont_sqr,
    sub_mod,
    to_mont,
)
from ct_mapreduce_tpu_torch.verify import host as vhost

DEFAULT_WINDOW = 8  # verifyPrecompWindow default; 0 = the Jacobian ladder
VALID_WINDOWS = (0, 2, 4, 8)  # w must divide 16 (limb radix)
MIN_QTABLE_SLOTS = 32  # Q-table slot floor of the convenience wrapper


@dataclass(frozen=True)
class CurveOps:
    """One curve's constants (host numpy). ``curve`` is the pure-python
    reference curve — table generation runs through it so every
    precomputed point is independently derivable."""

    name: str
    curve: vhost.Curve
    mod_p: Mod
    mod_n: Mod
    b_m: np.ndarray  # curve b, Montgomery domain
    gx_m: np.ndarray  # generator, Montgomery domain
    gy_m: np.ndarray
    nbits: int
    byte_len: int


def _make_ops(curve: vhost.Curve, mod_p: Mod, mod_n: Mod) -> CurveOps:
    nl = mod_p.nlimb
    r = 1 << (bigint.RADIX * nl)
    p = curve.p
    return CurveOps(
        name=curve.name,
        curve=curve,
        mod_p=mod_p,
        mod_n=mod_n,
        b_m=bigint.limbs_from_int(curve.b * r % p, nl),
        gx_m=bigint.limbs_from_int(curve.gx * r % p, nl),
        gy_m=bigint.limbs_from_int(curve.gy * r % p, nl),
        nbits=bigint.RADIX * nl,
        byte_len=2 * nl,
    )


P256_OPS = _make_ops(vhost.P256, P256_P, P256_N)
P384_OPS = _make_ops(vhost.P384, P384_P, P384_N)
CURVE_OPS = {o.name: o for o in (P256_OPS, P384_OPS)}


def resolve_precomp_window(window: Optional[int] = None) -> int:
    """The ``verifyPrecompWindow`` knob: explicit value (≥ 0) >
    ``CTMR_VERIFY_PRECOMP_WINDOW`` env > default 8. 0 selects the
    Jacobian ladder; invalid values (the window must divide 16) fall
    back to the default."""
    if window is None or window < 0:
        try:
            window = int(
                os.environ.get("CTMR_VERIFY_PRECOMP_WINDOW", "") or -1)
        except ValueError:
            window = -1
    if window < 0 or window not in VALID_WINDOWS:
        return DEFAULT_WINDOW if window != 0 else 0
    return window


def _c(v: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host limb constant broadcast to ``like``'s shape."""
    return bigint._limbs_t(v, like.device).expand(like.shape)


# -- Jacobian ladder primitives (window = 0) -----------------------------

def _mul(mod: Mod, pairs) -> tuple:
    """Independent Montgomery products in one stacked call."""
    a = torch.stack([p[0] for p in pairs])
    b = torch.stack([p[1] for p in pairs])
    return tuple(mont_mul(a, b, mod).unbind(0))


def _dbl(x1, y1, z1, mod: Mod):
    """Jacobian doubling, a = -3 (dbl-2001-b). Z = 0 stays Z = 0."""
    delta, gamma = _mul(mod, ((z1, z1), (y1, y1)))
    t0 = sub_mod(x1, delta, mod)
    t1 = add_mod(x1, delta, mod)
    t2 = add_mod(y1, z1, mod)
    beta, alpha, g2, t2sq = _mul(
        mod, ((x1, gamma), (t0, t1), (gamma, gamma), (t2, t2)))
    alpha = add_mod(add_mod(alpha, alpha, mod), alpha, mod)
    b2 = add_mod(beta, beta, mod)
    b4 = add_mod(b2, b2, mod)
    b8 = add_mod(b4, b4, mod)
    x3 = sub_mod(mont_sqr(alpha, mod), b8, mod)
    z3 = sub_mod(sub_mod(t2sq, gamma, mod), delta, mod)
    g8 = add_mod(add_mod(g2, g2, mod), add_mod(g2, g2, mod), mod)
    g8 = add_mod(g8, g8, mod)
    y3 = sub_mod(mont_mul(alpha, sub_mod(b4, x3, mod), mod), g8, mod)
    return x3, y3, z3


def _sel(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane limb select: c bool[...], a/b [..., nl]."""
    return torch.where(c.unsqueeze(-1), a, b)


def _add_mixed(x1, y1, z1, x2, y2, q_inf, mod: Mod):
    """Complete Jacobian + affine addition by select: P at infinity →
    Q, Q at infinity → P, P == Q → double, P == -Q → infinity."""
    p_inf = is_zero(z1)
    z1z1 = mont_sqr(z1, mod)
    u2, z1_3 = _mul(mod, ((x2, z1z1), (z1, z1z1)))
    s2 = mont_mul(y2, z1_3, mod)
    h = sub_mod(u2, x1, mod)
    rr = sub_mod(s2, y1, mod)
    hh, rr2, z3 = _mul(mod, ((h, h), (rr, rr), (z1, h)))
    hhh, v = _mul(mod, ((h, hh), (x1, hh)))
    x3 = sub_mod(sub_mod(rr2, hhh, mod), add_mod(v, v, mod), mod)
    ya, yb = _mul(mod, ((rr, sub_mod(v, x3, mod)), (y1, hhh)))
    y3 = sub_mod(ya, yb, mod)

    same_x = is_zero(h) & ~p_inf & ~q_inf
    dbl_case = same_x & is_zero(rr)
    neg_case = same_x & ~is_zero(rr)
    if bool(dbl_case.any()):
        dx, dy, dz = _dbl(x1, y1, z1, mod)
        x3 = _sel(dbl_case, dx, x3)
        y3 = _sel(dbl_case, dy, y3)
        z3 = _sel(dbl_case, dz, z3)

    zero = torch.zeros_like(x1)
    one_m = _c(mod.one_m, x1)
    z3 = _sel(neg_case, zero, z3)
    x3 = _sel(p_inf, x2, x3)
    y3 = _sel(p_inf, y2, y3)
    z3 = _sel(p_inf, _sel(q_inf, zero, one_m), z3)
    q_only = q_inf & ~p_inf
    x3 = _sel(q_only, x1, x3)
    y3 = _sel(q_only, y1, y3)
    z3 = _sel(q_only, z1, z3)
    return x3, y3, z3


def _to_affine(x, y, z, mod: Mod):
    """Jacobian → affine (Montgomery domain); infinity → (0, 0, inf)."""
    inf = is_zero(z)
    zi = mont_inv(z, mod)
    zi2 = mont_sqr(zi, mod)
    ax = mont_mul(x, zi2, mod)
    ay = mont_mul(y, mont_mul(zi, zi2, mod), mod)
    return ax, ay, inf


def _on_curve(x_m, y_m, ops: CurveOps):
    """y² == x³ - 3x + b (Montgomery domain)."""
    mod = ops.mod_p
    lhs = mont_sqr(y_m, mod)
    x3 = mont_mul(mont_sqr(x_m, mod), x_m, mod)
    x_3 = add_mod(add_mod(x_m, x_m, mod), x_m, mod)
    rhs = add_mod(sub_mod(x3, x_3, mod), _c(ops.b_m, x_m), mod)
    return eq(lhs, rhs)


def _check_inputs(ops: CurveOps, digest, r, s, qx, qy, valid):
    """The shared validity prefix: limb conversion, range checks,
    on-curve check. Returns (ok, r_l, s_l, e_l, qx_m, qy_m)."""
    mod_n, mod_p = ops.mod_n, ops.mod_p
    r_l = bytes_to_limbs(r)
    s_l = bytes_to_limbs(s)
    e_l = bytes_to_limbs(digest)
    qx_l = bytes_to_limbs(qx)
    qy_l = bytes_to_limbs(qy)
    n_b = _c(mod_n.n, r_l)
    p_b = _c(mod_p.n, r_l)
    ok = (
        valid.to(torch.bool)
        & ~is_zero(r_l) & ~geq(r_l, n_b)
        & ~is_zero(s_l) & ~geq(s_l, n_b)
        & ~geq(qx_l, p_b) & ~geq(qy_l, p_b)
        & ~(is_zero(qx_l) & is_zero(qy_l))
    )
    qx_m = to_mont(qx_l, mod_p)
    qy_m = to_mont(qy_l, mod_p)
    ok = ok & _on_curve(qx_m, qy_m, ops)
    return ok, r_l, s_l, e_l, qx_m, qy_m


def _scalars(ops: CurveOps, r_l, s_l, e_l, w_m):
    """u1 = e·s⁻¹, u2 = r·s⁻¹ (plain domain) from the Montgomery-domain
    inverse ``w_m``; the digest is reduced mod n once."""
    mod_n = ops.mod_n
    e_m = to_mont(mod_reduce_once(e_l, mod_n), mod_n)
    r_nm = to_mont(mod_reduce_once(r_l, mod_n), mod_n)
    u1 = from_mont(mont_mul(e_m, w_m, mod_n), mod_n)
    u2 = from_mont(mont_mul(r_nm, w_m, mod_n), mod_n)
    return u1, u2


@torch.inference_mode()
def _verify_jacobian(ops: CurveOps, digest, r, s, qx, qy, valid):
    """The plain window = 0 ladder: Shamir's joint double-and-add over
    (u1, u2), MSB first, with T = G + Q computed once a lane."""
    mod_p = ops.mod_p
    ok, r_l, s_l, e_l, qx_m, qy_m = _check_inputs(
        ops, digest, r, s, qx, qy, valid)
    w_m = mont_inv(to_mont(s_l, ops.mod_n), ops.mod_n)
    u1, u2 = _scalars(ops, r_l, s_l, e_l, w_m)

    gx_b = _c(ops.gx_m, qx_m)
    gy_b = _c(ops.gy_m, qx_m)
    one_m = _c(mod_p.one_m, qx_m)
    q_inf = torch.zeros(ok.shape, dtype=torch.bool, device=ok.device)
    tx_j, ty_j, tz_j = _add_mixed(gx_b, gy_b, one_m, qx_m, qy_m, q_inf, mod_p)
    tx, ty, t_inf = _to_affine(tx_j, ty_j, tz_j, mod_p)

    x = torch.zeros_like(qx_m)
    y = torch.zeros_like(qx_m)
    z = torch.zeros_like(qx_m)
    for i in range(ops.nbits):
        k = ops.nbits - 1 - i
        sel = bigint.bit_at(u1, k) + 2 * bigint.bit_at(u2, k)
        ax = _sel(sel == 1, gx_b, _sel(sel == 2, qx_m, tx))
        ay = _sel(sel == 1, gy_b, _sel(sel == 2, qy_m, ty))
        a_inf = torch.where(sel == 3, t_inf, sel == 0)
        x, y, z = _dbl(x, y, z, mod_p)
        x, y, z = _add_mixed(x, y, z, ax, ay, a_inf, mod_p)

    r_inf = is_zero(z)
    ax, _ay, _ = _to_affine(x, y, z, mod_p)
    v = mod_reduce_once(from_mont(ax, mod_p), ops.mod_n)
    return ok & ~r_inf & eq(v, r_l)


# -- complete projective addition ----------------------------------------

def _madd_complete(ops: CurveOps, x1, y1, z1, x2, y2):
    """COMPLETE projective mixed addition, a = -3 (Renes–Costello–
    Batina 2015, Alg. 5). P1 = (X:Y:Z) homogeneous projective, any point
    including the identity (0:1:0); P2 = (x2, y2) affine. Its 13
    products in three stacked calls; no exceptional cases."""
    mod = ops.mod_p

    def add(a, b):
        return add_mod(a, b, mod)

    def sub(a, b):
        return sub_mod(a, b, mod)

    b_c = _c(ops.b_m, x1)
    t0, t1, sxy, y2z1, x2z1, bz = _mul(mod, (
        (x1, x2), (y1, y2), (add(x2, y2), add(x1, y1)), (y2, z1),
        (x2, z1), (b_c, z1)))
    t3 = sub(sub(sxy, t0), t1)  # x1y2+x2y1
    t4 = add(y2z1, y1)  # y1 + y2·z1
    ty = add(x2z1, x1)  # x1 + x2·z1
    x3 = sub(ty, bz)
    x3 = add(x3, add(x3, x3))  # 3(ty - b·z1)
    z3t = sub(t1, x3)
    x3t = add(t1, x3)
    y3 = mont_mul(b_c, ty, mod)
    z1_3 = add(add(z1, z1), z1)
    y3 = sub(sub(y3, z1_3), t0)
    y3 = add(y3, add(y3, y3))  # 3(b·ty - 3z1 - t0)
    t0n = sub(add(add(t0, t0), t0), z1_3)  # 3t0 - 3z1
    p = _mul(mod, ((t3, x3t), (t4, y3), (x3t, z3t), (t0n, y3), (t4, z3t),
                   (t3, t0n)))
    return sub(p[0], p[1]), add(p[2], p[3]), add(p[4], p[5])


# -- window tables (host-built through the reference curve math) ---------

_TABLE_LOCK = threading.Lock()  # one precompute-table build at a time
_GTABLES_NP: dict[tuple[str, int], np.ndarray] = {}  # (curve, w) → table
_GTABLES: dict[tuple[str, int, str], torch.Tensor] = {}  # + device
_QTABLES: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
_QTABLE_NP_CAP = 128  # host-side table LRU bound (per process)


def _jac_add(p: int, P1, P2):
    """Host Jacobian addition over python ints; Z = 0 is infinity.
    General and total — doubling and cancellation resolve inline."""
    x1, y1, z1 = P1
    x2, y2, z2 = P2
    if z1 == 0:
        return P2
    if z2 == 0:
        return P1
    z1s = z1 * z1 % p
    z2s = z2 * z2 % p
    u1 = x1 * z2s % p
    u2 = x2 * z1s % p
    s1 = y1 * z2s * z2 % p
    s2 = y2 * z1s * z1 % p
    h = (u2 - u1) % p
    r = (s2 - s1) % p
    if h == 0:
        if r != 0:
            return (1, 1, 0)  # P = -Q
        ys = y1 * y1 % p
        s = 4 * x1 * ys % p
        m = (3 * x1 * x1 - 3 * z1s * z1s) % p
        x3 = (m * m - 2 * s) % p
        return (x3, (m * (s - x3) - 8 * ys * ys) % p, 2 * y1 * z1 % p)
    hs = h * h % p
    hc = h * hs % p
    v = u1 * hs % p
    x3 = (r * r - hc - 2 * v) % p
    return (x3, (r * (v - x3) - s1 * hc) % p, z1 * z2 * h % p)


def _limbs_mont(v: int, nl: int) -> np.ndarray:
    """int (already Montgomery-reduced) → uint32[nl] 16-bit limbs."""
    return np.frombuffer(
        v.to_bytes(2 * nl, "little"), "<u2").astype(np.uint32)


def point_table_np(curve: vhost.Curve, x: int, y: int,
                   window: int) -> np.ndarray:
    """Fixed-base window table for base point (x, y): entry [j][d] is
    the Montgomery-domain affine point d·2^(w·j)·(x, y), d ∈ [1, 2^w),
    as uint32[nwin, 2^w, 2, nl] 16-bit limbs; entry [j][0] is zeros
    (the identity — the ladders select it away). Built with Jacobian
    accumulation and one batched inversion for the whole table. Invalid
    bases give well-defined garbage that no lane reads with ok = True
    (their lanes fail the on-curve check)."""
    nl = curve.byte_len // 2
    nbits = bigint.RADIX * nl
    nwin = nbits // window
    r_mont = 1 << nbits
    p = curve.p
    tab = np.zeros((nwin, 1 << window, 2, nl), np.uint32)
    base = (x % p, y % p, 1)
    jac: list[tuple[int, tuple[int, int, int]]] = []  # (flat idx, point)
    for j in range(nwin):
        acc = (1, 1, 0)
        for d in range(1, 1 << window):
            acc = _jac_add(p, acc, base)
            if acc[2] != 0:
                jac.append((j * (1 << window) + d, acc))
        for _ in range(window):
            base = _jac_add(p, base, base)
    prefix = []
    total = 1
    for _, (_x, _y, z) in jac:
        prefix.append(total)
        total = total * z % p
    tinv = pow(total, p - 2, p)
    for k in range(len(jac) - 1, -1, -1):
        flat, (xj, yj, zj) = jac[k]
        zi = tinv * prefix[k] % p
        tinv = tinv * zj % p
        zi2 = zi * zi % p
        tab[flat >> window, flat & ((1 << window) - 1), 0] = \
            _limbs_mont(xj * zi2 % p * r_mont % p, nl)
        tab[flat >> window, flat & ((1 << window) - 1), 1] = \
            _limbs_mont(yj * zi2 % p * zi % p * r_mont % p, nl)
    return tab


def pack_table(tab: np.ndarray) -> np.ndarray:
    """16-bit limbs [..., nl] → 32-bit limbs as int32 bit patterns
    [..., nl/2] (limb pair (lo, hi) → lo | hi << 16): the layout a table
    has on a device."""
    t = np.ascontiguousarray(tab, np.uint32)
    pairs = t.reshape(*t.shape[:-1], t.shape[-1] // 2, 2)
    return (pairs[..., 0] | (pairs[..., 1] << 16)).view(np.int32)


def _unpack(t: torch.Tensor) -> torch.Tensor:
    """Packed int32 [..., nl/2] → int64 16-bit limbs [..., nl]."""
    x = t.to(torch.int64) & 0xFFFFFFFF
    return torch.stack((x & 0xFFFF, x >> 16), -1).reshape(
        *t.shape[:-1], 2 * t.shape[-1])


def fixed_base_table(ops: CurveOps, window: int, device=None):
    """The shared u1·G table for (curve, window) on ``device`` (packed
    int32 ``[nwin, 2^w, 2, nl/2]``): built once per process, shipped
    once per device. Returns ``(table, build_seconds)`` — 0.0 when both
    were cached."""
    dev = resolve_device(device)
    with _TABLE_LOCK:
        key = (ops.name, window, str(dev))
        tab = _GTABLES.get(key)
        if tab is not None:
            return tab, 0.0
        t0 = time.perf_counter()
        np_tab = _GTABLES_NP.get((ops.name, window))
        if np_tab is None:
            np_tab = point_table_np(
                ops.curve, ops.curve.gx, ops.curve.gy, window)
            _GTABLES_NP[(ops.name, window)] = np_tab
        tab = torch.from_numpy(pack_table(np_tab)).to(dev)
        _GTABLES[key] = tab
        return tab, time.perf_counter() - t0


def point_table_cached(ops: CurveOps, window: int, x: int, y: int):
    """Host-side window table (JAX layout) for an arbitrary base point,
    LRU-cached per process and keyed by coordinates. Returns
    ``(np_table, build_seconds)``."""
    key = (ops.name, window, x, y)
    with _TABLE_LOCK:
        tab = _QTABLES.get(key)
        if tab is not None:
            _QTABLES.move_to_end(key)
            return tab, 0.0
        t0 = time.perf_counter()
        tab = point_table_np(ops.curve, x, y, window)
        _QTABLES[key] = tab
        while len(_QTABLES) > _QTABLE_NP_CAP:
            _QTABLES.popitem(last=False)
        return tab, time.perf_counter() - t0


def zero_qtable(slots: int, nwin: int, entries: int, nl: int,
                device=None) -> torch.Tensor:
    """Fresh Q-table slots on ``device`` (all identity): packed int32
    ``[slots, nwin, entries, 2, nl/2]`` for ``nl`` 16-bit limbs."""
    return torch.zeros((slots, nwin, entries, 2, nl // 2),
                       dtype=torch.int32, device=resolve_device(device))


def qtable_slot_set(tab: torch.Tensor, slot: int,
                    np_tab: np.ndarray) -> torch.Tensor:
    """Ship ONE key's window table (JAX layout) into slot ``slot`` of
    ``tab``, in place (only the new table crosses to the device), on
    the current stream. Returns ``tab``."""
    src = torch.from_numpy(pack_table(np_tab))
    tab[int(slot)].copy_(src)
    return tab


# -- windowed verification -----------------------------------------------

@torch.inference_mode()
def _verify_windowed(ops: CurveOps, digest, r, s, qx, qy, valid,
                     key_idx, gtab, qtab):
    """The plain windowed ladder. digest/r/s/qx/qy: uint8[B, byte_len]
    big-endian (digest left-padded for P-384); valid: bool[B]; key_idx:
    int32[B] Q-table slot of each lane (clamped into the table, as
    XLA's gather clamps); gtab: packed int32[nwin, 2^w, 2, nl/2];
    qtab: packed int32[K, nwin, 2^w, 2, nl/2]. → bool[B]."""
    mod_p, mod_n = ops.mod_p, ops.mod_n
    ok, r_l, s_l, e_l, qx_m, qy_m = _check_inputs(
        ops, digest, r, s, qx, qy, valid)
    w_m = mont_inv(to_mont(s_l, mod_n), mod_n)
    u1, u2 = _scalars(ops, r_l, s_l, e_l, w_m)

    nwin = int(gtab.shape[0])
    w_bits = (int(gtab.shape[1]) - 1).bit_length()
    keys = key_idx.to(torch.int64).clamp(0, int(qtab.shape[0]) - 1)
    x = torch.zeros_like(qx_m)
    y = _c(mod_p.one_m, qx_m).clone()
    z = torch.zeros_like(qx_m)

    def add_entry(x, y, z, point, dig):
        point = _unpack(point)
        xn, yn, zn = _madd_complete(ops, x, y, z, point[:, 0], point[:, 1])
        keep = dig == 0  # digit 0 = identity: keep the accumulator
        return _sel(keep, x, xn), _sel(keep, y, yn), _sel(keep, z, zn)

    for j in range(nwin):
        d1 = bigint.window_digit(u1, j, w_bits)
        d2 = bigint.window_digit(u2, j, w_bits)
        x, y, z = add_entry(x, y, z, gtab[j][d1], d1)
        x, y, z = add_entry(x, y, z, qtab[keys, j, d2], d2)

    r_inf = is_zero(z)
    z_inv = mont_inv(z, mod_p)
    x_aff = from_mont(mont_mul(x, z_inv, mod_p), mod_p)
    v = mod_reduce_once(x_aff, mod_n)
    return ok & ~r_inf & eq(v, r_l)


def verify_windowed(ops: CurveOps, digest, r, s, qx, qy, valid, key_idx,
                    gtab, qtab) -> torch.Tensor:
    """Windowed verdicts bool[B]: K6 on CUDA tensors, the plain version
    on CPU tensors (arguments as :func:`_verify_windowed`)."""
    dev = digest.device
    if dev.type == "cuda":
        from ct_mapreduce_tpu_torch.ops import ecdsa_cuda

        return ecdsa_cuda.verify_windowed(ops, digest, r, s, qx, qy, valid,
                                          key_idx, gtab, qtab)
    if dev.type == "cpu":
        return _verify_windowed(ops, digest, r, s, qx, qy, valid, key_idx,
                                gtab, qtab)
    raise ValueError(f"no ECDSA verify path for device {dev}")


def verify_jacobian(ops: CurveOps, digest, r, s, qx, qy,
                    valid) -> torch.Tensor:
    """Window = 0 verdicts bool[B]: K6's Jacobian ladder on CUDA
    tensors, the plain version on CPU tensors."""
    dev = digest.device
    if dev.type == "cuda":
        from ct_mapreduce_tpu_torch.ops import ecdsa_cuda

        return ecdsa_cuda.verify_jacobian(ops, digest, r, s, qx, qy, valid)
    if dev.type == "cpu":
        return _verify_jacobian(ops, digest, r, s, qx, qy, valid)
    raise ValueError(f"no ECDSA verify path for device {dev}")


def pad_width(n: int, min_width: int = 32) -> int:
    """Pow2-padded batch width, as the JAX package pads its compile
    shapes (kept so both packages batch alike)."""
    return max(min_width, 1 << max(0, (max(n, 1) - 1).bit_length()))


# -- numpy convenience wrappers ------------------------------------------

def _pad_rows(a, width: int, byte_len: int) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a, np.uint8))
    if a.shape[1] < byte_len:  # left-pad short digests (P-384 lanes)
        a = np.pad(a, ((0, 0), (byte_len - a.shape[1], 0)))
    if a.shape[0] != width:
        a = np.pad(a, ((0, width - a.shape[0]), (0, 0)))
    return a


def _key_on_curve(c: vhost.Curve, kx: int, ky: int) -> bool:
    return (kx < c.p and ky < c.p and bool(kx or ky)
            and (ky * ky - kx * kx * kx - c.a * kx - c.b) % c.p == 0)


def verify_batch(ops: CurveOps, digest, r, s, qx, qy, valid=None,
                 window: Optional[int] = None, device=None) -> np.ndarray:
    """Synchronous convenience verify: numpy byte rows in (digest may be
    shorter than byte_len — left-padded), bool[n] out, on ``device``
    (CUDA unless named). The windowed path groups lanes by public key
    and builds the per-key tables on the host; the ingest lane keeps
    its own device-resident cache (verify/lane.py) instead."""
    dev = resolve_device(device)
    window = resolve_precomp_window(window)
    n = int(digest.shape[0])
    width = pad_width(n)
    bl = ops.byte_len
    v = np.ones((n,), bool) if valid is None else np.asarray(valid, bool)
    v = np.pad(v, (0, width - n))
    rows = [_pad_rows(a, width, bl) for a in (digest, r, s, qx, qy)]
    args = [torch.from_numpy(a).to(dev) for a in rows]
    vt = torch.from_numpy(v).to(dev)
    if window == 0:
        out = verify_jacobian(ops, *args, vt)
        return out.cpu().numpy()[:n]

    gtab, _ = fixed_base_table(ops, window, dev)
    qx_p, qy_p = rows[3], rows[4]
    slots: dict[tuple[int, int], int] = {}
    key_idx = np.zeros((width,), np.int32)
    tabs: list[np.ndarray] = []
    for i in range(n):
        kx = int.from_bytes(qx_p[i].tobytes(), "big")
        ky = int.from_bytes(qy_p[i].tobytes(), "big")
        # Keys failing the range/on-curve checks fail anyway: no table.
        if not _key_on_curve(ops.curve, kx, ky):
            continue
        slot = slots.get((kx, ky))
        if slot is None:
            slot = len(tabs)
            slots[(kx, ky)] = slot
            tabs.append(point_table_cached(ops, window, kx, ky)[0])
        key_idx[i] = slot
    k_pad = max(MIN_QTABLE_SLOTS, pad_width(len(tabs), 1))
    nl = ops.mod_p.nlimb
    qtab = zero_qtable(k_pad, ops.nbits // window, 1 << window, nl, dev)
    for slot, tab in enumerate(tabs):
        qtable_slot_set(qtab, slot, tab)
    out = verify_windowed(ops, *args, vt, torch.from_numpy(key_idx).to(dev),
                          gtab, qtab)
    return out.cpu().numpy()[:n]


def verify_p256(digest, r, s, qx, qy, valid=None,
                window: Optional[int] = None, device=None) -> np.ndarray:
    """Batched ECDSA-P256 verify over 32-byte rows → bool[n]."""
    return verify_batch(P256_OPS, digest, r, s, qx, qy, valid, window,
                        device)


def verify_p384(digest, r, s, qx, qy, valid=None,
                window: Optional[int] = None, device=None) -> np.ndarray:
    """Batched ECDSA-P384 verify over 48-byte rows (the 32-byte SHA-256
    digest is left-padded) → bool[n]."""
    return verify_batch(P384_OPS, digest, r, s, qx, qy, valid, window,
                        device)
