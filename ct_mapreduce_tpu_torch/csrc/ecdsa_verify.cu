// ECDSA verify K6: batched P-256 / P-384 signature verdicts, one thread
// a signature.
//
// Replaces the JAX package's jitted verify kernels,
// ct_mapreduce_tpu/ops/ecdsa.py::_verify_windowed (the windowed
// precompute ladder, verifyPrecompWindow 2, 4 or 8) and
// ::_verify_jacobian (the Shamir ladder, window 0), with their big-int
// layer ct_mapreduce_tpu/ops/bigint.py. A lane's verdict equals the
// JAX package's and verify/host.py::verify_ecdsa's on every input:
//   - it fails for r or s outside [1, n-1], a key coordinate >= p, the
//     key (0, 0), a key off the curve, and a padding lane (valid = 0)
//     (ops/ecdsa.py::_check_inputs), and for a result at infinity;
//   - the digest is reduced mod n once (_scalars), u1 = e/s, u2 = r/s;
//   - x_R is reduced mod n before it is compared with r (p > n).
//
// Field arithmetic: 32-bit limbs, little-endian (8 for P-256, 12 for
// P-384; the kernels are templated on the count), Montgomery products
// by CIOS with R = 2^256 / 2^384 — the same R as the JAX package's 16
// or 24 limbs of 16 bits, so the host-built window tables need no
// change of domain, only their limb pairs packed (lo | hi << 16). Every
// field result is canonical (< the modulus), so each value equals the
// JAX package's bit for bit; the verdicts follow.
//
// The windowed ladder: 2 * (bits / w) complete projective mixed
// additions (Renes-Costello-Batina 2015, Alg. 5, a = -3), no doublings.
// Window j's digits are the w bits at bit j * w of u1 and u2 (read off a
// shift register, never a run-time index into a register array); a
// zero digit keeps the accumulator, as ops/ecdsa.py's add_entry does.
// Entry d of window j of the G table, and of the lane's Q-table slot,
// is d * 2^(w j) times the base, affine, in Montgomery form. The window
// width is a run-time argument (2, 4 or 8), so one kernel serves all.
//
// The window-0 ladder: T = G + Q once a lane, then MSB first a Jacobian
// double and a select-based complete mixed addition of G, Q or T a bit
// (ops/ecdsa.py::_dbl, ::_add_mixed, with the same case analysis), all
// in one loop so that the kernel holds one copy of each (the addition's
// P == Q case doubles in the loop's next step).
//
// Inversions: per-lane Fermat (a^(m-2), square and multiply over the
// constant exponent's bits), where the JAX windowed ladder inverts by
// one batch inversion across lanes. The inverse is unique and 0 inverts
// to 0 in both, so a neighbour's zero is harmless by construction.
//
// Tables are read through the read-only path as 16-byte vectors: the G
// table (512 KiB packed for P-256 at w = 8) stays in L2; the Q table is
// [K, nwin, 2^w, 2, NL] words, K log-key slots.
//
// What bounds it on an H100: the 32x32 -> 64-bit multiply-adds of the
// Montgomery products (2 NL^2 products a product, about 1,700 products
// a P-256 verify at w = 8); the bytes (5 rows of 32-48 bytes a lane and
// the table entries) are small beside them. A lane that fails its input
// checks exits before the ladders. The design is the simple one: one
// thread a lane, everything in registers, no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxNL = 12;

// Constant words of a curve, 32-bit limbs little-endian. Curve 0 is
// P-256, curve 1 P-384; the host sets both before the first launch.
enum Field {
  kP = 0,   // the field prime p
  kN,       // the group order n
  kR2P,     // R^2 mod p
  kR2N,     // R^2 mod n
  kOneP,    // R mod p (Montgomery 1)
  kOneN,    // R mod n
  kB,       // curve b, Montgomery form
  kGX,      // generator, Montgomery form
  kGY,
  kExpP,    // p - 2 (Fermat exponent)
  kExpN,    // n - 2
  kFields
};
__constant__ uint32_t c_words[2][kFields][kMaxNL];
__constant__ uint32_t c_minv[2][2];  // -p^-1, -n^-1 mod 2^32

template <int NL>
struct Curve {
  static constexpr int kIdx = NL == 8 ? 0 : 1;
};

template <int NL, int F>
__device__ __forceinline__ uint32_t cw(int k) {
  return c_words[Curve<NL>::kIdx][F][k];
}

template <int NL, int F>
__device__ __forceinline__ void load_const(uint32_t (&r)[NL]) {
#pragma unroll
  for (int k = 0; k < NL; ++k) r[k] = cw<NL, F>(k);
}

template <int NL>
__device__ __forceinline__ void copy(uint32_t (&r)[NL],
                                     const uint32_t (&a)[NL]) {
#pragma unroll
  for (int k = 0; k < NL; ++k) r[k] = a[k];
}

template <int NL>
__device__ __forceinline__ void zero(uint32_t (&r)[NL]) {
#pragma unroll
  for (int k = 0; k < NL; ++k) r[k] = 0;
}

template <int NL>
__device__ __forceinline__ bool is_zero(const uint32_t (&a)[NL]) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) acc |= a[k];
  return acc == 0;
}

template <int NL>
__device__ __forceinline__ bool equal(const uint32_t (&a)[NL],
                                      const uint32_t (&b)[NL]) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) acc |= a[k] ^ b[k];
  return acc == 0;
}

// a < modulus M.
template <int NL, int M>
__device__ __forceinline__ bool less(const uint32_t (&a)[NL]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const uint64_t x = static_cast<uint64_t>(a[k]) - cw<NL, M>(k) - borrow;
    borrow = static_cast<uint32_t>(x >> 63);
  }
  return borrow != 0;
}

// r = t - M if (carry or t >= M) else t: t (< 2M, with `carry` the bit
// at 2^(32 NL)) to its canonical residue.
template <int NL, int M>
__device__ __forceinline__ void cond_sub(uint32_t (&r)[NL],
                                         const uint32_t (&t)[NL],
                                         uint32_t carry) {
  uint32_t d[NL];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const uint64_t x = static_cast<uint64_t>(t[k]) - cw<NL, M>(k) - borrow;
    d[k] = static_cast<uint32_t>(x);
    borrow = static_cast<uint32_t>(x >> 63);
  }
  const bool take = carry != 0 || borrow == 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) r[k] = take ? d[k] : t[k];
}

template <int NL, int M>
__device__ __forceinline__ void add_mod(uint32_t (&r)[NL],
                                        const uint32_t (&a)[NL],
                                        const uint32_t (&b)[NL]) {
  uint32_t s[NL];
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const uint64_t x = static_cast<uint64_t>(a[k]) + b[k] + c;
    s[k] = static_cast<uint32_t>(x);
    c = static_cast<uint32_t>(x >> 32);
  }
  cond_sub<NL, M>(r, s, c);
}

template <int NL, int M>
__device__ __forceinline__ void sub_mod(uint32_t (&r)[NL],
                                        const uint32_t (&a)[NL],
                                        const uint32_t (&b)[NL]) {
  uint32_t d[NL];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const uint64_t x = static_cast<uint64_t>(a[k]) - b[k] - borrow;
    d[k] = static_cast<uint32_t>(x);
    borrow = static_cast<uint32_t>(x >> 63);
  }
  const uint32_t mask = 0u - borrow;  // add M back after a borrow
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const uint64_t x =
        static_cast<uint64_t>(d[k]) + (cw<NL, M>(k) & mask) + c;
    r[k] = static_cast<uint32_t>(x);
    c = static_cast<uint32_t>(x >> 32);
  }
}

// Montgomery product a * b * R^-1 mod M (CIOS), canonical. a < R,
// b < M; r may alias a or b.
template <int NL, int M>
__device__ __forceinline__ void mont_mul(uint32_t (&r)[NL],
                                         const uint32_t (&a)[NL],
                                         const uint32_t (&b)[NL]) {
  const uint32_t minv = c_minv[Curve<NL>::kIdx][M == kP ? 0 : 1];
  uint32_t t[NL + 2];
#pragma unroll
  for (int k = 0; k < NL + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const uint64_t s = static_cast<uint64_t>(a[i]) * b[j] + t[j] + c;
      t[j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    uint64_t s = static_cast<uint64_t>(t[NL]) + c;
    t[NL] = static_cast<uint32_t>(s);
    t[NL + 1] = static_cast<uint32_t>(s >> 32);
    const uint32_t m = t[0] * minv;
    s = static_cast<uint64_t>(m) * cw<NL, M>(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NL; ++j) {
      s = static_cast<uint64_t>(m) * cw<NL, M>(j) + t[j] + c;
      t[j - 1] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    s = static_cast<uint64_t>(t[NL]) + c;
    t[NL - 1] = static_cast<uint32_t>(s);
    t[NL] = t[NL + 1] + static_cast<uint32_t>(s >> 32);
  }
  uint32_t lo[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) lo[k] = t[k];
  cond_sub<NL, M>(r, lo, t[NL]);
}

// a^(M-2) in the Montgomery domain (the inverse; 0 -> 0), MSB first.
template <int NL, int M>
__device__ __forceinline__ void mont_inv(uint32_t (&r)[NL],
                                      const uint32_t (&a)[NL]) {
  constexpr int kExp = M == kP ? kExpP : kExpN;
  uint32_t acc[NL];
  load_const<NL, M == kP ? kOneP : kOneN>(acc);
#pragma unroll 1
  for (int i = 32 * NL - 1; i >= 0; --i) {
    mont_mul<NL, M>(acc, acc, acc);
    if ((c_words[Curve<NL>::kIdx][kExp][i >> 5] >> (i & 31)) & 1u) {
      mont_mul<NL, M>(acc, acc, a);
    }
  }
  copy<NL>(r, acc);
}

// Big-endian byte row -> limbs.
template <int NL>
__device__ __forceinline__ void load_be(uint32_t (&r)[NL],
                                        const uint8_t* __restrict__ row) {
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const uint8_t* p = row + 4 * (NL - 1 - k);
    r[k] = (static_cast<uint32_t>(p[0]) << 24) |
           (static_cast<uint32_t>(p[1]) << 16) |
           (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
  }
}

// The shared prefix of both ladders: input checks, the key in
// Montgomery form, u1 and u2. False when the lane fails a check.
template <int NL>
__device__ __forceinline__ bool prologue(
    long long lane, const uint8_t* __restrict__ digest,
    const uint8_t* __restrict__ r_rows, const uint8_t* __restrict__ s_rows,
    const uint8_t* __restrict__ qx_rows, const uint8_t* __restrict__ qy_rows,
    const bool* __restrict__ valid, uint32_t (&qx)[NL], uint32_t (&qy)[NL],
    uint32_t (&u1)[NL], uint32_t (&u2)[NL]) {
  const long long off = lane * 4 * NL;
  if (!valid[lane]) return false;
  uint32_t r[NL], s[NL];
  load_be<NL>(r, r_rows + off);
  load_be<NL>(s, s_rows + off);
  load_be<NL>(qx, qx_rows + off);
  load_be<NL>(qy, qy_rows + off);
  if (is_zero<NL>(r) || !less<NL, kN>(r) || is_zero<NL>(s) ||
      !less<NL, kN>(s) || !less<NL, kP>(qx) || !less<NL, kP>(qy) ||
      (is_zero<NL>(qx) && is_zero<NL>(qy))) {
    return false;
  }
  uint32_t r2[NL], t[NL], u[NL];
  // y^2 == x^3 - 3x + b, Montgomery form.
  load_const<NL, kR2P>(r2);
  mont_mul<NL, kP>(qx, qx, r2);
  mont_mul<NL, kP>(qy, qy, r2);
  mont_mul<NL, kP>(t, qx, qx);
  mont_mul<NL, kP>(t, t, qx);
  add_mod<NL, kP>(u, qx, qx);
  add_mod<NL, kP>(u, u, qx);
  sub_mod<NL, kP>(t, t, u);
  load_const<NL, kB>(u);
  add_mod<NL, kP>(t, t, u);
  mont_mul<NL, kP>(u, qy, qy);
  if (!equal<NL>(t, u)) return false;
  // w = s^-1 mod n; u1 = e w, u2 = r w (plain domain).
  load_const<NL, kR2N>(r2);
  mont_mul<NL, kN>(s, s, r2);
  uint32_t w[NL];
  mont_inv<NL, kN>(w, s);
  load_be<NL>(t, digest + off);
  cond_sub<NL, kN>(t, t, 0);
  mont_mul<NL, kN>(t, t, r2);
  mont_mul<NL, kN>(t, t, w);
  zero<NL>(u);
  u[0] = 1;
  mont_mul<NL, kN>(u1, t, u);
  cond_sub<NL, kN>(t, r, 0);
  mont_mul<NL, kN>(t, t, r2);
  mont_mul<NL, kN>(t, t, w);
  mont_mul<NL, kN>(u2, t, u);
  return true;
}

// The end of both ladders: x_R = X * zinv^2 (Jacobian, `jacobian`) or
// X * zinv (projective), to the plain domain, mod n, == r (read again
// from its row, so it holds no registers through the ladder).
template <int NL>
__device__ __forceinline__ bool epilogue(const uint32_t (&x)[NL],
                                         const uint32_t (&z)[NL],
                                         const uint8_t* __restrict__ r_row,
                                         bool jacobian) {
  if (is_zero<NL>(z)) return false;  // the result is at infinity
  uint32_t zi[NL], t[NL], r[NL];
  load_be<NL>(r, r_row);
  mont_inv<NL, kP>(zi, z);
  if (jacobian) mont_mul<NL, kP>(zi, zi, zi);
  mont_mul<NL, kP>(t, x, zi);
  zero<NL>(zi);
  zi[0] = 1;
  mont_mul<NL, kP>(t, t, zi);
  cond_sub<NL, kN>(t, t, 0);
  return equal<NL>(t, r);
}

// Complete projective mixed addition (X:Y:Z) += (x2, y2), a = -3
// (ops/ecdsa.py::_madd_complete; the same values, an order that keeps
// fewer temporaries live).
template <int NL>
__device__ __forceinline__ void madd_complete(uint32_t (&X)[NL],
                                              uint32_t (&Y)[NL],
                                              uint32_t (&Z)[NL],
                                              const uint32_t (&x2)[NL],
                                              const uint32_t (&y2)[NL]) {
  uint32_t t0[NL], t1[NL], t3[NL], t4[NL], ty[NL], a[NL], b[NL];
  mont_mul<NL, kP>(t0, X, x2);
  mont_mul<NL, kP>(t1, Y, y2);
  add_mod<NL, kP>(a, x2, y2);
  add_mod<NL, kP>(b, X, Y);
  mont_mul<NL, kP>(t3, a, b);
  sub_mod<NL, kP>(t3, t3, t0);
  sub_mod<NL, kP>(t3, t3, t1);  // x1 y2 + x2 y1
  mont_mul<NL, kP>(t4, y2, Z);
  add_mod<NL, kP>(t4, t4, Y);  // y1 + y2 z1
  mont_mul<NL, kP>(ty, x2, Z);
  add_mod<NL, kP>(ty, ty, X);  // x1 + x2 z1
  load_const<NL, kB>(b);
  mont_mul<NL, kP>(a, b, Z);
  sub_mod<NL, kP>(a, ty, a);
  add_mod<NL, kP>(X, a, a);
  add_mod<NL, kP>(a, a, X);  // x3 = 3 (ty - b z1)
  sub_mod<NL, kP>(X, t1, a);  // z3t
  add_mod<NL, kP>(Y, t1, a);  // x3t
  mont_mul<NL, kP>(t1, b, ty);  // b ty
  add_mod<NL, kP>(a, Z, Z);
  add_mod<NL, kP>(a, a, Z);  // 3 z1
  sub_mod<NL, kP>(t1, t1, a);
  sub_mod<NL, kP>(t1, t1, t0);
  add_mod<NL, kP>(b, t1, t1);
  add_mod<NL, kP>(t1, t1, b);  // y3 = 3 (b ty - 3 z1 - t0)
  add_mod<NL, kP>(b, t0, t0);
  add_mod<NL, kP>(b, b, t0);
  sub_mod<NL, kP>(t0, b, a);  // t0n = 3 t0 - 3 z1
  // Live: t3, t4, X = z3t, Y = x3t, t1 = y3, t0 = t0n.
  mont_mul<NL, kP>(a, t3, Y);
  mont_mul<NL, kP>(b, t4, t1);
  sub_mod<NL, kP>(ty, a, b);  // xo = t3 x3t - t4 y3
  mont_mul<NL, kP>(a, Y, X);
  mont_mul<NL, kP>(b, t0, t1);
  add_mod<NL, kP>(Y, a, b);  // yo = x3t z3t + t0n y3
  mont_mul<NL, kP>(a, t4, X);
  mont_mul<NL, kP>(b, t3, t0);
  add_mod<NL, kP>(Z, a, b);  // zo = t4 z3t + t3 t0n
  copy<NL>(X, ty);
}

// Jacobian doubling, a = -3 (ops/ecdsa.py::_dbl); Z = 0 stays 0.
template <int NL>
__device__ __forceinline__ void dbl(uint32_t (&X)[NL], uint32_t (&Y)[NL],
                                    uint32_t (&Z)[NL]) {
  uint32_t delta[NL], gamma[NL], beta[NL], alpha[NL], t[NL];
  mont_mul<NL, kP>(delta, Z, Z);
  mont_mul<NL, kP>(gamma, Y, Y);
  mont_mul<NL, kP>(beta, X, gamma);
  sub_mod<NL, kP>(t, X, delta);
  add_mod<NL, kP>(alpha, X, delta);
  mont_mul<NL, kP>(alpha, t, alpha);
  add_mod<NL, kP>(t, alpha, alpha);
  add_mod<NL, kP>(alpha, t, alpha);  // 3 (x - delta)(x + delta)
  add_mod<NL, kP>(beta, beta, beta);
  add_mod<NL, kP>(beta, beta, beta);  // 4 beta
  add_mod<NL, kP>(t, Y, Z);
  mont_mul<NL, kP>(t, t, t);
  sub_mod<NL, kP>(t, t, gamma);
  sub_mod<NL, kP>(Z, t, delta);  // z3 = (y + z)^2 - gamma - delta
  mont_mul<NL, kP>(X, alpha, alpha);
  add_mod<NL, kP>(t, beta, beta);
  sub_mod<NL, kP>(X, X, t);  // x3 = alpha^2 - 8 beta
  mont_mul<NL, kP>(gamma, gamma, gamma);
  add_mod<NL, kP>(gamma, gamma, gamma);
  add_mod<NL, kP>(gamma, gamma, gamma);
  add_mod<NL, kP>(gamma, gamma, gamma);  // 8 gamma^2
  sub_mod<NL, kP>(beta, beta, X);
  mont_mul<NL, kP>(Y, alpha, beta);
  sub_mod<NL, kP>(Y, Y, gamma);  // y3 = alpha (4 beta - x3) - 8 gamma^2
}

// Jacobian + affine addition with the select semantics of
// ops/ecdsa.py::_add_mixed: P at infinity -> Q (or infinity), Q at
// infinity -> P, P == -Q -> Z = 0. P == Q returns true and leaves P as
// it is: the caller doubles it (so the kernel holds one copy of dbl).
template <int NL>
__device__ __forceinline__ bool add_mixed(uint32_t (&X)[NL],
                                          uint32_t (&Y)[NL],
                                          uint32_t (&Z)[NL],
                                          const uint32_t (&x2)[NL],
                                          const uint32_t (&y2)[NL],
                                          bool q_inf) {
  const bool p_inf = is_zero<NL>(Z);
  uint32_t z1z1[NL], h[NL], rr[NL], hh[NL], v[NL], t[NL];
  mont_mul<NL, kP>(z1z1, Z, Z);
  mont_mul<NL, kP>(h, x2, z1z1);  // u2
  sub_mod<NL, kP>(h, h, X);
  mont_mul<NL, kP>(rr, Z, z1z1);
  mont_mul<NL, kP>(rr, y2, rr);  // s2
  sub_mod<NL, kP>(rr, rr, Y);
  mont_mul<NL, kP>(hh, h, h);
  mont_mul<NL, kP>(v, X, hh);
  mont_mul<NL, kP>(hh, h, hh);  // hhh
  mont_mul<NL, kP>(z1z1, Z, h);  // z3
  const bool same_x = is_zero<NL>(h) && !p_inf && !q_inf;
  const bool rr_zero = is_zero<NL>(rr);
  if (p_inf) {
    copy<NL>(X, x2);
    copy<NL>(Y, y2);
    if (q_inf) {
      zero<NL>(Z);
    } else {
      load_const<NL, kOneP>(Z);
    }
  } else if (q_inf) {
    // keep P
  } else if (same_x && rr_zero) {
    return true;
  } else {
    mont_mul<NL, kP>(t, rr, rr);
    sub_mod<NL, kP>(t, t, hh);
    add_mod<NL, kP>(h, v, v);
    sub_mod<NL, kP>(t, t, h);  // x3 = rr^2 - hhh - 2v
    sub_mod<NL, kP>(v, v, t);
    mont_mul<NL, kP>(v, rr, v);
    mont_mul<NL, kP>(hh, Y, hh);
    sub_mod<NL, kP>(Y, v, hh);  // y3 = rr (v - x3) - y1 hhh
    copy<NL>(X, t);
    if (same_x) {
      zero<NL>(Z);  // P == -Q
    } else {
      copy<NL>(Z, z1z1);
    }
  }
  return false;
}

// Shift a limb vector right by w bits (1 <= w < 32).
template <int NL>
__device__ __forceinline__ void shr(uint32_t (&a)[NL], int w) {
#pragma unroll
  for (int k = 0; k < NL - 1; ++k) a[k] = (a[k] >> w) | (a[k + 1] << (32 - w));
  a[NL - 1] >>= w;
}

template <int NL>
__device__ __forceinline__ void load_entry(uint32_t (&x)[NL],
                                           uint32_t (&y)[NL],
                                           const uint4* __restrict__ e) {
#pragma unroll
  for (int q = 0; q < NL / 2; ++q) {
    const uint4 v = __ldg(e + q);
    const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 4 * q + c;  // NL is a multiple of 4: a vector is x's
      if (i < NL) {             // or y's, known at compile time
        x[i] = vv[c];
      } else {
        y[i - NL] = vv[c];
      }
    }
  }
}

template <int NL>
__global__ void __launch_bounds__(kThreads)
ecdsa_windowed_kernel(const uint8_t* __restrict__ digest,
                      const uint8_t* __restrict__ r_rows,
                      const uint8_t* __restrict__ s_rows,
                      const uint8_t* __restrict__ qx_rows,
                      const uint8_t* __restrict__ qy_rows,
                      const bool* __restrict__ valid,
                      const int32_t* __restrict__ key_idx,
                      const uint4* __restrict__ gtab,
                      const uint4* __restrict__ qtab, int w, int key_slots,
                      bool* __restrict__ out, long long n) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= n) return;
  uint32_t qx[NL], qy[NL], u1[NL], u2[NL];
  if (!prologue<NL>(lane, digest, r_rows, s_rows, qx_rows, qy_rows, valid,
                    qx, qy, u1, u2)) {
    out[lane] = false;
    return;
  }
  int key = key_idx[lane];
  key = key < 0 ? 0 : (key >= key_slots ? key_slots - 1 : key);
  const int nwin = 32 * NL / w;
  const uint32_t mask = (1u << w) - 1u;
  const uint4* qbase =
      qtab + ((static_cast<size_t>(key) * nwin) << w) * (NL / 2);
  uint32_t X[NL], Y[NL], Z[NL];
  zero<NL>(X);
  load_const<NL, kOneP>(Y);
  zero<NL>(Z);
#pragma unroll 1
  for (int j = 0; j < nwin; ++j) {
    const uint32_t d1 = u1[0] & mask;
    const uint32_t d2 = u2[0] & mask;
    shr<NL>(u1, w);
    shr<NL>(u2, w);
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const uint32_t d = h ? d2 : d1;
      if (d == 0) continue;  // digit 0: the identity, keep the sum
      const size_t entry = ((static_cast<size_t>(j) << w) + d) * (NL / 2);
      uint32_t px[NL], py[NL];
      load_entry<NL>(px, py, (h ? qbase : gtab) + entry);
      madd_complete<NL>(X, Y, Z, px, py);
    }
  }
  out[lane] = epilogue<NL>(X, Z, r_rows + lane * 4 * NL, false);
}

template <int NL>
__global__ void __launch_bounds__(kThreads)
ecdsa_jacobian_kernel(const uint8_t* __restrict__ digest,
                      const uint8_t* __restrict__ r_rows,
                      const uint8_t* __restrict__ s_rows,
                      const uint8_t* __restrict__ qx_rows,
                      const uint8_t* __restrict__ qy_rows,
                      const bool* __restrict__ valid,
                      bool* __restrict__ out, long long n) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= n) return;
  uint32_t qx[NL], qy[NL], u1[NL], u2[NL];
  if (!prologue<NL>(lane, digest, r_rows, s_rows, qx_rows, qy_rows, valid,
                    qx, qy, u1, u2)) {
    out[lane] = false;
    return;
  }
  // One loop runs T = G + Q (its first step) and then the ladder, so
  // the kernel holds one copy each of dbl and add_mixed: a step doubles
  // (a bit's double, or the add that found P == Q), then adds.
  uint32_t X[NL], Y[NL], Z[NL], tx[NL], ty[NL], ax[NL], ay[NL], g[NL];
  load_const<NL, kGX>(X);
  load_const<NL, kGY>(Y);
  load_const<NL, kOneP>(Z);
  bool in_t = true;   // the step that makes T
  bool redo = false;  // the last add met P == Q: double P instead
  bool t_inf = false;
  int i = 0;
#pragma unroll 1
  for (;;) {
    if (!in_t || redo) dbl<NL>(X, Y, Z);
    const bool step_done = redo;
    redo = false;
    if (!step_done) {
      bool a_inf = false;
      if (in_t) {
        copy<NL>(ax, qx);
        copy<NL>(ay, qy);
      } else {
        const uint32_t b1 = u1[NL - 1] >> 31;  // bit i of u1, u2, MSB first
        const uint32_t b2 = u2[NL - 1] >> 31;
#pragma unroll
        for (int k = NL - 1; k > 0; --k) {
          u1[k] = (u1[k] << 1) | (u1[k - 1] >> 31);
          u2[k] = (u2[k] << 1) | (u2[k - 1] >> 31);
        }
        u1[0] <<= 1;
        u2[0] <<= 1;
        const uint32_t sel = b1 + 2 * b2;  // 0 none, 1 G, 2 Q, 3 G + Q
        load_const<NL, kGX>(g);
#pragma unroll
        for (int k = 0; k < NL; ++k) {
          ax[k] = sel == 1 ? g[k] : (sel == 2 ? qx[k] : tx[k]);
        }
        load_const<NL, kGY>(g);
#pragma unroll
        for (int k = 0; k < NL; ++k) {
          ay[k] = sel == 1 ? g[k] : (sel == 2 ? qy[k] : ty[k]);
        }
        a_inf = sel == 3 ? t_inf : sel == 0;
      }
      redo = add_mixed<NL>(X, Y, Z, ax, ay, a_inf);
      if (redo) continue;
    }
    if (in_t) {
      // T to affine (t_inf when Q == -G); the ladder starts at infinity.
      uint32_t zi[NL];
      t_inf = is_zero<NL>(Z);
      mont_inv<NL, kP>(zi, Z);
      mont_mul<NL, kP>(g, zi, zi);
      mont_mul<NL, kP>(tx, X, g);
      mont_mul<NL, kP>(g, zi, g);
      mont_mul<NL, kP>(ty, Y, g);
      zero<NL>(X);
      zero<NL>(Y);
      zero<NL>(Z);
      in_t = false;
      continue;
    }
    if (++i == 32 * NL) break;
  }
  out[lane] = epilogue<NL>(X, Z, r_rows + lane * 4 * NL, true);
}

}  // namespace

// Plain C entry points (loaded with ctypes).

// Copy one curve's constants (curve 0 P-256, 1 P-384): `words` is
// uint32[kFields][12] host memory in the Field order above, `minv`
// uint32[2]. Synchronous; call before the curve's first launch on
// `device`. Returns the CUDA error (0 = set).
extern "C" int ctmr_ecdsa_set_constants(int curve, const void* words,
                                        const void* minv, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (curve < 0 || curve > 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t wbytes = sizeof(uint32_t) * kFields * kMaxNL;
  err = cudaMemcpyToSymbol(c_words, words, wbytes, curve * wbytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyToSymbol(c_minv, minv, 2 * sizeof(uint32_t),
                           curve * 2 * sizeof(uint32_t));
  return static_cast<int>(err);
}

// Windowed verdicts of `n` lanes on `stream`: rows uint8[n, 4 nl]
// big-endian, valid bool[n], key_idx int32[n], gtab uint32[32 nl / w,
// 2^w, 2, nl], qtab uint32[key_slots, 32 nl / w, 2^w, 2, nl], out
// bool[n]. nl is 8 or 12, w 2, 4 or 8. Does not synchronise; returns
// cudaGetLastError() of the launch (0 = launched).
extern "C" int ctmr_ecdsa_verify_windowed(
    int nl, const void* digest, const void* r, const void* s,
    const void* qx, const void* qy, const void* valid, const void* key_idx,
    const void* gtab, const void* qtab, int w, int key_slots, void* out,
    long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((nl != 8 && nl != 12) || (w != 2 && w != 4 && w != 8) ||
      key_slots < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const unsigned int blocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(digest);
  const auto* rr = static_cast<const uint8_t*>(r);
  const auto* ss = static_cast<const uint8_t*>(s);
  const auto* xx = static_cast<const uint8_t*>(qx);
  const auto* yy = static_cast<const uint8_t*>(qy);
  const auto* v = static_cast<const bool*>(valid);
  const auto* k = static_cast<const int32_t*>(key_idx);
  const auto* g = static_cast<const uint4*>(gtab);
  const auto* q = static_cast<const uint4*>(qtab);
  auto* o = static_cast<bool*>(out);
  if (nl == 8) {
    ecdsa_windowed_kernel<8><<<blocks, kThreads, 0, st>>>(
        d, rr, ss, xx, yy, v, k, g, q, w, key_slots, o, n);
  } else {
    ecdsa_windowed_kernel<12><<<blocks, kThreads, 0, st>>>(
        d, rr, ss, xx, yy, v, k, g, q, w, key_slots, o, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Window-0 (Jacobian ladder) verdicts; arguments as above.
extern "C" int ctmr_ecdsa_verify_jacobian(
    int nl, const void* digest, const void* r, const void* s,
    const void* qx, const void* qy, const void* valid, void* out,
    long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nl != 8 && nl != 12) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const unsigned int blocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(digest);
  const auto* rr = static_cast<const uint8_t*>(r);
  const auto* ss = static_cast<const uint8_t*>(s);
  const auto* xx = static_cast<const uint8_t*>(qx);
  const auto* yy = static_cast<const uint8_t*>(qy);
  const auto* v = static_cast<const bool*>(valid);
  auto* o = static_cast<bool*>(out);
  if (nl == 8) {
    ecdsa_jacobian_kernel<8><<<blocks, kThreads, 0, st>>>(
        d, rr, ss, xx, yy, v, o, n);
  } else {
    ecdsa_jacobian_kernel<12><<<blocks, kThreads, 0, st>>>(
        d, rr, ss, xx, yy, v, o, n);
  }
  return static_cast<int>(cudaGetLastError());
}
