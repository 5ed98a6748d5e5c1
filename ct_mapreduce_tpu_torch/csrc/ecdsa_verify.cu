// ECDSA verify K6: batched P-256 / P-384 signature verdicts, a group of
// G threads a signature, SIGS signatures a block.
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
// Layout. A field element is NL 32-bit limbs, little-endian (8 for
// P-256, 12 for P-384), in Montgomery form with R = 2^256 / 2^384, the
// JAX package's R, so the host-built window tables need no change of
// domain, only their 16-bit limb pairs packed (lo | hi << 16). The G
// threads of a signature's group (neighbours in one warp) hold L = NL / G
// limbs each: rank k holds limbs [k L, k L + L). Every field result is
// canonical (< the modulus), so each value equals the JAX package's bit
// for bit; the verdicts follow. The windowed ladder runs G = 2 and 64
// signatures a block, the window-0 ladder G = 1 and 128 (Spec below).
//
// Field products: CIOS Montgomery products in the group's layout, with
// PTX carry chains (mad.lo.cc / madc.hi.cc / addc). Limb a_i and the
// reduction factor m are broadcast with __shfl_sync; each thread adds
// a_i * b and m * p over its own limbs, then the accumulator moves down
// a limb (__shfl_down_sync). Carries between the threads' slices stay
// pending in a word of the slice until the end, where one generate /
// propagate step over the group (two ballots) settles them, as it does
// for every addition, subtraction and comparison. With G = 1 no
// collective is emitted.
//
// Warps. Every lane of a warp that runs a collective passes the same
// mask: a branch that only some groups take (a failed lane, a zero
// digit, the Jacobian ladder's cases) first narrows the mask with a
// ballot (Group::narrow). Groups of one warp that passed per-group masks
// to the same shuffle ran 3-4x slower on the H100.
//
// Inversions: s^-1 mod n and the result's Z^-1 mod p are block batch
// inversions (Montgomery's trick, as ops/bigint.py::batch_inv_mont),
// over a product tree in shared memory: the leaves are the block's live
// values, each level a step in which every group multiplies one node's
// children, the root is inverted once, by a binary extended GCD in one
// thread (its inputs are public, so variable time is allowed; the
// inverse is unique, so it equals a Fermat chain's), and the way down
// gives each child the inverse of its parent times its sibling: 3 SIGS -
// 1 products a block in 2 log2(SIGS) + 1 steps. A lane that failed its
// input checks (a padding lane, or a lane past the batch) and a lane
// whose Z is 0 is not live: its leaf is 1 and its inverse is forced to
// 0, so a bad lane cannot change a neighbour's verdict. No thread
// returns early: every thread reaches every barrier of both batch steps,
// and a failed lane carries its mask past them. On SIMT hardware a
// serial chain in one group costs the whole warp's issue slots, so the
// batch pays only where its chain is short and shared by many warps:
// hence the tree, the GCD and blocks of 4 warps.
//
// The windowed ladder: 2 * (bits / w) complete projective mixed
// additions (Renes-Costello-Batina 2015, Alg. 5, a = -3), no doublings.
// Window j's digits are the w bits at bit j * w of u1 and u2, read from
// shared memory; a zero digit keeps the accumulator, as ops/ecdsa.py's
// add_entry does. Entry d of window j of the G table, and of the lane's
// Q-table slot, is d * 2^(w j) times the base, affine, in Montgomery
// form; the group reads an entry's 2 NL words as one contiguous run, a
// slice a thread. The window width is a run-time argument (2, 4 or 8).
//
// The window-0 ladder: T = G + Q once a lane (its Z inverted by a
// per-lane Fermat chain inside the ladder's loop, where no barrier can
// go), then MSB first a Jacobian double and a select-based complete
// mixed addition of G, Q or T a bit (ops/ecdsa.py::_dbl, ::_add_mixed,
// with the same case analysis), all in one loop so that the kernel holds
// one copy of each (the addition's P == Q case doubles in the loop's
// next step). s and the final Z are block batch inversions.
//
// What bounds it on an H100: at wide batches the multiply-adds of the
// Montgomery products (2 NL^2 32x32-bit products, 4 NL^2 mul.lo / mul.hi
// instructions a product, about 850 products a valid P-256 verify at
// w = 8); the bytes (5 rows of 32-48 bytes a lane and the table entries)
// are small beside them. A group of G threads costs 3 NL + 4 shuffles a
// product beside the multiplies, and more instructions a product than
// one thread, for a shorter chain of dependent instructions: at
// verifyBatch's 1,024 lanes, 16 blocks of 64 signatures, the latency of
// one signature's chain (the ladder, two trees, two GCDs) bounds it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxNL = 12;
// Threads a signature and signatures a block, by ladder.
constexpr int kGroupW = 2, kSigsW = 64;  // windowed
constexpr int kGroupJ = 1, kSigsJ = 128;  // window 0

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

// A kernel's shape: NL limbs a field element, G threads a signature
// (each holding L limbs), SIGS signatures a block.
template <int NL_, int G_, int SIGS_>
struct Spec {
  static constexpr int NL = NL_, G = G_, L = NL_ / G_, SIGS = SIGS_;
  static constexpr int kThreads = G_ * SIGS_;
  static constexpr int kIdx = NL_ == 8 ? 0 : 1;  // the constants' curve
  static_assert(NL_ % G_ == 0 && 32 % G_ == 0 && G_ <= 16,
                "a group splits the limbs evenly and sits in a warp");
  static_assert(kThreads % 32 == 0, "whole warps");
};

// A thread's slice of a field element.
template <class S>
using Limbs = uint32_t[S::L];

// -- PTX carry chains ------------------------------------------------------
// Each is one instruction; the carry flag passes between consecutive
// statements (volatile keeps their order).

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// -- The thread group --------------------------------------------------------

// The lanes that run a step together: `mask` holds every lane of the
// warp in the step (the same value on each of them, so no collective
// splits the warp); a branch that some groups take narrows it by a
// ballot first. With one thread a signature no collective is emitted.
template <class S>
struct Group {
  uint32_t mask;   // the warp's lanes in this step
  uint32_t shift;  // this group's first lane in the warp
  int rank;        // this thread holds limbs [rank L, rank L + L)

  __device__ explicit Group(int tid)
      : mask(0xFFFFFFFFu),
        shift(static_cast<uint32_t>((tid & 31) - tid % S::G)),
        rank(tid % S::G) {}
  __device__ Group(const Group& g, uint32_t m)
      : mask(m), shift(g.shift), rank(g.rank) {}
  // The lanes of this step for which `p` holds: every lane of the step
  // calls it, and only those lanes use the result.
  __device__ Group narrow(bool p) const {
    if constexpr (S::G == 1) return *this;
    return Group(*this, __ballot_sync(mask, p));
  }
  __device__ uint32_t shfl(uint32_t v, int src) const {
    if constexpr (S::G == 1) return v;
    return __shfl_sync(mask, v, src, S::G);
  }
  // Rank + 1's value; 0 on the top rank.
  __device__ uint32_t from_above(uint32_t v) const {
    if constexpr (S::G == 1) return 0u;
    const uint32_t x = __shfl_down_sync(mask, v, 1, S::G);
    return rank == S::G - 1 ? 0u : x;
  }
  // Rank - 1's value; 0 on rank 0.
  __device__ uint32_t from_below(uint32_t v) const {
    if constexpr (S::G == 1) return 0u;
    const uint32_t x = __shfl_up_sync(mask, v, 1, S::G);
    return rank == 0 ? 0u : x;
  }
  // Bit k: `p` on rank k of this group.
  __device__ uint32_t bits(bool p) const {
    if constexpr (S::G == 1) return p ? 1u : 0u;
    return (__ballot_sync(mask, p) >> shift) & ((1u << S::G) - 1u);
  }
  __device__ bool all(bool p) const {
    return bits(p) == (1u << S::G) - 1u;
  }
  // Carries (or borrows) between the slices: `gen` is this slice's carry
  // out, `prop` whether a carry into it passes through (a sum of all
  // ones, a difference of all zeros; never both). Returns the carry into
  // this slice; `top` gets the carry out of the top slice.
  __device__ uint32_t settle(bool gen, bool prop, uint32_t& top) const {
    if constexpr (S::G == 1) {
      top = gen ? 1u : 0u;
      return 0u;
    }
    const uint32_t g = bits(gen), p = bits(prop);
    const uint32_t c = ((g | p) + g) ^ p;  // bit k: the carry into slice k
    top = (c >> S::G) & 1u;
    return (c >> rank) & 1u;
  }
  __device__ void sync() const {
    if constexpr (S::G > 1) __syncwarp(mask);
  }
};

// -- Field arithmetic over the group -----------------------------------------

template <class S, int F>
__device__ __forceinline__ uint32_t cw(const Group<S>& g, int k) {
  if constexpr (S::G == 1) return c_words[S::kIdx][F][k];
  return c_words[S::kIdx][F][g.rank * S::L + k];
}

template <class S, int F>
__device__ __forceinline__ void load_const(const Group<S>& g, Limbs<S>& r) {
#pragma unroll
  for (int k = 0; k < S::L; ++k) r[k] = cw<S, F>(g, k);
}

template <class S>
__device__ __forceinline__ void copy(Limbs<S>& r, const Limbs<S>& a) {
#pragma unroll
  for (int k = 0; k < S::L; ++k) r[k] = a[k];
}

template <class S>
__device__ __forceinline__ void zero(Limbs<S>& r) {
#pragma unroll
  for (int k = 0; k < S::L; ++k) r[k] = 0;
}

// The plain 1 (limb 0 on rank 0).
template <class S>
__device__ __forceinline__ void one_plain(const Group<S>& g, Limbs<S>& r) {
  zero<S>(r);
  if (g.rank == 0) r[0] = 1;
}

template <class S>
__device__ __forceinline__ bool is_zero(const Group<S>& g,
                                        const Limbs<S>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < S::L; ++k) acc |= a[k];
  return g.all(acc == 0);
}

template <class S>
__device__ __forceinline__ bool equal(const Group<S>& g, const Limbs<S>& a,
                                      const Limbs<S>& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < S::L; ++k) acc |= a[k] ^ b[k];
  return g.all(acc == 0);
}

// d = a - M over the slice; returns the slice's borrow out, `dz` whether
// d is all zeros.
template <class S, int M>
__device__ __forceinline__ bool sub_mod_slice(const Group<S>& g, Limbs<S>& d,
                                              const Limbs<S>& a, bool& dz) {
  d[0] = sub_cc(a[0], cw<S, M>(g, 0));
#pragma unroll
  for (int k = 1; k < S::L; ++k) d[k] = subc_cc(a[k], cw<S, M>(g, k));
  const uint32_t bo = subc(0u, 0u) & 1u;
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < S::L; ++k) acc |= d[k];
  dz = acc == 0;
  return bo != 0;
}

// a < modulus M.
template <class S, int M>
__device__ __forceinline__ bool less(const Group<S>& g, const Limbs<S>& a) {
  Limbs<S> d;
  bool dz;
  const bool bo = sub_mod_slice<S, M>(g, d, a, dz);
  uint32_t top;
  g.settle(bo, dz, top);
  return top != 0;
}

// r = t - M if (hi or t >= M) else t: t (< 2M, with `hi` its word at
// 2^(32 NL), the same on every rank) to its canonical residue.
template <class S, int M>
__device__ __forceinline__ void cond_sub(const Group<S>& g, Limbs<S>& r,
                                         const Limbs<S>& t, uint32_t hi) {
  Limbs<S> d;
  bool dz;
  const bool bo = sub_mod_slice<S, M>(g, d, t, dz);
  uint32_t top;
  const uint32_t bin = g.settle(bo, dz, top);
  if constexpr (S::G > 1) {
    d[0] = sub_cc(d[0], bin);
#pragma unroll
    for (int k = 1; k < S::L; ++k) d[k] = subc_cc(d[k], 0u);
  }
  const bool take = hi != 0 || top == 0;
#pragma unroll
  for (int k = 0; k < S::L; ++k) r[k] = take ? d[k] : t[k];
}

// s (a slice with carry `c` out) += the carries settled over the group;
// returns the carry out of the top slice.
template <class S>
__device__ __forceinline__ uint32_t settle_sum(const Group<S>& g,
                                               Limbs<S>& s, uint32_t c) {
  if constexpr (S::G == 1) return c;
  uint32_t acc = 0xFFFFFFFFu;
#pragma unroll
  for (int k = 0; k < S::L; ++k) acc &= s[k];
  uint32_t top;
  const uint32_t cin = g.settle(c != 0, acc == 0xFFFFFFFFu, top);
  s[0] = add_cc(s[0], cin);
#pragma unroll
  for (int k = 1; k < S::L; ++k) s[k] = addc_cc(s[k], 0u);
  return top;
}

template <class S, int M>
__device__ __forceinline__ void add_mod(const Group<S>& g, Limbs<S>& r,
                                        const Limbs<S>& a,
                                        const Limbs<S>& b) {
  Limbs<S> s;
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < S::L; ++k) s[k] = addc_cc(a[k], b[k]);
  const uint32_t c = addc(0u, 0u);
  const uint32_t top = settle_sum<S>(g, s, c);
  cond_sub<S, M>(g, r, s, top);
}

template <class S, int M>
__device__ __forceinline__ void sub_mod(const Group<S>& g, Limbs<S>& r,
                                        const Limbs<S>& a,
                                        const Limbs<S>& b) {
  Limbs<S> d;
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < S::L; ++k) d[k] = subc_cc(a[k], b[k]);
  const uint32_t bo = subc(0u, 0u) & 1u;
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < S::L; ++k) acc |= d[k];
  uint32_t borrow;
  const uint32_t bin = g.settle(bo != 0, acc == 0, borrow);
  if constexpr (S::G > 1) {
    d[0] = sub_cc(d[0], bin);
#pragma unroll
    for (int k = 1; k < S::L; ++k) d[k] = subc_cc(d[k], 0u);
  }
  // After a borrow, add M back (the sum's carry out of the top is the
  // borrow's 2^(32 NL), dropped).
  const uint32_t mask = 0u - borrow;
  d[0] = add_cc(d[0], cw<S, M>(g, 0) & mask);
#pragma unroll
  for (int k = 1; k < S::L; ++k) d[k] = addc_cc(d[k], cw<S, M>(g, k) & mask);
  const uint32_t c = addc(0u, 0u);
  settle_sum<S>(g, d, c);
  copy<S>(r, d);
}

// t[0 .. L+1] += x * y over the slice, lo words then hi words.
template <int L>
__device__ __forceinline__ void mul_acc(uint32_t (&t)[L + 2], uint32_t x,
                                        const uint32_t (&y)[L]) {
  t[0] = mad_lo_cc(x, y[0], t[0]);
#pragma unroll
  for (int k = 1; k < L; ++k) t[k] = madc_lo_cc(x, y[k], t[k]);
  t[L] = addc_cc(t[L], 0u);
  t[L + 1] = addc(t[L + 1], 0u);
  t[1] = mad_hi_cc(x, y[0], t[1]);
#pragma unroll
  for (int k = 1; k < L; ++k) t[k + 1] = madc_hi_cc(x, y[k], t[k + 1]);
  t[L + 1] = addc(t[L + 1], 0u);
}

// Montgomery product a * b * R^-1 mod M (CIOS over the group),
// canonical. a < R, b < M; r may alias a or b.
//
// Each thread's accumulator is its L limbs, t[L] (the word due at the
// next rank's limb 0) and t[L + 1]; a step adds a_i * b and m * M, then
// divides by 2^32: limbs move down, rank k + 1's limb 0 joins rank k's
// t[L]. The pending words stay small (a few units), so nothing
// overflows; the end settles them over the group.
template <class S, int M>
__device__ __forceinline__ void mont_mul(const Group<S>& g, Limbs<S>& r,
                                         const Limbs<S>& a,
                                         const Limbs<S>& b) {
  constexpr int L = S::L;
  const uint32_t minv = c_minv[S::kIdx][M == kP ? 0 : 1];
  uint32_t mod[L];
  load_const<S, M>(g, mod);
  uint32_t t[L + 2];
#pragma unroll
  for (int k = 0; k < L + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < S::NL; ++i) {
    const uint32_t ai = g.shfl(a[i % L], i / L);
    mul_acc<L>(t, ai, b);
    const uint32_t m = g.shfl(t[0] * minv, 0);
    mul_acc<L>(t, m, mod);
    const uint32_t below = g.from_above(t[0]);
#pragma unroll
    for (int k = 0; k + 1 < L; ++k) t[k] = t[k + 1];
    t[L - 1] = add_cc(t[L], below);
    t[L] = addc(t[L + 1], 0u);
    t[L + 1] = 0;
  }
  // Settle: rank k - 1's t[L] joins limb 0 here; the top rank's t[L] is
  // the result's word at 2^(32 NL).
  uint32_t s[L];
  uint32_t hi = t[L];
  if constexpr (S::G > 1) {
    const uint32_t in = g.from_below(t[L]);
    s[0] = add_cc(t[0], in);
#pragma unroll
    for (int k = 1; k < L; ++k) s[k] = addc_cc(t[k], 0u);
    const uint32_t c = addc(0u, 0u);
    const uint32_t top = settle_sum<S>(g, s, c);
    hi = g.shfl(t[L], S::G - 1) + top;
  } else {
#pragma unroll
    for (int k = 0; k < L; ++k) s[k] = t[k];
  }
  cond_sub<S, M>(g, r, s, hi);
}

// a^(M-2) in the Montgomery domain (the inverse; 0 -> 0), MSB first.
template <class S, int M>
__device__ __forceinline__ void mont_inv(const Group<S>& g, Limbs<S>& r,
                                         const Limbs<S>& a) {
  constexpr int kExp = M == kP ? kExpP : kExpN;
  Limbs<S> acc;
  load_const<S, M == kP ? kOneP : kOneN>(g, acc);
#pragma unroll 1
  for (int i = 32 * S::NL - 1; i >= 0; --i) {
    mont_mul<S, M>(g, acc, acc, acc);
    if ((c_words[S::kIdx][kExp][i >> 5] >> (i & 31)) & 1u) {
      mont_mul<S, M>(g, acc, acc, a);
    }
  }
  copy<S>(r, acc);
}

// x^-1 mod M of a plain residue x in [1, M) (M an odd prime), by the
// binary extended Euclidean algorithm, in one thread: u = x, v = M with
// x1 x == u and x2 x == v (mod M), halving the even one of u, v and
// subtracting the smaller from the larger until one of them is 1. Its
// time depends on x, which is public (a product of signature values).
template <class S, int M>
__device__ __forceinline__ void gcd_inv(uint32_t (&x)[S::NL]) {
  constexpr int NL = S::NL;
  // The modulus is read from constant memory where it is used, so that
  // the four values are all this holds in registers.
  auto mw = [](int k) { return c_words[S::kIdx][M][k]; };
  uint32_t u[NL], v[NL], x1[NL], x2[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    u[k] = x[k];
    v[k] = mw(k);
    x1[k] = k == 0;
    x2[k] = 0;
  }
  // a / 2 mod M: (a + M) / 2 for odd a.
  auto halve = [&](uint32_t (&a)[NL]) {
    const uint32_t odd = 0u - (a[0] & 1u);
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      c += static_cast<uint64_t>(a[k]) + (mw(k) & odd);
      a[k] = static_cast<uint32_t>(c);
      c >>= 32;
    }
#pragma unroll
    for (int k = 0; k < NL - 1; ++k) a[k] = (a[k] >> 1) | (a[k + 1] << 31);
    a[NL - 1] = (a[NL - 1] >> 1) | (static_cast<uint32_t>(c) << 31);
  };
  auto shr1 = [&](uint32_t (&a)[NL]) {
#pragma unroll
    for (int k = 0; k < NL - 1; ++k) a[k] = (a[k] >> 1) | (a[k + 1] << 31);
    a[NL - 1] >>= 1;
  };
  // The borrow of a - b.
  auto borrow = [&](const uint32_t (&a)[NL], const uint32_t (&b)[NL]) {
    uint64_t br = 0;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      br = (static_cast<uint64_t>(a[k]) - b[k] - br) >> 63;
    }
    return static_cast<uint32_t>(br);
  };
  // a -= b; returns the borrow.
  auto sub = [&](uint32_t (&a)[NL], const uint32_t (&b)[NL]) {
    uint64_t br = 0;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      const uint64_t d = static_cast<uint64_t>(a[k]) - b[k] - br;
      a[k] = static_cast<uint32_t>(d);
      br = d >> 63;
    }
    return static_cast<uint32_t>(br);
  };
  // a = a - b mod M (a, b < M).
  auto sub_m = [&](uint32_t (&a)[NL], const uint32_t (&b)[NL]) {
    const uint32_t mask = 0u - sub(a, b);
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      c += static_cast<uint64_t>(a[k]) + (mw(k) & mask);
      a[k] = static_cast<uint32_t>(c);
      c >>= 32;
    }
  };
  auto is_one = [&](const uint32_t (&a)[NL]) {
    uint32_t acc = a[0] ^ 1u;
#pragma unroll
    for (int k = 1; k < NL; ++k) acc |= a[k];
    return acc == 0;
  };
#pragma unroll 1
  while (!is_one(u) && !is_one(v)) {
#pragma unroll 1
    while (!(u[0] & 1u)) {
      shr1(u);
      halve(x1);
    }
#pragma unroll 1
    while (!(v[0] & 1u)) {
      shr1(v);
      halve(x2);
    }
    if (!borrow(u, v)) {  // u >= v
      sub(u, v);
      sub_m(x1, x2);
    } else {
      sub(v, u);
      sub_m(x2, x1);
    }
  }
  const bool one_u = is_one(u);
#pragma unroll
  for (int k = 0; k < NL; ++k) x[k] = one_u ? x1[k] : x2[k];
}

// The block's shared scratch: the batch inversions' product tree (node
// 1 the root, node k's children 2k and 2k + 1, signature j's leaf SIGS +
// j) and each signature's scalars u1, u2 (plain domain).
template <class S>
struct Shared {
  uint32_t tree[2 * S::SIGS][S::NL];
  uint32_t u[S::SIGS][2][S::NL];
};

// r = x^-1 (Montgomery domain) on the block's live lanes, 0 on the
// others, by Montgomery's trick over a product tree: the leaves are the
// live values (1 for the others), a level of the tree a step with one
// product a node, each by its own group; the root is inverted once (a
// binary GCD in one thread, then two products back to the Montgomery
// domain); the way down gives node 2k the inverse of node k times node
// 2k + 1 and vice versa, two products a node. 3 SIGS - 1 products a
// block in 2 log2(SIGS) + 1 steps. Every thread of the block calls it.
template <class S, int M>
__device__ __forceinline__ void block_inv(const Group<S>& g, int sig,
                                          Shared<S>& sh, Limbs<S>& r,
                                          const Limbs<S>& x, bool live) {
  constexpr int L = S::L, B = S::SIGS;
  static_assert((B & (B - 1)) == 0, "a power of two signatures a block");
  const int base = g.rank * L;
  {
    Limbs<S> one;
    load_const<S, M == kP ? kOneP : kOneN>(g, one);
#pragma unroll
    for (int k = 0; k < L; ++k) {
      sh.tree[B + sig][base + k] = live ? x[k] : one[k];
    }
  }
  if (!__syncthreads_or(live)) {
    zero<S>(r);
    return;  // the same on every thread of the block
  }
  Limbs<S> a, b;
#pragma unroll 1
  for (int half = B / 2; half >= 1; half /= 2) {  // node half + sig
    const bool mine = sig < half;
    const Group<S> gn = g.narrow(mine);
    if (mine) {
      const int k = half + sig;
#pragma unroll
      for (int q = 0; q < L; ++q) {
        a[q] = sh.tree[2 * k][base + q];
        b[q] = sh.tree[2 * k + 1][base + q];
      }
      mont_mul<S, M>(gn, a, a, b);
#pragma unroll
      for (int q = 0; q < L; ++q) sh.tree[k][base + q] = a[q];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) gcd_inv<S, M>(sh.tree[1]);
  __syncthreads();
  // Each loop below holds one product, for one copy of its code.
  const Group<S> g0 = g.narrow(sig == 0);
  if (sig == 0) {  // (T R)^-1 R^2 R^-1 R^2 R^-1 = T^-1 R
    load_const<S, M == kP ? kR2P : kR2N>(g0, b);
#pragma unroll
    for (int q = 0; q < L; ++q) a[q] = sh.tree[1][base + q];
#pragma unroll 1
    for (int t = 0; t < 2; ++t) mont_mul<S, M>(g0, a, a, b);
#pragma unroll
    for (int q = 0; q < L; ++q) sh.tree[1][base + q] = a[q];
  }
  __syncthreads();
#pragma unroll 1
  for (int half = 1; half < B; half *= 2) {  // node half + sig's children
    const bool mine = sig < half;
    const Group<S> gn = g.narrow(mine);
    if (mine) {
      const int k = half + sig;
#pragma unroll
      for (int q = 0; q < L; ++q) b[q] = sh.tree[k][base + q];
      // 1 / node 2k = 1 / node k * node 2k + 1, and the other way.
      Limbs<S> left;
#pragma unroll 1
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int q = 0; q < L; ++q) a[q] = sh.tree[2 * k + 1 - c][base + q];
        mont_mul<S, M>(gn, a, b, a);
        if (c == 0) copy<S>(left, a);
      }
#pragma unroll
      for (int q = 0; q < L; ++q) {
        sh.tree[2 * k][base + q] = left[q];
        sh.tree[2 * k + 1][base + q] = a[q];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < L; ++k) r[k] = live ? sh.tree[B + sig][base + k] : 0u;
}

// This thread's limbs of a big-endian byte row.
template <class S>
__device__ __forceinline__ void load_be(const Group<S>& g, Limbs<S>& r,
                                        const uint8_t* __restrict__ row) {
#pragma unroll
  for (int k = 0; k < S::L; ++k) {
    const uint8_t* p = row + 4 * (S::NL - 1 - (g.rank * S::L + k));
    r[k] = (static_cast<uint32_t>(p[0]) << 24) |
           (static_cast<uint32_t>(p[1]) << 16) |
           (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
  }
}

// The shared prefix of both ladders: input checks, the key in
// Montgomery form (qx, qy) and s in Montgomery form (s_m). False when
// the lane fails a check or lies past the batch. Every lane of `g`
// calls it.
template <class S>
__device__ __forceinline__ bool prologue(
    const Group<S>& g, long long lane, long long n,
    const uint8_t* __restrict__ r_rows, const uint8_t* __restrict__ s_rows,
    const uint8_t* __restrict__ qx_rows, const uint8_t* __restrict__ qy_rows,
    const bool* __restrict__ valid, Limbs<S>& qx, Limbs<S>& qy,
    Limbs<S>& s_m) {
  zero<S>(qx);
  zero<S>(qy);
  zero<S>(s_m);
  bool ok = lane < n && valid[lane];
  const Group<S> gr = g.narrow(ok);
  if (ok) {
    const long long off = lane * 4 * S::NL;
    Limbs<S> r;
    load_be<S>(gr, r, r_rows + off);
    load_be<S>(gr, s_m, s_rows + off);
    load_be<S>(gr, qx, qx_rows + off);
    load_be<S>(gr, qy, qy_rows + off);
    // Every check runs (no short cut), so the group's collectives match.
    const bool r_ok = !is_zero<S>(gr, r) & less<S, kN>(gr, r);
    const bool s_ok = !is_zero<S>(gr, s_m) & less<S, kN>(gr, s_m);
    const bool q_ok = less<S, kP>(gr, qx) & less<S, kP>(gr, qy) &
                      !(is_zero<S>(gr, qx) & is_zero<S>(gr, qy));
    ok = r_ok && s_ok && q_ok;
  }
  const Group<S> gc = g.narrow(ok);
  if (ok) {
    Limbs<S> r2, t, u;
    // y^2 == x^3 - 3x + b, Montgomery form.
    load_const<S, kR2P>(gc, r2);
    mont_mul<S, kP>(gc, qx, qx, r2);
    mont_mul<S, kP>(gc, qy, qy, r2);
    mont_mul<S, kP>(gc, t, qx, qx);
    mont_mul<S, kP>(gc, t, t, qx);
    add_mod<S, kP>(gc, u, qx, qx);
    add_mod<S, kP>(gc, u, u, qx);
    sub_mod<S, kP>(gc, t, t, u);
    load_const<S, kB>(gc, u);
    add_mod<S, kP>(gc, t, t, u);
    mont_mul<S, kP>(gc, u, qy, qy);
    ok = equal<S>(gc, t, u);
  }
  const Group<S> gs = g.narrow(ok);
  if (ok) {
    Limbs<S> r2;
    load_const<S, kR2N>(gs, r2);
    mont_mul<S, kN>(gs, s_m, s_m, r2);
  }
  return ok;
}

// u1 = e w, u2 = r w (plain domain) into the group's shared slot, from
// w = s^-1 (Montgomery domain).
template <class S>
__device__ __forceinline__ void scalars(const Group<S>& g, long long lane,
                                        const uint8_t* __restrict__ digest,
                                        const uint8_t* __restrict__ r_rows,
                                        const Limbs<S>& w,
                                        uint32_t (&u)[2][S::NL]) {
  const long long off = lane * 4 * S::NL;
  Limbs<S> r2, t, one, out;
  load_const<S, kR2N>(g, r2);
  one_plain<S>(g, one);
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    load_be<S>(g, t, (h ? r_rows : digest) + off);
    cond_sub<S, kN>(g, t, t, 0);
    mont_mul<S, kN>(g, t, t, r2);
    mont_mul<S, kN>(g, t, t, w);
    mont_mul<S, kN>(g, out, t, one);
#pragma unroll
    for (int k = 0; k < S::L; ++k) u[h][g.rank * S::L + k] = out[k];
  }
  g.sync();
}

// The end of both ladders, for a live lane: x_R = X * zinv^2 (Jacobian)
// or X * zinv (projective), to the plain domain, mod n, == r (read again
// from its row, so it holds no registers through the ladder).
template <class S>
__device__ __forceinline__ bool epilogue(const Group<S>& g,
                                         const Limbs<S>& x, Limbs<S>& zi,
                                         const uint8_t* __restrict__ r_row,
                                         bool jacobian) {
  Limbs<S> t, r;
  load_be<S>(g, r, r_row);
  if (jacobian) mont_mul<S, kP>(g, zi, zi, zi);
  mont_mul<S, kP>(g, t, x, zi);
  one_plain<S>(g, zi);
  mont_mul<S, kP>(g, t, t, zi);
  cond_sub<S, kN>(g, t, t, 0);
  return equal<S>(g, t, r);
}

// Complete projective mixed addition (X:Y:Z) += (x2, y2), a = -3
// (ops/ecdsa.py::_madd_complete; the same values, an order that keeps
// fewer temporaries live).
template <class S>
__device__ __forceinline__ void madd_complete(const Group<S>& g, Limbs<S>& X,
                                              Limbs<S>& Y, Limbs<S>& Z,
                                              const Limbs<S>& x2,
                                              const Limbs<S>& y2) {
  Limbs<S> t0, t1, t3, t4, ty, a, b;
  mont_mul<S, kP>(g, t0, X, x2);
  mont_mul<S, kP>(g, t1, Y, y2);
  add_mod<S, kP>(g, a, x2, y2);
  add_mod<S, kP>(g, b, X, Y);
  mont_mul<S, kP>(g, t3, a, b);
  sub_mod<S, kP>(g, t3, t3, t0);
  sub_mod<S, kP>(g, t3, t3, t1);  // x1 y2 + x2 y1
  mont_mul<S, kP>(g, t4, y2, Z);
  add_mod<S, kP>(g, t4, t4, Y);  // y1 + y2 z1
  mont_mul<S, kP>(g, ty, x2, Z);
  add_mod<S, kP>(g, ty, ty, X);  // x1 + x2 z1
  load_const<S, kB>(g, b);
  mont_mul<S, kP>(g, a, b, Z);
  sub_mod<S, kP>(g, a, ty, a);
  add_mod<S, kP>(g, X, a, a);
  add_mod<S, kP>(g, a, a, X);  // x3 = 3 (ty - b z1)
  sub_mod<S, kP>(g, X, t1, a);  // z3t
  add_mod<S, kP>(g, Y, t1, a);  // x3t
  mont_mul<S, kP>(g, t1, b, ty);  // b ty
  add_mod<S, kP>(g, a, Z, Z);
  add_mod<S, kP>(g, a, a, Z);  // 3 z1
  sub_mod<S, kP>(g, t1, t1, a);
  sub_mod<S, kP>(g, t1, t1, t0);
  add_mod<S, kP>(g, b, t1, t1);
  add_mod<S, kP>(g, t1, t1, b);  // y3 = 3 (b ty - 3 z1 - t0)
  add_mod<S, kP>(g, b, t0, t0);
  add_mod<S, kP>(g, b, b, t0);
  sub_mod<S, kP>(g, t0, b, a);  // t0n = 3 t0 - 3 z1
  // Live: t3, t4, X = z3t, Y = x3t, t1 = y3, t0 = t0n.
  mont_mul<S, kP>(g, a, t3, Y);
  mont_mul<S, kP>(g, b, t4, t1);
  sub_mod<S, kP>(g, ty, a, b);  // xo = t3 x3t - t4 y3
  mont_mul<S, kP>(g, a, Y, X);
  mont_mul<S, kP>(g, b, t0, t1);
  add_mod<S, kP>(g, Y, a, b);  // yo = x3t z3t + t0n y3
  mont_mul<S, kP>(g, a, t4, X);
  mont_mul<S, kP>(g, b, t3, t0);
  add_mod<S, kP>(g, Z, a, b);  // zo = t4 z3t + t3 t0n
  copy<S>(X, ty);
}

// Jacobian doubling, a = -3 (ops/ecdsa.py::_dbl); Z = 0 stays 0.
template <class S>
__device__ __forceinline__ void dbl(const Group<S>& g, Limbs<S>& X,
                                    Limbs<S>& Y, Limbs<S>& Z) {
  Limbs<S> delta, gamma, beta, alpha, t;
  mont_mul<S, kP>(g, delta, Z, Z);
  mont_mul<S, kP>(g, gamma, Y, Y);
  mont_mul<S, kP>(g, beta, X, gamma);
  sub_mod<S, kP>(g, t, X, delta);
  add_mod<S, kP>(g, alpha, X, delta);
  mont_mul<S, kP>(g, alpha, t, alpha);
  add_mod<S, kP>(g, t, alpha, alpha);
  add_mod<S, kP>(g, alpha, t, alpha);  // 3 (x - delta)(x + delta)
  add_mod<S, kP>(g, beta, beta, beta);
  add_mod<S, kP>(g, beta, beta, beta);  // 4 beta
  add_mod<S, kP>(g, t, Y, Z);
  mont_mul<S, kP>(g, t, t, t);
  sub_mod<S, kP>(g, t, t, gamma);
  sub_mod<S, kP>(g, Z, t, delta);  // z3 = (y + z)^2 - gamma - delta
  mont_mul<S, kP>(g, X, alpha, alpha);
  add_mod<S, kP>(g, t, beta, beta);
  sub_mod<S, kP>(g, X, X, t);  // x3 = alpha^2 - 8 beta
  mont_mul<S, kP>(g, gamma, gamma, gamma);
  add_mod<S, kP>(g, gamma, gamma, gamma);
  add_mod<S, kP>(g, gamma, gamma, gamma);
  add_mod<S, kP>(g, gamma, gamma, gamma);  // 8 gamma^2
  sub_mod<S, kP>(g, beta, beta, X);
  mont_mul<S, kP>(g, Y, alpha, beta);
  sub_mod<S, kP>(g, Y, Y, gamma);  // y3 = alpha (4 beta - x3) - 8 gamma^2
}

// Jacobian + affine addition with the select semantics of
// ops/ecdsa.py::_add_mixed: P at infinity -> Q (or infinity), Q at
// infinity -> P, P == -Q -> Z = 0. P == Q returns true and leaves P as
// it is: the caller doubles it (so the kernel holds one copy of dbl).
template <class S>
__device__ __forceinline__ bool add_mixed(const Group<S>& g, Limbs<S>& X,
                                          Limbs<S>& Y, Limbs<S>& Z,
                                          const Limbs<S>& x2,
                                          const Limbs<S>& y2, bool q_inf) {
  const bool p_inf = is_zero<S>(g, Z);
  Limbs<S> z1z1, h, rr, hh, v, t;
  mont_mul<S, kP>(g, z1z1, Z, Z);
  mont_mul<S, kP>(g, h, x2, z1z1);  // u2
  sub_mod<S, kP>(g, h, h, X);
  mont_mul<S, kP>(g, rr, Z, z1z1);
  mont_mul<S, kP>(g, rr, y2, rr);  // s2
  sub_mod<S, kP>(g, rr, rr, Y);
  mont_mul<S, kP>(g, hh, h, h);
  mont_mul<S, kP>(g, v, X, hh);
  mont_mul<S, kP>(g, hh, h, hh);  // hhh
  mont_mul<S, kP>(g, z1z1, Z, h);  // z3
  const bool same_x = is_zero<S>(g, h) && !p_inf && !q_inf;
  const bool rr_zero = is_zero<S>(g, rr);
  const bool general = !p_inf && !q_inf && !(same_x && rr_zero);
  const Group<S> gg = g.narrow(general);
  if (general) {
    mont_mul<S, kP>(gg, t, rr, rr);
    sub_mod<S, kP>(gg, t, t, hh);
    add_mod<S, kP>(gg, h, v, v);
    sub_mod<S, kP>(gg, t, t, h);  // x3 = rr^2 - hhh - 2v
    sub_mod<S, kP>(gg, v, v, t);
    mont_mul<S, kP>(gg, v, rr, v);
    mont_mul<S, kP>(gg, hh, Y, hh);
    sub_mod<S, kP>(gg, Y, v, hh);  // y3 = rr (v - x3) - y1 hhh
    copy<S>(X, t);
    if (same_x) {
      zero<S>(Z);  // P == -Q
    } else {
      copy<S>(Z, z1z1);
    }
    return false;
  }
  if (p_inf) {
    copy<S>(X, x2);
    copy<S>(Y, y2);
    if (q_inf) {
      zero<S>(Z);
    } else {
      load_const<S, kOneP>(g, Z);
    }
    return false;
  }
  return !q_inf;  // Q at infinity keeps P; else P == Q
}

// This thread's slice of a table entry's x and y (2 NL words: x's limbs,
// then y's), read through the read-only path.
template <class S>
__device__ __forceinline__ void load_entry(const Group<S>& g, Limbs<S>& x,
                                           Limbs<S>& y,
                                           const uint32_t* __restrict__ e) {
#pragma unroll
  for (int k = 0; k < S::L; ++k) {
    x[k] = __ldg(e + g.rank * S::L + k);
    y[k] = __ldg(e + S::NL + g.rank * S::L + k);
  }
}

// Both kernels name 1 as their minimum blocks an SM: with the block
// size alone, ptxas held the P-384 windowed kernel to 128 registers and
// spilled; with it, 135 and none.
template <class S>
__global__ void __launch_bounds__(S::kThreads, 1)
ecdsa_windowed_kernel(const uint8_t* __restrict__ digest,
                      const uint8_t* __restrict__ r_rows,
                      const uint8_t* __restrict__ s_rows,
                      const uint8_t* __restrict__ qx_rows,
                      const uint8_t* __restrict__ qy_rows,
                      const bool* __restrict__ valid,
                      const int32_t* __restrict__ key_idx,
                      const uint32_t* __restrict__ gtab,
                      const uint32_t* __restrict__ qtab, int w,
                      int key_slots, bool* __restrict__ out, long long n) {
  constexpr int NL = S::NL;
  __shared__ Shared<S> sh;
  const Group<S> g(threadIdx.x);
  const int sig = threadIdx.x / S::G;
  const long long lane = static_cast<long long>(blockIdx.x) * S::SIGS + sig;
  Limbs<S> X, Y, Z;
  bool ok;
  {
    Limbs<S> s;
    ok = prologue<S>(g, lane, n, r_rows, s_rows, qx_rows, qy_rows, valid, X,
                     Y, s);
    block_inv<S, kN>(g, sig, sh, Z, s, ok);
  }
  zero<S>(X);
  load_const<S, kOneP>(g, Y);
  const Group<S> gl = g.narrow(ok);
  if (ok) {
    scalars<S>(gl, lane, digest, r_rows, Z, sh.u[sig]);
    zero<S>(Z);
    int key = key_idx[lane];
    key = key < 0 ? 0 : (key >= key_slots ? key_slots - 1 : key);
    const int nwin = 32 * NL / w;
    const uint32_t mask = (1u << w) - 1u;
    const uint32_t* qbase =
        qtab + ((static_cast<size_t>(key) * nwin) << w) * (2 * NL);
#pragma unroll 1
    for (int j = 0; j < nwin; ++j) {
      const int bit = j * w;  // w divides 32: a digit sits in one word
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        // Digit 0 is the identity: that group keeps its sum.
        const uint32_t d = (sh.u[sig][h][bit >> 5] >> (bit & 31)) & mask;
        const Group<S> gd = gl.narrow(d != 0);
        if (d != 0) {
          const size_t entry = ((static_cast<size_t>(j) << w) + d) * (2 * NL);
          Limbs<S> px, py;
          load_entry<S>(gd, px, py, (h ? qbase : gtab) + entry);
          madd_complete<S>(gd, X, Y, Z, px, py);
        }
      }
    }
  }
  bool live = false;  // else at infinity, or failed
  if (ok) live = !is_zero<S>(gl, Z);
  Limbs<S> zi;
  block_inv<S, kP>(g, sig, sh, zi, Z, live);
  bool verdict = false;
  const Group<S> ge = g.narrow(live);
  if (live) verdict = epilogue<S>(ge, X, zi, r_rows + lane * 4 * NL, false);
  if (g.rank == 0 && lane < n) out[lane] = verdict;
}

template <class S>
__global__ void __launch_bounds__(S::kThreads, 1)
ecdsa_jacobian_kernel(const uint8_t* __restrict__ digest,
                      const uint8_t* __restrict__ r_rows,
                      const uint8_t* __restrict__ s_rows,
                      const uint8_t* __restrict__ qx_rows,
                      const uint8_t* __restrict__ qy_rows,
                      const bool* __restrict__ valid,
                      bool* __restrict__ out, long long n) {
  constexpr int NL = S::NL;
  __shared__ Shared<S> sh;
  const Group<S> g(threadIdx.x);
  const int sig = threadIdx.x / S::G;
  const long long lane = static_cast<long long>(blockIdx.x) * S::SIGS + sig;
  Limbs<S> qx, qy, X, Y, Z;
  bool ok;
  {
    Limbs<S> s;
    ok = prologue<S>(g, lane, n, r_rows, s_rows, qx_rows, qy_rows, valid,
                     qx, qy, s);
    block_inv<S, kN>(g, sig, sh, Z, s, ok);
  }
  const Group<S> gl = g.narrow(ok);
  if (ok) {
    scalars<S>(gl, lane, digest, r_rows, Z, sh.u[sig]);
    // One loop runs T = G + Q (its first step) and then the ladder, so
    // the kernel holds one copy each of dbl and add_mixed: a step
    // doubles (a bit's double, or the add that found P == Q), then adds.
    // `ga` is the groups still in the loop; each step narrows it for
    // the parts only some of them run.
    Limbs<S> tx, ty, ax, ay, c;
    load_const<S, kGX>(gl, X);
    load_const<S, kGY>(gl, Y);
    load_const<S, kOneP>(gl, Z);
    bool in_t = true;   // the step that makes T
    bool redo = false;  // the last add met P == Q: double P instead
    bool t_inf = false;
    int i = 32 * NL - 1;  // the bit of u1, u2 this step adds, MSB first
    Group<S> ga = gl;
#pragma unroll 1
    for (;;) {
      const bool twice = !in_t || redo;
      const Group<S> gd = ga.narrow(twice);
      if (twice) dbl<S>(gd, X, Y, Z);
      const bool add = !redo;  // else the double was this step
      redo = false;
      const Group<S> gq = ga.narrow(add);
      if (add) {
        bool a_inf = false;
        if (in_t) {
          copy<S>(ax, qx);
          copy<S>(ay, qy);
        } else {
          const uint32_t b1 = (sh.u[sig][0][i >> 5] >> (i & 31)) & 1u;
          const uint32_t b2 = (sh.u[sig][1][i >> 5] >> (i & 31)) & 1u;
          const uint32_t sel = b1 + 2 * b2;  // 0 none, 1 G, 2 Q, 3 G + Q
          load_const<S, kGX>(gq, c);
#pragma unroll
          for (int k = 0; k < S::L; ++k) {
            ax[k] = sel == 1 ? c[k] : (sel == 2 ? qx[k] : tx[k]);
          }
          load_const<S, kGY>(gq, c);
#pragma unroll
          for (int k = 0; k < S::L; ++k) {
            ay[k] = sel == 1 ? c[k] : (sel == 2 ? qy[k] : ty[k]);
          }
          a_inf = sel == 3 ? t_inf : sel == 0;
        }
        redo = add_mixed<S>(gq, X, Y, Z, ax, ay, a_inf);
      }
      const bool to_t = !redo && in_t;
      const Group<S> gt = ga.narrow(to_t);
      if (to_t) {
        // T to affine (t_inf when Q == -G); the ladder starts at infinity.
        Limbs<S> zi;
        t_inf = is_zero<S>(gt, Z);
        mont_inv<S, kP>(gt, zi, Z);
        mont_mul<S, kP>(gt, c, zi, zi);
        mont_mul<S, kP>(gt, tx, X, c);
        mont_mul<S, kP>(gt, c, zi, c);
        mont_mul<S, kP>(gt, ty, Y, c);
        zero<S>(X);
        zero<S>(Y);
        zero<S>(Z);
        in_t = false;
      }
      const bool done = !to_t && !redo && --i < 0;
      const Group<S> gn = ga.narrow(!done);
      if (done) break;
      ga = gn;
    }
  }
  bool live = false;  // else at infinity, or failed
  if (ok) live = !is_zero<S>(gl, Z);
  Limbs<S> zi;
  block_inv<S, kP>(g, sig, sh, zi, Z, live);
  bool verdict = false;
  const Group<S> ge = g.narrow(live);
  if (live) verdict = epilogue<S>(ge, X, zi, r_rows + lane * 4 * NL, true);
  if (g.rank == 0 && lane < n) out[lane] = verdict;
}

using P256W = Spec<8, kGroupW, kSigsW>;
using P384W = Spec<12, kGroupW, kSigsW>;
using P256J = Spec<8, kGroupJ, kSigsJ>;
using P384J = Spec<12, kGroupJ, kSigsJ>;

}  // namespace

// Plain C entry points (loaded with ctypes).

// Signatures a block of the windowed (window > 0) or the window-0
// kernel: the width of its batch inversions.
extern "C" int ctmr_ecdsa_lanes_per_block(int window) {
  return window ? kSigsW : kSigsJ;
}

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

template <class S>
static unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + S::SIGS - 1) / S::SIGS);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(digest);
  const auto* rr = static_cast<const uint8_t*>(r);
  const auto* ss = static_cast<const uint8_t*>(s);
  const auto* xx = static_cast<const uint8_t*>(qx);
  const auto* yy = static_cast<const uint8_t*>(qy);
  const auto* v = static_cast<const bool*>(valid);
  const auto* k = static_cast<const int32_t*>(key_idx);
  const auto* g = static_cast<const uint32_t*>(gtab);
  const auto* q = static_cast<const uint32_t*>(qtab);
  auto* o = static_cast<bool*>(out);
  if (nl == 8) {
    ecdsa_windowed_kernel<P256W>
        <<<blocks_for<P256W>(n), P256W::kThreads, 0, st>>>(
            d, rr, ss, xx, yy, v, k, g, q, w, key_slots, o, n);
  } else {
    ecdsa_windowed_kernel<P384W>
        <<<blocks_for<P384W>(n), P384W::kThreads, 0, st>>>(
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(digest);
  const auto* rr = static_cast<const uint8_t*>(r);
  const auto* ss = static_cast<const uint8_t*>(s);
  const auto* xx = static_cast<const uint8_t*>(qx);
  const auto* yy = static_cast<const uint8_t*>(qy);
  const auto* v = static_cast<const bool*>(valid);
  auto* o = static_cast<bool*>(out);
  if (nl == 8) {
    ecdsa_jacobian_kernel<P256J>
        <<<blocks_for<P256J>(n), P256J::kThreads, 0, st>>>(
            d, rr, ss, xx, yy, v, o, n);
  } else {
    ecdsa_jacobian_kernel<P384J>
        <<<blocks_for<P384J>(n), P384J::kThreads, 0, st>>>(
            d, rr, ss, xx, yy, v, o, n);
  }
  return static_cast<int>(cudaGetLastError());
}
