// Bloom bit-scatter K5: the probe positions of one filter-cascade layer
// round, set into a packed uint32 word arena.
//
// Replaces the XLA scatters of the JAX package's filter build:
// ct_mapreduce_tpu/filter/cascade.py::_layer_bits_jit (one layer) and
// ct_mapreduce_tpu/filter/fused.py::_fused_bits_jit (every group of a
// layer round in one dispatch). One kernel serves both: the one-layer
// form is the fused form with one group at arena offset 0.
//
// Each lane is one key uint32[4] of group gid. The group's vectors give
// its layer size m (bits), probe count k and bit offset in the arena.
// Kirsch-Mitzenmacher double hashing, all in wrapping uint32:
//   a = (k0 ^ layer * 0x9E3779B9) + k2
//   b = ((k1 ^ layer * 0x85EBCA6B) + k3) | 1
//   probe i < k sets bit off + ((a + i * b) mod m)
// Bit j of the arena is word j >> 5, bit j & 31: the little-endian word
// packing of the reference's _pack_words, so the arena leaves the card
// as the artifact's words with no bool bitmap and no packbits.
//
// What bounds it on an H100: the scatter. A lane reads 16 B of key and
// 4 B of group id, coalesced, then does k atomicOr's at random words of
// the arena; those read-modify-writes (at L2 when the arena fits there)
// are the cost, not the arithmetic. The design is the simple one: one
// thread per lane, the group vectors read through the read-only path
// (they are tiny and every lane of a group reads the same entry), one
// atomicOr per probe. The OR commutes, so the words do not depend on
// the order the atomics land in: the result is bit-exact, not merely
// close. Word indices are computed in 64 bits: an arena may reach
// 2^31 - 1 bits. Probes i >= k write nothing. There are no padding
// lanes to mask: the builders launch exactly their live lanes (the
// reference padded for XLA's compile shapes and parked those lanes past
// the arena).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kGold = 0x9E3779B9u;  // filter/cascade.py _GOLD
constexpr uint32_t kMix = 0x85EBCA6Bu;   // filter/cascade.py _MIX

__global__ void __launch_bounds__(kThreads)
bloom_scatter_kernel(const uint4* __restrict__ keys,
                     const int32_t* __restrict__ gid,
                     const long long* __restrict__ offs,
                     const int32_t* __restrict__ ms,
                     const int32_t* __restrict__ ks, uint32_t layer,
                     uint32_t* __restrict__ words, long long n) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= n) return;
  const uint4 key = keys[lane];
  const int32_t g = gid[lane];
  const uint32_t m = static_cast<uint32_t>(__ldg(ms + g));
  const int32_t k = __ldg(ks + g);
  const unsigned long long off =
      static_cast<unsigned long long>(__ldg(offs + g));
  const uint32_t a = (key.x ^ (layer * kGold)) + key.z;
  const uint32_t b = ((key.y ^ (layer * kMix)) + key.w) | 1u;
  for (int32_t i = 0; i < k; ++i) {
    const uint32_t pos = (a + static_cast<uint32_t>(i) * b) % m;
    const unsigned long long j = off + pos;
    atomicOr(words + (j >> 5), 1u << (j & 31u));
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). ORs the probe bits of `n`
// lanes into `words` on `stream` of device `device`. Does not
// synchronise, and returns cudaGetLastError() of the launch (0 =
// launched).
extern "C" int ctmr_bloom_scatter(const void* keys, const void* gid,
                                  const void* offs, const void* ms,
                                  const void* ks,
                                  unsigned int layer, void* words,
                                  long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  bloom_scatter_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(keys), static_cast<const int32_t*>(gid),
      static_cast<const long long*>(offs), static_cast<const int32_t*>(ms),
      static_cast<const int32_t*>(ks), layer, static_cast<uint32_t*>(words),
      n);
  return static_cast<int>(cudaGetLastError());
}
