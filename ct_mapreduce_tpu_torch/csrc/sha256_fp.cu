// Dedup-key fingerprint for the pre-parsed ingest step: one SHA-256
// compression per lane over the fingerprint message, words 4..7 of the
// digest out.
//
// Replaces ct_mapreduce_tpu/ops/pallas_sha256.py::_kernel (the Pallas
// single-block SHA-256 the JAX package runs on every ingest step) and
// fuses in front of it the message build of
// ct_mapreduce_tpu/ops/pipeline.py::fingerprints: the 64-byte block
//   exp_hour (4 B, big-endian) | issuer_idx (4 B) | serial_len (1 B) |
//   serial (46 B) | 0x80 at byte 9 + serial_len | bit length in 62..63
// is assembled in registers from the lane's fields, so no [B, 16]
// block ever reaches device memory.
//
// What bounds it on an H100: integer ALU work, not bytes. A lane reads
// 58 B and writes 16 B, and does about 2.3k 2-input 32-bit operations
// (64 rounds of 26, 48 schedule steps of 13), which the card's 3-input
// logic and add instructions cut to about 1.4k. So the design keeps
// everything in registers: one thread per lane, the eight state words
// and the rolling 16-word schedule as locals, fully unrolled rounds so
// every schedule index is static, the round constants in __constant__
// memory, rotations as funnel shifts, and one 16-byte store per lane.
// No shared memory, no tensor cores (they do not apply to SHA-256).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSerialBytes = 46;  // packing.MAX_SERIAL_BYTES
constexpr int kThreads = 256;

__constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu,
    0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u,
    0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u,
    0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu,
    0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u,
    0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
    0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
    0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u, 0xD192E819u,
    0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u, 0x1E376C08u,
    0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu,
    0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

__constant__ uint32_t kH0[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__global__ void __launch_bounds__(kThreads)
sha256_fp_kernel(const int32_t* __restrict__ issuer_idx,
                 const int32_t* __restrict__ exp_hour,
                 const uint8_t* __restrict__ serials,
                 const int32_t* __restrict__ serial_len,
                 uint4* __restrict__ out, long long n) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= n) return;

  const uint32_t eh = static_cast<uint32_t>(exp_hour[lane]);
  const uint32_t ii = static_cast<uint32_t>(issuer_idx[lane]);
  const int32_t slen = serial_len[lane];
  // Same wrap-around arithmetic as the reference's int32/uint32 ops.
  const uint32_t msg_len = 9u + static_cast<uint32_t>(slen);
  const uint32_t bits = msg_len * 8u;
  const uint8_t* s = serials + lane * kSerialBytes;

  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 4 * i + j;
      uint32_t b;
      if (p < 4) {
        b = (eh >> (24 - 8 * p)) & 0xFFu;
      } else if (p < 8) {
        b = (ii >> (24 - 8 * (p - 4))) & 0xFFu;
      } else if (p == 8) {
        b = static_cast<uint32_t>(slen) & 0xFFu;
      } else if (p < 9 + kSerialBytes) {
        b = s[p - 9];
      } else {
        b = 0u;
      }
      if (msg_len == static_cast<uint32_t>(p)) b = 0x80u;
      if (p == 62) b = (bits >> 8) & 0xFFu;
      if (p == 63) b = bits & 0xFFu;
      word = (word << 8) | b;
    }
    w[i] = word;
  }

  uint32_t a = kH0[0], b = kH0[1], c = kH0[2], d = kH0[3];
  uint32_t e = kH0[4], f = kH0[5], g = kH0[6], h = kH0[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    const uint32_t wt = w[t & 15];
    const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + s1 + ch + kK[t] + wt;
    const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = s0 + maj;
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
    if (t < 48) {
      // Rolling schedule: W[t+16] replaces W[t].
      const uint32_t w1 = w[(t + 1) & 15];
      const uint32_t w9 = w[(t + 9) & 15];
      const uint32_t w14 = w[(t + 14) & 15];
      const uint32_t sg0 = rotr(w1, 7) ^ rotr(w1, 18) ^ (w1 >> 3);
      const uint32_t sg1 = rotr(w14, 17) ^ rotr(w14, 19) ^ (w14 >> 10);
      w[t & 15] = wt + sg0 + w9 + sg1;
    }
  }
  // Digest words 4..7 (the low 128 bits): the dedup key.
  out[lane] = make_uint4(e + kH0[4], f + kH0[5], g + kH0[6], h + kH0[7]);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` of
// device `device`, does not synchronise, and returns cudaGetLastError()
// of the launch (0 = launched).
extern "C" int ctmr_sha256_fp(const void* issuer_idx, const void* exp_hour,
                              const void* serials, const void* serial_len,
                              void* out, long long n, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  sha256_fp_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(issuer_idx),
      static_cast<const int32_t*>(exp_hour),
      static_cast<const uint8_t*>(serials),
      static_cast<const int32_t*>(serial_len), static_cast<uint4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
