// Device functions of the DER walker, shared by the walker kernel K3
// (der_walk.cu) and the probe ladder (mosaic_probe.cu), whose stages
// build the walker up one construct at a time.
//
// Bytes come from a source: RowChunks reads one lane's row of a
// uint8[B, L] batch, 8 bytes at a time, through a 32-byte register
// cache; LaneWords reads one lane of big-endian uint32 words laid out
// [n_words, lanes] (lanes on the minor axis), 0 outside them. A Window
// puts the JAX walker's fixed byte windows over a row: window byte j is
// row byte base + j for 0 <= j < width, and 0 outside the window or
// past the row.

#pragma once

#include <stdint.h>

namespace derwalk {

// Keeps the low n bytes of v (all of them for n >= 8, none for n <= 0).
__device__ __forceinline__ uint64_t keep_bytes(uint64_t v, int n) {
  return n >= 8 ? v : (n <= 0 ? 0ull : v & ((1ull << (8 * n)) - 1ull));
}

// One lane's row of a uint8[B, L] tensor, read in 16-byte chunks that
// are aligned on absolute addresses. Two neighbouring chunks (32 bytes)
// stay in eight registers (w0..w7: named, never indexed at run time, so
// they cannot fall into local memory). A read takes 8 bytes at once; when
// they are not inside the held pair, the pair that starts with the chunk
// of their first byte is loaded with two 16-byte read-only loads. A pair
// that reaches past either end of the tensor (the first row of an unaligned
// view, the last row's tail) is read byte by byte, and only the bytes of
// this row: no load leaves the tensor. A Window masks what lies past the
// row.
struct RowChunks {
  const uint8_t* base;  // the aligned chunk that holds the row's byte 0
  unsigned skew;        // row start - base, 0..15
  int len;              // row length
  int c_lo, c_hi;       // chunks c_lo..c_hi (from base) lie in the tensor
  int held;             // first chunk of the pair in w0..w7
  uint32_t w0, w1, w2, w3, w4, w5, w6, w7;

  // Row `lane` of the tensor [data, data + n * row_len).
  __device__ __forceinline__ RowChunks(const uint8_t* data, long long n,
                                       int row_len, long long lane) {
    const uintptr_t lo = reinterpret_cast<uintptr_t>(data);
    const uintptr_t hi = lo + static_cast<uintptr_t>(n) * row_len;
    const uintptr_t row = lo + static_cast<uintptr_t>(lane) * row_len;
    const uintptr_t b = row & ~static_cast<uintptr_t>(15);
    const uintptr_t last = (hi - b) / 16;  // chunks from b wholly below hi
    base = reinterpret_cast<const uint8_t*>(b);
    skew = static_cast<unsigned>(row - b);
    len = row_len;
    c_lo = b < lo ? 1 : 0;
    c_hi = last > 0x7FFFFFFF ? 0x7FFFFFFF : static_cast<int>(last) - 1;
    held = -2;  // no pair: every read misses
    w0 = w1 = w2 = w3 = w4 = w5 = w6 = w7 = 0;
  }

  // Chunks c and c + 1 into w0..w7.
  __device__ __forceinline__ void fetch(int c) {
    held = c;
    const uint8_t* p = base + (static_cast<long long>(c) << 4);
    if (c >= c_lo && c < c_hi) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
      const uint4 y = __ldg(reinterpret_cast<const uint4*>(p) + 1);
      w0 = x.x; w1 = x.y; w2 = x.z; w3 = x.w;
      w4 = y.x; w5 = y.y; w6 = y.z; w7 = y.w;
      return;
    }
    // Byte by byte through a shift register: byte i of the pair ends in
    // byte i of w0..w7.
    const int r0 = (c << 4) - static_cast<int>(skew);
#pragma unroll 1
    for (int i = 0; i < 32; ++i) {
      const uint32_t b = static_cast<unsigned>(r0 + i) < static_cast<unsigned>(len)
                             ? static_cast<uint32_t>(__ldg(p + i)) : 0u;
      w0 = __funnelshift_r(w0, w1, 8);
      w1 = __funnelshift_r(w1, w2, 8);
      w2 = __funnelshift_r(w2, w3, 8);
      w3 = __funnelshift_r(w3, w4, 8);
      w4 = __funnelshift_r(w4, w5, 8);
      w5 = __funnelshift_r(w5, w6, 8);
      w6 = __funnelshift_r(w6, w7, 8);
      w7 = (w7 >> 8) | (b << 24);
    }
  }

  // Bytes q..q+7 of the tensor from row position q >= 0 on, byte j in
  // bits 8j..8j+7. Bytes past the row are the next row's, or 0: the
  // caller masks them.
  __device__ __forceinline__ uint64_t raw8(int q) {
    const unsigned t = static_cast<unsigned>(q) + skew;
    unsigned d = t - (static_cast<unsigned>(held) << 4);
    if (d > 24u) {
      fetch(static_cast<int>(t >> 4));
      d = t & 15u;
    }
    // Shift the pair right by d bytes (d <= 24) with selects: 16, 8, 4
    // bytes, then the rest inside a word.
    const bool s16 = d & 16u, s8 = d & 8u, s4 = d & 4u;
    const uint32_t x0 = s16 ? w4 : w0, x1 = s16 ? w5 : w1;
    const uint32_t x2 = s16 ? w6 : w2, x3 = s16 ? w7 : w3;
    const uint32_t x4 = s16 ? 0u : w4, x5 = s16 ? 0u : w5;
    const uint32_t y0 = s8 ? x2 : x0, y1 = s8 ? x3 : x1;
    const uint32_t y2 = s8 ? x4 : x2, y3 = s8 ? x5 : x3;
    const uint32_t z0 = s4 ? y1 : y0, z1 = s4 ? y2 : y1, z2 = s4 ? y3 : y2;
    const unsigned sh = (d & 3u) * 8u;
    return (static_cast<uint64_t>(__funnelshift_r(z1, z2, sh)) << 32) |
           __funnelshift_r(z0, z1, sh);
  }
};

struct LaneWords {
  const uint32_t* w;  // word 0 of this lane
  long long stride;   // words between word k and word k + 1 of a lane
  int n_bytes;
  __device__ __forceinline__ int operator()(int q) const {
    if (q < 0 || q >= n_bytes) return 0;
    const uint32_t word = __ldg(w + static_cast<long long>(q >> 2) * stride);
    return static_cast<int>((word >> ((3 - (q & 3)) * 8)) & 0xFFu);
  }
};

// A window over a row: reads go through the row by pointer, since a
// RowChunks source changes as it reads (the held pair) and every window
// of a lane shares it. Windows never start before the row (base >= 0:
// the flat windows clamp, the scan windows anchor at p >= 0).
struct Window {
  RowChunks* src;
  int base;  // a multiple of 4
  int a;     // alignment of the anchor position in its word
  int width;
  int end;   // window bytes below min(width, row length - base) are real
  // Window bytes rel..rel+7, byte j in bits 8j..8j+7: 0 outside the
  // window and past the row.
  __device__ __forceinline__ uint64_t span8(int rel) const {
    const int lo = rel < 0 ? 0 : rel;
    const int skip = lo - rel;  // bytes before the window
    // A read wholly past the window or the row is masked to 0 below, so
    // it may read any row byte: the last one keeps it inside the row.
    const int q = lo < end ? base + lo : base + end - 1;
    const uint64_t v = end > 0 && skip < 8 ? src->raw8(q) << (8 * skip) : 0ull;
    return keep_bytes(v, end - rel);
  }
  __device__ __forceinline__ int operator[](int rel) const {
    return static_cast<int>(span8(rel) & 0xFFu);
  }
};

__device__ __forceinline__ Window make_window(RowChunks& src, int base, int a,
                                              int width) {
  const int in_row = src.len - base;
  return Window{&src, base, a, width, width < in_row ? width : in_row};
}

// der_kernel._window: the base word is clamped to nw - 1.
__device__ __forceinline__ Window flat_window(RowChunks& src, int nw, int p,
                                              int width) {
  int c = p < 0 ? 0 : p;
  if (c > (nw - 1) * 4) c = (nw - 1) * 4;
  return make_window(src, (c >> 2) << 2, (p < 0 ? 0 : p) & 3, width);
}

// der_kernel._sup_window: anchored at p & ~3, no clamp (p >= 0).
__device__ __forceinline__ Window scan_window(RowChunks& src, int p,
                                              int width) {
  return make_window(src, (p >> 2) << 2, (p < 0 ? 0 : p) & 3, width);
}

// Content length of a long-form DER length of n octets b1 b2 b3 (n of
// 1 or 2 reads those octets; any other n reads three).
__device__ __forceinline__ int long_form_len(int n, int b1, int b2, int b3) {
  return n == 1 ? b1 : n == 2 ? ((b1 << 8) | b2) : ((b1 << 16) | (b2 << 8) | b3);
}

struct Hdr {
  int tag, clen, hlen;
  bool ok;
};

// _read_header_w: the TLV header at row position p + delta, read through
// the window anchored at p. Short form, or long form of up to 3 length
// octets; ok needs the whole frame inside `limit`.
__device__ __forceinline__ Hdr read_header(const Window& win, int delta, int p,
                                           int limit) {
  const uint64_t v = win.span8(win.a + delta);
  Hdr h;
  h.tag = static_cast<int>(v & 0xFFu);
  const int b0 = static_cast<int>((v >> 8) & 0xFFu);
  const int b1 = static_cast<int>((v >> 16) & 0xFFu);
  const int b2 = static_cast<int>((v >> 24) & 0xFFu);
  const int b3 = static_cast<int>((v >> 32) & 0xFFu);
  const bool short_form = b0 < 0x80;
  const int n_len = b0 - 0x80;
  const bool long_ok = b0 > 0x80 && n_len <= 3;
  h.clen = short_form ? b0 : long_form_len(n_len, b1, b2, b3);
  h.hlen = short_form ? 2 : 2 + n_len;
  const int pos = p + delta;
  h.ok = (short_form || long_ok) && pos >= 0 && pos + h.hlen + h.clen <= limit;
  return h;
}

}  // namespace derwalk
