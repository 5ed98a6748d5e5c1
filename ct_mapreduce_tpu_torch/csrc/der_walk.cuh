// Device functions of the DER walker, shared by the walker kernel K3
// (der_walk.cu) and the probe ladder (mosaic_probe.cu), whose stages
// build the walker up one construct at a time.
//
// Bytes come from a source: RowBytes reads one lane's row of a
// uint8[B, L] batch, LaneWords reads one lane of big-endian uint32
// words laid out [n_words, lanes] (lanes on the minor axis). Both give 0
// outside their bytes. A Window puts the JAX walker's fixed byte
// windows over a source: window byte j is source byte base + j for
// 0 <= j < width, and 0 outside the window.

#pragma once

#include <stdint.h>

namespace derwalk {

struct RowBytes {
  const uint8_t* p;
  int len;
  __device__ __forceinline__ int operator()(int q) const {
    return (q >= 0 && q < len) ? static_cast<int>(__ldg(p + q)) : 0;
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

template <class Src>
struct Window {
  Src src;
  int base;  // a multiple of 4
  int a;     // alignment of the anchor position in its word
  int width;
  __device__ __forceinline__ int operator[](int rel) const {
    return (rel >= 0 && rel < width) ? src(base + rel) : 0;
  }
};

// der_kernel._window: the base word is clamped to nw - 1.
template <class Src>
__device__ __forceinline__ Window<Src> flat_window(const Src& src, int nw,
                                                   int p, int width) {
  int c = p < 0 ? 0 : p;
  if (c > (nw - 1) * 4) c = (nw - 1) * 4;
  return Window<Src>{src, (c >> 2) << 2, (p < 0 ? 0 : p) & 3, width};
}

// der_kernel._sup_window: anchored at p & ~3, no clamp (p >= 0).
template <class Src>
__device__ __forceinline__ Window<Src> scan_window(const Src& src, int p,
                                                   int width) {
  return Window<Src>{src, (p >> 2) << 2, (p < 0 ? 0 : p) & 3, width};
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
template <class W>
__device__ __forceinline__ Hdr read_header(const W& win, int delta, int p,
                                           int limit) {
  const int rel = win.a + delta;
  Hdr h;
  h.tag = win[rel];
  const int b0 = win[rel + 1];
  const int b1 = win[rel + 2], b2 = win[rel + 3], b3 = win[rel + 4];
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
