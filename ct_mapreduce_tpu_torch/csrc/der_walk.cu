// K3: the DER walker of the ingest step, one thread per certificate.
//
// Replaces the XLA walker ct_mapreduce_tpu/ops/der_kernel.py::
// parse_certs_rows (with _scan_issuer_cn, _scan_extensions, _ext_round,
// _read_header_w, _parse_time_w), plus gather_serials_rows and the CN
// window that window_bytes_rows gives pipeline._cn_prefix_match. The
// probe kernels of tools/mosaic_probe.py (a Pallas bisect toward this
// walker) are its staged fragments, in mosaic_probe.cu.
//
// The JAX walker read bytes through one-hot word windows because a TPU
// gathers badly. Here each thread reads its own row of uint8[B, L]
// straight from device memory, and only the window SEMANTICS are kept
// (der_walk.cuh): reads outside a window see 0, the flat windows clamp
// their base word, the scan windows do not. The walk itself follows the
// scalar walker of native/ctmr_native.cpp (walker::extract_one), which
// is bit-exact with parse_certs_rows, with three differences that make
// it exact here too: the scan windows are not clamped, days-from-civil
// floors its divisions, and issuer_cn_off is left unmasked on !ok.
//
// What bounds it on an H100: bytes. The least a lane must move is the
// distinct 32-byte sectors its walk touches (about 10 for a 2 KB leaf)
// plus 159 B of inputs and outputs: 0.1497 ms for 2^20 stream rows at
// 3.35 TB/s. A lane does a few thousand integer operations, well under
// that.
//
// What held the first version back: it read its row one byte per load
// (about 340 loads a lane) and wrote the serial and CN windows one byte
// per store (107 a lane). The 32 threads of a warp sit a row (2 KB)
// apart, so every such load or store touches 32 different cache lines
// and costs the L1 one transaction per thread.
//
// What this version does about it:
// - Reads: RowChunks (der_walk.cuh) keeps two neighbouring aligned
//   16-byte chunks of the row in eight registers and reads 8 bytes at a
//   time out of them, so a TLV header (tag and up to four length octets)
//   is one read, not five. Only when the 8 bytes leave the held pair does
//   it load the pair that starts with their chunk, with two 16-byte
//   loads. The walk moves forward through windows of 12-68 bytes, so a
//   lane loads a few dozen chunks instead of a few hundred bytes; the
//   serial and CN windows jump back to early offsets that the L1 or L2
//   still holds. Bytes leave the registers through selects and funnel
//   shifts, never through a register array indexed at run time, and one
//   byte mask applies the window's and the row's ends.
// - Writes: each thread puts its serial and CN windows into shared
//   memory, and after a barrier the block writes its 128 x serial_k and
//   128 x cn_k contiguous output bytes with 16-byte stores. The
//   lane-minor field and flag stores already coalesce and stay.
// - Staging whole rows through shared memory was not chosen: a lane
//   needs bytes scattered over 1-1.5 KB of its 2 KB row, and which bytes
//   depends on the parse, so a fixed staged prefix either moves most of
//   the 2 GiB batch (about 0.64 ms at 3.35 TB/s, four times the bound)
//   or misses.

#include <cuda_runtime.h>
#include <stdint.h>

#include "der_walk.cuh"

namespace {

using derwalk::Hdr;
using derwalk::read_header;
using derwalk::RowChunks;
using derwalk::Window;

constexpr int kMaxRdns = 12;  // der_kernel.MAX_RDNS
constexpr int kMaxExts = 24;  // der_kernel.MAX_EXTS
constexpr int kFixed = 68;    // 17 words
constexpr int kHeader = 12;   // 3 words
constexpr int kValidity = 52; // 13 words
constexpr int kExtHead = 52;  // 13 words
constexpr int kRdn = 32;      // 8 words
constexpr int kExt = 44;      // 11 words
constexpr int kNoLimit = 1 << 30;
constexpr int kThreads = 128;
// Eight resident blocks an SM (1,024 threads) cap a thread at 64
// registers; without the cap ptxas keeps 56 and spills a value.
constexpr int kMinBlocks = 8;
// Widest serial window the staging buffer is sized for: 128 x (256 +
// 61) bytes stay under the 48 KB of dynamic shared memory a launch gets
// without opting in.
constexpr int kMaxSerial = 256;
constexpr int kMaxCn = 61;  // der_kernel.MAX_FIXED_WINDOW_BYTES

// Output fields, lane-minor: fields[f * n + lane].
enum Field {
  kSerialOff, kSerialLen, kNotAfterHour, kCnOff, kCnLen, kIssuerOff,
  kIssuerLen, kSpkiOff, kSpkiLen, kCrldpOff, kCrldpLen, kNumFields
};
enum Flag { kOk, kIsCa, kHasCrldp, kFits, kNumFlags };

__device__ __forceinline__ int floor_div(int x, int d) {
  const int q = x / d;
  return (x % d != 0 && (x < 0)) ? q - 1 : q;
}

// _parse_time_w: (epoch hour, ok) of the time at p + delta.
__device__ __forceinline__ bool parse_time(const Window& win,
                                           int delta, int p, int* hour_out) {
  const Hdr h = read_header(win, delta, p, kNoLimit);
  const bool is_utc = h.tag == 0x17;
  const bool is_gen = h.tag == 0x18;
  bool ok = h.ok && (is_utc || is_gen) && (is_utc ? h.clen >= 11 : h.clen >= 13);
  const int q = win.a + delta + h.hlen;
  const int body = is_utc ? q : q + 2;
  const uint64_t lead = win.span8(q), tail = win.span8(body + 2);
  int d[10];
  for (int i = 0; i < 4; ++i) d[i] = static_cast<int>((lead >> (8 * i)) & 0xFFu);
  for (int i = 0; i < 6; ++i) d[4 + i] = static_cast<int>((tail >> (8 * i)) & 0xFFu);
  bool digits = true;
  for (int i = 0; i < 10; ++i) {
    if (is_utc && (i == 2 || i == 3)) continue;
    digits = digits && d[i] >= 0x30 && d[i] <= 0x39;
  }
  const int yy = (d[0] - 0x30) * 10 + (d[1] - 0x30);
  const int cc = (d[2] - 0x30) * 10 + (d[3] - 0x30);
  const int month = (d[4] - 0x30) * 10 + (d[5] - 0x30);
  const int day = (d[6] - 0x30) * 10 + (d[7] - 0x30);
  const int hour = (d[8] - 0x30) * 10 + (d[9] - 0x30);
  const int year = is_utc ? (yy >= 50 ? 1900 + yy : 2000 + yy) : yy * 100 + cc;
  ok = ok && digits && month >= 1 && month <= 12 && day >= 1 && day <= 31 &&
       hour <= 23;
  // Days-from-civil with floor division (jnp's //): year 0 in Jan/Feb
  // gives y = -1 on an accepted lane.
  const int y = year - (month <= 2 ? 1 : 0);
  const int era = floor_div(y, 400);
  const int yoe = y - era * 400;
  const int mp = month > 2 ? month - 3 : month + 9;
  const int doy = floor_div(153 * mp + 2, 5) + day - 1;
  const int doe = yoe * 365 + floor_div(yoe, 4) - floor_div(yoe, 100) + doy;
  const int days = era * 146097 + doe - 719468;
  *hour_out = days * 24 + hour;
  return ok;
}

// _scan_issuer_cn: first CN of the issuer Name, one RDN SET (first ATV)
// a round through an 8-word window.
__device__ __forceinline__ void scan_issuer_cn(RowChunks& row, int off,
                                               int end, bool alive,
                                               int* cn_off, int* cn_len) {
  int p = off, cnt = 0;
  *cn_off = 0;
  *cn_len = 0;
  bool active = alive && p < end;
  while (active) {
    const Window win = derwalk::scan_window(row, p, kRdn);
    const int a = win.a;
    const Hdr set = read_header(win, 0, p, end);
    const bool set_ok = set.ok && set.tag == 0x31;
    const int da = set.hlen;
    const Hdr atv = read_header(win, da, p, end);
    const int dro = da + atv.hlen;
    const Hdr oid = read_header(win, dro, p, end);
    const int ro = a + dro + oid.hlen;
    const bool is_cn = set_ok && atv.ok && atv.tag == 0x30 && oid.ok &&
                       oid.tag == 0x06 && oid.clen == 3 &&
                       (win.span8(ro) & 0xFFFFFFu) == 0x030455u;  // 55 04 03
    const int dv = dro + oid.hlen + oid.clen;
    const Hdr val = read_header(win, dv, p, end);
    if (is_cn && val.ok && *cn_len == 0) {
      *cn_off = p + dv + val.hlen;
      *cn_len = val.clen;
    }
    if (set.ok) {
      p += set.hlen + set.clen;
      ++cnt;
    }
    alive = alive && set.ok;
    active = alive && p < end && cnt < kMaxRdns;
  }
}

// _scan_extensions + _ext_round: BasicConstraints CA and the first CRLDP
// window, an 11-word window a round. Returns the lane's ext_ok.
__device__ __forceinline__ bool scan_extensions(RowChunks& row, int off,
                                                int end, bool alive,
                                                bool* is_ca, bool* has_crldp,
                                                int* dp_off, int* dp_len) {
  int p = off, cnt = 0;
  *is_ca = false;
  *has_crldp = false;
  *dp_off = 0;
  *dp_len = 0;
  bool active = alive && p < end;
  while (active) {
    const Window win = derwalk::scan_window(row, p, kExt);
    const int a = win.a;
    const Hdr e = read_header(win, 0, p, end);
    const bool ext_ok = e.ok && e.tag == 0x30;
    const int di = e.hlen;
    const Hdr oid = read_header(win, di, p, end);
    const bool oid_ok = ext_ok && oid.ok && oid.tag == 0x06 && oid.clen == 3;
    const int ro = a + di + oid.hlen;
    const uint64_t o = win.span8(ro) & 0xFFFFFFu;
    const bool is_bc = oid_ok && o == 0x131D55u;  // 55 1D 13
    const bool is_dp = oid_ok && o == 0x1F1D55u;  // 55 1D 1F
    const int dc = di + oid.hlen + oid.clen;
    const Hdr crit = read_header(win, dc, p, end);
    const bool has_crit = crit.ok && crit.tag == 0x01;
    const int dv = has_crit ? dc + crit.hlen + crit.clen : dc;
    // One read for both limits: inside `end` implies inside kNoLimit.
    const Hdr val2 = read_header(win, dv, p, kNoLimit);
    Hdr val = val2;
    val.ok = val2.ok && p + dv + val2.hlen + val2.clen <= end;
    const bool overrun =
        ext_ok && val2.ok && dv + val2.hlen + val2.clen > e.hlen + e.clen;
    const bool val_ok = val.ok && val.tag == 0x04 && !overrun;
    const int db = dv + val.hlen;
    const Hdr bc = read_header(win, db, p, end);
    const bool bc_seq_ok = val_ok && bc.ok && bc.tag == 0x30;
    const int df = db + bc.hlen;
    const Hdr f = read_header(win, df, p, end);
    const bool ca_flag = bc_seq_ok && bc.clen > 0 && f.ok && f.tag == 0x01 &&
                         f.clen == 1 && win[a + df + f.hlen] != 0;
    if (is_bc && ca_flag) *is_ca = true;
    if (is_dp && val_ok && *dp_len == 0) {
      *dp_off = p + dv + val.hlen;
      *dp_len = val.clen;
    }
    if (is_dp && val_ok) *has_crldp = true;
    if (e.ok) {
      p += e.hlen + e.clen;
      ++cnt;
    }
    alive = alive && e.ok && !overrun;
    active = alive && p < end && cnt < kMaxExts;
  }
  return alive && !(p < end);  // a list left unfinished rejects the lane
}

// The walk of one lane: every field and flag to its lane-minor slot,
// the serial window to `ser` (serial_k bytes) and the CN window to `cnw`
// (cn_k bytes), both in shared memory.
__device__ __forceinline__ void walk_lane(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ length,
    long long n, int row_len, long long lane, bool scan_cn, int cn_k,
    int serial_k, int32_t* __restrict__ fields, uint8_t* __restrict__ flags,
    uint8_t* ser, uint8_t* cnw) {
  RowChunks row(data, n, row_len, lane);
  const int nw = (row_len + 3) / 4;
  const int limit = length[lane];
  bool ok = limit > 4;

  // The fixed 17-word window at 0: Certificate, TBS, [0] version,
  // serial and signature AlgorithmIdentifier headers.
  Window win = derwalk::flat_window(row, nw, 0, kFixed);
  Hdr h = read_header(win, 0, 0, limit);
  ok = ok && h.ok && h.tag == 0x30;
  const int d_tbs = h.hlen;
  h = read_header(win, d_tbs, 0, limit);
  ok = ok && h.ok && h.tag == 0x30;
  const int tbs_end = d_tbs + h.hlen + h.clen;
  int d = d_tbs + h.hlen;
  const Hdr v = read_header(win, d, 0, tbs_end);
  const int dser = d + ((v.ok && v.tag == 0xA0) ? v.hlen + v.clen : 0);
  h = read_header(win, dser, 0, tbs_end);
  ok = ok && h.ok && h.tag == 0x02 && win.a + dser + 5 <= kFixed;
  const int serial_off = dser + h.hlen;
  const int serial_len = h.clen;
  const int d_alg = dser + h.hlen + h.clen;
  h = read_header(win, d_alg, 0, tbs_end);
  ok = ok && h.ok && h.tag == 0x30 && win.a + d_alg + 5 <= kFixed;
  int p = d_alg + h.hlen + h.clen;

  // Issuer Name header, its own 3-word window; then the RDN scan.
  h = read_header(derwalk::flat_window(row, nw, p, kHeader), 0, p, tbs_end);
  ok = ok && h.ok && h.tag == 0x30;
  const int issuer_off = p;
  const int issuer_len = h.hlen + h.clen;
  int cn_off = 0, cn_len = 0;
  if (scan_cn) scan_issuer_cn(row, p + h.hlen, p + h.hlen + h.clen, ok, &cn_off, &cn_len);
  p += h.hlen + h.clen;

  // 13-word window: validity { notBefore, notAfter } + subject header.
  win = derwalk::flat_window(row, nw, p, kValidity);
  h = read_header(win, 0, p, tbs_end);
  ok = ok && h.ok && h.tag == 0x30;
  const int dnb = h.hlen;
  const Hdr nb = read_header(win, dnb, p, tbs_end);
  ok = ok && nb.ok;
  int not_after_hour = 0;
  const bool t_ok = parse_time(win, dnb + nb.hlen + nb.clen, p, &not_after_hour);
  ok = ok && t_ok;
  const int d_subj = h.hlen + h.clen;
  const Hdr subj = read_header(win, d_subj, p, tbs_end);
  ok = ok && subj.ok && subj.tag == 0x30 && win.a + d_subj + 5 <= kValidity;
  p += d_subj + subj.hlen + subj.clen;

  // SPKI header, its own 3-word window.
  h = read_header(derwalk::flat_window(row, nw, p, kHeader), 0, p, tbs_end);
  ok = ok && h.ok && h.tag == 0x30;
  const int spki_off = p;
  const int spki_len = h.hlen + h.clen;
  p += h.hlen + h.clen;

  // 13-word window: optional UniqueIDs, [3] and the inner SEQUENCE.
  win = derwalk::flat_window(row, nw, p, kExtHead);
  d = 0;
  for (int r = 0; r < 2; ++r) {
    const Hdr u = read_header(win, d, p, tbs_end);
    if (u.ok && (u.tag == 0x81 || u.tag == 0x82 || u.tag == 0xA1 || u.tag == 0xA2))
      d += u.hlen + u.clen;
  }
  const bool in_win = win.a + d + 11 <= kExtHead;
  const Hdr x = read_header(win, d, p, tbs_end);
  const bool has_ext = x.ok && x.tag == 0xA3 && p + d < tbs_end && in_win;
  // Trailing TBS bytes that are not a well-formed in-window [3] frame
  // send the lane to the exact host lane.
  ok = ok && (has_ext || p + d >= tbs_end);
  const int de = d + x.hlen;
  const Hdr el = read_header(win, de, p, tbs_end);
  const bool ext_listed = has_ext && el.ok && el.tag == 0x30;
  if (has_ext) ok = ok && el.ok && el.tag == 0x30;
  const int ext_off = p + de + el.hlen;
  const int ext_end = ext_listed ? p + de + el.hlen + el.clen : 0;
  bool is_ca, has_crldp;
  int dp_off, dp_len;
  const bool ext_ok = scan_extensions(row, ext_off, ext_end, ok, &is_ca,
                                      &has_crldp, &dp_off, &dp_len);
  ok = ok && ext_ok;

  const int s_off = ok ? serial_off : 0;
  const int s_len = ok ? serial_len : 0;
  fields[kSerialOff * n + lane] = s_off;
  fields[kSerialLen * n + lane] = s_len;
  fields[kNotAfterHour * n + lane] = ok ? not_after_hour : 0;
  fields[kCnOff * n + lane] = cn_off;  // not masked, as in the JAX walker
  fields[kCnLen * n + lane] = ok ? cn_len : 0;
  fields[kIssuerOff * n + lane] = ok ? issuer_off : 0;
  fields[kIssuerLen * n + lane] = ok ? issuer_len : 0;
  fields[kSpkiOff * n + lane] = ok ? spki_off : 0;
  fields[kSpkiLen * n + lane] = ok ? spki_len : 0;
  fields[kCrldpOff * n + lane] = ok ? dp_off : 0;
  fields[kCrldpLen * n + lane] = ok ? dp_len : 0;
  flags[kOk * n + lane] = ok;
  flags[kIsCa * n + lane] = ok && is_ca;
  flags[kHasCrldp * n + lane] = ok && has_crldp;
  flags[kFits * n + lane] = s_len <= serial_k;

  // gather_serials_rows: serial_k bytes through the flat window of
  // (6 + k)/4 + 1 words at the (masked) serial offset, zero past s_len.
  const Window sw = derwalk::flat_window(row, nw, s_off, ((6 + serial_k) / 4 + 1) * 4);
  for (int j = 0; j < serial_k; j += 8) {
    const uint64_t v = derwalk::keep_bytes(sw.span8(sw.a + j), s_len - j);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (j + i < serial_k) ser[j + i] = static_cast<uint8_t>(v >> (8 * i));
  }
  // window_bytes_rows at the CN offset (masked later by cn_len).
  if (cn_k > 0) {
    const Window cw = derwalk::flat_window(row, nw, cn_off, ((6 + cn_k) / 4 + 1) * 4);
    for (int j = 0; j < cn_k; j += 8) {
      const uint64_t v = cw.span8(cw.a + j);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (j + i < cn_k) cnw[j + i] = static_cast<uint8_t>(v >> (8 * i));
    }
  }
}

// `bytes` bytes from shared `src` to global `dst` (both 16-byte aligned)
// by the whole block: 16-byte stores, then the ragged tail.
__device__ __forceinline__ void store_span(const uint8_t* src,
                                           uint8_t* __restrict__ dst,
                                           int bytes) {
  const int full = bytes >> 4;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < full; i += kThreads) d4[i] = s4[i];
  for (int i = (full << 4) + threadIdx.x; i < bytes; i += kThreads)
    dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
der_walk_kernel(const uint8_t* __restrict__ data,
                const int32_t* __restrict__ length, long long n, int row_len,
                bool scan_cn, int cn_k, int serial_k,
                int32_t* __restrict__ fields, uint8_t* __restrict__ flags,
                uint8_t* __restrict__ serials, uint8_t* __restrict__ cn) {
  // kThreads x serial_k serial bytes, then kThreads x cn_k CN bytes.
  extern __shared__ uint4 stage[];
  uint8_t* const ser_stage = reinterpret_cast<uint8_t*>(stage);
  uint8_t* const cn_stage = ser_stage + kThreads * serial_k;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const long long lane = first + threadIdx.x;
  if (lane < n)
    walk_lane(data, length, n, row_len, lane, scan_cn, cn_k, serial_k,
              fields, flags, ser_stage + threadIdx.x * serial_k,
              cn_stage + threadIdx.x * cn_k);
  __syncthreads();
  const int lanes = static_cast<int>(n - first < kThreads ? n - first : kThreads);
  store_span(ser_stage, serials + first * serial_k, lanes * serial_k);
  if (cn_k > 0) store_span(cn_stage, cn + first * cn_k, lanes * cn_k);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` of
// device `device`, does not synchronise, and returns cudaGetLastError()
// of the launch (0 = launched), or cudaErrorInvalidValue for widths the
// staging buffer is not sized for or outputs not 16-byte aligned.
extern "C" int ctmr_der_walk(const void* data, const void* length, long long n,
                             int row_len, int scan_cn, int cn_k, int serial_k,
                             void* fields, void* flags, void* serials, void* cn,
                             int device, void* stream) {
  if (row_len < 1 || serial_k < 1 || serial_k > kMaxSerial || cn_k < 0 ||
      cn_k > kMaxCn || reinterpret_cast<uintptr_t>(serials) % 16 != 0 ||
      (cn_k > 0 && reinterpret_cast<uintptr_t>(cn) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const size_t shared = static_cast<size_t>(kThreads) * (serial_k + cn_k);
  der_walk_kernel<<<static_cast<unsigned int>(blocks), kThreads, shared,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(length),
      n, row_len, scan_cn != 0, cn_k, serial_k, static_cast<int32_t*>(fields),
      static_cast<uint8_t*>(flags), static_cast<uint8_t*>(serials),
      static_cast<uint8_t*>(cn));
  return static_cast<int>(cudaGetLastError());
}
