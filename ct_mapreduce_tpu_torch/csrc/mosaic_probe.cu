// The probe ladder of tools/mosaic_probe.py as ten CUDA kernels.
//
// Replaces the Pallas stage kernels that tools/mosaic_probe.py::run_stage
// and time_stage9 launch (k_elementwise ... k_serial_extract). On the TPU
// the ladder bisected the Mosaic lowering of a Pallas DER walker, each
// stage adding one construct. Here each stage adds one construct on the
// way to the walker kernel K3 (der_walk.cu), and the stages' byte reads
// and headers are built from K3's own device functions in der_walk.cuh:
// the byte read of a source (LaneWords) and the long-form length decode
// (long_form_len).
//
// Layout, as in the original: words[64, lanes] big-endian uint32 (int32
// bits) with lanes on the minor axis, so a warp reading word k of its
// 32 lanes reads 128 consecutive bytes; out int32[1, lanes].
//
// What bounds them on an H100: bytes, counted in the 32-byte sectors a
// lane's reads touch (a data-dependent read of word k costs a sector
// that only its 7 neighbouring lanes can share), and for the shortest
// stages the launch itself (see k_word_stage). Stages 0, 4 and 5 read
// every word of a lane (256 B) once, coalesced across the warp; stages 1
// and 7 one word of a lane, four lanes a thread; stages 2 and 6 one word
// per byte read from global memory. Stage 8
// stages whole rows in shared memory and walks them there (see
// k_tlv_walk), stages 3 and 9 a window of each row (see k_fori_reads,
// k_serial_extract).

#include <cuda_runtime.h>
#include <stdint.h>

#include "der_walk.cuh"

namespace {

using derwalk::LaneWords;

constexpr int kWords = 64;
constexpr int kRowBytes = kWords * 4;
constexpr int kWrap = kRowBytes - 4;  // offsets wrap modulo 252
constexpr int kThreads = 128;

// _read_vec(w, off, clip=True): the offset clamped into the row.
struct Clipped {
  LaneWords src;
  __device__ __forceinline__ int operator()(int q) const {
    return src(q < 0 ? 0 : (q >= kRowBytes ? kRowBytes - 1 : q));
  }
};

struct ProbeTlv {
  int tag, hdr, content;
};

// The probe's TLV header from its four bytes, the tag in the top 8
// bits: long form reads one length octet when the count is 1 and two
// otherwise (K3 reads up to three).
__device__ __forceinline__ ProbeTlv tlv_of(uint32_t v) {
  const int l0 = static_cast<int>((v >> 16) & 0xFFu);
  const int l1 = static_cast<int>((v >> 8) & 0xFFu);
  const int l2 = static_cast<int>(v & 0xFFu);
  const bool long_form = l0 >= 0x80;
  const int nlen = long_form ? (l0 & 0x7F) : 0;
  ProbeTlv t;
  t.tag = static_cast<int>(v >> 24);
  t.content = long_form ? derwalk::long_form_len(nlen == 1 ? 1 : 2, l1, l2, 0) : l0;
  t.hdr = 2 + nlen;
  return t;
}

__device__ __forceinline__ long long lane_id() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

#define PROBE_KERNEL(name)                                                   \
  __global__ void __launch_bounds__(kThreads)                                \
      name(const uint32_t* __restrict__ w, long long lanes,                  \
           int32_t* __restrict__ out)

// Stage 0: elementwise + sum over the lane's words of (word & 0xFF).
PROBE_KERNEL(k_elementwise) {
  const long long lane = lane_id();
  if (lane >= lanes) return;
  int acc = 0;
  for (int k = 0; k < kWords; ++k) acc += static_cast<int>(__ldg(w + k * lanes + lane) & 0xFFu);
  out[lane] = acc;
}

// Stages 1 and 7: one word of a lane in (word 4, word 0), one int32 out.
//
// A lane reads 4 B and writes 4 B, 8 MiB at 2^20 lanes: 2.5 us at 3.35
// TB/s. At one lane a thread in blocks of 128 (the stages' first design,
// 8,192 blocks at 2^20 lanes) the time was the grid's: on an H100 an
// empty kernel of 8,192 blocks of 128 takes nearly as long, launched
// back to back, as those stages did (0.0067 ms against 0.0070), one of
// 1,024 blocks of 256 0.0024 ms and one block 0.0019 (floor (a) of
// tools/kernel_times.py). So a thread takes kWordLanes consecutive
// lanes with one 16-byte load and one 16-byte store, in blocks of
// kWordThreads: 1,024 blocks at 2^20 lanes, fewer than the card holds
// at once. Word k of lanes 4t..4t+3 is the 16 bytes at w + k * lanes +
// 4t, 16-byte aligned for any lanes when w is and k is a multiple of 4
// (words 0 and 4). Where w or out is not 16-byte aligned (a view into a
// buffer), the launch takes the kernel built without the 16-byte path
// (kAligned false); there, and for the last lanes % 4 lanes, a thread
// loads its lanes one 4-byte word at a time, every load before its
// first store. On an H100, blocks of 256 were 3-11% faster than blocks
// of 128 and within 3% of blocks of 512 or 1,024; the alignment chosen
// at the launch 2-6% faster than tested in the kernel; eight lanes a
// thread (two 16-byte loads), four lanes 128 apart with 4-byte loads,
// and loads that allocate no L1 line with streaming stores no faster.
constexpr int kWordLanes = 4;
constexpr int kWordThreads = 256;

// Stage 1: one byte read at a fixed offset, byte 17 (bits 16-23 of word
// 4).
struct OnehotFixed {
  static constexpr int kWord = 4;
  __device__ __forceinline__ int operator()(uint32_t v) const {
    return static_cast<int>((v >> 16) & 0xFFu);
  }
};

template <class F, bool kAligned>
__global__ void __launch_bounds__(kWordThreads)
    k_word_stage(const uint32_t* __restrict__ w, long long lanes, int32_t* __restrict__ out) {
  static_assert(F::kWord % 4 == 0, "word k of four lanes is 16-byte aligned only for k % 4 == 0");
  const long long first =
      (static_cast<long long>(blockIdx.x) * kWordThreads + threadIdx.x) * kWordLanes;
  if (first >= lanes) return;
  const uint32_t* src = w + F::kWord * lanes + first;
  int32_t* dst = out + first;
  const F f;
  if (kAligned && first + kWordLanes <= lanes) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    *reinterpret_cast<int4*>(dst) = make_int4(f(v.x), f(v.y), f(v.z), f(v.w));
    return;
  }
  const long long left = lanes - first;
  uint32_t v[kWordLanes];
#pragma unroll
  for (int j = 0; j < kWordLanes; ++j) v[j] = j < left ? __ldg(src + j) : 0u;
#pragma unroll
  for (int j = 0; j < kWordLanes; ++j)
    if (j < left) dst[j] = f(v[j]);
}

// A 4-byte load of read-only data that allocates no line in L1
// (ld.global.nc.L1::no_allocate): for words that no other read of the
// thread's block takes again.
__device__ __forceinline__ uint32_t ldg_no_allocate(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Stage 2: one byte read at a data-dependent offset, q = (byte 0) % 252.
//
// Two dependent loads a lane: word 0 (coalesced), then word q / 4, a
// scattered sector that only the lane's 7 neighbours could share. The
// L2 fetches 64 B from device memory at a time (the card's
// cudaLimitMaxL2FetchGranularity), so each scattered read moves about
// twice its sector, and the stage's time less that of its coalesced
// part is about what 64 B a lane take at the streaming rate of stage 0:
// the stage is near the card's floor for a scattered read. What is left
// to save, 11% together on an H100: the scattered read allocates no L1
// line (no other lane reads it), and a lane whose q falls in word 0
// (byte 0 of 0-3 or 252-255) takes its byte from the word it holds and
// makes no second load. Two or four lanes a thread, every scattered read
// of a thread in flight at once, were 4-9% slower. q lies in 0..251, in
// the row, so no read is clipped.
PROBE_KERNEL(k_onehot_dyn) {
  const long long lane = lane_id();
  if (lane >= lanes) return;
  const uint32_t w0 = __ldg(w + lane);
  const int q = static_cast<int>(w0 >> 24) % kWrap;
  const uint32_t word = q < 4 ? w0 : ldg_no_allocate(w + (q >> 2) * lanes + lane);
  out[lane] = static_cast<int>((word >> ((3 - (q & 3)) * 8)) & 0xFFu);
}

// Stage 3: 16 reads in a loop with a carried offset,
// off = (off + 1 + (byte & 3)) % 252.
//
// Each offset waits on the last byte, so reading from global memory (the
// stage's first design) made a chain of 16 dependent loads a lane. But
// the walk's reach is bounded: it starts at 0 and a step moves 1 to 4
// bytes, so read i (0..15) lies at offset <= 4i <= 60, in words 0..15,
// and the modulo never wraps. The last read lies at the sum of 15 steps;
// on random rows, each step is uniform in 1..4 and reaches word 12 or
// past with probability 0.97% (word 11: 8.3%, word 13: 0.04%;
// mosaic_probe.fori_reach_share). So a lane loads its first
// kForiWindowWords words at once, independent coalesced loads, stages
// them in a shared-memory column (word k at col[k * kThreads]: a warp's
// lanes are 32 banks apart whatever word each reads, no conflicts) and
// walks there, a read one shared load, a shift and a mask. A read past
// the window goes to the row in global memory (LaneWords), so any row
// gives the plain version's result. Each thread writes and reads only its
// own column, so no barrier is needed; lanes past the last are neither
// loaded nor stored. On an H100, 12 words were 21% faster than 16 (which
// no walk leaves), loads that allocate no L1 line 5% faster than __ldg,
// and copies with cp.async or two lanes a thread slower.
constexpr int kForiReads = 16;
constexpr int kForiWindowWords = 12;

PROBE_KERNEL(k_fori_reads) {
  __shared__ uint32_t window[kForiWindowWords * kThreads];
  const long long lane = lane_id();
  if (lane >= lanes) return;
  uint32_t* col = window + threadIdx.x;
  uint32_t v[kForiWindowWords];
#pragma unroll
  for (int k = 0; k < kForiWindowWords; ++k) v[k] = ldg_no_allocate(w + k * lanes + lane);
#pragma unroll
  for (int k = 0; k < kForiWindowWords; ++k) col[k * kThreads] = v[k];
  const LaneWords src{w + lane, lanes, kRowBytes};
  int off = 0, acc = 0;
#pragma unroll
  for (int i = 0; i < kForiReads; ++i) {
    const int k = off >> 2;
    const int byte =
        k < kForiWindowWords
            ? static_cast<int>((col[k * kThreads] >> ((3 - (off & 3)) * 8)) & 0xFFu)
            : src(off);
    off = (off + 1 + (byte & 3)) % kWrap;
    acc += byte;
  }
  out[lane] = acc;
}

// Stage 4: the original's masked reduction inside a loop of
// kMaskedTrips trips, trip i summing (w & 0xFF) over the words whose
// (w >> 8) % 3 is i % 3. A word of residue m is summed once for each
// trip i with i % 3 == m, so one pass over the row, each low byte
// weighed by that count, gives the same sum with the row read once and
// not kMaskedTrips times (stage 5's traffic). At most 64 x 255 x 3 =
// 48,960: the int32 sum cannot overflow.
constexpr int kMaskedTrips = 8;
__host__ __device__ constexpr int trips_with_residue(int m) {
  return (kMaskedTrips + 2 - m) / 3;
}

// x % 3 for every uint32 x: the quotient by a multiply-high with
// ceil(2^33 / 3), exact over the whole range.
__device__ __forceinline__ uint32_t mod3(uint32_t x) {
  return x - 3u * (__umulhi(x, 0xAAAAAAABu) >> 1);
}

PROBE_KERNEL(k_fori_masked) {
  const long long lane = lane_id();
  if (lane >= lanes) return;
  constexpr int kW0 = trips_with_residue(0), kW1 = trips_with_residue(1),
                kW2 = trips_with_residue(2);
  int acc = 0;
  for (int k = 0; k < kWords; ++k) {
    const uint32_t word = __ldg(w + k * lanes + lane);
    const uint32_t m = mod3(word >> 8);
    acc += static_cast<int>(word & 0xFFu) * (m == 0u ? kW0 : (m == 1u ? kW1 : kW2));
  }
  out[lane] = acc;
}

// Stage 5: the uint32 reduction (a TPU workaround; the same sum here).
PROBE_KERNEL(k_uint_reduce) {
  const long long lane = lane_id();
  if (lane >= lanes) return;
  uint32_t acc = 0;
  for (int k = 0; k < kWords; ++k) acc += __ldg(w + k * lanes + lane) & 0xFFu;
  out[lane] = static_cast<int32_t>(acc);
}

// Stage 6: a loop that ends early, at the first zero byte or 32 rounds.
PROBE_KERNEL(k_while_early_exit) {
  const long long lane = lane_id();
  if (lane >= lanes) return;
  const LaneWords src{w + lane, lanes, kRowBytes};
  int off = 0;
  for (int n = 0; n < 32; ++n) {
    if (src(off) == 0) break;
    off = (off + 1) % kWrap;
  }
  out[lane] = off;
}

// Stage 7: one TLV header decode at offset 0, from word 0 in one load;
// the header's end clipped into the row.
struct TlvStep {
  static constexpr int kWord = 0;
  __device__ __forceinline__ int operator()(uint32_t v) const {
    const ProbeTlv t = tlv_of(v);
    const int end = t.hdr + t.content;
    return end < 0 ? 0 : (end > kRowBytes - 1 ? kRowBytes - 1 : end);
  }
};

// Stage 8: a chained walk of 12 headers, descending into constructed
// tags and skipping primitives.
//
// Each header's offset waits on the last header's bytes, and the random
// rows of the ladder send the walk all over the row: read from global
// memory (the stage's first design), a lane's walk was a chain of 48
// dependent byte loads touching ~7 of the row's 8 sectors of 32 B. Here
// a block stages a tile of kThreads lanes' whole rows (64 x 128 words,
// 32 KiB) in shared memory, read once and coalesced, and walks it
// there: tile[k * kThreads + t] holds word k of the tile's lane t, so
// thread t reads bank t % 32 whatever word its walk needs (no
// conflicts). A header is then one 4-byte read, two shared loads and a
// funnel shift. Each thread copies and reads only its own lane's
// column, so no barrier is needed: cp.async.wait_all orders a thread's
// own copies before its reads.
//
// Each thread copies its column with cp.async (no registers held for the
// 64 loads), waits and walks; with 32 KiB a block, up to 6 blocks are
// resident on an SM and fill each other's waits. The kernel reads the whole row, 256 B a
// lane, at about stage 0's rate. Lanes past the last are neither copied
// nor stored, so any width is covered.
constexpr int kTileWords = kWords * kThreads;

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Waits until every cp.async of this thread has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A lane's row as a column of a staged tile: word k at col[k * kThreads].
// Reads are clipped into the row as Clipped does. The walk's offsets stay
// in 0..kWrap-1, so a header's bytes off..off+3 lie in the row and the
// clip never changes a read; it is kept so that any offset reads as the
// plain version's does.
struct TileColumn {
  const uint32_t* col;

  __device__ __forceinline__ uint32_t byte(int q) const {
    const int c = q < 0 ? 0 : (q >= kRowBytes ? kRowBytes - 1 : q);
    return (col[(c >> 2) * kThreads] >> ((3 - (c & 3)) * 8)) & 0xFFu;
  }

  // Bytes q..q+3, byte q in the top 8 bits.
  __device__ __forceinline__ uint32_t bytes4(int q) const {
    if (q >= 0 && q <= kRowBytes - 4) {
      const int k = q >> 2;
      const uint32_t hi = col[k * kThreads];
      const uint32_t lo = col[(k + 1 < kWords ? k + 1 : k) * kThreads];
      return __funnelshift_l(lo, hi, (q & 3) * 8);
    }
    return (byte(q) << 24) | (byte(q + 1) << 16) | (byte(q + 2) << 8) | byte(q + 3);
  }
};

__device__ __forceinline__ int tlv_walk(const TileColumn& row) {
  int off = 0, acc = 0;
#pragma unroll 4
  for (int i = 0; i < 12; ++i) {
    const ProbeTlv t = tlv_of(row.bytes4(off));
    const bool constructed = (t.tag & 0x20) != 0;
    off = (constructed ? off + t.hdr : off + t.hdr + t.content) % kWrap;
    acc += t.tag;
  }
  return off + acc;
}

PROBE_KERNEL(k_tlv_walk) {
  __shared__ uint32_t tile[kTileWords];
  const long long lane = lane_id();
  if (lane >= lanes) return;
  uint32_t* col = tile + threadIdx.x;
#pragma unroll 16
  for (int k = 0; k < kWords; ++k) cp_async4(col + k * kThreads, w + k * lanes + lane);
  cp_async_wait_all();
  out[lane] = tlv_walk(TileColumn{col});
}

// Stage 9: the walker fragment on real certificates: Certificate → TBS
// → optional [0] version → serial, then the serial's byte sum plus
// 1000 x its length (0 unless the serial tag is INTEGER).
//
// Its four headers depend on each other, so reading each byte from
// global memory made a chain of dependent load rounds (the stage's
// first design, ~40 loads a lane). Here a lane loads its first
// kWindowWords words at once, independent coalesced loads, and stages
// them in shared memory, one column a thread (conflict-free: a warp's
// lanes are 32 banks apart whatever word each reads). A header is then
// two shared loads and a funnel shift, the serial's sum one shared load
// and one __vsadu4 a word. Only a byte past the window goes to global
// memory, with the same clipping, so every row gives the plain version's
// result. Nine words (36 bytes) hold the headers and a 21-byte serial of
// every certificate of the ladder's corpus (its footprint's last word is
// word 8).
constexpr int kWindowWords = 9;
constexpr int kSerialLanes = 2;

struct SerialWindow {
  const uint32_t* col;  // this lane's column: word k at col[k * kThreads]
  Clipped row;          // the lane's row in global memory

  __device__ __forceinline__ uint32_t word(int k) const {
    return k < kWindowWords ? col[k * kThreads]
                            : __ldg(row.src.w + static_cast<long long>(k) * row.src.stride);
  }

  // Bytes q..q+3, byte q in the top 8 bits, each read clipped into the
  // row as Clipped does.
  __device__ __forceinline__ uint32_t bytes4(int q) const {
    if (q >= 0 && q + 3 < 4 * kWindowWords) {
      const int k = q >> 2;
      const uint32_t hi = col[k * kThreads];
      const uint32_t lo = col[(k + 1 < kWindowWords ? k + 1 : k) * kThreads];
      return __funnelshift_l(lo, hi, (q & 3) * 8);
    }
    return (static_cast<uint32_t>(row(q)) << 24) |
           (static_cast<uint32_t>(row(q + 1)) << 16) |
           (static_cast<uint32_t>(row(q + 2)) << 8) |
           static_cast<uint32_t>(row(q + 3));
  }

  // The header at off from one 4-byte read.
  __device__ __forceinline__ ProbeTlv tlv(int off) const { return tlv_of(bytes4(off)); }

  // Sum of row bytes lo..hi-1 (0 <= lo, hi <= kRowBytes).
  __device__ __forceinline__ int byte_sum(int lo, int hi) const {
    int total = 0;
    for (int k = lo >> 2; 4 * k < hi; ++k) {
      const int a = lo - 4 * k, b = hi - 4 * k;  // keep bytes a..b-1
      const uint32_t keep =
          __funnelshift_rc(0xFFFFFFFFu, 0u, a > 0 ? 8 * a : 0) &
          ~__funnelshift_rc(0xFFFFFFFFu, 0u, b < 4 ? 8 * b : 32);
      total += static_cast<int>(__vsadu4(word(k) & keep, 0u));
    }
    return total;
  }
};

__device__ __forceinline__ int serial_checksum(const SerialWindow& win) {
  const ProbeTlv t0 = win.tlv(0);
  const int tbs_off = t0.hdr;
  const ProbeTlv t1 = win.tlv(tbs_off);
  const int el = tbs_off + t1.hdr;
  const ProbeTlv te = win.tlv(el);
  const int ser_el = te.tag == 0xA0 ? el + te.hdr + te.content : el;
  const ProbeTlv ts = win.tlv(ser_el);
  const int ser_off = ser_el + ts.hdr;
  const int lo = ser_off < 0 ? 0 : ser_off;
  const int hi = ser_off + ts.content > kRowBytes ? kRowBytes : ser_off + ts.content;
  const int total = lo < hi ? win.byte_sum(lo, hi) : 0;
  return ts.tag == 0x02 ? total + ts.content * 1000 : 0;
}

// kSerialLanes lanes a thread (lanes kThreads apart, so a warp's loads
// stay coalesced): every window load of both is issued before the first
// decode, which halves the rounds of load latency a block waits out.
PROBE_KERNEL(k_serial_extract) {
  __shared__ uint32_t window[kSerialLanes * kWindowWords * kThreads];
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads * kSerialLanes + threadIdx.x;
  uint32_t v[kSerialLanes][kWindowWords];
#pragma unroll
  for (int j = 0; j < kSerialLanes; ++j) {
    const long long lane = first + j * kThreads;
#pragma unroll
    for (int k = 0; k < kWindowWords; ++k)
      v[j][k] = lane < lanes ? __ldg(w + k * lanes + lane) : 0u;
  }
#pragma unroll
  for (int j = 0; j < kSerialLanes; ++j)
#pragma unroll
    for (int k = 0; k < kWindowWords; ++k)
      window[(j * kWindowWords + k) * kThreads + threadIdx.x] = v[j][k];
#pragma unroll
  for (int j = 0; j < kSerialLanes; ++j) {
    const long long lane = first + j * kThreads;
    if (lane < lanes)
      out[lane] = serial_checksum(SerialWindow{
          window + j * kWindowWords * kThreads + threadIdx.x,
          Clipped{LaneWords{w + lane, lanes, kRowBytes}}});
  }
}

using ProbeFn = void (*)(const uint32_t*, long long, int32_t*);
const ProbeFn kStages[] = {
    k_elementwise, k_word_stage<OnehotFixed, true>, k_onehot_dyn, k_fori_reads,
    k_fori_masked, k_uint_reduce,                   k_while_early_exit,
    k_word_stage<TlvStep, true>, k_tlv_walk,        k_serial_extract,
};
constexpr int kNumStages = sizeof(kStages) / sizeof(kStages[0]);
// What a stage launches instead where words or out is not 16-byte
// aligned (nullptr: the same kernel).
const ProbeFn kUnalignedStages[kNumStages] = {
    nullptr, k_word_stage<OnehotFixed, false>, nullptr, nullptr, nullptr,
    nullptr, nullptr, k_word_stage<TlvStep, false>, nullptr, nullptr};
// Threads a block of each stage, and lanes a block covers.
constexpr int kStageThreads[kNumStages] = {
    kThreads, kWordThreads, kThreads, kThreads, kThreads,
    kThreads, kThreads,     kWordThreads, kThreads, kThreads};
constexpr int kWordBlockLanes = kWordThreads * kWordLanes;
constexpr int kStageLanes[kNumStages] = {
    kThreads, kWordBlockLanes, kThreads, kThreads, kThreads,
    kThreads, kThreads,        kWordBlockLanes, kThreads, kThreads * kSerialLanes};

// Reads and stores nothing: a launch's fixed cost.
__global__ void k_empty() {}

}  // namespace

// Plain C entry point (loaded with ctypes): launch stage `stage` over
// words[64, lanes] on `stream` of `device`; does not synchronise;
// returns cudaGetLastError() of the launch (0 = launched), or -1 for an
// unknown stage.
extern "C" int ctmr_probe_stage(int stage, const void* words, long long lanes,
                                void* out, int device, void* stream) {
  if (stage < 0 || stage >= kNumStages) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lanes <= 0) return 0;
  const long long blocks = (lanes + kStageLanes[stage] - 1) / kStageLanes[stage];
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(words) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const ProbeFn fn = aligned || !kUnalignedStages[stage] ? kStages[stage] : kUnalignedStages[stage];
  fn<<<static_cast<unsigned int>(blocks), kStageThreads[stage], 0,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), lanes, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The device's cudaLimitMaxL2FetchGranularity in bytes (the L2's fetch
// size from device memory), for the record beside stage 2's scattered
// reads; read only: the limit is the whole process's. Returns the
// cudaError_t of the query.
extern "C" int ctmr_probe_l2_fetch_granularity(int device, long long* bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t v = 0;
  err = cudaDeviceGetLimit(&v, cudaLimitMaxL2FetchGranularity);
  *bytes = static_cast<long long>(v);
  return static_cast<int>(err);
}

// An empty kernel of `blocks` blocks of `threads` threads on `stream` of
// `device`: the fixed cost of a launch of that grid, the floor under a
// short stage's time. Does not synchronise; returns cudaGetLastError()
// of the launch.
extern "C" int ctmr_probe_empty(long long blocks, int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  k_empty<<<static_cast<unsigned int>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
