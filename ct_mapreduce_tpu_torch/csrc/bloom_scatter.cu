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
// What bounds it on an H100: the scatter. The function reads 20 B a
// key and reads and writes the arena once; its arithmetic is a few
// integer operations a probe. Its first design (one thread a lane, one
// global atomicOr a probe) ran at ~78 G atomics/s, slower than if every
// probe were a 32-B read-modify-write out of HBM: the L2's atomic units
// on scattered words set its pace, and each probe paid a 32-bit division
// by a run-time m.
//
// The design: a region-binned scatter. The arena is cut into regions of
// 2^R bits (R >= 18: 32 KB of shared memory; larger only past 2^29-bit
// arenas, so that there are at most kMaxRegions). One cooperative launch
// of resident blocks runs five phases, a grid barrier where a phase
// needs every block's work before it:
//   0 prep   zero the region counts; one reciprocal of m a group; each
//            group's k checked against kmax.
//   1 count  each lane's probes (the modulo is a multiply-high by the
//            group's reciprocal and one correction step) counted by
//            region in the block's histogram, over every tile of lanes
//            the block takes (a lane whose group lies in one region adds
//            its k at once); one global atomicAdd a (block, touched
//            region) at the end, which also places the block's probes in
//            that region's list.
//   2 scan   every block alike, no barrier: the counts scanned into the
//            regions' list starts and work items (runs of at most kChunk
//            probes of a list; an item finds its region by a search).
//   3 bin    the probes again, a tile at a time (the block's tiles of
//            phase 1); the tile sorts its probes by region in shared
//            memory and writes them out as runs at the block's cursors:
//            each probe's bit offset inside its region.
//   4 own    a work item at a time: the region's words into shared
//            memory (the arena may be non-zero on entry: the fused build
//            ORs several dispatches into one arena), the item's probes
//            ORed there with shared-memory atomics, the words stored back
//            with coalesced plain stores. Where a region's list is long
//            enough for several items, each starts from zero and ORs its
//            non-zero words into the arena with one global atomicOr a
//            word. A region no probe hits is neither read nor written.
// Every region word has one owner, or is ORed whole, and OR commutes:
// the words are bit-exact, not merely close. A block loads the keys and
// groups of the tiles after the one it works on, and a batch of probes at
// once when owning, so that load latency stays hidden.
//
// Scratch (from the wrapper, torch's caching allocator): the region
// counts, the group reciprocals and the probe lists (n * kmax * 4 bytes,
// most of it; ops/bloom.py's scratch_bytes). An arena may reach 2^31 - 1
// bits (bit indices are 32-bit, word offsets of a region 64-bit). Probes
// i >= k write nothing. kmax, the caller's bound on ks, sizes the probe
// lists: a group whose k passes it traps the launch before any list or
// arena word is written, rather than lose its probes.
// Any gid order is taken: past kLaneThreads regions, a tile's region
// range is what its own lanes reach.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kGold = 0x9E3779B9u;  // filter/cascade.py _GOLD
constexpr uint32_t kMix = 0x85EBCA6Bu;   // filter/cascade.py _MIX
constexpr int kMinRegionBits = 18;
constexpr int kMaxRegions = 2048;
constexpr int kChunk = 16384;  // probes a work item at most
constexpr int kLaneThreads = 256;  // a block's threads: a tile of lanes
constexpr int kBlocksPerSm = 4;
constexpr int kOwnBatch = 8;  // probes a thread loads at once when owning
constexpr unsigned kFull = 0xFFFFFFFFu;

// The scratch buffer's parts, in this order, each 16-byte aligned.
struct Layout {
  long long counts, minv, probes, bytes;
};

__host__ __device__ inline long long align16(long long x) {
  return (x + 15) & ~15ll;
}

__host__ inline int region_bits(long long n_words) {
  const long long bits = n_words * 32;
  int r = kMinRegionBits;
  while (((bits + (1ll << r) - 1) >> r) > kMaxRegions) ++r;
  return r;
}

__host__ inline int num_regions(long long n_words, int r) {
  const long long n = (n_words * 32 + (1ll << r) - 1) >> r;
  return n < 1 ? 1 : static_cast<int>(n);
}

__host__ inline Layout layout(long long n, int kmax, long long n_words,
                              int n_groups) {
  const int regions = num_regions(n_words, region_bits(n_words));
  Layout l;
  l.counts = 0;
  l.minv = align16(l.counts + 4ll * regions);
  l.probes = align16(l.minv + 4ll * n_groups);
  l.bytes = align16(l.probes + 4ll * n * kmax);
  return l;
}

// What every phase reads: the inputs, the schedule and the scratch parts.
// Scratch written in one phase and read in a later one is read with
// __ldcg (through L2, never a stale L1 line).
struct Args {
  const uint4* keys;
  const int32_t* gid;
  const long long* offs;
  const int32_t* ms;
  const int32_t* ks;
  uint32_t* words;
  uint32_t* counts;
  uint32_t* minv;
  uint32_t* probes;
  long long n, n_words;
  uint32_t layer;
  int kmax, n_groups, rbits, regions, phases;
};

// One lane's probes: a, b, the group's m and its reciprocal, k and the
// group's bit offset. A bit index of an arena of at most 2^31 - 1 bits
// fits 32 bits, so the offset and the targets are 32-bit.
struct Lane {
  uint32_t a, b, m, minv;
  int k;
  uint32_t off;

  // (a + i * b) mod m by a multiply-high: minv = floor((2^32 - 1) / m)
  // leaves the quotient at most one short, so one correction suffices.
  __device__ __forceinline__ uint32_t target(int i) const {
    const uint32_t x = a + static_cast<uint32_t>(i) * b;
    const uint32_t q = __umulhi(x, minv);
    uint32_t r = x - q * m;
    if (r >= m) r -= m;
    return off + r;
  }
};

// A lane's key and group id, and its group's vectors.
struct Raw {
  uint4 key;
  int32_t g;
  bool live;
};

struct Group {
  uint32_t m, minv, off;
  int k;
};

__device__ __forceinline__ Raw load_raw(const Args& a, long long lane) {
  Raw r{make_uint4(0u, 0u, 0u, 0u), 0, lane < a.n};
  if (r.live) {
    r.key = a.keys[lane];
    r.g = a.gid[lane];
  }
  return r;
}

__device__ __forceinline__ Group load_group(const Args& a, const Raw& r) {
  Group g{1u, 0u, 0u, 0};
  if (!r.live) return g;
  g.m = static_cast<uint32_t>(__ldg(a.ms + r.g));
  g.minv = __ldcg(a.minv + r.g);
  g.k = __ldg(a.ks + r.g);
  g.off = static_cast<uint32_t>(__ldg(a.offs + r.g));
  return g;
}

// work(lane) for each of the block's lanes, a tile of kLaneThreads at a
// time (tiles blockIdx.x, + gridDim.x, ...). Keys and group ids are
// loaded two tiles ahead and the group vectors one tile ahead, so that
// their latency hides behind the tile being worked on.
template <class Work>
__device__ __forceinline__ void for_each_tile(const Args& a, Work work) {
  const long long tiles = (a.n + kLaneThreads - 1) / kLaneThreads;
  const long long step = gridDim.x;
  long long tile = blockIdx.x;
  Raw cur = load_raw(a, tile * kLaneThreads + threadIdx.x);
  Raw next = load_raw(a, (tile + step) * kLaneThreads + threadIdx.x);
  Group g = load_group(a, cur);
  for (; tile < tiles; tile += step) {
    Lane l{(cur.key.x ^ (a.layer * kGold)) + cur.key.z,
           ((cur.key.y ^ (a.layer * kMix)) + cur.key.w) | 1u, g.m, g.minv,
           g.k, g.off};
    cur = next;
    next = load_raw(a, (tile + 2 * step) * kLaneThreads + threadIdx.x);
    g = load_group(a, cur);
    work(l);
  }
}

// The block's shared memory: two tables of a.regions + 1 entries that
// live from the scan to the end, three of a.regions entries and the
// staging for the bin phase (dynamic), a tile's range and the scan's warp
// sums (static).
struct Shared {
  uint32_t* start;   // each region's list start; the total at [regions]
  uint32_t* item;    // each region's first work item; the count at [regions]
  uint32_t* local;   // counts, then run starts
  uint32_t* gbase;   // list slot of run slot 0
  uint32_t* cursor;  // the block's next slot in each list
  uint32_t* warp_sums;
  int* range;        // the tile's least and greatest region
};

// The tile's region range [lo, lo + span), over the regions its lanes'
// groups reach (span <= 0: no live probe in the tile).
__device__ __forceinline__ void tile_range(const Lane& l, int rbits,
                                           Shared& sh, int* lo, int* span) {
  if (threadIdx.x == 0) {
    sh.range[0] = 0x7FFFFFFF;
    sh.range[1] = -1;
  }
  __syncthreads();
  const bool any = l.k > 0;
  const int rlo = any ? static_cast<int>(l.off >> rbits) : 0x7FFFFFFF;
  const int rhi = any ? static_cast<int>((l.off + l.m - 1) >> rbits) : -1;
  const int wlo = __reduce_min_sync(kFull, rlo);
  const int whi = __reduce_max_sync(kFull, rhi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(sh.range, wlo);
    atomicMax(sh.range + 1, whi);
  }
  __syncthreads();
  *lo = sh.range[0];
  *span = sh.range[1] - sh.range[0] + 1;
}

// Adds n to hist[key] for each live lane and returns where the lane's n
// slots start. A warp whose live lanes share one key makes one shared
// atomic (a fused build's lanes, laid out group by group, mostly do), the
// lane's slots following those of the live lanes before it; any other
// warp makes one a live lane.
__device__ __forceinline__ uint32_t warp_add(uint32_t* hist, uint32_t key,
                                             uint32_t n, bool live) {
  const unsigned alive = __ballot_sync(kFull, live);
  if (!alive) return 0u;
  const int leader = __ffs(alive) - 1;
  const uint32_t first = __shfl_sync(kFull, key, leader);
  if (__ballot_sync(kFull, live && key == first) != alive)
    return live ? atomicAdd(hist + key, n) : 0u;
  const int me = threadIdx.x & 31;
  const uint32_t mine = live ? n : 0u;
  uint32_t x = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, d);
    if (me >= d) x += y;
  }
  const uint32_t total = __shfl_sync(kFull, x, 31);
  uint32_t base = 0;
  if (me == leader) base = atomicAdd(hist + first, total);
  return __shfl_sync(kFull, base, leader) + x - mine;
}

// The lane's region when every probe of its group falls in one (a fused
// build's small groups), else -1.
__device__ __forceinline__ int single_region(const Lane& l, int rbits) {
  const uint32_t rlo = l.off >> rbits, rhi = (l.off + l.m - 1) >> rbits;
  return l.k > 0 && rlo == rhi ? static_cast<int>(rlo) : -1;
}

// Exclusive scan of v[0..n) in shared memory by the block, each thread
// over a run of ceil(n / kLaneThreads) entries; returns the total.
__device__ uint32_t block_scan(uint32_t* v, int n, uint32_t* warp_sums) {
  const int per = (n + kLaneThreads - 1) / kLaneThreads;
  const int b = threadIdx.x * per, e = b + per < n ? b + per : n;
  uint32_t own = 0;
  for (int i = b; i < e; ++i) own += v[i];
  uint32_t s = own;
  const int me = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, s, d);
    if (me >= d) s += y;
  }
  if (me == 31) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = me < kLaneThreads / 32 ? warp_sums[me] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, w, d);
      if (me >= d) w += y;
    }
    warp_sums[me] = w;  // inclusive
  }
  __syncthreads();
  uint32_t run = (warp ? warp_sums[warp - 1] : 0u) + s - own;
  const uint32_t total = warp_sums[kLaneThreads / 32 - 1];
  for (int i = b; i < e; ++i) {
    const uint32_t x = v[i];
    v[i] = run;
    run += x;
  }
  __syncthreads();
  return total;
}

// Phase 1: the block's probes counted by region over all its tiles (a
// lane whose group lies in one region counts its k probes at once); at
// the end one global atomicAdd a (block, touched region), whose old value
// is where the block's probes start in that region's list.
__device__ void count_phase(const Args& a, Shared& sh) {
  for (int i = threadIdx.x; i < a.regions; i += kLaneThreads) sh.local[i] = 0;
  __syncthreads();
  for_each_tile(a, [&](const Lane& l) {
    const int one = single_region(l, a.rbits);
    warp_add(sh.local, one, l.k, one >= 0);
    if (one < 0)
      for (int i = 0; i < l.k; ++i) atomicAdd(sh.local + (l.target(i) >> a.rbits), 1u);
  });
  __syncthreads();
  for (int i = threadIdx.x; i < a.regions; i += kLaneThreads)
    sh.cursor[i] = sh.local[i] ? atomicAdd(a.counts + i, sh.local[i]) : 0u;
}

// Phase 2, every block alike: the lists' starts and the work items
// (runs of at most kChunk probes of a list), scanned from the counts;
// the block's cursors move to its place in each list.
__device__ void scan_phase(const Args& a, Shared& sh) {
  for (int r = threadIdx.x; r <= a.regions; r += kLaneThreads) {
    const uint32_t c = r < a.regions ? __ldcg(a.counts + r) : 0u;
    sh.start[r] = c;
    sh.item[r] = (c + kChunk - 1) / kChunk;
  }
  __syncthreads();
  block_scan(sh.start, a.regions + 1, sh.warp_sums);
  block_scan(sh.item, a.regions + 1, sh.warp_sums);
  for (int r = threadIdx.x; r < a.regions; r += kLaneThreads)
    sh.cursor[r] += sh.start[r];
  __syncthreads();
}

// Phase 3, one tile: each probe's bit offset inside its region, written
// into the region's list as runs at the block's cursors. Counting the
// tile's probes by region also gives each its rank in its run; probes
// and ranks wait in shared memory while the counts are scanned, then
// each probe is placed, sorted by region, for the store.
__device__ void bin_tile(const Args& a, const Lane& l, Shared& sh,
                         uint32_t* staged) {
  const int slots = kLaneThreads * a.kmax;
  uint32_t* entry = staged + slots;  // (region - lo) << rbits | bit
  uint16_t* rank = reinterpret_cast<uint16_t*>(entry + slots);
  int lo = 0, span = a.regions;
  if (a.regions <= kLaneThreads) {
    __syncthreads();  // a few regions: all of them, no range to reduce
  } else {
    tile_range(l, a.rbits, sh, &lo, &span);
    if (span <= 0) return;
  }
  for (int i = threadIdx.x; i < span; i += kLaneThreads) sh.local[i] = 0;
  __syncthreads();
  const uint32_t mask = (1u << a.rbits) - 1u;
  const int one = single_region(l, a.rbits);
  const uint32_t base = warp_add(sh.local, one - lo, l.k, one >= 0);
  const int me = threadIdx.x;
  if (one >= 0) {
    for (int i = 0; i < l.k; ++i) {
      entry[i * kLaneThreads + me] = ((one - lo) << a.rbits) | (l.target(i) & mask);
      rank[i * kLaneThreads + me] = static_cast<uint16_t>(base + i);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < l.k; ++i) {
      const uint32_t t = l.target(i);
      const uint32_t r = (t >> a.rbits) - lo;
      entry[i * kLaneThreads + me] = (r << a.rbits) | (t & mask);
      rank[i * kLaneThreads + me] =
          static_cast<uint16_t>(atomicAdd(sh.local + r, 1u));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < span; i += kLaneThreads)
    sh.gbase[i] = sh.local[i];
  __syncthreads();
  const uint32_t total = block_scan(sh.local, span, sh.warp_sums);
  for (int i = threadIdx.x; i < span; i += kLaneThreads) {
    const uint32_t c = sh.gbase[i];
    sh.gbase[i] = sh.cursor[lo + i] - sh.local[i];
    sh.cursor[lo + i] += c;
  }
  __syncthreads();
  for (int i = 0; i < l.k; ++i) {
    const uint32_t e = entry[i * kLaneThreads + me];
    staged[sh.local[e >> a.rbits] + rank[i * kLaneThreads + me]] = e;
  }
  __syncthreads();
  for (uint32_t e = threadIdx.x; e < total; e += kLaneThreads) {
    const uint32_t v = staged[e];
    a.probes[sh.gbase[v >> a.rbits] + e] = v & mask;
  }
}

__device__ void bin_phase(const Args& a, Shared& sh, uint32_t* staged) {
  for_each_tile(a, [&](const Lane& l) { bin_tile(a, l, sh, staged); });
}

// Phase 4: one work item at a time, its probes ORed into its region.
__device__ void own_phase(const Args& a, const Shared& sh, uint32_t* region) {
  const uint32_t n_items = sh.item[a.regions];
  const int rwords = 1 << (a.rbits - 5);
  for (uint32_t it = blockIdx.x; it < n_items; it += gridDim.x) {
    int r = 0, hi = a.regions;  // the region whose items hold `it`
    while (hi - r > 1) {
      const int mid = (r + hi) >> 1;
      if (sh.item[mid] <= it) r = mid; else hi = mid;
    }
    const bool shared = sh.item[r + 1] - sh.item[r] > 1;
    const uint32_t p_lo = sh.start[r] + (it - sh.item[r]) * kChunk;
    const uint32_t p_end = p_lo + kChunk < sh.start[r + 1] ? p_lo + kChunk
                                                          : sh.start[r + 1];
    const long long w0 = static_cast<long long>(r) << (a.rbits - 5);
    const long long left = a.n_words - w0;
    const int nw = left < rwords ? static_cast<int>(left) : rwords;
    for (int i = threadIdx.x; i < nw; i += kLaneThreads)
      region[i] = shared ? 0u : a.words[w0 + i];
    __syncthreads();
    for (uint32_t p0 = p_lo + threadIdx.x; p0 < p_end;
         p0 += kLaneThreads * kOwnBatch) {
      uint32_t bit[kOwnBatch];
#pragma unroll
      for (int j = 0; j < kOwnBatch; ++j) {
        const uint32_t p = p0 + j * kLaneThreads;
        bit[j] = p < p_end ? __ldcg(a.probes + p) : 0xFFFFFFFFu;
      }
#pragma unroll
      for (int j = 0; j < kOwnBatch; ++j)
        if (bit[j] != 0xFFFFFFFFu)
          atomicOr(region + (bit[j] >> 5), 1u << (bit[j] & 31u));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nw; i += kLaneThreads) {
      const uint32_t v = region[i];
      if (!shared)
        a.words[w0 + i] = v;
      else if (v)
        atomicOr(a.words + w0 + i, v);
    }
    __syncthreads();
  }
}

// The whole scatter in one cooperative launch, a grid barrier between
// phases; `a.phases` (1-5) stops it after that many (for timing each).
__global__ void __launch_bounds__(kLaneThreads, kBlocksPerSm)
scatter_kernel(const Args a) {
  __shared__ uint32_t warp_sums[32];
  __shared__ int range[2];
  // start and item; then the bin phase's tables and staging, or the own
  // phase's region words
  extern __shared__ uint32_t dyn[];
  const int t = a.regions + 1;
  Shared sh{dyn, dyn + t, dyn + 2 * t, dyn + 2 * t + a.regions,
            dyn + 2 * t + 2 * a.regions, warp_sums, range};
  uint32_t* staged = dyn + 2 * t + 3 * a.regions;
  cg::grid_group grid = cg::this_grid();
  // Phase 0: zero the region counts; one reciprocal a group; a group of
  // more than kmax probes would overrun the lists: trap (the launch fails).
  const long long gtid =
      static_cast<long long>(blockIdx.x) * kLaneThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kLaneThreads;
  for (long long i = gtid; i < a.regions; i += stride) a.counts[i] = 0;
  for (long long i = gtid; i < a.n_groups; i += stride) {
    if (a.ks[i] > a.kmax) __trap();
    a.minv[i] = 0xFFFFFFFFu / static_cast<uint32_t>(a.ms[i]);
  }
  if (a.phases < 2) return;
  grid.sync();
  count_phase(a, sh);
  if (a.phases < 3) return;
  grid.sync();
  scan_phase(a, sh);
  if (a.phases < 4) return;
  bin_phase(a, sh, staged);
  if (a.phases < 5) return;
  grid.sync();
  own_phase(a, sh, dyn + 2 * t);
}

int launch(int phases, const void* keys, const void* gid, const void* offs,
           const void* ms, const void* ks, int n_groups, int kmax,
           unsigned int layer, void* words, long long n_words, long long n,
           void* scratch, long long scratch_bytes, int device,
           cudaStream_t stream) {
  Args a;
  a.rbits = region_bits(n_words);
  a.regions = num_regions(n_words, a.rbits);
  const Layout lay = layout(n, kmax, n_words, n_groups);
  if (scratch_bytes < lay.bytes) return static_cast<int>(cudaErrorInvalidValue);
  char* s = static_cast<char*>(scratch);
  a.keys = static_cast<const uint4*>(keys);
  a.gid = static_cast<const int32_t*>(gid);
  a.offs = static_cast<const long long*>(offs);
  a.ms = static_cast<const int32_t*>(ms);
  a.ks = static_cast<const int32_t*>(ks);
  a.words = static_cast<uint32_t*>(words);
  a.counts = reinterpret_cast<uint32_t*>(s + lay.counts);
  a.minv = reinterpret_cast<uint32_t*>(s + lay.minv);
  a.probes = reinterpret_cast<uint32_t*>(s + lay.probes);
  a.n = n;
  a.n_words = n_words;
  a.layer = layer;
  a.kmax = kmax;
  a.n_groups = n_groups;
  a.phases = phases;
  const int tables = 8 * (a.regions + 1);
  const int bin_smem = tables + 12 * a.regions + kLaneThreads * kmax * 10;
  const int own_smem = tables + (4 << (a.rbits - 5));
  const int smem = bin_smem > own_smem ? bin_smem : own_smem;
  // The shared-memory limit and the resident blocks are asked of the
  // device on every launch (microseconds, against a kernel of tens), so
  // that no state outlives a call: any card, any thread.
  cudaError_t err = cudaFuncSetAttribute(
      scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter_kernel, kLaneThreads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // Every block must be resident for the grid barrier; more blocks than
  // tiles or work items would only wait at it.
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long tiles = (n + kLaneThreads - 1) / kLaneThreads;
  const long long items = a.regions + (n * kmax + kChunk - 1) / kChunk;
  const long long work = tiles > items ? tiles : items;
  const long long grid = resident < work ? resident : work;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(scatter_kernel),
      dim3(static_cast<unsigned>(grid)), dim3(kLaneThreads), params,
      static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). ORs the probe bits of `n`
// lanes into the `n_words` words of `words` on `stream` of device
// `device`, with `scratch` of `scratch_bytes` bytes (ops/bloom.py's
// scratch_bytes, or more); `kmax` must bound every ks (a group past it
// traps the kernel). Does not synchronise, and returns cudaGetLastError()
// of the launch (0 = launched; cudaErrorInvalidValue for a short scratch).
extern "C" int ctmr_bloom_scatter(const void* keys, const void* gid,
                                  const void* offs, const void* ms,
                                  const void* ks, int n_groups, int kmax,
                                  unsigned int layer, void* words,
                                  long long n_words, long long n,
                                  void* scratch, long long scratch_bytes,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  return launch(5, keys, gid, offs, ms, ks, n_groups, kmax, layer, words,
                n_words, n, scratch, scratch_bytes, device,
                static_cast<cudaStream_t>(stream));
}

// The first `phases` phases (1-5) of the scatter alone, for timing each
// (every prefix is a consistent run of its own; only all five write the
// arena).
extern "C" int ctmr_bloom_scatter_phases(
    int phases, const void* keys, const void* gid, const void* offs,
    const void* ms, const void* ks, int n_groups, int kmax,
    unsigned int layer, void* words, long long n_words, long long n,
    void* scratch, long long scratch_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || phases <= 0) return 0;
  return launch(phases, keys, gid, offs, ms, ks, n_groups, kmax, layer, words,
                n_words, n, scratch, scratch_bytes, device,
                static_cast<cudaStream_t>(stream));
}
