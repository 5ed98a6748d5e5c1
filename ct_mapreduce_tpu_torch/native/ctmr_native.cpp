// Native host-side ingest decoder for the port.
//
// A copy of ct_mapreduce_tpu/native/ctmr_native.cpp without its SCT
// extraction (the verify lane is not ported yet): batched base64 and
// RFC 6962 MerkleTreeLeaf/extra_data decoding, packing certificate
// bytes into the fixed-width [n, pad_len] row layout, and the
// pre-parsed lane's sidecar extraction (a scalar port of the DER
// walker). One call handles a whole get-entries batch; the *_mt entry
// points split it over a persistent worker pool.
//
// ABI: plain C, consumed via ctypes. All buffers are caller-allocated
// (NumPy arrays, or the pinned host buffers of the ingest sink).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace pool {

// Persistent, lazily-grown worker pool shared by the *_mt entry
// points. One global instance per process; threads are created the
// first time a caller asks for them and then parked on a condition
// variable between batches (thread create/join per 64K-entry chunk
// would cost more than the decode it parallelizes). The instance is
// deliberately leaked: parked workers may still exist at process
// exit and C++ static destruction order makes tearing them down
// unsafe — the OS reclaims them.
class WorkerPool {
 public:
  static WorkerPool& get() {
    static WorkerPool* p = new WorkerPool();
    return *p;
  }

  int active_workers() {
    std::lock_guard<std::mutex> lk(mu_);
    return (int)workers_.size() + 1;  // + the calling thread
  }

  // Run fn(chunk) for chunk in [0, n_chunks) with up to `threads`
  // concurrent executors (the calling thread participates). Blocks
  // until every chunk finished. Chunk claiming is an atomic counter,
  // so which THREAD runs a chunk is nondeterministic — callers must
  // make each chunk's writes a pure function of its chunk id (disjoint
  // output ranges, no shared accumulators) to keep results
  // bit-identical to a serial pass.
  void run(int threads, int n_chunks, const std::function<void(int)>& fn) {
    if (threads <= 1 || n_chunks <= 1) {
      for (int c = 0; c < n_chunks; ++c) fn(c);
      return;
    }
    // One parallel region at a time: the Python side may issue
    // concurrent decode calls (overlap pipeline workers); the second
    // caller just runs serially rather than queueing behind the pool.
    std::unique_lock<std::mutex> region(run_mu_, std::try_to_lock);
    if (!region.owns_lock()) {
      for (int c = 0; c < n_chunks; ++c) fn(c);
      return;
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      while ((int)workers_.size() < threads - 1) {
        workers_.emplace_back([this] { worker_loop(); });
      }
      fn_ = fn;
      remaining_ = n_chunks;
      // n_chunks_ and fn_ are published by the release store on
      // next_: a worker only dereferences them after its acquire
      // fetch_add observes the reset counter.
      n_chunks_.store(n_chunks, std::memory_order_relaxed);
      next_.store(0, std::memory_order_release);
      ++epoch_;
    }
    cv_.notify_all();
    work();  // caller participates
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] { return remaining_ == 0; });
  }

 private:
  void work() {
    for (;;) {
      int c = next_.fetch_add(1, std::memory_order_acquire);
      if (c >= n_chunks_.load(std::memory_order_relaxed)) return;
      fn_(c);
      std::lock_guard<std::mutex> lk(mu_);
      if (--remaining_ == 0) done_cv_.notify_all();
    }
  }
  void worker_loop() {
    uint64_t seen = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return epoch_ != seen; });
        seen = epoch_;
      }
      work();
    }
  }

  std::mutex run_mu_;  // serializes parallel regions
  std::mutex mu_;      // guards pool state below
  std::condition_variable cv_, done_cv_;
  std::vector<std::thread> workers_;
  std::function<void(int)> fn_;
  std::atomic<int> next_{0};
  std::atomic<int> n_chunks_{0};
  int remaining_ = 0;
  uint64_t epoch_ = 0;
};

}  // namespace pool

namespace {

// RFC 4648 base64 (standard alphabet, '=' padding). Returns decoded
// length, or -1 on bad input. Whitespace is not tolerated — CT JSON
// carries clean base64.
struct B64Table {
  int8_t t[256];
  B64Table() {
    for (int i = 0; i < 256; ++i) t[i] = -1;
    const char* alpha =
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    for (int i = 0; i < 64; ++i) t[(uint8_t)alpha[i]] = (int8_t)i;
  }
};

int64_t b64_decode(const char* in, int64_t in_len, uint8_t* out) {
  // C++ magic static: thread-safe one-time init (multiple store
  // workers decode concurrently).
  static const B64Table table;
  // Match Python's b64decode(validate=True): total length must be a
  // multiple of 4 (padding included), at most 2 trailing '=' pads, and
  // any non-alphabet byte is fatal.
  if (in_len % 4 != 0) return -1;
  int pads = 0;
  while (in_len > 0 && in[in_len - 1] == '=') { --in_len; ++pads; }
  if (pads > 2) return -1;
  int64_t out_len = 0;
  uint32_t acc = 0;
  int bits = 0;
  for (int64_t i = 0; i < in_len; ++i) {
    int8_t v = table.t[(uint8_t)in[i]];
    if (v < 0) return -1;
    acc = (acc << 6) | (uint32_t)v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out[out_len++] = (uint8_t)((acc >> bits) & 0xFF);
    }
  }
  return out_len;
}

struct Reader {
  const uint8_t* p;
  int64_t len;
  int64_t pos = 0;
  bool ok = true;

  uint64_t uint(int width) {
    if (pos + width > len) { ok = false; return 0; }
    uint64_t v = 0;
    for (int i = 0; i < width; ++i) v = (v << 8) | p[pos + i];
    pos += width;
    return v;
  }
  // TLS opaque<len_width>: returns (offset, length) into p.
  bool opaque(int len_width, int64_t* off, int64_t* olen) {
    uint64_t n = uint(len_width);
    if (!ok || pos + (int64_t)n > len) { ok = false; return false; }
    *off = pos;
    *olen = (int64_t)n;
    pos += (int64_t)n;
    return true;
  }
};

// FNV-1a 64-bit over a byte span (issuer-dedup hash).
uint64_t fnv1a(const uint8_t* p, int64_t n) {
  uint64_t h = 1469598103934665603ull;
  for (int64_t i = 0; i < n; ++i) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

}  // namespace

extern "C" {

// Status codes per entry (mirrors ingest/leaf.py error taxonomy).
enum {
  CTMR_OK = 0,
  CTMR_BAD_B64 = 1,
  CTMR_BAD_LEAF = 2,
  CTMR_UNSUPPORTED = 3,   // version/leaf_type/entry_type unknown
  CTMR_NO_CHAIN = 4,      // no issuer certificate in extra_data
  CTMR_TOO_LONG = 5,      // cert exceeds pad_len (a wider redecode
                          // can clear it; exact host lane otherwise)
  CTMR_ISSUER_TOO_LONG = 6,  // issuer DER >= 2 MiB: the cert itself
                          // packed fine, so a wider redecode is futile
                          // — straight to the exact host lane
};

// Decode one get-entries batch and pack leaf certificates.
//
// Inputs: n entries; leaf_input/extra_data base64 blobs concatenated in
// `li_buf`/`ed_buf` with offsets (n+1 entries, prefix-sum style).
// Outputs:
//   data      [n, pad_len] uint8  — packed certificate DER (zero-padded)
//   length    [n] int32           — true DER length (0 on error lanes)
//   ts_ms     [n] int64           — leaf timestamps
//   entry_ty  [n] int32           — 0 x509 / 1 precert
//   issuer_off/issuer_len [n] int64/int32 — issuer (chain[0]) DER span
//       inside scratch; issuer bytes are written to `issuer_buf`
//       sequentially; issuer_cap is its capacity.
//   status    [n] int32
// Returns bytes used in issuer_buf, or -1 if issuer_buf overflowed.
int64_t ctmr_decode_entries(
    int64_t n,
    const char* li_buf, const int64_t* li_off,
    const char* ed_buf, const int64_t* ed_off,
    int64_t pad_len,
    uint8_t* data, int32_t* length,
    int64_t* ts_ms, int32_t* entry_ty,
    uint8_t* issuer_buf, int64_t issuer_cap,
    int64_t* issuer_off, int32_t* issuer_len,
    int32_t* status,
    uint8_t* scratch, int64_t scratch_cap) {
  int64_t issuer_used = 0;
  // Issuer dedup: CT batches carry a handful of distinct issuers, so
  // identical chain[0] DERs share one span of issuer_buf (callers
  // group entries by (off, len) without re-hashing bytes in Python).
  // Fixed-size open-addressed table; on overflow we just append —
  // correctness never depends on a dedup hit.
  constexpr int kIssSlots = 512;  // power of two
  struct IssSlot { uint64_t h; int64_t off; int32_t len; };
  IssSlot iss_tab[kIssSlots];
  std::memset(iss_tab, 0, sizeof(iss_tab));
  for (int64_t i = 0; i < n; ++i) {
    status[i] = CTMR_OK;
    length[i] = 0;
    ts_ms[i] = 0;
    entry_ty[i] = 0;
    issuer_off[i] = 0;
    issuer_len[i] = 0;
    uint8_t* row = data + i * pad_len;
    std::memset(row, 0, (size_t)pad_len);

    // -- leaf_input ---------------------------------------------------
    const char* li = li_buf + li_off[i];
    int64_t li_n = li_off[i + 1] - li_off[i];
    if ((li_n * 3) / 4 + 4 > scratch_cap) { status[i] = CTMR_BAD_B64; continue; }
    int64_t li_dec = b64_decode(li, li_n, scratch);
    if (li_dec < 0) { status[i] = CTMR_BAD_B64; continue; }

    Reader r{scratch, li_dec};
    uint64_t version = r.uint(1);
    uint64_t leaf_type = r.uint(1);
    if (!r.ok || version != 0 || leaf_type != 0) {
      status[i] = r.ok ? CTMR_UNSUPPORTED : CTMR_BAD_LEAF;
      continue;
    }
    uint64_t ts = r.uint(8);
    uint64_t ety = r.uint(2);
    if (!r.ok) { status[i] = CTMR_BAD_LEAF; continue; }
    // ts_ms/entry_ty are stored only once every BAD_* path is behind
    // us (below, before the TOO_LONG check): the Python codec yields
    // them only when the whole decode succeeds, and the conformance
    // fuzz pins byte equality of every output array.

    int64_t cert_off = 0, cert_len = 0;
    if (ety == 0) {  // x509_entry: leaf cert in leaf_input
      if (!r.opaque(3, &cert_off, &cert_len)) { status[i] = CTMR_BAD_LEAF; continue; }
    } else if (ety == 1) {  // precert: issuer_key_hash + TBS (unused)
      r.pos += 32;
      int64_t toff, tlen;
      if (r.pos > r.len || !r.opaque(3, &toff, &tlen)) {
        status[i] = CTMR_BAD_LEAF; continue;
      }
    } else {
      status[i] = CTMR_UNSUPPORTED;
      continue;
    }
    // CtExtensions<2>: content ignored, but the frame must be intact —
    // leaf.py's r.opaque(2) raises on truncation, so parity demands the
    // same validation here.
    {
      int64_t xoff, xlen;
      if (!r.opaque(2, &xoff, &xlen)) { status[i] = CTMR_BAD_LEAF; continue; }
    }

    const uint8_t* cert_src = scratch + cert_off;

    // -- extra_data ---------------------------------------------------
    const char* ed = ed_buf + ed_off[i];
    int64_t ed_n = ed_off[i + 1] - ed_off[i];
    uint8_t* ed_scratch = scratch + (li_dec + 7) / 8 * 8;
    int64_t ed_cap = scratch_cap - (li_dec + 7) / 8 * 8;
    int64_t ed_dec = 0;
    if (ed_n > 0) {
      if ((ed_n * 3) / 4 + 4 > ed_cap) { status[i] = CTMR_BAD_B64; continue; }
      ed_dec = b64_decode(ed, ed_n, ed_scratch);
      if (ed_dec < 0) { status[i] = CTMR_BAD_B64; continue; }
    }

    Reader er{ed_scratch, ed_dec};
    if (ety == 1) {
      // PrecertChainEntry: pre_certificate<3> is what gets stored.
      int64_t poff, plen;
      if (!er.opaque(3, &poff, &plen)) { status[i] = CTMR_BAD_LEAF; continue; }
      cert_src = ed_scratch + poff;
      cert_len = plen;
    }
    // chain (both types): outer <3> frame of <3>-prefixed certs. The
    // whole frame must parse — the Python codec's _read_chain raises on
    // ANY truncated element (not just the first), so a malformed frame
    // is BAD_LEAF, never a silent "no chain".
    int64_t chain_issuer_off = -1, chain_issuer_len = 0;
    if (er.pos < er.len) {
      int64_t foff, flen;
      if (!er.opaque(3, &foff, &flen)) { status[i] = CTMR_BAD_LEAF; continue; }
      Reader cr{ed_scratch + foff, flen};
      bool chain_ok = true;
      bool first = true;
      while (cr.pos < cr.len) {
        int64_t coff, clen;
        if (!cr.opaque(3, &coff, &clen)) { chain_ok = false; break; }
        if (first) {
          chain_issuer_off = foff + coff;
          chain_issuer_len = clen;
          first = false;
        }
      }
      if (!chain_ok) { status[i] = CTMR_BAD_LEAF; continue; }
    }

    ts_ms[i] = (int64_t)ts;
    entry_ty[i] = (int32_t)ety;
    if (cert_len > pad_len) { status[i] = CTMR_TOO_LONG; continue; }
    std::memcpy(row, cert_src, (size_t)cert_len);
    length[i] = (int32_t)cert_len;

    if (chain_issuer_off < 0 || chain_issuer_len == 0) {
      status[i] = CTMR_NO_CHAIN;  // cert still packed; caller decides
      continue;
    }
    if (chain_issuer_len >= (1 << 21)) {
      // Pathological >=2 MiB issuer DER: the Python span packing
      // (off*2^21 + len) requires len < 2^21, so route the entry down
      // the exact per-entry host lane instead of risking aliasing.
      // Distinct from CTMR_TOO_LONG: the cert row IS packed, so the
      // caller must not trigger a full-width batch redecode for it.
      status[i] = CTMR_ISSUER_TOO_LONG;
      continue;
    }
    const uint8_t* iss_src = ed_scratch + chain_issuer_off;
    uint64_t h = fnv1a(iss_src, chain_issuer_len);
    if (h == 0) h = 1;  // 0 marks an empty slot
    int64_t found_off = -1;
    int probe = (int)(h & (kIssSlots - 1));
    int tries = 0;
    for (; tries < kIssSlots; ++tries) {
      IssSlot& s = iss_tab[probe];
      if (s.h == 0) break;  // miss — insert here after the append
      if (s.h == h && s.len == (int32_t)chain_issuer_len &&
          std::memcmp(issuer_buf + s.off, iss_src,
                      (size_t)chain_issuer_len) == 0) {
        found_off = s.off;
        break;
      }
      probe = (probe + 1) & (kIssSlots - 1);
    }
    if (found_off >= 0) {
      issuer_off[i] = found_off;
      issuer_len[i] = (int32_t)chain_issuer_len;
      continue;
    }
    if (issuer_used + chain_issuer_len > issuer_cap) return -1;
    std::memcpy(issuer_buf + issuer_used, iss_src,
                (size_t)chain_issuer_len);
    issuer_off[i] = issuer_used;
    issuer_len[i] = (int32_t)chain_issuer_len;
    if (tries < kIssSlots && iss_tab[probe].h == 0) {
      iss_tab[probe] = {h, issuer_used, (int32_t)chain_issuer_len};
    }
    issuer_used += chain_issuer_len;
  }
  return issuer_used;
}

// Pack pre-decoded DER blobs (concatenated in `blob` with prefix-sum
// offsets) into the [n, pad_len] device layout. Returns count packed;
// lanes whose cert exceeds pad_len get length 0 and ok[i] = 0.
int64_t ctmr_pack_ders(
    int64_t n,
    const uint8_t* blob, const int64_t* off,
    int64_t pad_len,
    uint8_t* data, int32_t* length, uint8_t* okflags) {
  int64_t packed = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t* row = data + i * pad_len;
    std::memset(row, 0, (size_t)pad_len);
    int64_t len = off[i + 1] - off[i];
    if (len > pad_len) { length[i] = 0; okflags[i] = 0; continue; }
    std::memcpy(row, blob + off[i], (size_t)len);
    length[i] = (int32_t)len;
    okflags[i] = 1;
    ++packed;
  }
  return packed;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Pre-parsed ingest sidecars: a SCALAR PORT of the device DER walker
// (ct_mapreduce_tpu/ops/der_kernel.py parse_certs_rows).
//
// The contract is bit-exactness with the device walker on EVERY input,
// not "a good X.509 parser": the pre-parsed ingest lane substitutes
// these host-extracted fields for the on-device walk, and any
// divergence (a lane one side accepts and the other rejects, or a
// field extracted differently) silently re-routes entries between the
// device dedup domain and the exact host lane — the ParsEval failure
// mode (arXiv:2405.18993). So every quirk of the walker is reproduced
// deliberately: fixed byte-window limits around each merged header
// group (reads outside a window see zeros), long-form lengths capped
// at 3 octets, the MAX_RDNS/MAX_EXTS scan budgets, first-ATV-per-RDN /
// first-CN-wins CN selection, day<=31 non-calendar time validation,
// and the extnValue-overrun lane rejection. tests/test_preparsed.py
// pins `extract == parse_certs` across the mutation fuzz.

namespace walker {

constexpr int kMaxRdns = 12;   // der_kernel.MAX_RDNS
constexpr int kMaxExts = 24;   // der_kernel.MAX_EXTS

// One certificate row in the padded [pad_len] layout (zero padding
// beyond `length` is guaranteed by the packers).
struct Row {
  const uint8_t* p;
  int64_t pad_len;
  int64_t nwb;  // padded word bytes = ceil(pad_len/4)*4 (zeros past pad)

  // Byte `rel` of the W-byte window anchored at position `pos`
  // (der_kernel._window + _wbyte): window byte j is row byte
  // clip(pos)&~3 + j; out-of-window reads are zero, matching the
  // one-hot select's masked sum.
  int wbyte(int64_t pos, int64_t rel, int W) const {
    if (rel < 0 || rel >= W) return 0;
    int64_t base = pos < 0 ? 0 : pos;
    int64_t cap = (nwb / 4 - 1) * 4;
    if (base > cap) base = cap;
    base &= ~int64_t{3};
    int64_t q = base + rel;
    return (q >= 0 && q < pad_len) ? p[q] : 0;
  }
};

struct Hdr {
  int64_t tag = 0, clen = 0, hlen = 0;
  bool ok = false;
};

// _read_header_w: TLV header at row position pos+delta read through
// the W-byte window anchored at `pos`. Short form or long form up to
// 3 length octets; ok requires the whole frame inside `limit`.
inline Hdr read_header(const Row& r, int64_t pos, int64_t delta,
                       int64_t limit, int W) {
  int64_t a = (pos < 0 ? 0 : pos) & 3;
  int64_t rel = a + delta;
  Hdr h;
  h.tag = r.wbyte(pos, rel, W);
  int64_t b0 = r.wbyte(pos, rel + 1, W);
  int64_t b1 = r.wbyte(pos, rel + 2, W);
  int64_t b2 = r.wbyte(pos, rel + 3, W);
  int64_t b3 = r.wbyte(pos, rel + 4, W);
  bool short_form = b0 < 0x80;
  int64_t n_len = b0 - 0x80;
  bool long_ok = (b0 > 0x80) && (n_len <= 3);
  int64_t clen_long = n_len == 1 ? b1
                      : n_len == 2 ? ((b1 << 8) | b2)
                                   : ((b1 << 16) | (b2 << 8) | b3);
  h.clen = short_form ? b0 : clen_long;
  h.hlen = short_form ? 2 : 2 + n_len;
  int64_t at = pos + delta;
  h.ok = (short_form || long_ok) && at >= 0 && at + h.hlen + h.clen <= limit;
  return h;
}

// _parse_time_w: UTCTime/GeneralizedTime at pos+delta (window at pos).
// Mirrors the walker exactly: strict ASCII-digit checks on every byte
// feeding the bucket, month 1-12 / day 1-31 / hour 0-23 ranges, NO
// calendar (leap/length-of-month) or minutes/seconds validation.
inline bool parse_time(const Row& r, int64_t pos, int64_t delta, int W,
                       int32_t* hour_out) {
  Hdr h = read_header(r, pos, delta, int64_t{1} << 30, W);
  bool is_utc = h.tag == 0x17;
  bool is_gen = h.tag == 0x18;
  if (!h.ok || !(is_utc || is_gen)) return false;
  if (is_utc ? h.clen < 11 : h.clen < 13) return false;
  int64_t a = (pos < 0 ? 0 : pos) & 3;
  int64_t q = a + delta + h.hlen;
  auto d2 = [&](int64_t off, int64_t* out) -> bool {
    int b0 = r.wbyte(pos, off, W), b1 = r.wbyte(pos, off + 1, W);
    if (b0 < 0x30 || b0 > 0x39 || b1 < 0x30 || b1 > 0x39) return false;
    *out = (b0 - 0x30) * 10 + (b1 - 0x30);
    return true;
  };
  int64_t yy, cc = 0, month, day, hour;
  if (!d2(q, &yy)) return false;
  int64_t year;
  if (is_utc) {
    year = yy >= 50 ? 1900 + yy : 2000 + yy;
  } else {
    if (!d2(q + 2, &cc)) return false;
    year = yy * 100 + cc;
  }
  int64_t body = is_utc ? q : q + 2;
  if (!d2(body + 2, &month) || !d2(body + 4, &day) || !d2(body + 6, &hour))
    return false;
  if (month < 1 || month > 12 || day < 1 || day > 31 || hour > 23)
    return false;
  // Days-from-civil (identical arithmetic; floor divisions — all the
  // operands are non-negative here except the final epoch shift).
  int64_t y = year - (month <= 2 ? 1 : 0);
  int64_t era = y / 400;  // year >= 1900-ish in practice; y >= 0 always
  int64_t yoe = y - era * 400;
  int64_t mp = month > 2 ? month - 3 : month + 9;
  int64_t doy = (153 * mp + 2) / 5 + day - 1;
  int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  int64_t days = era * 146097 + doe - 719468;
  *hour_out = (int32_t)(days * 24 + hour);
  return true;
}

struct Sidecar {
  uint8_t ok = 0;
  int32_t serial_off = 0, serial_len = 0;
  int32_t not_after_hour = 0;
  uint8_t is_ca = 0, has_crldp = 0;
  int32_t cn_off = 0, cn_len = 0;
  int32_t issuer_off = 0, issuer_len = 0;
  int32_t spki_off = 0, spki_len = 0;
  int32_t crldp_off = 0, crldp_len = 0;
};

// _scan_issuer_cn: first CN (OID 2.5.4.3) via first-ATV-per-RDN-SET
// rounds in an 8-word (32B) window per round; structural breaks stop
// the scan silently (never affect the lane's ok).
inline void scan_issuer_cn(const Row& r, int64_t off, int64_t end,
                           bool alive0, Sidecar* s) {
  constexpr int W = 32;
  int64_t p = off, cn_off = 0, cn_len = 0;
  int cnt = 0;
  bool alive = alive0;
  while (alive && p < end && cnt < kMaxRdns) {
    int64_t a = (p < 0 ? 0 : p) & 3;
    Hdr set = read_header(r, p, 0, end, W);
    bool set_ok = set.ok && set.tag == 0x31;
    int64_t da = set.hlen;
    Hdr atv = read_header(r, p, da, end, W);
    int64_t dro = da + atv.hlen;
    Hdr oid = read_header(r, p, dro, end, W);
    int64_t ro = a + dro + oid.hlen;
    bool is_cn = set_ok && atv.ok && atv.tag == 0x30 && oid.ok
        && oid.tag == 0x06 && oid.clen == 3
        && r.wbyte(p, ro, W) == 0x55 && r.wbyte(p, ro + 1, W) == 0x04
        && r.wbyte(p, ro + 2, W) == 0x03;
    int64_t dv = dro + oid.hlen + oid.clen;
    Hdr val = read_header(r, p, dv, end, W);
    if (is_cn && val.ok && cn_len == 0) {
      cn_off = p + dv + val.hlen;
      cn_len = val.clen;
    }
    if (set.ok) {
      p += set.hlen + set.clen;
      ++cnt;
    }
    alive = alive && set.ok;
  }
  s->cn_off = (int32_t)cn_off;
  s->cn_len = (int32_t)cn_len;
}

// _scan_extensions + _ext_round: BasicConstraints CA + CRLDP windows,
// 11-word (44B) window per round, per-lane budget kMaxExts; a header
// failure or extnValue overrun rejects the lane, exhausting the
// budget mid-list rejects it too. Returns the lane's ext_ok.
inline bool scan_extensions(const Row& r, int64_t off, int64_t end,
                            bool alive0, Sidecar* s) {
  constexpr int W = 44;
  int64_t p = off;
  int cnt = 0;
  bool alive = alive0;
  bool live = alive0 && p < end;
  while (live) {
    int64_t a = (p < 0 ? 0 : p) & 3;
    Hdr e = read_header(r, p, 0, end, W);
    bool ext_ok = e.ok && e.tag == 0x30;
    int64_t di = e.hlen;
    Hdr oid = read_header(r, p, di, end, W);
    bool oid_ok = ext_ok && oid.ok && oid.tag == 0x06 && oid.clen == 3;
    int64_t ro = a + di + oid.hlen;
    int o0 = r.wbyte(p, ro, W), o1 = r.wbyte(p, ro + 1, W),
        o2 = r.wbyte(p, ro + 2, W);
    bool is_bc = oid_ok && o0 == 0x55 && o1 == 0x1D && o2 == 0x13;
    bool is_dp = oid_ok && o0 == 0x55 && o1 == 0x1D && o2 == 0x1F;
    int64_t dc = di + oid.hlen + oid.clen;
    Hdr crit = read_header(r, p, dc, end, W);
    bool has_crit = crit.ok && crit.tag == 0x01;
    int64_t dv = has_crit ? dc + crit.hlen + crit.clen : dc;
    Hdr val = read_header(r, p, dv, end, W);
    Hdr val2 = read_header(r, p, dv, int64_t{1} << 30, W);
    bool overrun = ext_ok && val2.ok
        && dv + val2.hlen + val2.clen > e.hlen + e.clen;
    bool val_ok = val.ok && val.tag == 0x04 && !overrun;
    int64_t db = dv + val.hlen;
    Hdr bc = read_header(r, p, db, end, W);
    bool bc_seq_ok = val_ok && bc.ok && bc.tag == 0x30;
    int64_t df = db + bc.hlen;
    Hdr f = read_header(r, p, df, end, W);
    bool ca_flag = bc_seq_ok && bc.clen > 0 && f.ok && f.tag == 0x01
        && f.clen == 1 && r.wbyte(p, a + df + f.hlen, W) != 0;
    if (is_bc && ca_flag) s->is_ca = 1;
    if (is_dp && val_ok && s->crldp_len == 0) {
      s->crldp_off = (int32_t)(p + dv + val.hlen);
      s->crldp_len = (int32_t)val.clen;
    }
    if (is_dp && val_ok) s->has_crldp = 1;
    if (e.ok) {
      p += e.hlen + e.clen;
      ++cnt;
    }
    alive = alive && e.ok && !overrun;
    live = alive && p < end && cnt < kMaxExts;
  }
  bool exhausted = alive && p < end;  // budget ran out mid-list
  return alive && !exhausted;
}

// parse_certs_rows, one lane: the fixed straight-line walk with the
// same merged windows (w1 17 words anchored at 0; per-header windows
// for the issuer/SPKI headers; w3/w4 13 words) and in-window guards.
inline Sidecar extract_one(const uint8_t* row, int64_t pad_len,
                           int64_t length) {
  Sidecar s;
  Row r{row, pad_len, (pad_len + 3) / 4 * 4};
  int64_t limit = length;
  bool ok = length > 4;

  constexpr int W1 = 68;  // 17 words
  Hdr h = read_header(r, 0, 0, limit, W1);
  ok = ok && h.ok && h.tag == 0x30;
  int64_t d_tbs = h.hlen;
  h = read_header(r, 0, d_tbs, limit, W1);
  ok = ok && h.ok && h.tag == 0x30;
  int64_t tbs_end = d_tbs + h.hlen + h.clen;
  int64_t d = d_tbs + h.hlen;
  Hdr v = read_header(r, 0, d, tbs_end, W1);
  int64_t dser = d + (v.ok && v.tag == 0xA0 ? v.hlen + v.clen : 0);
  h = read_header(r, 0, dser, tbs_end, W1);
  ok = ok && h.ok && h.tag == 0x02 && dser + 5 <= W1;  // a == 0 at pos 0
  int64_t serial_off = dser + h.hlen;
  int64_t serial_len = h.clen;
  int64_t d_alg = dser + h.hlen + h.clen;
  h = read_header(r, 0, d_alg, tbs_end, W1);
  ok = ok && h.ok && h.tag == 0x30 && d_alg + 5 <= W1;
  int64_t p = d_alg + h.hlen + h.clen;

  // issuer Name header (own window, like _header_at's 3 words)
  h = read_header(r, p, 0, tbs_end, 12);
  ok = ok && h.ok && h.tag == 0x30;
  int64_t issuer_off = p;
  int64_t issuer_len = h.hlen + h.clen;
  scan_issuer_cn(r, p + h.hlen, p + h.hlen + h.clen, ok, &s);
  p += h.hlen + h.clen;

  constexpr int W3 = 52;  // 13 words
  h = read_header(r, p, 0, tbs_end, W3);
  ok = ok && h.ok && h.tag == 0x30;
  int64_t dnb = h.hlen;
  Hdr nb = read_header(r, p, dnb, tbs_end, W3);
  ok = ok && nb.ok;
  int32_t nah = 0;
  ok = parse_time(r, p, dnb + nb.hlen + nb.clen, W3, &nah) && ok;
  int64_t d_subj = h.hlen + h.clen;
  Hdr subj = read_header(r, p, d_subj, tbs_end, W3);
  ok = ok && subj.ok && subj.tag == 0x30
      && ((p < 0 ? 0 : p) & 3) + d_subj + 5 <= W3;
  p += d_subj + subj.hlen + subj.clen;

  // SPKI header (own window)
  h = read_header(r, p, 0, tbs_end, 12);
  ok = ok && h.ok && h.tag == 0x30;
  int64_t spki_off = p;
  int64_t spki_len = h.hlen + h.clen;
  p += h.hlen + h.clen;

  constexpr int W4 = 52;
  int64_t a4 = (p < 0 ? 0 : p) & 3;
  d = 0;
  for (int round = 0; round < 2; ++round) {
    Hdr u = read_header(r, p, d, tbs_end, W4);
    bool is_uid = u.ok && (u.tag == 0x81 || u.tag == 0x82 || u.tag == 0xA1
                           || u.tag == 0xA2);
    if (is_uid) d += u.hlen + u.clen;
  }
  bool in_win = a4 + d + 11 <= W4;
  Hdr x = read_header(r, p, d, tbs_end, W4);
  bool has_ext = x.ok && x.tag == 0xA3 && p + d < tbs_end && in_win;
  // Undecodable trailing TBS bytes → exact host lane (see the
  // matching guard in der_kernel.parse_certs_rows).
  ok = ok && (has_ext || p + d >= tbs_end);
  int64_t de = d + x.hlen;
  Hdr el = read_header(r, p, de, tbs_end, W4);
  bool ext_listed = has_ext && el.ok && el.tag == 0x30;
  if (has_ext) ok = ok && el.ok && el.tag == 0x30;
  int64_t ext_off = p + de + el.hlen;
  int64_t ext_end = ext_listed ? p + de + el.hlen + el.clen : 0;
  ok = scan_extensions(r, ext_off, ext_end, ok, &s) && ok;

  s.ok = ok ? 1 : 0;
  if (ok) {
    s.serial_off = (int32_t)serial_off;
    s.serial_len = (int32_t)serial_len;
    s.not_after_hour = nah;
    s.issuer_off = (int32_t)issuer_off;
    s.issuer_len = (int32_t)issuer_len;
    s.spki_off = (int32_t)spki_off;
    s.spki_len = (int32_t)spki_len;
  } else {
    // Lane goes back through the device walker (or the exact host
    // lane) — zero every field like parse_certs_rows' jnp.where(ok, .)
    // masking, so callers can't consume half-extracted values.
    s = Sidecar{};
  }
  return s;
}

}  // namespace walker

extern "C" {

// Per-entry pre-parsed identity sidecars for a packed [n, pad_len]
// batch (the rows ctmr_decode_entries/ctmr_pack_ders produce). Lanes
// with length[i] == 0 come back ok=0. All output arrays length n.
void ctmr_extract_sidecars(
    int64_t n,
    const uint8_t* data, int64_t pad_len, const int32_t* length,
    uint8_t* ok,
    int32_t* serial_off, int32_t* serial_len,
    int32_t* not_after_hour,
    uint8_t* is_ca, uint8_t* has_crldp,
    int32_t* cn_off, int32_t* cn_len,
    int32_t* issuer_off, int32_t* issuer_len,
    int32_t* spki_off, int32_t* spki_len,
    int32_t* crldp_off, int32_t* crldp_len) {
  for (int64_t i = 0; i < n; ++i) {
    walker::Sidecar s =
        walker::extract_one(data + i * pad_len, pad_len, length[i]);
    ok[i] = s.ok;
    serial_off[i] = s.serial_off;
    serial_len[i] = s.serial_len;
    not_after_hour[i] = s.not_after_hour;
    is_ca[i] = s.is_ca;
    has_crldp[i] = s.has_crldp;
    cn_off[i] = s.cn_off;
    cn_len[i] = s.cn_len;
    issuer_off[i] = s.issuer_off;
    issuer_len[i] = s.issuer_len;
    spki_off[i] = s.spki_off;
    spki_len[i] = s.spki_len;
    crldp_off[i] = s.crldp_off;
    crldp_len[i] = s.crldp_len;
  }
}

}  // extern "C"

// Multi-threaded entry point: splits the batch into `threads`
// contiguous lane ranges (chunk t = lanes [n*t/T, n*(t+1)/T)) and runs
// the serial function above on each range through the persistent
// worker pool. Every per-lane output is written by exactly one chunk,
// so the sidecars are BIT-IDENTICAL to the serial pass.
extern "C" {

void ctmr_extract_sidecars_mt(
    int64_t n,
    const uint8_t* data, int64_t pad_len, const int32_t* length,
    uint8_t* ok,
    int32_t* serial_off, int32_t* serial_len,
    int32_t* not_after_hour,
    uint8_t* is_ca, uint8_t* has_crldp,
    int32_t* cn_off, int32_t* cn_len,
    int32_t* issuer_off, int32_t* issuer_len,
    int32_t* spki_off, int32_t* spki_len,
    int32_t* crldp_off, int32_t* crldp_len,
    int64_t threads) {
  if (n <= 0) return;
  int T = (int)threads;
  if (T < 1) T = 1;
  if ((int64_t)T > n) T = (int)n;
  pool::WorkerPool::get().run(T, T, [&](int t) {
    int64_t lo = n * t / T, hi = n * (t + 1) / T;
    ctmr_extract_sidecars(
        hi - lo, data + lo * pad_len, pad_len, length + lo,
        ok + lo, serial_off + lo, serial_len + lo, not_after_hour + lo,
        is_ca + lo, has_crldp + lo, cn_off + lo, cn_len + lo,
        issuer_off + lo, issuer_len + lo, spki_off + lo, spki_len + lo,
        crldp_off + lo, crldp_len + lo);
  });
}


int64_t ctmr_decode_entries_mt(
    int64_t n,
    const char* li_buf, const int64_t* li_off,
    const char* ed_buf, const int64_t* ed_off,
    int64_t pad_len,
    uint8_t* data, int32_t* length,
    int64_t* ts_ms, int32_t* entry_ty,
    uint8_t* issuer_buf, int64_t issuer_cap,
    int64_t* issuer_off, int32_t* issuer_len,
    int32_t* status,
    uint8_t* scratch, int64_t scratch_each,  // scratch holds T spans
    int64_t threads, int64_t* chunk_used /* [threads] out */) {
  if (n <= 0) return 0;
  int T = (int)threads;
  if (T < 1) T = 1;
  if ((int64_t)T > n) T = (int)n;
  int64_t iss_each = issuer_cap / T;
  pool::WorkerPool::get().run(T, T, [&](int t) {
    int64_t lo = n * t / T, hi = n * (t + 1) / T;
    int64_t base = (int64_t)t * iss_each;
    // li_off/ed_off entries are absolute offsets into the shared
    // buffers, so passing the shifted pointer re-bases lane indexing
    // while byte addressing stays global.
    int64_t used = ctmr_decode_entries(
        hi - lo, li_buf, li_off + lo, ed_buf, ed_off + lo, pad_len,
        data + lo * pad_len, length + lo, ts_ms + lo, entry_ty + lo,
        issuer_buf + base, iss_each, issuer_off + lo, issuer_len + lo,
        status + lo, scratch + (int64_t)t * scratch_each, scratch_each);
    if (used >= 0) {
      // Chunk-local spans → global offsets into the shared buffer.
      for (int64_t i = lo; i < hi; ++i) {
        if (issuer_len[i] > 0) issuer_off[i] += base;
      }
    }
    chunk_used[t] = used;
  });
  for (int t = T; t < (int)threads; ++t) chunk_used[t] = 0;
  int64_t total = 0;
  for (int t = 0; t < T; ++t) {
    if (chunk_used[t] < 0) return -1;  // a chunk's issuer slice overflowed
    total += chunk_used[t];
  }
  return total;
}

int64_t ctmr_pack_ders_mt(
    int64_t n,
    const uint8_t* blob, const int64_t* off,
    int64_t pad_len,
    uint8_t* data, int32_t* length, uint8_t* okflags,
    int64_t threads) {
  if (n <= 0) return 0;
  int T = (int)threads;
  if (T < 1) T = 1;
  if ((int64_t)T > n) T = (int)n;
  std::vector<int64_t> packed((size_t)T, 0);
  pool::WorkerPool::get().run(T, T, [&](int t) {
    int64_t lo = n * t / T, hi = n * (t + 1) / T;
    packed[(size_t)t] = ctmr_pack_ders(
        hi - lo, blob, off + lo, pad_len,
        data + lo * pad_len, length + lo, okflags + lo);
  });
  int64_t total = 0;
  for (int t = 0; t < T; ++t) total += packed[(size_t)t];
  return total;
}


}  // extern "C"
