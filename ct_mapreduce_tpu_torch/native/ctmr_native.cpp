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

// ---------------------------------------------------------------------
// Embedded-SCT extraction (copied from the JAX package's decoder): the
// host half of the signature verification lane. A PLAIN byte-wise DER
// walk (no word windows — the consumer is the host, not the device
// walker) that must stay in exact lockstep with the python mirror
// ct_mapreduce_tpu_torch/verify/sct.py: same TLV acceptance, same
// SCT-list bounds, same digest convention, same ok/fallback
// classification. Parity is pinned by tests/test_torch_verify.py's
// extraction fuzz.

namespace sctext {

// FIPS 180-4 SHA-256, incremental (the signed payload is streamed:
// header ‖ der-before-ext ‖ der-after-ext ‖ extensions).
struct Sha256 {
  uint32_t h[8];
  uint8_t buf[64];
  uint64_t total = 0;
  int fill = 0;
  Sha256() {
    static const uint32_t h0[8] = {
        0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
        0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    for (int i = 0; i < 8; ++i) h[i] = h0[i];
  }
  static uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
  }
  void block(const uint8_t* p) {
    static const uint32_t K[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
        0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
        0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
        0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
        0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
        0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
        0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
        0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
        0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
        0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
        0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int t = 0; t < 16; ++t)
      w[t] = (uint32_t(p[4 * t]) << 24) | (uint32_t(p[4 * t + 1]) << 16) |
             (uint32_t(p[4 * t + 2]) << 8) | uint32_t(p[4 * t + 3]);
    for (int t = 16; t < 64; ++t) {
      uint32_t s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3);
      uint32_t s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10);
      w[t] = w[t - 16] + s0 + w[t - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int t = 0; t < 64; ++t) {
      uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + s1 + ch + K[t] + w[t];
      uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = s0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }
  void update(const uint8_t* p, int64_t len) {
    total += (uint64_t)len;
    while (len > 0) {
      int take = 64 - fill;
      if (take > len) take = (int)len;
      for (int i = 0; i < take; ++i) buf[fill + i] = p[i];
      fill += take; p += take; len -= take;
      if (fill == 64) { block(buf); fill = 0; }
    }
  }
  void finish(uint8_t out[32]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t z = 0;
    while (fill != 56) update(&z, 1);
    uint8_t lb[8];
    for (int i = 0; i < 8; ++i) lb[i] = (uint8_t)(bits >> (56 - 8 * i));
    update(lb, 8);
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 4; ++j)
        out[4 * i + j] = (uint8_t)(h[i] >> (24 - 8 * j));
  }
};

struct Tlv {
  int tag = 0;
  int64_t off = 0, len = 0;
  bool ok = false;
};

// Mirror of sct.py::_tlv — definite lengths, 1..4 length octets.
inline Tlv tlv(const uint8_t* d, int64_t off, int64_t end) {
  Tlv t;
  if (off + 2 > end) return t;
  t.tag = d[off];
  int first = d[off + 1];
  int64_t p = off + 2;
  if (first < 0x80) {
    t.len = first;
  } else {
    int nb = first & 0x7f;
    if (nb == 0 || nb > 4 || p + nb > end) return t;
    int64_t v = 0;
    for (int i = 0; i < nb; ++i) v = (v << 8) | d[p + i];
    p += nb;
    t.len = v;
  }
  if (p + t.len > end) return t;
  t.off = p;
  t.ok = true;
  return t;
}

static const uint8_t kSctOid[10] = {0x2b, 0x06, 0x01, 0x04, 0x01,
                                    0xd6, 0x79, 0x02, 0x04, 0x02};
// 1.3.6.1.4.1.11129.2.4.3 — the precert poison (RFC 6962 §3.1),
// stripped alongside the SCT list during TBS reconstruction.
static const uint8_t kPoisonOid[10] = {0x2b, 0x06, 0x01, 0x04, 0x01,
                                       0xd6, 0x79, 0x02, 0x04, 0x03};

struct ExtWin {
  int64_t tlv_off = 0, tlv_end = 0, val_off = 0, val_end = 0;
  bool found = false;
};

// Mirror of sct.py::find_sct_extension.
inline ExtWin find_sct_extension(const uint8_t* d, int64_t n) {
  ExtWin w;
  Tlv t = tlv(d, 0, n);
  if (!t.ok || t.tag != 0x30) return w;
  Tlv tbs = tlv(d, t.off, t.off + t.len);
  if (!tbs.ok || tbs.tag != 0x30) return w;
  int64_t end = tbs.off + tbs.len;
  int64_t off = tbs.off;
  Tlv e = tlv(d, off, end);
  if (!e.ok) return w;
  if (e.tag == 0xa0) off = e.off + e.len;
  for (int i = 0; i < 6; ++i) {
    e = tlv(d, off, end);
    if (!e.ok) return w;
    off = e.off + e.len;
  }
  int64_t c_off = 0, c_len = 0;
  bool got = false;
  while (off < end) {
    e = tlv(d, off, end);
    if (!e.ok) return w;
    if (e.tag == 0xa3) { c_off = e.off; c_len = e.len; got = true; break; }
    off = e.off + e.len;
  }
  if (!got) return w;
  Tlv seq = tlv(d, c_off, c_off + c_len);
  if (!seq.ok || seq.tag != 0x30) return w;
  off = seq.off;
  end = seq.off + seq.len;
  while (off < end) {
    Tlv ext = tlv(d, off, end);
    if (!ext.ok || ext.tag != 0x30) return w;
    int64_t ext_end = ext.off + ext.len;
    Tlv oid = tlv(d, ext.off, ext_end);
    if (!oid.ok || oid.tag != 0x06) return w;
    bool is_sct = oid.len == 10 && std::memcmp(d + oid.off, kSctOid, 10) == 0;
    int64_t p = oid.off + oid.len;
    Tlv v = tlv(d, p, ext_end);
    if (v.ok && v.tag == 0x01) {  // critical BOOLEAN
      p = v.off + v.len;
      v = tlv(d, p, ext_end);
    }
    if (!v.ok || v.tag != 0x04) return w;
    if (is_sct) {
      w.tlv_off = off; w.tlv_end = ext_end;
      w.val_off = v.off; w.val_end = v.off + v.len;
      w.found = true;
      return w;
    }
    off = ext_end;
  }
  return w;
}

struct SctFields {
  const uint8_t* log_id = nullptr;
  int64_t timestamp = 0;
  const uint8_t* ext = nullptr;
  int64_t ext_len = 0;
  int hash_alg = 0, sig_alg = 0, version = 0;
  const uint8_t* sig = nullptr;
  int64_t sig_len = 0;
  bool ok = false;
};

// Mirror of sct.py::parse_sct_list (first SCT only).
inline SctFields parse_sct_list(const uint8_t* b, int64_t n) {
  SctFields f;
  if (n < 2) return f;
  int64_t total = ((int64_t)b[0] << 8) | b[1];
  if (total + 2 > n || total < 2) return f;
  int64_t n0 = ((int64_t)b[2] << 8) | b[3];
  int64_t p = 4;
  if (p + n0 > n || n0 < 47) return f;
  int64_t end = p + n0;
  f.version = b[p];
  f.log_id = b + p + 1;
  f.timestamp = 0;
  for (int i = 0; i < 8; ++i)
    f.timestamp = (f.timestamp << 8) | b[p + 33 + i];
  f.ext_len = ((int64_t)b[p + 41] << 8) | b[p + 42];
  int64_t q = p + 43;
  if (q + f.ext_len + 4 > end) return f;
  f.ext = b + q;
  q += f.ext_len;
  f.hash_alg = b[q];
  f.sig_alg = b[q + 1];
  int64_t sl = ((int64_t)b[q + 2] << 8) | b[q + 3];
  q += 4;
  if (q + sl != end) return f;
  f.sig = b + q;
  f.sig_len = sl;
  f.ok = true;
  return f;
}

// Mirror of sct.py::parse_ecdsa_sig with max_bytes = 32: big-endian
// 32-byte outputs, or false (fallback lane). Staged through locals —
// the python parser accepts or rejects the whole signature at once,
// so a failure after r parsed must leave r_out untouched (partial
// writes would diverge from the mirror on fallback lanes).
inline bool parse_ecdsa_sig32(const uint8_t* s, int64_t n,
                              uint8_t* r_out, uint8_t* s_out) {
  Tlv seq = tlv(s, 0, n);
  if (!seq.ok || seq.tag != 0x30 || seq.off + seq.len != n) return false;
  int64_t off = seq.off, end = seq.off + seq.len;
  uint8_t vals[2][32];
  for (int k = 0; k < 2; ++k) {
    Tlv v = tlv(s, off, end);
    if (!v.ok || v.tag != 0x02 || v.len < 1) return false;
    int64_t a = v.off, b = v.off + v.len;
    // python: content.lstrip(b"\x00") or b"\x00" — strip every
    // leading zero but keep one byte for the all-zero value.
    while (a < b - 1 && s[a] == 0) ++a;
    int64_t w = b - a;
    if (w > 32) return false;
    for (int i = 0; i < 32; ++i) vals[k][i] = 0;
    for (int64_t i = 0; i < w; ++i) vals[k][32 - w + i] = s[a + i];
    off = v.off + v.len;
  }
  if (off != end) return false;
  std::memcpy(r_out, vals[0], 32);
  std::memcpy(s_out, vals[1], 32);
  return true;
}

// Minimal-DER header (mirror of sct.py::_wrap_tlv): writes tag +
// length octets into out (<= 5 bytes), returns the header size.
inline int wrap_hdr(int tag, int64_t len, uint8_t* out) {
  out[0] = (uint8_t)tag;
  if (len < 0x80) { out[1] = (uint8_t)len; return 2; }
  if (len < 0x100) { out[1] = 0x81; out[2] = (uint8_t)len; return 3; }
  if (len < 0x10000) {
    out[1] = 0x82; out[2] = (uint8_t)(len >> 8); out[3] = (uint8_t)len;
    return 4;
  }
  out[1] = 0x83; out[2] = (uint8_t)(len >> 16);
  out[3] = (uint8_t)(len >> 8); out[4] = (uint8_t)len;
  return 5;
}

inline bool strip_oid(const uint8_t* d, const Tlv& oid) {
  return oid.len == 10 &&
         (std::memcmp(d + oid.off, kSctOid, 10) == 0 ||
          std::memcmp(d + oid.off, kPoisonOid, 10) == 0);
}

// RFC 6962 §3.2 signed payload, streamed (mirror of sct.py::
// sct_digest over reconstruct_precert_tbs, bit-identical — no
// materialized TBS buffer): header ‖ issuer_key_hash ‖ len3(tbs') ‖
// tbs' ‖ ext_len ‖ ext, where tbs' re-encodes the TBS with every
// SCT/poison extension removed and minimal lengths throughout.
// Returns false when the certificate doesn't parse to the extractor's
// acceptance (the caller then reports the lane as SCT_NONE, matching
// the python mirror).
inline bool digest_precert(const uint8_t* der, int64_t n,
                           const SctFields& f, const uint8_t* ikh,
                           uint8_t* out32) {
  Tlv cert = tlv(der, 0, n);
  if (!cert.ok || cert.tag != 0x30) return false;
  Tlv tbs = tlv(der, cert.off, cert.off + cert.len);
  if (!tbs.ok || tbs.tag != 0x30) return false;
  int64_t tbs_end = tbs.off + tbs.len;
  int64_t off = tbs.off;
  Tlv e = tlv(der, off, tbs_end);
  if (!e.ok) return false;
  if (e.tag == 0xa0) off = e.off + e.len;
  for (int i = 0; i < 6; ++i) {
    e = tlv(der, off, tbs_end);
    if (!e.ok) return false;
    off = e.off + e.len;
  }
  int64_t a3_off = -1, a3_end = 0, seq_off = 0, seq_len = 0;
  while (off < tbs_end) {
    e = tlv(der, off, tbs_end);
    if (!e.ok) return false;
    if (e.tag == 0xa3) {
      a3_off = off;
      a3_end = e.off + e.len;
      Tlv seq = tlv(der, e.off, a3_end);
      if (!seq.ok || seq.tag != 0x30) return false;
      seq_off = seq.off;
      seq_len = seq.len;
      break;
    }
    off = e.off + e.len;
  }
  // Pass 1: surviving extensions content length.
  int64_t kept_len = 0;
  if (a3_off >= 0) {
    int64_t p = seq_off, p_end = seq_off + seq_len;
    while (p < p_end) {
      Tlv ext = tlv(der, p, p_end);
      if (!ext.ok || ext.tag != 0x30) return false;
      int64_t ext_end = ext.off + ext.len;
      Tlv oid = tlv(der, ext.off, ext_end);
      if (!oid.ok || oid.tag != 0x06) return false;
      if (!strip_oid(der, oid)) kept_len += ext_end - p;
      p = ext_end;
    }
  }
  uint8_t seq_hdr[5], a3_hdr[5], tbs_hdr[5];
  int seq_hl = 0, a3_hl = 0;
  int64_t a3_total = 0;
  if (a3_off >= 0 && kept_len > 0) {
    seq_hl = wrap_hdr(0x30, kept_len, seq_hdr);
    a3_hl = wrap_hdr(0xa3, seq_hl + kept_len, a3_hdr);
    a3_total = a3_hl + seq_hl + kept_len;
  }
  int64_t content_len =
      a3_off >= 0
          ? (a3_off - tbs.off) + a3_total + (tbs_end - a3_end)
          : tbs.len;
  int tbs_hl = wrap_hdr(0x30, content_len, tbs_hdr);
  int64_t tbs_total = tbs_hl + content_len;

  Sha256 sha;
  uint8_t hdr[12];
  hdr[0] = 0; hdr[1] = 0;
  for (int j = 0; j < 8; ++j)
    hdr[2 + j] = (uint8_t)((uint64_t)f.timestamp >> (56 - 8 * j));
  hdr[10] = 0; hdr[11] = 1;
  sha.update(hdr, 12);
  sha.update(ikh, 32);
  uint8_t l3[3] = {(uint8_t)(tbs_total >> 16), (uint8_t)(tbs_total >> 8),
                   (uint8_t)tbs_total};
  sha.update(l3, 3);
  sha.update(tbs_hdr, tbs_hl);
  if (a3_off >= 0) {
    sha.update(der + tbs.off, a3_off - tbs.off);
    if (kept_len > 0) {
      sha.update(a3_hdr, a3_hl);
      sha.update(seq_hdr, seq_hl);
      // Pass 2: stream the surviving extension TLVs.
      int64_t p = seq_off, p_end = seq_off + seq_len;
      while (p < p_end) {
        Tlv ext = tlv(der, p, p_end);
        int64_t ext_end = ext.off + ext.len;
        Tlv oid = tlv(der, ext.off, ext_end);
        if (!strip_oid(der, oid)) sha.update(der + p, ext_end - p);
        p = ext_end;
      }
    }
    sha.update(der + a3_end, tbs_end - a3_end);
  } else {
    sha.update(der + tbs.off, tbs.len);
  }
  uint8_t el[2] = {(uint8_t)(f.ext_len >> 8), (uint8_t)f.ext_len};
  sha.update(el, 2);
  sha.update(f.ext, f.ext_len);
  sha.finish(out32);
  return true;
}

}  // namespace sctext

extern "C" {

// Embedded-SCT tuples for a packed row batch: status (0 none /
// 1 device-ready P-256 / 2 host-fallback), the RFC 6962 precert
// digest (reconstructed TBS + per-lane issuer_key_hash), log id,
// timestamp, and big-endian r/s for status-1 lanes. Keep in lockstep
// with ct_mapreduce_tpu_torch/verify/sct.py (extract_sct_lane).
// issuer_key_hash: [n, 32] per-lane SHA-256(issuer SPKI), or null
// (every lane hashes as all-zero — no issuer chain).
void ctmr_extract_scts_v2(
    int64_t n,
    const uint8_t* data, int64_t pad_len,
    const int32_t* length,
    const uint8_t* issuer_key_hash,  // [n, 32] or null
    uint8_t* ok,
    uint8_t* digest,      // [n, 32]
    uint8_t* log_id,      // [n, 32]
    int64_t* timestamp_ms,
    uint8_t* r_out,       // [n, 32]
    uint8_t* s_out,       // [n, 32]
    uint8_t* hash_alg,
    uint8_t* sig_alg) {
  static const uint8_t kZeroIkh[32] = {0};
  for (int64_t i = 0; i < n; ++i) {
    ok[i] = 0;
    int64_t len = length[i];
    if (len <= 0 || len > pad_len) continue;
    const uint8_t* der = data + i * pad_len;
    sctext::ExtWin w = sctext::find_sct_extension(der, len);
    if (!w.found) continue;
    sctext::SctFields f =
        sctext::parse_sct_list(der + w.val_off, w.val_end - w.val_off);
    if (!f.ok) continue;
    const uint8_t* ikh =
        issuer_key_hash ? issuer_key_hash + i * 32 : kZeroIkh;
    if (!sctext::digest_precert(der, len, f, ikh, digest + i * 32))
      continue;
    for (int j = 0; j < 32; ++j) log_id[i * 32 + j] = f.log_id[j];
    timestamp_ms[i] = f.timestamp;
    hash_alg[i] = (uint8_t)f.hash_alg;
    sig_alg[i] = (uint8_t)f.sig_alg;
    if (f.version != 0 || f.hash_alg != 4 || f.sig_alg != 3) {
      ok[i] = 2;
      continue;
    }
    if (!sctext::parse_ecdsa_sig32(f.sig, f.sig_len, r_out + i * 32,
                                   s_out + i * 32)) {
      ok[i] = 2;
      continue;
    }
    ok[i] = 1;
  }
}

void ctmr_extract_scts_v2_mt(
    int64_t n,
    const uint8_t* data, int64_t pad_len,
    const int32_t* length,
    const uint8_t* issuer_key_hash,
    uint8_t* ok, uint8_t* digest, uint8_t* log_id,
    int64_t* timestamp_ms, uint8_t* r_out, uint8_t* s_out,
    uint8_t* hash_alg, uint8_t* sig_alg,
    int64_t threads) {
  if (n <= 0) return;
  int T = (int)threads;
  if (T < 1) T = 1;
  if ((int64_t)T > n) T = (int)n;
  pool::WorkerPool::get().run(T, T, [&](int t) {
    int64_t lo = n * t / T, hi = n * (t + 1) / T;
    ctmr_extract_scts_v2(
        hi - lo, data + lo * pad_len, pad_len, length + lo,
        issuer_key_hash ? issuer_key_hash + lo * 32 : nullptr,
        ok + lo, digest + lo * 32, log_id + lo * 32, timestamp_ms + lo,
        r_out + lo * 32, s_out + lo * 32, hash_alg + lo, sig_alg + lo);
  });
}

}  // extern "C"
