// Native host entropy decoder: restart-segment-parallel Huffman scan decode.
//
// C++ replacement for the hot CPU loop of the engine (the role of
// xjpeg_decode_scan, xjpeg.c:449-632, reimplemented from scratch):
// decodes the entropy-coded segments of one baseline JPEG scan into dense
// per-component int16 coefficient tensors in natural (raster) order on the
// MCU-aligned block grid -- exactly the layout jax.device_put consumes.
//
// Differences from the reference's design, driven by the TPU engine:
//  * Restart segments are decoded IN PARALLEL on a thread pool (the
//    reference decodes strictly serially and uses RSTn only for
//    validation).  Segment byte spans come from the parser's marker walk
//    (xjpeg_scan_markers below); each segment resets its own bit reader and
//    DC predictors per the spec, so decode order is free.
//  * Full-width 16-bit Huffman LUT per table (symbol+length resolved in
//    one lookup) instead of an 8-bit prefix table with a maxcode
//    fallback walk (xjpeg.h:52-63) -- 128 KiB/table is nothing on a host
//    core and removes the slow path entirely.
//  * Byte destuffing (0xFF00) is handled inline by the bit reader.
//
// Exposed as a C ABI for ctypes; no external dependencies.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxComps = 4;
constexpr int kLutBits = 16;
constexpr int kLutSize = 1 << kLutBits;

// Zig-zag index -> raster index (generated by diagonal walk, cf. ops/zigzag.py).
struct ZigzagTable {
  uint8_t zz[64];
  ZigzagTable() {
    int k = 0;
    for (int s = 0; s < 15; ++s) {
      int r_lo = s < 8 ? 0 : s - 7;
      int r_hi = s < 8 ? s : 7;
      if (s % 2 == 0) {
        for (int r = r_hi; r >= r_lo; --r) zz[k++] = uint8_t(r * 8 + (s - r));
      } else {
        for (int r = r_lo; r <= r_hi; ++r) zz[k++] = uint8_t(r * 8 + (s - r));
      }
    }
  }
};
const ZigzagTable kZigzag;

struct HuffLut {
  // value = (symbol << 8) | code_length; length 0 marks invalid.
  std::vector<uint16_t> lut;
  // Two-level decode: codes of length <=8 (the overwhelming majority in
  // real streams) resolve from this 512-byte table; 0 means "look in
  // lut".  Measured NEUTRAL on this host (the decode loops are
  // dependency-chain-bound, not LUT-cache-bound) -- kept because it
  // shrinks the hot working set for the threaded many-segment decode,
  // where four tables' full LUTs would otherwise contend for L2.
  uint16_t fast[256];
  bool valid = false;

  inline uint16_t decode(uint32_t window16) const {
    const uint16_t e = fast[window16 >> 8];
    return e ? e : lut[window16];
  }

  // counts: 16 bytes; symbols: up to 256 bytes.
  bool build(const uint8_t* counts, const uint8_t* symbols) {
    lut.assign(kLutSize, 0);
    uint32_t code = 0;
    int si = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < counts[len - 1]; ++i) {
        uint32_t lo = code << (kLutBits - len);
        uint32_t hi = lo + (1u << (kLutBits - len));
        if (hi > uint32_t(kLutSize)) return false;  // over-subscribed
        uint16_t entry = uint16_t((symbols[si] << 8) | len);
        for (uint32_t w = lo; w < hi; ++w) lut[w] = entry;
        ++code;
        ++si;
      }
      code <<= 1;
    }
    for (uint32_t p = 0; p < 256; ++p) {
      const uint16_t e = lut[p << 8];
      fast[p] = (e & 0xFF) != 0 && (e & 0xFF) <= 8 ? e : 0;
    }
    valid = true;
    return true;
  }
};

// MSB-first bit reader with inline 0xFF00 destuffing and 1-padding at EOF.
class BitReader {
 public:
  BitReader(const uint8_t* data, int64_t len) : data_(data), len_(len) {}

  inline uint32_t peek16() {
    while (nbits_ < 16) refill_byte();
    return uint32_t((acc_ >> (nbits_ - 16)) & 0xFFFF);
  }

  inline void skip(int n) { nbits_ -= n; }

  inline int32_t get_bits(int n) {
    if (n == 0) return 0;
    while (nbits_ < n) refill_byte();
    nbits_ -= n;
    return int32_t((acc_ >> nbits_) & ((1u << n) - 1));
  }

  inline void skip_bits(int n) {
    while (nbits_ < n) refill_byte();
    nbits_ -= n;
  }

  // Bits consumed so far, counted in the DESTUFFED stream (stuffing zero
  // bytes feed no bits).  Exact as long as no EOF 1-padding byte has been
  // consumed -- true at every mid-stream MCU boundary.
  inline int64_t bits_consumed() const { return fed_ * 8 - nbits_; }

 private:
  inline void refill_byte() {
    uint32_t byte;
    if (pos_ < len_) {
      byte = data_[pos_++];
      if (byte == 0xFF) {
        // In a destuffed-correct stream the next byte is 0x00; markers
        // never appear inside a segment span (the parser split on them).
        if (pos_ < len_ && data_[pos_] == 0x00) ++pos_;
      }
    } else {
      byte = 0xFF;  // 1-padding past the end (spec F.2.2.5 behaviour)
    }
    acc_ = (acc_ << 8) | byte;
    nbits_ += 8;
    ++fed_;
  }

  const uint8_t* data_;
  int64_t len_;
  int64_t pos_ = 0;
  int64_t fed_ = 0;  // bytes fed into acc_ (excludes stuffing zeros)
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

inline int32_t huff_extend(int32_t v, int32_t size) {
  // EXTEND (spec F.2.2.1): sign-extend a size-bit amplitude.
  return (size && v < (1 << (size - 1))) ? v - (1 << size) + 1 : v;
}

struct ScanConfig {
  int32_t ncomps;
  int32_t nhmb;
  int32_t nvmb;
  int32_t restart_interval;  // 0 = none
  int32_t hsamp[kMaxComps];
  int32_t vsamp[kMaxComps];
  int32_t dc_tbl[kMaxComps];
  int32_t ac_tbl[kMaxComps];
  int32_t soa;  // 0: (vb, hb, 8, 8) blocks; 1: parity-split coefficient
  //               planes (vsamp, hsamp, 64, nvmb, nhmb) per component --
  //               the fused TPU pixel kernel's layout (ops/pixel_fused.py)
};

struct DecodeError {
  std::atomic<int32_t> code{0};
  void set(int32_t c) {
    int32_t expected = 0;
    code.compare_exchange_strong(expected, c);
  }
};

// Error codes (kept in sync with entropy_native.py).
enum {
  ERR_OK = 0,
  ERR_BAD_HUFF_TABLE = 1,
  ERR_INVALID_DC_CODE = 2,
  ERR_INVALID_AC_CODE = 3,
  ERR_BLOCK_OVERRUN = 4,
  ERR_BAD_PARAM = 5,
  ERR_PACK_OVERFLOW = 6,
};

// Decode MCUs [mcu_lo, mcu_hi) from one restart segment.
// Optional pack emission (the reference's minimal-upload stream,
// xjpeg.c:484-535): per block an absolute-DC entry (dc & 0xfff), then
// run<<12|value&0xfff per nonzero AC, 0x0000 as EOB (0xF000 for ZRL);
// the EOB entry is omitted when the block fills to position 63.
struct PackSink {
  uint16_t* out;        // this segment's local stream
  int32_t* offsets;     // per block (scan order within segment)
  int64_t n = 0;        // entries written
  int64_t block_i = 0;  // blocks seen
  int64_t cap = 0;
};

void decode_segment(const uint8_t* data, int64_t seg_start, int64_t seg_end,
                    const ScanConfig& cfg, const HuffLut* dc_luts,
                    const HuffLut* ac_luts, int16_t* const* coef_out,
                    PackSink* pack, int64_t mcu_lo,
                    int64_t mcu_hi, DecodeError* err) {
  BitReader br(data + seg_start, seg_end - seg_start);
  int32_t dc_pred[kMaxComps] = {0, 0, 0, 0};

  for (int64_t mcu = mcu_lo; mcu < mcu_hi; ++mcu) {
    const int64_t mby = mcu / cfg.nhmb;
    const int64_t mbx = mcu % cfg.nhmb;
    for (int ci = 0; ci < cfg.ncomps; ++ci) {
      const HuffLut& dl = dc_luts[cfg.dc_tbl[ci]];
      const HuffLut& al = ac_luts[cfg.ac_tbl[ci]];
      const int hs = cfg.hsamp[ci];
      const int vs = cfg.vsamp[ci];
      const int64_t hblocks = int64_t(cfg.nhmb) * hs;
      const int64_t pstride = int64_t(cfg.nvmb) * cfg.nhmb;  // soa plane
      for (int sby = 0; sby < vs; ++sby) {
        for (int sbx = 0; sbx < hs; ++sbx) {
          int16_t* block;
          int64_t stride;
          if (cfg.soa) {
            block = coef_out[ci] +
                    int64_t((sby * hs + sbx) * 64) * pstride +
                    mby * cfg.nhmb + mbx;
            stride = pstride;
          } else {
            block = coef_out[ci] +
                    ((mby * vs + sby) * hblocks + (mbx * hs + sbx)) * 64;
            stride = 1;
          }
          // DC
          uint16_t e = dl.decode(br.peek16());
          int len = e & 0xFF;
          if (len == 0) {
            err->set(ERR_INVALID_DC_CODE);
            return;
          }
          br.skip(len);
          int s = e >> 8;
          if (s > 15) {
            err->set(ERR_INVALID_DC_CODE);
            return;
          }
          dc_pred[ci] += huff_extend(br.get_bits(s), s);
          block[0] = int16_t(dc_pred[ci]);
          // (position 0 is the same in both layouts)
          if (pack) {
            if (pack->n >= pack->cap) { err->set(ERR_PACK_OVERFLOW); return; }
            pack->offsets[pack->block_i++] = int32_t(pack->n);
            pack->out[pack->n++] = uint16_t(dc_pred[ci] & 0xFFF);
          }
          // AC
          int k = 0;
          while (k < 63) {
            e = al.decode(br.peek16());
            len = e & 0xFF;
            if (len == 0) {
              err->set(ERR_INVALID_AC_CODE);
              return;
            }
            br.skip(len);
            const int rs = e >> 8;
            if (rs == 0) {  // EOB
              if (pack) {
                if (pack->n >= pack->cap) { err->set(ERR_PACK_OVERFLOW); return; }
                pack->out[pack->n++] = 0;
              }
              break;
            }
            const int run = rs >> 4;
            const int size = rs & 0x0F;
            k += run + 1;  // ZRL (15,0) advances 16 in total
            if (size == 0) {
              if (run != 15 || k > 63) {
                err->set(ERR_INVALID_AC_CODE);
                return;
              }
              if (pack) {
                if (pack->n >= pack->cap) { err->set(ERR_PACK_OVERFLOW); return; }
                pack->out[pack->n++] = 0xF000;
              }
              continue;
            }
            if (k > 63) {
              err->set(ERR_BLOCK_OVERRUN);
              return;
            }
            const int32_t v = huff_extend(br.get_bits(size), size);
            block[kZigzag.zz[k] * stride] = int16_t(v);
            if (pack) {
              if (pack->n >= pack->cap) { err->set(ERR_PACK_OVERFLOW); return; }
              pack->out[pack->n++] =
                  uint16_t(((run & 0xF) << 12) | (v & 0xFFF));
            }
          }
        }
      }
    }
    if (err->code.load(std::memory_order_relaxed) != 0) return;
  }
}

}  // namespace

extern "C" {

// Decode a full baseline scan.
//
//   data, len            : the whole file buffer
//   seg_starts/ends, nseg: restart-segment byte spans (exclusive of RSTn)
//   huff_counts          : 8 x 16 bytes   (slot = class*4 + id)
//   huff_symbols         : 8 x 256 bytes
//   huff_present         : 8 bytes (0/1)
//   cfg                  : scan geometry
//   coef_out             : ncomps pointers; comp ci buffer holds
//                          (nvmb*vsamp) * (nhmb*hsamp) * 64 int16, zeroed
//   n_threads            : restart-parallel worker count (<=1 -> serial)
//
// Returns ERR_* (0 on success).
int32_t xjpeg_decode_scan(const uint8_t* data, int64_t len,
                          const int64_t* seg_starts, const int64_t* seg_ends,
                          int64_t nseg, const uint8_t* huff_counts,
                          const uint8_t* huff_symbols,
                          const uint8_t* huff_present, const ScanConfig* cfg,
                          int16_t* const* coef_out, int32_t n_threads) {
  if (!data || !cfg || cfg->ncomps < 1 || cfg->ncomps > kMaxComps || nseg < 1)
    return ERR_BAD_PARAM;
  (void)len;

  HuffLut dc_luts[4], ac_luts[4];
  for (int i = 0; i < 8; ++i) {
    if (!huff_present[i]) continue;
    HuffLut& t = (i < 4) ? dc_luts[i] : ac_luts[i - 4];
    if (!t.build(huff_counts + i * 16, huff_symbols + i * 256))
      return ERR_BAD_HUFF_TABLE;
  }
  for (int ci = 0; ci < cfg->ncomps; ++ci) {
    if (cfg->dc_tbl[ci] < 0 || cfg->dc_tbl[ci] > 3 ||
        !dc_luts[cfg->dc_tbl[ci]].valid)
      return ERR_BAD_HUFF_TABLE;
    if (cfg->ac_tbl[ci] < 0 || cfg->ac_tbl[ci] > 3 ||
        !ac_luts[cfg->ac_tbl[ci]].valid)
      return ERR_BAD_HUFF_TABLE;
  }

  const int64_t n_mcus = int64_t(cfg->nhmb) * cfg->nvmb;
  const int64_t interval =
      cfg->restart_interval > 0 ? cfg->restart_interval : n_mcus;

  DecodeError err;
  auto run_range = [&](int64_t seg_lo, int64_t seg_hi) {
    for (int64_t si = seg_lo; si < seg_hi; ++si) {
      if (err.code.load(std::memory_order_relaxed) != 0) return;
      const int64_t mcu_lo = si * interval;
      const int64_t mcu_hi = std::min((si + 1) * interval, n_mcus);
      if (mcu_lo >= n_mcus) return;
      decode_segment(data, seg_starts[si], seg_ends[si], *cfg, dc_luts,
                     ac_luts, coef_out, nullptr, mcu_lo, mcu_hi, &err);
    }
  };

  if (n_threads <= 1 || nseg == 1) {
    run_range(0, nseg);
  } else {
    const int workers = int(std::min<int64_t>(n_threads, nseg));
    std::vector<std::thread> pool;
    pool.reserve(workers);
    for (int w = 0; w < workers; ++w) {
      const int64_t lo = nseg * w / workers;
      const int64_t hi = nseg * (w + 1) / workers;
      pool.emplace_back(run_range, lo, hi);
    }
    for (auto& t : pool) t.join();
  }
  return err.code.load();
}

// Destuff + pack restart segments into the device stream byte matrix.
//
//   mat (may be NULL)    : nseg rows x row_bytes bytes, caller-allocated;
//                          each row gets its segment's destuffed bytes,
//                          1-padded (0xFF) to row_bytes.  Rows beyond nseg
//                          are the caller's business.
//   out_max_destuffed    : if non-NULL, receives the max destuffed segment
//                          length in bytes (use with mat=NULL to size rows).
//
// Returns ERR_* (0 on success).
int32_t xjpeg_pack_streams(const uint8_t* data, int64_t len,
                           const int64_t* seg_starts, const int64_t* seg_ends,
                           int64_t nseg, int64_t row_bytes, uint8_t* mat,
                           int64_t* out_max_destuffed, int32_t n_threads) {
  if (!data || !seg_starts || !seg_ends || nseg < 1) return ERR_BAD_PARAM;
  for (int64_t si = 0; si < nseg; ++si) {
    if (seg_starts[si] < 0 || seg_ends[si] > len ||
        seg_starts[si] > seg_ends[si])
      return ERR_BAD_PARAM;
  }
  std::atomic<int64_t> maxlen{0};
  auto run_range = [&](int64_t lo, int64_t hi) {
    int64_t local_max = 0;
    for (int64_t si = lo; si < hi; ++si) {
      const uint8_t* p = data + seg_starts[si];
      const uint8_t* e = data + seg_ends[si];
      // The destuffed length is always tracked (even when writing), so a
      // caller packing into a pre-sized matrix in ONE pass can verify
      // after the fact that no row truncated -- the serving loop's
      // pinned-nw fast path (host/segments.py build_plan(nw=...)).
      uint8_t* o = mat ? mat + si * row_bytes : nullptr;
      uint8_t* const oend = o ? o + row_bytes : nullptr;
      int64_t n = 0;
      while (p < e) {
        const uint8_t b = *p++;
        if (o < oend) *o++ = b;
        ++n;
        if (b == 0xFF && p < e && *p == 0x00) ++p;
      }
      while (o < oend) *o++ = 0xFF;
      local_max = std::max(local_max, n);
    }
    int64_t cur = maxlen.load(std::memory_order_relaxed);
    while (local_max > cur &&
           !maxlen.compare_exchange_weak(cur, local_max)) {
    }
  };
  if (n_threads <= 1 || nseg == 1) {
    run_range(0, nseg);
  } else {
    const int workers = int(std::min<int64_t>(n_threads, nseg));
    std::vector<std::thread> pool;
    pool.reserve(workers);
    for (int w = 0; w < workers; ++w) {
      const int64_t lo = nseg * w / workers;
      const int64_t hi = nseg * (w + 1) / workers;
      pool.emplace_back(run_range, lo, hi);
    }
    for (auto& t : pool) t.join();
  }
  if (out_max_destuffed) *out_max_destuffed = maxlen.load();
  return 0;
}

// Decode a full baseline scan AND emit the packed (run,value) stream.
//
//   pack_out      : (nseg, max_entries) uint16, caller-zeroed or not
//   entry_counts  : (nseg,) int32 -- entries written per segment
//   block_offsets : (nseg, blocks_per_seg) int32 -- per in-scan-order
//                   block, its DC entry's offset within the segment's
//                   local stream (host stitches global indexes)
//   max_entries   : per-segment stream capacity
//
// Coefficients are written exactly as xjpeg_decode_scan.
int32_t xjpeg_decode_scan_pack(
    const uint8_t* data, int64_t len, const int64_t* seg_starts,
    const int64_t* seg_ends, int64_t nseg, const uint8_t* huff_counts,
    const uint8_t* huff_symbols, const uint8_t* huff_present,
    const ScanConfig* cfg, int16_t* const* coef_out, uint16_t* pack_out,
    int32_t* entry_counts, int32_t* block_offsets, int64_t max_entries,
    int64_t blocks_per_seg, int32_t n_threads) {
  if (!data || !cfg || cfg->ncomps < 1 || cfg->ncomps > kMaxComps ||
      nseg < 1 || !pack_out || !entry_counts || !block_offsets)
    return ERR_BAD_PARAM;
  (void)len;

  HuffLut dc_luts[4], ac_luts[4];
  for (int i = 0; i < 8; ++i) {
    if (!huff_present[i]) continue;
    HuffLut& t = (i < 4) ? dc_luts[i] : ac_luts[i - 4];
    if (!t.build(huff_counts + i * 16, huff_symbols + i * 256))
      return ERR_BAD_HUFF_TABLE;
  }
  for (int ci = 0; ci < cfg->ncomps; ++ci) {
    if (cfg->dc_tbl[ci] < 0 || cfg->dc_tbl[ci] > 3 ||
        !dc_luts[cfg->dc_tbl[ci]].valid)
      return ERR_BAD_HUFF_TABLE;
    if (cfg->ac_tbl[ci] < 0 || cfg->ac_tbl[ci] > 3 ||
        !ac_luts[cfg->ac_tbl[ci]].valid)
      return ERR_BAD_HUFF_TABLE;
  }

  const int64_t n_mcus = int64_t(cfg->nhmb) * cfg->nvmb;
  const int64_t interval =
      cfg->restart_interval > 0 ? cfg->restart_interval : n_mcus;

  DecodeError err;
  auto run_range = [&](int64_t seg_lo, int64_t seg_hi) {
    for (int64_t si = seg_lo; si < seg_hi; ++si) {
      if (err.code.load(std::memory_order_relaxed) != 0) return;
      const int64_t mcu_lo = si * interval;
      const int64_t mcu_hi = std::min((si + 1) * interval, n_mcus);
      if (mcu_lo >= n_mcus) return;
      PackSink sink;
      sink.out = pack_out + si * max_entries;
      sink.offsets = block_offsets + si * blocks_per_seg;
      sink.cap = max_entries;
      decode_segment(data, seg_starts[si], seg_ends[si], *cfg, dc_luts,
                     ac_luts, coef_out, &sink, mcu_lo, mcu_hi, &err);
      entry_counts[si] = int32_t(sink.n);
    }
  };

  if (n_threads <= 1 || nseg == 1) {
    run_range(0, nseg);
  } else {
    const int workers = int(std::min<int64_t>(n_threads, nseg));
    std::vector<std::thread> pool;
    pool.reserve(workers);
    for (int w = 0; w < workers; ++w) {
      const int64_t lo = nseg * w / workers;
      const int64_t hi = nseg * (w + 1) / workers;
      pool.emplace_back(run_range, lo, hi);
    }
    for (auto& t : pool) t.join();
  }
  return err.code.load();
}

// Index scan for DRI-less streams: Huffman-walk the single entropy span
// decoding code LENGTHS only (no coefficient stores, no IDCT bookkeeping)
// and record, at every ``interval``-th MCU boundary, the bit offset into
// the DESTUFFED stream plus the running DC predictors.  Those boundaries
// define pseudo-restart-segments the TPU kernel decodes in parallel: the
// packer below re-aligns each one to bit 0, and the device adds the DC
// base back after decode (DC prediction does not reset at pseudo
// boundaries, unlike real RSTn segments, xjpeg.c:613-618).
//
//   out_bitpos : (nseg,) int64 -- destuffed-stream bit offset of pseudo
//                segment j (j*interval MCUs in; slot 0 is 0)
//   out_dc     : (nseg, ncomps) int32 -- DC predictor values entering
//                pseudo segment j (slot 0 is zeros)
//   out_end    : int64 -- destuffed bit length consumed by the whole scan
//
// Returns ERR_* (0 on success).  Serial by nature (the stream is one
// dependency chain); the payoff is that the full per-coefficient decode
// moves to the accelerator.
//
// Hot-path design: the span is destuffed ONCE up front so the reader
// below runs on clean bytes, and each symbol's refill is ONE unaligned
// 8-byte big-endian load (no serial per-byte shift-or chain).  Measured
// on the 1080p 4:2:0 q85 serving scan: 10.1 -> 8.3 ms.  The walk is
// dependency-chain/branch-bound, not cache-bound: removing the per-byte
// stuffing test alone and adding the two-level LUT were each neutral;
// only shortening the refill chain moved the number.
namespace {
class DestuffedBitReader {
 public:
  // ``data`` must carry >=8 readable bytes of 0xFF padding past ``len``
  // (F.2.2.5 1-padding): ensure() feeds the accumulator with ONE
  // unaligned 8-byte big-endian load instead of a serial per-byte
  // shift-or chain.
  DestuffedBitReader(const uint8_t* data, int64_t len)
      : data_(data), len_(len) {}

  inline void ensure(int n) {
    if (nbits_ < n) {
      uint64_t chunk;
      // Clamp the load for corrupt streams that decode far into the
      // 1-padding: bytes at [len_, len_+8) are 0xFF, the same values
      // conceptual infinite padding would feed.
      std::memcpy(&chunk, data_ + (pos_ < len_ ? pos_ : len_), 8);
      chunk = __builtin_bswap64(chunk);
      // 4..7 bytes whenever n <= 32: shifts stay < 64 (no UB at
      // nbits_ == 0) and the accumulator tops up to >= 32 bits.
      const int take = (63 - nbits_) >> 3;
      acc_ = (acc_ << (8 * take)) | (chunk >> (64 - 8 * take));
      pos_ += take;
      nbits_ += 8 * take;
    }
  }

  inline uint32_t peek16() {
    return uint32_t((acc_ >> (nbits_ - 16)) & 0xFFFF);
  }

  inline void skip(int n) { nbits_ -= n; }

  inline int32_t get_bits(int n) {
    if (n == 0) return 0;
    nbits_ -= n;
    return int32_t((acc_ >> nbits_) & ((1u << n) - 1));
  }

  // Exact while no padding byte has been consumed (true at every
  // mid-stream MCU boundary); eagerly-fed unconsumed bits stay in acc_.
  inline int64_t bits_consumed() const { return pos_ * 8 - nbits_; }

 private:
  const uint8_t* data_;
  int64_t len_;
  int64_t pos_ = 0;
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

// Destuff [seg_start, seg_end) into ``clean`` (+8 bytes of 0xFF padding
// for the readers); returns the clean length WITHOUT padding.  Shared by
// the index scan, the bit packer and their fused form -- fusing them
// saves this pass running twice per frame on the serving path.
int64_t destuff_span(const uint8_t* data, int64_t seg_start, int64_t seg_end,
                     std::vector<uint8_t>& clean) {
  clean.reserve(seg_end - seg_start + 8);
  const uint8_t* p = data + seg_start;
  const uint8_t* e = data + seg_end;
  while (p < e) {
    const uint8_t b = *p++;
    clean.push_back(b);
    if (b == 0xFF && p < e && *p == 0x00) ++p;
  }
  const int64_t n = int64_t(clean.size());
  clean.resize(clean.size() + 8, 0xFF);
  return n;
}

// The serial length-only Huffman walk over an already-destuffed buffer.
int32_t index_scan_clean(const uint8_t* clean, int64_t clean_len,
                         const uint8_t* huff_counts,
                         const uint8_t* huff_symbols,
                         const uint8_t* huff_present, const ScanConfig* cfg,
                         int64_t interval, int64_t* out_bitpos,
                         int32_t* out_dc, int64_t* out_end) {
  HuffLut dc_luts[4], ac_luts[4];
  for (int i = 0; i < 8; ++i) {
    if (!huff_present[i]) continue;
    HuffLut& t = (i < 4) ? dc_luts[i] : ac_luts[i - 4];
    if (!t.build(huff_counts + i * 16, huff_symbols + i * 256))
      return ERR_BAD_HUFF_TABLE;
  }
  for (int ci = 0; ci < cfg->ncomps; ++ci) {
    if (cfg->dc_tbl[ci] < 0 || cfg->dc_tbl[ci] > 3 ||
        !dc_luts[cfg->dc_tbl[ci]].valid)
      return ERR_BAD_HUFF_TABLE;
    if (cfg->ac_tbl[ci] < 0 || cfg->ac_tbl[ci] > 3 ||
        !ac_luts[cfg->ac_tbl[ci]].valid)
      return ERR_BAD_HUFF_TABLE;
  }

  DestuffedBitReader br(clean, clean_len);
  int32_t dc_pred[kMaxComps] = {0, 0, 0, 0};
  const int64_t n_mcus = int64_t(cfg->nhmb) * cfg->nvmb;
  int64_t seg_i = 0;

  for (int64_t mcu = 0; mcu < n_mcus; ++mcu) {
    if (mcu % interval == 0) {
      out_bitpos[seg_i] = br.bits_consumed();
      for (int ci = 0; ci < cfg->ncomps; ++ci)
        out_dc[seg_i * cfg->ncomps + ci] = dc_pred[ci];
      ++seg_i;
    }
    for (int ci = 0; ci < cfg->ncomps; ++ci) {
      const HuffLut& dl = dc_luts[cfg->dc_tbl[ci]];
      const HuffLut& al = ac_luts[cfg->ac_tbl[ci]];
      const int nblk = cfg->hsamp[ci] * cfg->vsamp[ci];
      for (int b = 0; b < nblk; ++b) {
        br.ensure(31);  // DC code (<=16) + amplitude (<=15)
        uint16_t e = dl.decode(br.peek16());
        int clen = e & 0xFF;
        if (clen == 0) return ERR_INVALID_DC_CODE;
        br.skip(clen);
        const int s = e >> 8;
        if (s > 15) return ERR_INVALID_DC_CODE;
        dc_pred[ci] += huff_extend(br.get_bits(s), s);
        int k = 0;
        while (k < 63) {
          br.ensure(31);  // AC code (<=16) + skipped amplitude (<=15)
          e = al.decode(br.peek16());
          clen = e & 0xFF;
          if (clen == 0) return ERR_INVALID_AC_CODE;
          br.skip(clen);
          const int rs = e >> 8;
          if (rs == 0) break;  // EOB
          const int run = rs >> 4;
          const int size = rs & 0x0F;
          k += run + 1;
          if (size == 0) {
            if (run != 15 || k > 63) return ERR_INVALID_AC_CODE;
            continue;
          }
          if (k > 63) return ERR_BLOCK_OVERRUN;
          br.skip(size);  // amplitude value not needed
        }
      }
    }
  }
  if (out_end) *out_end = br.bits_consumed();
  return ERR_OK;
}

// Emit each pseudo segment's destuffed bytes LEFT-SHIFTED so its first
// entropy bit lands on bit 7 of row byte 0 (the kernel's bit readers
// always start bit-aligned, exactly like a real RSTn boundary).  Rows
// 1-pad (0xFF) past the segment's data per the F.2.2.5 padding contract.
// ``buf`` carries >= 8 bytes of 0xFF padding past ``dlen``.
void pack_rows_clean(const uint8_t* buf, int64_t dlen, const int64_t* bitpos,
                     int64_t nseg, int64_t end_bit, int64_t row_bytes,
                     uint8_t* mat, int32_t n_threads) {
  auto run_range = [&](int64_t lo, int64_t hi) {
    for (int64_t si = lo; si < hi; ++si) {
      const int64_t b0 = bitpos[si];
      const int64_t b1 = (si + 1 < nseg) ? bitpos[si + 1] : end_bit;
      if (b0 < 0 || b1 < b0) continue;
      const int64_t byte0 = b0 >> 3;
      const int r = int(b0 & 7);
      // Bytes needed to cover [b0, b1) after the shift, plus one so the
      // last partial byte's low bits come from real (or padding) data.
      const int64_t need =
          std::min(row_bytes, ((b1 - b0) + 7) / 8 + 1);
      uint8_t* out = mat + si * row_bytes;
      for (int64_t i = 0; i < need; ++i) {
        const int64_t q = byte0 + i;
        const uint8_t hi8 = q < dlen ? buf[q] : 0xFF;
        const uint8_t lo8 = (q + 1) < dlen ? buf[q + 1] : 0xFF;
        out[i] = r == 0 ? hi8 : uint8_t((hi8 << r) | (lo8 >> (8 - r)));
      }
      for (int64_t i = need; i < row_bytes; ++i) out[i] = 0xFF;
    }
  };
  if (n_threads <= 1 || nseg == 1) {
    run_range(0, nseg);
  } else {
    const int workers = int(std::min<int64_t>(n_threads, nseg));
    std::vector<std::thread> pool;
    pool.reserve(workers);
    for (int w = 0; w < workers; ++w) {
      const int64_t lo = nseg * w / workers;
      const int64_t hi = nseg * (w + 1) / workers;
      pool.emplace_back(run_range, lo, hi);
    }
    for (auto& t : pool) t.join();
  }
}
}  // namespace

int32_t xjpeg_index_scan(const uint8_t* data, int64_t len, int64_t seg_start,
                         int64_t seg_end, const uint8_t* huff_counts,
                         const uint8_t* huff_symbols,
                         const uint8_t* huff_present, const ScanConfig* cfg,
                         int64_t interval, int64_t* out_bitpos,
                         int32_t* out_dc, int64_t* out_end) {
  if (!data || !cfg || cfg->ncomps < 1 || cfg->ncomps > kMaxComps ||
      interval < 1 || !out_bitpos || !out_dc || seg_start < 0 ||
      seg_end > len || seg_start > seg_end)
    return ERR_BAD_PARAM;
  // Destuff once; the scan then reads clean bytes.  bits_consumed() is
  // thereby already in destuffed-bit space, which is the coordinate
  // system out_bitpos is defined in (and that pack_streams_bits slices).
  std::vector<uint8_t> clean;
  const int64_t clean_len = destuff_span(data, seg_start, seg_end, clean);
  return index_scan_clean(clean.data(), clean_len, huff_counts, huff_symbols,
                          huff_present, cfg, interval, out_bitpos, out_dc,
                          out_end);
}

int32_t xjpeg_pack_streams_bits(const uint8_t* data, int64_t len,
                                int64_t seg_start, int64_t seg_end,
                                const int64_t* bitpos, int64_t nseg,
                                int64_t end_bit, int64_t row_bytes,
                                uint8_t* mat, int32_t n_threads) {
  if (!data || !bitpos || nseg < 1 || !mat || seg_start < 0 ||
      seg_end > len || seg_start > seg_end)
    return ERR_BAD_PARAM;
  std::vector<uint8_t> buf;
  const int64_t dlen = destuff_span(data, seg_start, seg_end, buf);
  pack_rows_clean(buf.data(), dlen, bitpos, nseg, end_bit, row_bytes, mat,
                  n_threads);
  return ERR_OK;
}

// Fused scan + pack for the serving loop's pinned-row-width case: one
// destuff feeds both the serial length walk and the bit-aligned row
// emit (the split form destuffs the span twice per frame).  Fails with
// ERR_PACK_OVERFLOW if any pseudo segment needs more than row_bytes
// (callers rebuild without the pin, exactly like build_plan's nw hint).
int32_t xjpeg_index_scan_pack(const uint8_t* data, int64_t len,
                              int64_t seg_start, int64_t seg_end,
                              const uint8_t* huff_counts,
                              const uint8_t* huff_symbols,
                              const uint8_t* huff_present,
                              const ScanConfig* cfg, int64_t interval,
                              int64_t* out_bitpos, int32_t* out_dc,
                              int64_t* out_end, int64_t row_bytes,
                              uint8_t* mat, int32_t n_threads) {
  if (!data || !cfg || cfg->ncomps < 1 || cfg->ncomps > kMaxComps ||
      interval < 1 || !out_bitpos || !out_dc || !out_end || !mat ||
      row_bytes < 1 || seg_start < 0 || seg_end > len || seg_start > seg_end)
    return ERR_BAD_PARAM;
  std::vector<uint8_t> clean;
  const int64_t clean_len = destuff_span(data, seg_start, seg_end, clean);
  const int32_t rc =
      index_scan_clean(clean.data(), clean_len, huff_counts, huff_symbols,
                       huff_present, cfg, interval, out_bitpos, out_dc,
                       out_end);
  if (rc != ERR_OK) return rc;
  const int64_t n_mcus = int64_t(cfg->nhmb) * cfg->nvmb;
  const int64_t nseg = (n_mcus + interval - 1) / interval;
  for (int64_t si = 0; si < nseg; ++si) {
    const int64_t b1 = (si + 1 < nseg) ? out_bitpos[si + 1] : *out_end;
    // Same sizing contract as the unpinned path (_check_nw): data bytes
    // + shift tail, rounded to words, + 2 words of 0xFF refill slack.
    const int64_t need_bytes = (b1 - out_bitpos[si] + 7) / 8 + 1;
    if (((need_bytes + 3) / 4 + 2) * 4 > row_bytes) return ERR_PACK_OVERFLOW;
  }
  pack_rows_clean(clean.data(), clean_len, out_bitpos, nseg, *out_end,
                  row_bytes, mat, n_threads);
  return ERR_OK;
}

// The producer's two walks over a frame's entropy-coded bytes: the
// parser's marker walk (host/parser.py) and the device index scan's window
// rows (host/segments.py:build_spec_scan_input).  Both give what their
// numpy forms give, run with the interpreter lock released (ctypes.CDLL)
// and keep nothing between calls.  memchr finds each 0xFF; the bytes
// between two are neither looked at one by one nor, destuffing, copied
// one by one.
namespace {
// The destuffed bytes of [p, e) (less each 0x00 directly after a 0xFF), a
// piece at a time.
struct Destuffer {
  const uint8_t* p;
  const uint8_t* e;

  // The next ``n`` destuffed bytes into ``out``, 0xFF past the end;
  // returns how many came from the span.
  int64_t take(uint8_t* out, int64_t n) {
    int64_t k = 0;
    while (k < n && p < e) {
      const int64_t avail = std::min<int64_t>(n - k, e - p);
      const uint8_t* f =
          static_cast<const uint8_t*>(std::memchr(p, 0xFF, size_t(avail)));
      const int64_t run = f ? f + 1 - p : avail;  // up to and with the 0xFF
      std::memcpy(out + k, p, size_t(run));
      k += run;
      p += run;
      if (f && p < e && *p == 0x00) ++p;
    }
    std::memset(out + k, 0xFF, size_t(n - k));
    return k;
  }
};

constexpr int64_t kScanLanes = 1024;  // 8 sublanes x 128 lanes a batch
constexpr int64_t kLaneTile = 16;     // lanes a pass of the row writer
}  // namespace

// The marker walk of the entropy-coded data from ``start``: each 0xFF is
// stuffed (before 0x00), a fill byte (before 0xFF), a restart marker RSTn
// or the marker that ends the scan; a 0xFF as the last byte counts as
// neither stuffed nor a marker.
//
//   rst_pos : rst_cap int64, caller-allocated; receives the positions of
//             the RSTn before the ending marker, in order (those past
//             rst_cap are counted, not stored)
//   out[0]  : the number of those RSTn
//   out[1]  : the position of the ending marker, or len if there is none
//   out[2]  : the index of the first RSTn out of the modulo-8 sequence
//             RST0, RST1, ..., RST7, RST0, ..., or -1
//   out[3]  : that marker's n
//   out[4]  : the stuffed zeros before the ending marker (what a destuff
//             of the segments drops)
//
// Returns ERR_* (0 on success).
int32_t xjpeg_scan_markers(const uint8_t* data, int64_t len, int64_t start,
                           int64_t* rst_pos, int64_t rst_cap, int64_t* out) {
  if (!data || !out || start < 0 || start > len || rst_cap < 0 ||
      (rst_cap > 0 && !rst_pos))
    return ERR_BAD_PARAM;
  int64_t n_rst = 0, end_pos = len, bad = -1, bad_n = 0, stuffed = 0;
  const uint8_t* p = data + start;
  const uint8_t* const e = data + len;
  while (p < e) {
    const uint8_t* f =
        static_cast<const uint8_t*>(std::memchr(p, 0xFF, size_t(e - p)));
    if (!f || f + 1 >= e) break;
    const uint8_t m = f[1];
    if (m == 0x00) {
      ++stuffed;
      p = f + 2;
    } else if (m == 0xFF) {
      p = f + 1;
    } else if (m < 0xD0 || m > 0xD7) {
      end_pos = f - data;
      break;
    } else {
      if (n_rst < rst_cap) rst_pos[n_rst] = f - data;
      if (bad < 0 && int64_t(m - 0xD0) != (n_rst & 7)) {
        bad = n_rst;
        bad_n = m - 0xD0;
      }
      ++n_rst;
      p = f + 2;
    }
  }
  out[0] = n_rst;
  out[1] = end_pos;
  out[2] = bad;
  out[3] = bad_n;
  out[4] = stuffed;
  return ERR_OK;
}

// The device index scan's window rows of the segment [seg_start, seg_end):
// the segment destuffed and 0xFF-padded, read as big-endian 32-bit words;
// lane j = (b*8 + s)*128 + l reads words j*spw .. j*spw + nws - 1, word w
// of them at out[((b*nws + w)*8 + s)*128 + l].  ``out`` holds
// bs*nws*1024 int32, caller-allocated.  Returns the destuffed length, or
// -1 on bad parameters or a segment longer than the bs*1024 lanes' strides.
//
// One pass: kLaneTile lanes' bytes are destuffed into a buffer that stays
// in the L1 cache, then written out as whole 64-byte lines of each row.
int64_t xjpeg_scan_windows(const uint8_t* data, int64_t len,
                           int64_t seg_start, int64_t seg_end, int64_t bs,
                           int64_t spw, int64_t nws, int32_t* out) {
  if (!data || !out || seg_start < 0 || seg_end > len ||
      seg_start > seg_end || bs < 1 || spw < 1 || nws < spw)
    return -1;
  const int64_t stride = spw * 4;
  const int64_t tail = (nws - spw) * 4;  // a lane's bytes past its stride
  const int64_t span = kLaneTile * stride;
  // The tile's lanes and the next lane's first ``tail`` bytes.
  std::vector<uint8_t> tile(size_t(span + tail));
  Destuffer src{data + seg_start, data + seg_end};
  int64_t n = src.take(tile.data(), span + tail);
  for (int64_t b = 0; b < bs; ++b) {
    for (int64_t l0 = 0; l0 < kScanLanes; l0 += kLaneTile) {
      if (b || l0) {
        std::memmove(tile.data(), tile.data() + span, size_t(tail));
        n += src.take(tile.data() + tail, span);
      }
      int32_t* dst = out + b * nws * kScanLanes + l0;
      for (int64_t w = 0; w < nws; ++w, dst += kScanLanes) {
        for (int64_t k = 0; k < kLaneTile; ++k) {
          uint32_t word;
          std::memcpy(&word, tile.data() + k * stride + w * 4, 4);
          dst[k] = int32_t(__builtin_bswap32(word));
        }
      }
    }
  }
  return src.p < src.e ? -1 : n;
}

int32_t xjpeg_host_abi_version() { return 7; }

}  // extern "C"
