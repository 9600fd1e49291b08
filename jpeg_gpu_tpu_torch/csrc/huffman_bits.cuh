// Bit window and canonical-rank Huffman decode shared by K2 and K3.
//
// The window is 64 bits, MSB-aligned, in two 32-bit halves (hi, lo);
// `navail` counts its valid bits and `wp` is the next word to fetch.  Bits
// below `navail` are zero, so the window always shows the stream from the
// current bit on.  Every shift here is logical and a shift by 32 gives 0,
// as in jpeg_gpu_tpu/ops/entropy_device.py:_lsr_safe/_shl_safe (a 32-bit
// shift by 32 is undefined in C++, so the 32 case is spelled out).

#pragma once

#include <stdint.h>

namespace jgt {

constexpr int kErrBadCode = 1;
constexpr int kErrOverrun = 2;

__device__ __forceinline__ uint32_t lsr_safe(uint32_t x, int n) {
  return n >= 32 ? 0u : (x >> n);
}

__device__ __forceinline__ uint32_t shl_safe(uint32_t x, int n) {
  return n >= 32 ? 0u : (x << n);
}

// One table slot in shared memory: the rows of host/segments.py:
// _table_tensors for one slot, with the packed entries of one sublane.
struct Slot {
  int32_t cbase[16];    // mincode[L] - 1
  int32_t counts[17];   // codes of length L; [16] = XOR-biased invalid limit
  uint32_t entries[128];  // (sym | len << 8), two 16-bit entries per word
};

// Load one slot of an image's tables into shared memory.  `cbase` is (8, 16),
// `counts` (8, 17), `symbols` (8, 8, 128); `sublane` picks the row of
// `symbols` that the caller's lanes gather from.  Called by `nthreads`
// threads, `tid` of them each.
__device__ __forceinline__ void load_slot(Slot* dst, const int32_t* cbase,
                                          const int32_t* counts,
                                          const int32_t* symbols, int slot,
                                          int sublane, int tid, int nthreads) {
  for (int w = tid; w < 128; w += nthreads) {
    dst->entries[w] =
        static_cast<uint32_t>(symbols[(slot * 8 + sublane) * 128 + w]);
    if (w < 16) dst->cbase[w] = cbase[slot * 16 + w];
    if (w < 17) dst->counts[w] = counts[slot * 17 + w];
  }
}

// Load slots 0..7 of one image's tables into shared memory, by all the
// threads of the block.
__device__ __forceinline__ void load_slots(Slot* slots, const int32_t* cbase,
                                           const int32_t* counts,
                                           const int32_t* symbols,
                                           int sublane) {
  for (int slot = 0; slot < 8; ++slot)
    load_slot(slots + slot, cbase, counts, symbols, slot, sublane,
              threadIdx.x, blockDim.x);
}

struct Window {
  uint32_t hi = 0, lo = 0;
  int navail = 0;
  int wp = 0;

  // Top the window back above 32 bits with one word of `row` (word w at
  // row[w * stride]); a word index outside [0, nwords) reads 0.
  __device__ __forceinline__ void refill(const int32_t* row, int nwords,
                                         int stride) {
    if (navail > 32) return;
    const uint32_t w = (wp >= 0 && wp < nwords)
                           ? static_cast<uint32_t>(row[static_cast<int64_t>(wp) * stride])
                           : 0u;
    hi |= lsr_safe(w, navail);
    lo |= shl_safe(w, 32 - navail);
    navail += 32;
    wp += 1;
  }

  // Advance by n bits, 0 <= n <= 31.
  __device__ __forceinline__ void consume(int n) {
    hi = shl_safe(hi, n) | lsr_safe(lo, 32 - n);
    lo = shl_safe(lo, n);
    navail -= n;
  }
};

// Canonical rank of the code at the top of `hi` (spec F.2.2.3 as a sum of
// independent per-length terms, ops/entropy_device.py:decode_symbol):
//   rank = sum_L clamp(top_L(hi) - cbase[L], 0, counts[L]).
// Every term grows with `hi`, so the rank is monotone in the window.
__device__ __forceinline__ int symbol_rank(uint32_t hi, const Slot& t) {
  int rank = 0;
#pragma unroll
  for (int l = 1; l <= 16; ++l) {
    const int top = static_cast<int>(hi >> (32 - l));
    rank += min(max(top - t.cbase[l - 1], 0), t.counts[l - 1]);
  }
  return rank;
}

// A window at or past the first unassigned code is invalid: a signed
// compare of the sign-flipped window against the biased limit (monotone in
// the window too).
__device__ __forceinline__ bool window_invalid(uint32_t hi, const Slot& t) {
  return static_cast<int32_t>(hi ^ 0x80000000u) >= t.counts[16];
}

// Canonical-rank decode: the packed entry at rank - 1 gives (symbol, code
// length); an invalid window gives length 17.
__device__ __forceinline__ void decode_symbol(uint32_t hi, const Slot& t,
                                              int& sym, int& len) {
  const int idx = min(max(symbol_rank(hi, t) - 1, 0), 255);
  const uint32_t ent = (t.entries[idx >> 1] >> ((idx & 1) * 16)) & 0xFFFFu;
  len = window_invalid(hi, t) ? 17 : static_cast<int>(ent >> 8);
  sym = static_cast<int>(ent & 0xFFu);
}

// The `size` amplitude bits after a `len`-bit code, EXTENDed (spec F.2.2.1).
__device__ __forceinline__ int extend(uint32_t hi, int len, int size) {
  const int raw = static_cast<int>(lsr_safe(hi << min(len, 31), 32 - size));
  const int half = 1 << max(size - 1, 0);
  const int full = 1 << min(size, 30);
  return (size > 0 && raw < half) ? raw - full + 1 : raw;
}

}  // namespace jgt
