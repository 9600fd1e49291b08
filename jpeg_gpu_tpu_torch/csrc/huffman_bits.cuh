// The canonical-rank Huffman decode shared by K2 and K3: the tables of
// host/segments.py in shared memory and decode_symbol, which the kernels'
// symbol tables (csrc/symbol_lut.cuh) are built from and fall back to.

#pragma once

#include <stdint.h>

namespace jgt {

constexpr int kErrBadCode = 1;
constexpr int kErrOverrun = 2;

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

}  // namespace jgt
