// Two-level symbol tables that stand in for the canonical-rank decode of
// huffman_bits.cuh, shared by K2 (entropy_decode.cu) and K3
// (specsync_scan.cu).  The kernels differ only in what an entry holds: K3
// keeps the bits a symbol consumes ready made (its chain entry), K2 the code
// length and the symbol apart (it needs the amplitude's size).
//
// The tables of one (sublane, slot) are kSlotEntries u16.  First 1024
// first-level entries, one per 10-bit prefix of the window: the entry where
// the prefix decides the symbol (codes of up to 10 bits, and ranges that are
// invalid throughout); else kLutSub | the byte offset of the j-th
// second-level table, where this is the j-th such prefix in rising order;
// else (more than 16 such prefixes) kLutMiss.  Then 16 second-level tables
// of 64 entries, one per 16-bit prefix under its 10-bit prefix: the entry (a
// code has at most 16 bits), or kLutMiss where even that range does not
// decode alike, which only tables that are no Huffman tables produce.
//
// An entry answers only where the rank and the invalid test agree at both
// ends of the prefix's range: both are monotone in the window, so every
// window with that prefix decodes alike, whatever the tables hold.  A miss
// falls through to jgt::decode_symbol, so lookup and decode_symbol agree for
// every window.  An entry function never returns kLutMiss.
//
// One image's tables are kLutImage u16: the 64 (sublane, slot) tables,
// [sublane][slot][entry], then 64 flags, [sublane][slot]: 1 where the slot's
// tables answer every window.

#pragma once

#include <stdint.h>

#include "huffman_bits.cuh"

namespace jgt {

constexpr int kLutBits = 10;             // first level: the window's top 10 bits
constexpr int kLutSize = 1 << kLutBits;
constexpr int kSubBits = 6;              // second level: the 6 bits after them
constexpr int kSubSize = 1 << kSubBits;
constexpr int kSubTables = 16;           // second-level tables per slot
constexpr int kSlotEntries = kLutSize + kSubTables * kSubSize;   // one slot's tables
constexpr int kLutImage = 64 * kSlotEntries + 64;                // one image's, with flags
constexpr uint32_t kLutMiss = 0u;        // no answer: use decode_symbol
constexpr uint32_t kLutSub = 0x8000u;    // first-level entry: go to the table at byte (entry & 0x7FFF)

// The entry of every window whose top `bits` bits are those of `lo`, or
// kLutMiss if they do not all decode alike.
template <class Entry>
__device__ __forceinline__ uint32_t range_entry(uint32_t lo, int bits, const Slot& t,
                                                Entry entry) {
  const uint32_t hi = lo | ((1u << (32 - bits)) - 1u);
  const bool alike = symbol_rank(lo, t) == symbol_rank(hi, t) &&
                     window_invalid(lo, t) == window_invalid(hi, t);
  int sym, len;
  decode_symbol(lo, t, sym, len);
  return alike ? entry(sym, len) : kLutMiss;
}

// Build the tables of (sublane, slot) = (which >> 3, which & 7) of one image
// into `lut` (kLutImage u16) from the image's cbase (8, 16), counts (8, 17)
// and symbols (8, 8, 128).  Called by all 1024 threads of a block.
template <class Entry>
__device__ __forceinline__ void build_slot_lut(const int32_t* __restrict__ cbase,
                                               const int32_t* __restrict__ counts,
                                               const int32_t* __restrict__ symbols,
                                               uint16_t* __restrict__ lut, int which,
                                               Entry entry) {
  __shared__ Slot t;
  __shared__ int warp_count[kLutSize / 32];
  __shared__ int sub_prefix[kSubTables];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int slot = which & 7, sublane = which >> 3;
  load_slot(&t, cbase, counts, symbols, slot, sublane, tid, blockDim.x);
  if (tid < kSubTables) sub_prefix[tid] = -1;
  __syncthreads();
  uint32_t e = range_entry(static_cast<uint32_t>(tid) << (32 - kLutBits), kLutBits, t, entry);
  // Number the prefixes that need a second level, in rising order.
  const unsigned deep = __ballot_sync(0xFFFFFFFFu, e == kLutMiss);
  if (lane == 0) warp_count[warp] = __popc(deep);
  __syncthreads();
  if (e == kLutMiss) {
    int j = __popc(deep & ((1u << lane) - 1u));
    for (int i = 0; i < warp; ++i) j += warp_count[i];
    if (j < kSubTables) {
      sub_prefix[j] = tid;
      e = kLutSub | static_cast<uint32_t>((kLutSize + j * kSubSize) * sizeof(uint16_t));
    }
  }
  uint16_t* out = lut + static_cast<size_t>(which) * kSlotEntries;
  out[tid] = static_cast<uint16_t>(e);
  __syncthreads();
  static_assert(kSubTables * kSubSize == kLutSize, "one second-level entry per thread");
  const int prefix = sub_prefix[tid / kSubSize];
  const uint32_t second =
      prefix < 0 ? kLutMiss
                 : range_entry((static_cast<uint32_t>(prefix) << kSubBits | (tid % kSubSize)) << 16,
                               kLutBits + kSubBits, t, entry);
  out[kLutSize + tid] = static_cast<uint16_t>(second);
  // Complete: no window of this slot is left to decode_symbol.
  const int holes = __syncthreads_or(e == kLutMiss || (prefix >= 0 && second == kLutMiss));
  if (tid == 0) lut[static_cast<size_t>(64) * kSlotEntries + which] = holes ? 0 : 1;
}

// The entry of window `hi` in the slot's tables at `tables` (bytes), or
// kLutMiss.
__device__ __forceinline__ uint32_t lut_lookup(const unsigned char* tables, uint32_t hi) {
  const uint32_t sub = (hi >> (16 - 1)) & ((kSubSize - 1) << 1);   // byte offset in a second table
  uint32_t e = *reinterpret_cast<const uint16_t*>(tables + ((hi >> (32 - kLutBits)) << 1));
  if (e & kLutSub)   // a code of more than 10 bits: its second-level table
    e = *reinterpret_cast<const uint16_t*>(tables + (e & (kLutSub - 1)) + sub);
  return e;
}

}  // namespace jgt
