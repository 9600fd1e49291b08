// K2 on Hopper: baseline Huffman decode, one lane per restart segment or MCU.
//
// Replaces the TPU kernel jpeg_gpu_tpu/ops/entropy_device.py:_entropy_kernel
// (its body _decode_tile), launched by decode_segments_device_multi.  Two
// forms share one decode loop:
//
// * The row form (jgt_entropy_decode) keeps the TPU kernel's interface:
//   destuffed big-endian words (B, NW, 8, 128) int32 -- word w of segment
//   slot b*1024 + s*128 + l at [b, w, s, l] -- in, natural-order
//   coefficients (B, T, 64, 8, 128) int16 and per-segment error flags
//   (B, 8, 128) int32 out.  It serves restart-marked streams, whose
//   segments start at bit 0 of their rows with DC predictors 0.
// * The fused form (jgt_entropy_decode_fused) serves streams without
//   restart markers after the index scan (K3): lane m decodes MCU m
//   straight out of the scan's window tensor (BS, NWS, 8, 128), from bit
//   bitpos[m] of the stream on, and a second small kernel adds the DC
//   predictor each MCU starts from.  It replaces three passes of the
//   TPU design that were plain array code there: a gather of bit-aligned
//   per-MCU rows, the decode from DC 0, and cumulative sums of the DC totals
//   added back to the DC rows.
//
// Bound: each lane is one serial chain (look up, extend, consume, refill),
// so a warp's time is its longest lane's symbol count times the cost of a
// step; the bytes moved (about 1 bit in per coded bit, 2 bytes out per
// coefficient) are far below the card's bandwidth.  One warp on an SM finds
// nothing to overlap, so a step costs about five cycles for each of its
// instructions: the design makes the step short and keeps device memory out
// of it.
//
// Design:
// * Symbols come from the two-level tables of csrc/symbol_lut.cuh (entry:
//   code length and symbol), built once per table set by
//   jgt_entropy_lut; a CUDA block holds its sublane's tables for the eight
//   slots in shared memory.  Tables that leave windows unanswered (no
//   Huffman tables, or long codes under more than 16 ten-bit prefixes) take
//   jgt::decode_symbol on a miss; that call is compiled into a second
//   instance of the loop which runs only for such tables.
// * A lane never waits for device memory inside its chain.  In the fused
//   form the MCUs of a warp are consecutive in the stream, so the warp
//   copies the span from its first MCU's word to its last MCU's end (at most
//   kStageWords words, cp.async) into shared memory and every lane refills
//   from there at its own bit offset; flat stream word W sits at
//   [W / spw / 1024, W % spw, (W / spw) % 1024] of the window tensor.  In
//   the row form the warp stages the next 64 words of its 32 rows before
//   each chunk of block steps.  A word outside the staged part is read from
//   device memory, bounded: past the row it reads 0 (as the TPU's masked
//   fetch did), past the window grid 0xFFFFFFFF (the bit reader's padding).
// * One loop walks a lane's symbols, DC and AC alike, without a
//   data-dependent branch: the lanes of a warp sit at different places of
//   their blocks, and a branch would make every lane pay for both sides.
//   The rules are selects and the coefficient store is predicated.
// * Coefficients collect in a shared-memory tile of up to kMaxChunk block
//   steps x 64 x 32 lanes, which starts as zeros; when every lane of the
//   warp has finished the chunk's blocks, the warp writes the tile out with
//   16-byte stores (whole 64-byte rows of the output) and clears it.  So
//   the kernel writes every coefficient, zeros included, and the caller
//   allocates the output without filling it.
// * DC predictors in the fused form: a lane decodes from predictor 0 and
//   leaves its per-component DC totals in dctot (4, lanes) and its warp's
//   sums in tilesum (4, warps).  dc_base_kernel gives each lane the sum of
//   the totals before it (the warps before it, then a shuffle scan inside
//   the warp) and adds it to the lane's DC rows, wrapping in int16.
// * Flag semantics are the reference's: an invalid window or a DC size
//   > 15 is ERR_BAD_CODE and consumes no bits; an AC symbol of size 0 that
//   is neither EOB nor ZRL is ERR_BAD_CODE; k past 63 is ERR_OVERRUN.  The
//   flags of the short last segment's padded tail steps are suppressed
//   (seg_meta) in the row form.  In the fused form a lane that has consumed
//   more bits than its MCU holds (bitpos[m + 1], or the stream's length for
//   the last) is flagged ERR_OVERRUN.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman_bits.cuh"
#include "symbol_lut.cuh"
#include "tile_stage.cuh"

namespace {

using jgt::kSlotEntries;
using jgt::kWarp;

constexpr int kLanes = 1024;        // lanes per batch (8 x 128)
constexpr int kThreads = 128;       // one sublane row per block
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxChunk = 8;        // block steps between two flushes of the tile
constexpr int kStageWords = 2048;   // staged stream words per warp
constexpr int kStageRows = kStageWords / kWarp;   // row form: words per lane
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kSlotBytes = kSlotEntries * sizeof(uint16_t);

// Raster index of zig-zag position k (ops/zigzag.py:ZIGZAG).
__constant__ uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// What K2 needs of a decoded symbol, in 14 bits: bits 0-4 the code length
// (17 for any invalid code, whose symbol is then 0), bits 5-12 the symbol,
// bit 13 set so that an entry is never kLutMiss.
struct SymbolEntry {
  __device__ __forceinline__ uint32_t operator()(int sym, int len) const {
    if (len > 16) {
      sym = 0;
      len = 17;
    }
    return static_cast<uint32_t>(len) | static_cast<uint32_t>(sym & 255) << 5 | 0x2000u;
  }
};

// One block per (image, sublane, slot), 1024 threads.
__global__ void __launch_bounds__(jgt::kLutSize)
symbol_lut_kernel(const int32_t* __restrict__ cbase, const int32_t* __restrict__ counts,
                  const int32_t* __restrict__ symbols, uint16_t* __restrict__ lut) {
  const int img = blockIdx.x >> 6;
  jgt::build_slot_lut(cbase + img * 8 * 16, counts + img * 8 * 17, symbols + img * 8 * 8 * 128,
                      lut + static_cast<size_t>(img) * jgt::kLutImage, blockIdx.x & 63,
                      SymbolEntry());
}

struct Args {
  const int32_t* words;         // row form: streams; fused form: windows
  const int32_t* img_of_batch;  // row form
  const int32_t* comp_map;
  const int32_t* dcslot_map;
  const int32_t* acslot_map;
  const int32_t* seg_meta;      // row form
  const int32_t* cbase;
  const int32_t* counts;
  const int32_t* symbols;
  const uint16_t* lut;
  const int32_t* bitpos;        // fused form
  int16_t* out;
  int32_t* err;
  int32_t* dctot;               // fused form: (4, nbatch * 1024)
  int32_t* tilesum;             // fused form: (4, nbatch * 32)
  int nbatch, nw, nsteps, nimages, chunk;
  int n_mcus, nbits, spw;       // fused form; nw = words of a window row
  int64_t grid_words;           // fused form: stream words the grid holds
};

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// A block's shared memory: the sublane's tables, its rank tables (for a
// miss), the zig-zag order, then per warp the chunk's step maps (DC table
// offset, AC table offset, component), the DC predictors (4 x 32), the
// staged words and the coefficient tile.
constexpr size_t kLutBytes = 8 * kSlotBytes;
constexpr size_t kRankBytes = align16(8 * sizeof(jgt::Slot));
constexpr size_t kZigzagBytes = 64;
constexpr size_t kMapBytes = 3 * kMaxChunk * sizeof(uint32_t);
constexpr size_t kDcBytes = 4 * kWarp * sizeof(int32_t);
constexpr size_t kStageBytes = kStageWords * sizeof(uint32_t);

__host__ __device__ inline size_t warp_bytes(int chunk) {
  return kMapBytes + kDcBytes + kStageBytes + size_t(chunk) * 64 * kWarp * sizeof(int16_t);
}

__host__ __device__ inline size_t smem_bytes(int chunk) {
  return kLutBytes + kRankBytes + kZigzagBytes + kWarps * warp_bytes(chunk);
}

struct WarpSmem {
  const unsigned char* lut;
  const jgt::Slot* slots;
  const uint8_t* zigzag;
  uint32_t* dc_off;    // [chunk] byte offset of the step's DC tables in lut
  uint32_t* ac_off;    // [chunk]
  uint32_t* comp;      // [chunk]
  int32_t* dc;         // [4][32] DC predictors, per component and lane
  uint32_t* stage;     // [kStageWords]
  int16_t* tile;       // [chunk][64][32]
};

// Flat stream word W of the window tensor; `g` = W / spw, `w_in` = W % spw.
__device__ __forceinline__ int64_t window_index(int64_t g, int w_in, int nws) {
  return ((g >> 10) * nws + w_in) * kLanes + (g & (kLanes - 1));
}

// Where a lane's words come from.  Row form: word w of the lane's row, the
// words [w0, w0 + kStageRows) staged at stage[(w - w0) * 32 + lane].  Fused
// form: flat stream word w, the words [w0, w0 + nstaged) staged at
// stage[w - w0].
template <bool kFused>
struct Words {
  const uint32_t* stage;
  const int32_t* src;     // row form: the lane's word 0; fused form: the windows
  uint32_t w0, nstaged;
  int nw, spw;            // row form: words a row; fused form: of a window row, and its stride
  int64_t grid_words;

  __device__ __forceinline__ uint32_t operator()(uint32_t w) const {
    const uint32_t rel = w - w0;
    if (rel < nstaged) return kFused ? stage[rel] : stage[rel * kWarp];
    if (kFused) {
      if (static_cast<int64_t>(w) >= grid_words) return 0xFFFFFFFFu;
      const int64_t g = w / static_cast<uint32_t>(spw);
      return static_cast<uint32_t>(
          __ldg(src + window_index(g, static_cast<int>(w - g * spw), nw)));
    }
    return w < static_cast<uint32_t>(nw)
               ? static_cast<uint32_t>(__ldg(src + static_cast<int64_t>(w) * kLanes))
               : 0u;
  }
};

struct Lane {
  uint32_t hi, lo, w;   // the window, and the next word, loaded a step ahead
  int navail;
  uint32_t wp;          // index of `w`
  uint32_t p;           // bits consumed so far (fused form: stream bit position)
  int flags;
};

__device__ __forceinline__ void store_tile_if(bool p, uint32_t addr, int v) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %0, 0;\n\t@q st.shared.u16 [%1], %2;\n\t}"
      :
      : "r"(static_cast<uint32_t>(p)), "r"(addr), "h"(static_cast<int16_t>(v))
      : "memory");
}

// One lane's decode of the chunk's `nt` block steps, global steps t0 ...;
// `quiet_from` is the first global step whose flags are dropped (the padded
// tail of a short last segment).  The window is the reference's: 64 bits at
// the current bit, MSB-aligned in (hi, lo), `navail` of them valid, topped up
// with the next word once 32 or fewer are left; that word is loaded a step
// ahead and merged by a clamped shift and a select, as in K3.
template <bool kFused, bool kComplete>
__device__ __forceinline__ void decode_chunk(const WarpSmem& sm, const Words<kFused>& word,
                                             int nt, int t0, int quiet_from, Lane& st) {
  const int lane = threadIdx.x & (kWarp - 1);
  uint32_t hi = st.hi, lo = st.lo, w = st.w, wp = st.wp, p = st.p;
  int navail = st.navail, flags = st.flags;
  const uint32_t tile = static_cast<uint32_t>(__cvta_generic_to_shared(sm.tile + lane));
  int32_t* dcs = sm.dc + lane;
  int tl = 0, k = 0;
  bool is_dc = true;
  while (tl < nt) {
    const uint32_t off = (is_dc ? sm.dc_off : sm.ac_off)[tl];
    uint32_t e = jgt::lut_lookup(sm.lut + off, hi);
    if (!kComplete && e == jgt::kLutMiss) {
      int sym, len;
      jgt::decode_symbol(hi, sm.slots[off / kSlotBytes], sym, len);
      e = SymbolEntry()(sym, len);
    }
    const int len = static_cast<int>(e & 31u);
    const int sym = static_cast<int>((e >> 5) & 255u);
    const int run = sym >> 4, size = sym & 15;
    const bool invalid = len > 16;
    // The `size` amplitude bits after the code, EXTENDed (spec F.2.2.1).
    const int raw = static_cast<int>(__funnelshift_l(hi << len, 0u, size));
    const int val = (size > 0 && raw < (1 << (size - (size > 0)))) ? raw - (1 << size) + 1 : raw;
    // DC: an invalid code or a size above 15 consumes nothing and ends the
    // block.  AC: an invalid code counts as EOB and consumes nothing.
    const bool bad_dc = invalid || sym > 15;
    const bool eob = sym == 0;
    const int newk = k + run + 1;
    const bool over = newk > 63;
    const bool badsym = size == 0 && run != 15;
    const bool coded = !is_dc && !invalid && !eob;
    const int n = is_dc ? (bad_dc ? 0 : len + size) : (invalid ? 0 : eob ? len : len + size);
    const int step_flags =
        is_dc ? (bad_dc ? jgt::kErrBadCode : 0)
              : (invalid ? jgt::kErrBadCode
                         : coded ? (badsym ? jgt::kErrBadCode : 0) | (over ? jgt::kErrOverrun : 0)
                                 : 0);
    flags |= t0 + tl < quiet_from ? step_flags : 0;
    int32_t* pred = dcs + sm.comp[tl] * kWarp;
    const int dc = *pred + ((is_dc && !bad_dc) ? val : 0);
    *pred = dc;
    const int row = is_dc ? 0 : sm.zigzag[min(newk, 63)];
    store_tile_if(is_dc || (coded && size > 0 && !over),
                  tile + static_cast<uint32_t>((tl * 64 + row) * kWarp * sizeof(int16_t)),
                  is_dc ? dc : val);
    const bool done = is_dc ? bad_dc : (!coded || newk >= 63 || badsym);
    k = is_dc ? 0 : min(newk, 63);
    tl += done ? 1 : 0;
    is_dc = done;
    p += n;
    hi = __funnelshift_l(lo, hi, n);
    lo <<= n;
    navail -= n;
    const bool need = navail <= 32;
    hi |= __funnelshift_rc(w, 0u, navail);   // w >> navail, 0 from 32 on
    lo |= need ? w << ((32 - navail) & 31) : 0u;
    navail += need ? 32 : 0;
    wp += need ? 1u : 0u;
    w = word(wp);
  }
  st.hi = hi;
  st.lo = lo;
  st.w = w;
  st.wp = wp;
  st.p = p;
  st.navail = navail;
  st.flags = flags;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// One warp: its 32 lanes through all block steps, chunk by chunk.
template <bool kFused, bool kComplete>
__device__ __forceinline__ void decode_warp(const Args& a, const WarpSmem& sm, int b, int s,
                                            bool dead, int img) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int slot = s * 128 + warp * kWarp + lane;          // the lane's slot in its batch
  const int64_t gl = static_cast<int64_t>(b) * kLanes + slot;
  uint4* tile4 = reinterpret_cast<uint4*>(sm.tile);
  for (int i = lane; i < a.chunk * 64 * kWarp / 8; i += kWarp) tile4[i] = make_uint4(0, 0, 0, 0);
  for (int c = 0; c < 4; ++c) sm.dc[c * kWarp + lane] = 0;

  Words<kFused> word;
  word.stage = sm.stage + (kFused ? 0 : lane);
  word.w0 = 0;
  word.nstaged = 0;
  word.nw = a.nw;
  word.spw = a.spw;
  word.grid_words = a.grid_words;
  bool active = !dead;
  uint32_t start = 0, end = 0;
  int quiet_from = INT32_MAX;
  if (kFused) {
    word.src = a.words;
    active = gl < a.n_mcus;
    if (active) {
      start = static_cast<uint32_t>(a.bitpos[gl]);
      end = gl + 1 < a.n_mcus ? static_cast<uint32_t>(a.bitpos[gl + 1])
                              : static_cast<uint32_t>(a.nbits);
    }
    // The warp's span of the stream: from its first MCU's word to two words
    // past its last MCU's end (the window looks that far ahead).
    const unsigned live = __ballot_sync(kFull, active);
    if (live) {
      const uint32_t first = __shfl_sync(kFull, start, 0) >> 5;
      const uint32_t last = (__shfl_sync(kFull, end, 31 - __clz(live)) >> 5) + 3;
      word.w0 = first;
      word.nstaged = last > first ? min(last - first, static_cast<uint32_t>(kStageWords)) : 0u;
      if (lane < static_cast<int>(word.nstaged)) {
        int64_t g = (first + lane) / static_cast<uint32_t>(a.spw);
        int w_in = static_cast<int>(first + lane - g * a.spw);
        for (uint32_t i = lane; i < word.nstaged; i += kWarp) {
          if (static_cast<int64_t>(first) + i < a.grid_words)
            __pipeline_memcpy_async(sm.stage + i, a.words + window_index(g, w_in, a.nw), 4);
          else
            sm.stage[i] = 0xFFFFFFFFu;
          w_in += kWarp;
          while (w_in >= a.spw) {
            w_in -= a.spw;
            ++g;
          }
        }
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
    }
    __syncwarp();
  } else {
    word.src = a.words + static_cast<int64_t>(b) * a.nw * kLanes + slot;
    if (!dead) {
      const int32_t* meta = a.seg_meta + img * 3;
      if (b == meta[0] && slot == meta[1]) quiet_from = meta[2];
    }
  }

  Lane st = {};
  st.p = start;
  st.wp = start >> 5;
  bool primed = false;
  for (int t0 = 0; t0 < a.nsteps; t0 += a.chunk) {
    const int nt = min(a.chunk, a.nsteps - t0);
    if (lane < nt) {
      sm.dc_off[lane] = (static_cast<uint32_t>(a.dcslot_map[t0 + lane]) & 7u) * kSlotBytes;
      sm.ac_off[lane] = (static_cast<uint32_t>(a.acslot_map[t0 + lane]) & 7u) * kSlotBytes;
      sm.comp[lane] = static_cast<uint32_t>(a.comp_map[t0 + lane]) & 3u;
    }
    if (!kFused && !dead) {
      // The next words of the warp's rows, from the word the slowest lane is at.
      const uint32_t at = primed ? st.wp : 0u;
      const uint32_t w0 = __reduce_min_sync(kFull, at);
      __syncwarp();
      jgt::stage_rows_async(sm.stage, word.src - lane, kLanes, static_cast<int>(w0), kStageRows,
                            a.nw);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      word.w0 = w0;
      word.nstaged = kStageRows;
    }
    __syncwarp();
    if (active) {
      if (!primed) {
        // The 64-bit window at the lane's first bit.
        const int sh = static_cast<int>(start & 31u);
        const uint32_t w0 = word(st.wp), w1 = word(st.wp + 1);
        st.hi = __funnelshift_l(w1, w0, sh);
        st.lo = w1 << sh;
        st.navail = 64 - sh;
        st.wp += 2;
        st.w = word(st.wp);
        primed = true;
      } else if (!kFused) {
        st.w = word(st.wp);   // the staged part moved
      }
      decode_chunk<kFused, kComplete>(sm, word, nt, t0, quiet_from, st);
    }
    __syncwarp();
    // The tile out, 16 bytes a thread and whole 64-byte rows, and cleared.
    int16_t* dst = a.out + ((static_cast<int64_t>(b) * a.nsteps + t0) * 64) * kLanes + s * 128 +
                   warp * kWarp;
    for (int i = lane; i < nt * 64 * 4; i += kWarp) {
      const int row = i >> 2, part = i & 3;
      *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(row) * kLanes + part * 8) = tile4[i];
      tile4[i] = make_uint4(0, 0, 0, 0);
    }
  }
  if (dead) st.flags = jgt::kErrBadCode;
  if (kFused) {
    if (active && st.p > end) st.flags |= jgt::kErrOverrun;
    const int64_t nlanes = static_cast<int64_t>(a.nbatch) * kLanes;
    const int64_t tile_id = gl / kWarp;
    for (int c = 0; c < 4; ++c) {
      const int total = sm.dc[c * kWarp + lane];
      a.dctot[c * nlanes + gl] = total;
      const int sum = warp_sum(total);
      if (lane == 0) a.tilesum[c * (nlanes / kWarp) + tile_id] = sum;
    }
  }
  a.err[gl] = st.flags;
}

template <bool kFused>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid / kWarp;
  const int b = blockIdx.x >> 3, s = blockIdx.x & 7;
  int img = 0;
  bool dead = false;
  if (!kFused) {
    // A batch whose image index has no tables: every segment is flagged and
    // its coefficients are zero (uniform over the block).
    img = a.img_of_batch[b];
    dead = img < 0 || img >= a.nimages;
    if (dead) img = 0;
  }
  unsigned char* base = smem_raw;
  WarpSmem sm;
  sm.lut = base;
  base += kLutBytes;
  jgt::Slot* slots = reinterpret_cast<jgt::Slot*>(base);
  sm.slots = slots;
  base += kRankBytes;
  uint8_t* zigzag = base;
  sm.zigzag = zigzag;
  base += kZigzagBytes + warp * warp_bytes(a.chunk);
  sm.dc_off = reinterpret_cast<uint32_t*>(base);
  sm.ac_off = sm.dc_off + kMaxChunk;
  sm.comp = sm.ac_off + kMaxChunk;
  base += kMapBytes;
  sm.dc = reinterpret_cast<int32_t*>(base);
  base += kDcBytes;
  sm.stage = reinterpret_cast<uint32_t*>(base);
  base += kStageBytes;
  sm.tile = reinterpret_cast<int16_t*>(base);

  const uint16_t* lut = a.lut + static_cast<size_t>(img) * jgt::kLutImage;
  const uint16_t* mine = lut + static_cast<size_t>(s) * 8 * kSlotEntries;
  for (int i = tid; i < static_cast<int>(kLutBytes / 16); i += kThreads)
    __pipeline_memcpy_async(smem_raw + i * 16, reinterpret_cast<const unsigned char*>(mine) + i * 16,
                            16);
  __pipeline_commit();
  if (tid < 64) zigzag[tid] = kZigzag[tid];
  // One flag per (sublane, slot) follows the image's tables.
  const bool complete = __syncthreads_and(lut[64 * kSlotEntries + s * 8 + (tid & 7)] != 0);
  if (!complete)
    jgt::load_slots(slots, a.cbase + img * 8 * 16, a.counts + img * 8 * 17,
                    a.symbols + img * 8 * 8 * 128, s);
  __pipeline_wait_prior(0);
  __syncthreads();
  if (complete)
    decode_warp<kFused, true>(a, sm, b, s, dead, img);
  else
    decode_warp<kFused, false>(a, sm, b, s, dead, img);
}

// The DC predictor each MCU starts from, added to its DC rows.  One warp per
// 32 lanes: the sums of the warps before it, a scan of its own lanes' totals,
// then one read-modify-write per block step.
__global__ void __launch_bounds__(kThreads)
dc_base_kernel(const int32_t* __restrict__ comp_map, const int32_t* __restrict__ dctot,
               const int32_t* __restrict__ tilesum, int16_t* __restrict__ out, int nbatch,
               int nsteps, int n_mcus) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t tile_id = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / kWarp;
  const int64_t nlanes = static_cast<int64_t>(nbatch) * kLanes, ntiles = nlanes / kWarp;
  const int64_t gl = tile_id * kWarp + lane;
  if (tile_id >= ntiles || tile_id * kWarp >= n_mcus) return;   // uniform over the warp
  int base[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int before = 0;
    for (int64_t i = lane; i < tile_id; i += kWarp) before += __ldg(tilesum + c * ntiles + i);
    before = warp_sum(before);
    const int own = dctot[c * nlanes + gl];
    int incl = own;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    base[c] = before + incl - own;
  }
  if (gl >= n_mcus) return;
  const int64_t b = gl / kLanes, slot = gl % kLanes;
  for (int t = 0; t < nsteps; ++t) {
    const int c = __ldg(comp_map + t) & 3;
    const int add = c == 0 ? base[0] : c == 1 ? base[1] : c == 2 ? base[2] : base[3];
    int16_t* dc = out + ((b * nsteps + t) * 64) * kLanes + slot;
    *dc = static_cast<int16_t>(static_cast<int>(*dc) + add);   // wraps as an int16 add does
  }
}

int chunk_steps(int nsteps) { return nsteps < kMaxChunk ? nsteps : kMaxChunk; }

template <bool kFused>
int launch_decode(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.chunk);
  int rc = int(cudaFuncSetAttribute(decode_kernel<kFused>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
  if (rc) return rc;
  decode_kernel<kFused><<<a.nbatch * 8, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// The symbol tables of `nimages` table sets: cbase (NI, 8, 16), counts
// (NI, 8, 17), symbols (NI, 8, 8, 128) i32 -> lut, NI x (8 x 8 x 2048 u16,
// [sublane][slot][entry], then 64 u16 flags, [sublane][slot]).
extern "C" int jgt_entropy_lut(const void* cbase, const void* counts, const void* symbols,
                               void* lut, int nimages, void* stream) {
  if (nimages <= 0) return int(cudaErrorInvalidValue);
  symbol_lut_kernel<<<nimages * 64, jgt::kLutSize, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cbase), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(symbols), static_cast<uint16_t*>(lut));
  return int(cudaGetLastError());
}

// The row form.  streams (B, NW, 8, 128) i32; img_of_batch (B,) i32;
// comp/dcslot/acslot maps (T,) i32; seg_meta (NI, 3) i32; cbase (NI, 8, 16),
// counts (NI, 8, 17), symbols (NI, 8, 8, 128) i32; lut as jgt_entropy_lut
// built it from them; out (B, T, 64, 8, 128) i16, written whole; err
// (B, 8, 128) i32.  One launch.  Returns cudaGetLastError() after it.
extern "C" int jgt_entropy_decode(const void* streams, const void* img_of_batch,
                                  const void* comp_map, const void* dcslot_map,
                                  const void* acslot_map, const void* seg_meta,
                                  const void* cbase, const void* counts,
                                  const void* symbols, const void* lut, void* out, void* err,
                                  int nbatch, int nw, int nsteps, int nimages,
                                  void* stream) {
  if (nbatch <= 0 || nsteps <= 0 || nw <= 0 || nimages <= 0) return int(cudaErrorInvalidValue);
  Args a = {};
  a.words = static_cast<const int32_t*>(streams);
  a.img_of_batch = static_cast<const int32_t*>(img_of_batch);
  a.comp_map = static_cast<const int32_t*>(comp_map);
  a.dcslot_map = static_cast<const int32_t*>(dcslot_map);
  a.acslot_map = static_cast<const int32_t*>(acslot_map);
  a.seg_meta = static_cast<const int32_t*>(seg_meta);
  a.cbase = static_cast<const int32_t*>(cbase);
  a.counts = static_cast<const int32_t*>(counts);
  a.symbols = static_cast<const int32_t*>(symbols);
  a.lut = static_cast<const uint16_t*>(lut);
  a.out = static_cast<int16_t*>(out);
  a.err = static_cast<int32_t*>(err);
  a.nbatch = nbatch;
  a.nw = nw;
  a.nsteps = nsteps;
  a.nimages = nimages;
  a.chunk = chunk_steps(nsteps);
  return launch_decode<false>(a, static_cast<cudaStream_t>(stream));
}

// The fused form.  windows (BS, NWS, 8, 128) i32, whose first spw words of
// each row tile the stream; bitpos (n_mcus,) i32, the stream bit at which
// each MCU starts; nbits the stream's length; the maps (T,) i32 of one MCU's
// block steps; one table set and its lut; out (B, T, 64, 8, 128) i16 with B
// = ceil(n_mcus / 1024), written whole, lanes past n_mcus as zeros; err
// (B, 8, 128) i32; dctot 4 * B * 1024 and tilesum 4 * B * 32 i32 scratch.
// Two launches: the decode, then the DC predictors.  Returns the first CUDA
// error, 0 if none.
extern "C" int jgt_entropy_decode_fused(const void* windows, const void* bitpos,
                                        const void* comp_map, const void* dcslot_map,
                                        const void* acslot_map, const void* cbase,
                                        const void* counts, const void* symbols,
                                        const void* lut, void* out, void* err, void* dctot,
                                        void* tilesum, int nbatch_windows, int nws, int spw,
                                        int nbits, int n_mcus, int nsteps, void* stream_) {
  if (nbatch_windows <= 0 || nws <= 0 || spw <= 0 || spw > nws || nbits < 0 || n_mcus <= 0 ||
      nsteps <= 0)
    return int(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  Args a = {};
  a.words = static_cast<const int32_t*>(windows);
  a.bitpos = static_cast<const int32_t*>(bitpos);
  a.comp_map = static_cast<const int32_t*>(comp_map);
  a.dcslot_map = static_cast<const int32_t*>(dcslot_map);
  a.acslot_map = static_cast<const int32_t*>(acslot_map);
  a.cbase = static_cast<const int32_t*>(cbase);
  a.counts = static_cast<const int32_t*>(counts);
  a.symbols = static_cast<const int32_t*>(symbols);
  a.lut = static_cast<const uint16_t*>(lut);
  a.out = static_cast<int16_t*>(out);
  a.err = static_cast<int32_t*>(err);
  a.dctot = static_cast<int32_t*>(dctot);
  a.tilesum = static_cast<int32_t*>(tilesum);
  a.nbatch = (n_mcus + kLanes - 1) / kLanes;
  a.nw = nws;
  a.nsteps = nsteps;
  a.nimages = 1;
  a.chunk = chunk_steps(nsteps);
  a.n_mcus = n_mcus;
  a.nbits = nbits;
  a.spw = spw;
  a.grid_words = static_cast<int64_t>(nbatch_windows) * kLanes * spw;
  int rc = launch_decode<true>(a, stream);
  if (rc) return rc;
  const int ntiles = a.nbatch * (kLanes / kWarp);
  dc_base_kernel<<<(ntiles + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      a.comp_map, a.dctot, a.tilesum, a.out, a.nbatch, nsteps, n_mcus);
  return int(cudaGetLastError());
}
