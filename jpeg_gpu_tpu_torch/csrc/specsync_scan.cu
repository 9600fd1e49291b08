// K3 on Hopper: the speculative self-synchronising index scan, whole.
//
// Replaces the TPU kernel jpeg_gpu_tpu/ops/specsync_device.py:_scan_kernel
// together with the rounds of device_index_scan around it.  The destuffed
// stream of a stream without restart markers is cut into subsequences of SB
// bytes, one per lane slot b*1024 + s*128 + l; lane (b, s, l) reads its own
// window row [b, :, s, l] of NWS words.  From its entry state (p, c, at_dc,
// k) -- bit position relative to its window, block phase in the MCU,
// whether the next symbol is a DC symbol, zig-zag index -- a lane decodes
// code lengths only (no amplitudes) until p passes its end; its exit state
// is the next lane's entry.  Lane 0 is pinned to the true start, so the
// fixed point of this Jacobi iteration is the serial decode.  While it
// decodes, a lane notes the bit position of every MCU start it meets: up
// to `maxrec` of them, while its count runs on past maxrec (the overflow
// check and the caller's fallback depend on it).
//
// Bound: a serial chain per lane.  A pass over the stream is SB * 8 / (bits
// per symbol) dependent steps whatever the byte count, and every lane runs
// at once on its own, so the time is (passes) x (steps of the longest lane)
// x (cycles a step).  One warp on an SM finds nothing to overlap: measured
// on an H100, a step costs about five cycles for each of its instructions,
// on the chain of dependent ones or off it.  The design runs few passes and
// makes the step short.
//
// Design:
// * The whole scan is one cooperative launch (index_scan_kernel): rounds,
//   the shift of exit states to the next lane, the convergence test and the
//   stitch all run on the device, with one grid-wide barrier per round and
//   no host sync.  A block is one warp that walks over 32-lane tiles with a
//   grid stride, so any number of lanes runs with the blocks that fit the
//   card at once.
// * A lane decodes only when its entry changed: its exit is a function of
//   its entry, so an unchanged lane keeps its exit and its records.  Every
//   decode records, so at the fixed point each lane's records come from its
//   final entry and no separate record pass exists.  If the rounds run out
//   first, the lanes whose entry changed last decode once more, which is
//   the record pass of the plain version from the final entries.
// * The step runs out of shared memory: a tile's window rows (NWS x 128
//   bytes) are staged with cp.async before its lanes start and stay there
//   while the warp keeps its tile; the records collect there and leave as
//   coalesced rows; the tables of every block phase sit beside them.
// * Symbols come from two levels of tables instead of the rank sum (some
//   150 instructions): the window's top 10 bits index a first level whose
//   16-bit entry holds what the step needs ready made (chain_entry); a code
//   of more than 10 bits takes a second load from a 64-entry table of its
//   prefix.  A small kernel builds them (scan_lut_kernel, the scheme of
//   csrc/symbol_lut.cuh), before the scan or once per table set when the
//   caller keeps them:
//   an entry answers only where the rank and the invalid test agree at both
//   ends of the prefix's range -- both are monotone in the window, so every
//   window with that prefix decodes alike -- and is a miss otherwise, which
//   falls through to jgt::decode_symbol.  The lookup therefore equals
//   decode_symbol for every window and any table contents.  A Huffman table
//   never misses in a second-level table (a code has at most 16 bits); its
//   first level misses where more than 16 prefixes of 10 bits hold longer
//   codes, which a valid table can ask for (255 codes of 11 bits) and the
//   tables encoders write do not.
// * The step has no branch (decode_lane): the lanes of a warp sit at
//   different places of their blocks, and a branch would make every lane pay
//   for both sides.  Records are predicated stores, the DC and AC rules are
//   selects, the next stream word and both tables the next step may need are
//   fetched before the symbol is known, and the call of decode_symbol is
//   compiled in only for tables that do not answer every window (the table
//   kernel leaves a flag).
// * The stitch: per-tile record sums, one barrier, then each warp takes the
//   prefix of the tiles before its own, scans its 32 counts with shuffles
//   and stores `record + lane base` straight to bitpos; positions no record
//   reaches are stored as 0, and one thread writes ok and stats.
// * The loop is bounded by SB * 8 + 2 steps (every step of a Huffman table
//   consumes at least one bit), every word read lies in the staged row, and
//   an invalid code consumes 17 bits as in the reference: off the true path
//   any deterministic rule that consumes at least one bit will do.
// * The same kernel runs one round from given entry states and stops after
//   its first pass (ops/specsync_device.py:scan_round).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman_bits.cuh"
#include "symbol_lut.cuh"
#include "tile_stage.cuh"

namespace cg = cooperative_groups;

namespace {

using jgt::kLutBits;
using jgt::kLutMiss;
using jgt::kLutSub;
using jgt::kSlotEntries;
using jgt::kSubSize;
using jgt::kWarp;

constexpr int kLanes = 1024;             // lanes per batch (8 x 128)
constexpr int kTilesPerBatch = kLanes / kWarp;
constexpr unsigned kFull = 0xFFFFFFFFu;

// What the step needs of a decoded symbol, in 15 bits: an invalid code
// (length above 16) counts as EOB with 17 bits; then bits 0-4 = the bits an
// AC symbol consumes (length + low nibble, at most 31), bits 5-9 = the bits
// a DC symbol consumes (length + min(symbol, 15)), bits 10-13 = the zero run
// (high nibble), bit 14 = the symbol is 0 (EOB).  Never 0: a symbol that
// sets neither nibble is 0 and sets bit 14.
__device__ __forceinline__ uint32_t chain_entry(int sym, int len) {
  if (len > 16) {
    sym = 0;
    len = 17;
  }
  return static_cast<uint32_t>(len + (sym & 15)) | static_cast<uint32_t>(len + min(sym, 15)) << 5 |
         static_cast<uint32_t>(sym >> 4) << 10 | (sym == 0 ? 0x4000u : 0u);
}

struct ChainEntry {
  __device__ __forceinline__ uint32_t operator()(int sym, int len) const {
    return chain_entry(sym, len);
  }
};

// The symbol tables of csrc/symbol_lut.cuh with chain entries, one block per
// (sublane, slot), 1024 threads.
__global__ void __launch_bounds__(jgt::kLutSize)
scan_lut_kernel(const int32_t* __restrict__ cbase,
                const int32_t* __restrict__ counts,
                const int32_t* __restrict__ symbols,
                uint16_t* __restrict__ lut) {
  jgt::build_slot_lut(cbase, counts, symbols, lut, blockIdx.x, ChainEntry());
}

// One warp's shared memory.
struct WarpSmem {
  uint16_t* lut;      // [8][kSlotEntries] the symbol tables of the tile's sublane
  jgt::Slot* slots;   // [8] its rank tables, for a miss
  // Byte offset into lut of each block phase's DC and AC slot.  Entry bpm of
  // each is slot 0, for a phase outside [0, bpm), as the reference's masked
  // select gives.
  uint32_t* dc_off;   // [bpm + 1]
  uint32_t* ac_off;   // [bpm + 1]
  int32_t* rec;       // [maxrec + 1][32] records; row maxrec takes the overflow
  uint32_t* rows;     // [nws][32] the tile's window rows
  int sublane;        // whose tables are loaded; -1 = none
  int tile;           // whose rows are staged; -1 = none
  int nws;            // words of a window row
  bool complete;      // the loaded tables answer every window
};

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

constexpr size_t kLutBytes = align16(8 * kSlotEntries * sizeof(uint16_t));
constexpr size_t kSlotBytes = align16(8 * sizeof(jgt::Slot));
constexpr size_t kRowBytes = kWarp * sizeof(uint32_t);

__host__ __device__ inline size_t phase_bytes(int bpm) {
  return align16((size_t(bpm) + 1) * sizeof(uint32_t));
}

__host__ __device__ inline size_t smem_bytes(int nws, int maxrec, int bpm) {
  return kLutBytes + kSlotBytes + 2 * phase_bytes(bpm) +
         (size_t(maxrec) + 1 + size_t(nws)) * kRowBytes;
}

__device__ __forceinline__ WarpSmem carve(unsigned char* base, int maxrec, int nws, int bpm) {
  WarpSmem sm;
  sm.nws = nws;
  sm.lut = reinterpret_cast<uint16_t*>(base);
  base += kLutBytes;
  sm.slots = reinterpret_cast<jgt::Slot*>(base);
  base += kSlotBytes;
  sm.dc_off = reinterpret_cast<uint32_t*>(base);
  sm.ac_off = reinterpret_cast<uint32_t*>(base + phase_bytes(bpm));
  base += 2 * phase_bytes(bpm);
  sm.rec = reinterpret_cast<int32_t*>(base);
  base += (size_t(maxrec) + 1) * kRowBytes;
  sm.rows = reinterpret_cast<uint32_t*>(base);
  sm.sublane = -1;
  sm.tile = -1;
  sm.complete = false;
  return sm;
}

struct Tables {
  const int32_t* dcslot;
  const int32_t* acslot;
  const int32_t* cbase;
  const int32_t* counts;
  const int32_t* symbols;
  const uint16_t* lut;
  int bpm;
};

// The lanes of tile t: batch b, sublane s, lanes [l0, l0 + 32) of the row.
struct Tile {
  int t, b, s, lane;   // lane = s * 128 + l0 + thread, the slot inside the batch
  int64_t gl;          // b * 1024 + lane
  __device__ __forceinline__ explicit Tile(int tile) : t(tile) {
    b = t / kTilesPerBatch;
    const int in_batch = t % kTilesPerBatch;
    s = in_batch / (128 / kWarp);
    lane = in_batch * kWarp + static_cast<int>(threadIdx.x);
    gl = static_cast<int64_t>(b) * kLanes + lane;
  }
};

// Stage tile `tile`'s window rows unless they are staged already, and its
// sublane's tables unless they are loaded already; returns once every
// thread of the warp may read them.
__device__ __forceinline__ void stage_tile(WarpSmem& sm, const Tables& tab,
                                           const int32_t* windows, int nws,
                                           const Tile& tile) {
  if (sm.tile == tile.t) return;
  __syncwarp();  // the previous tile's readers are done
  const int tid = threadIdx.x;
  const int32_t* src = windows + static_cast<int64_t>(tile.b) * nws * kLanes + (tile.lane - tid);
  jgt::stage_rows_async(sm.rows, src, kLanes, 0, nws, nws);
  sm.tile = tile.t;
  if (sm.sublane != tile.s) {
    const uint16_t* lut = tab.lut + static_cast<size_t>(tile.s) * 8 * kSlotEntries;
    for (int i = tid; i < 8 * kSlotEntries / 8; i += kWarp)
      __pipeline_memcpy_async(sm.lut + i * 8, lut + i * 8, 16);
    jgt::load_slots(sm.slots, tab.cbase, tab.counts, tab.symbols, tile.s);
    for (int c = tid; c <= tab.bpm; c += kWarp) {
      const uint32_t slot_bytes = kSlotEntries * sizeof(uint16_t);
      sm.dc_off[c] = c < tab.bpm ? (static_cast<uint32_t>(tab.dcslot[c]) & 7u) * slot_bytes : 0u;
      sm.ac_off[c] = c < tab.bpm ? (static_cast<uint32_t>(tab.acslot[c]) & 7u) * slot_bytes : 0u;
    }
    // One flag per (sublane, slot) follows the tables.
    const uint16_t* flags = tab.lut + static_cast<size_t>(64) * kSlotEntries + tile.s * 8;
    sm.complete = __all_sync(kFull, flags[tid & 7] != 0);
    sm.sublane = tile.s;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
}

struct LaneState {
  int p, c, at_dc, k;
};

// One lane's decode from `st` to its first token boundary at or past `end`
// (bits, relative to its window).  Notes the MCU starts it meets in
// sm.rec[j][lane], j < maxrec, and returns their count, which may be larger.
// kComplete: the tables answer every window, so the step holds no call of
// decode_symbol (a branch that costs some 50 cycles a step even when no lane
// ever takes it).
//
// Measured on the card, a step of this loop costs its instruction count
// times about five cycles: one warp on an SM finds nothing to overlap.  So
// the step has no branch, and as few instructions as the rules allow:
// * the window is the reference's (64 bits at bit p, MSB-aligned in (hi, lo),
//   `navail` of them valid, topped up with word `wp` once 32 or fewer are
//   left; a word outside the row reads 0), but the next word is loaded a
//   step ahead and merged by a clamped shift (0 while more than 32 bits are
//   left) and a select;
// * a record is one predicated store to shared memory;
// * both tables the next step may look up in -- the phase's AC table, or
//   the next phase's DC table after a block end -- are picked from the
//   phase before the symbol is known;
// * the table entry holds the consumed bits ready made (chain_entry), and a
//   first-level entry that points on holds the second table's byte offset.
template <bool kComplete>
__device__ __forceinline__ int decode_lane_as(const WarpSmem& sm, int bpm, int end,
                                              int max_iters, int maxrec, LaneState& st) {
  int p = st.p, c = st.c, at_dc = st.at_dc, k = st.k;
  const int lane = threadIdx.x & (kWarp - 1);
  auto phase = [&](int cc) -> int {   // index into dc_off / ac_off
    return static_cast<int>(min(static_cast<uint32_t>(cc), static_cast<uint32_t>(bpm)));
  };
  const uint32_t* row = sm.rows + lane;
  const int nws = sm.nws;
  auto word = [&](int w) -> uint32_t {
    return static_cast<uint32_t>(w) < static_cast<uint32_t>(nws) ? row[w * kWarp] : 0u;
  };
  int wp = static_cast<int>(static_cast<uint32_t>(p) >> 5);
  const int sh = p & 31;
  const uint32_t w0 = word(wp), w1 = word(wp + 1);
  uint32_t hi = __funnelshift_l(w1, w0, sh);
  uint32_t lo = w1 << sh;
  int navail = 64 - sh;   // 33..64 at every lookup
  wp += 2;
  uint32_t w = word(wp);  // the next word, loaded a step ahead
  const unsigned char* lut = reinterpret_cast<const unsigned char*>(sm.lut);
  const uint32_t rec = static_cast<uint32_t>(__cvta_generic_to_shared(sm.rec + lane));
  uint32_t off = (at_dc > 0 ? sm.dc_off : sm.ac_off)[phase(c)];

  int recn = 0;
  for (int it = 0; it < max_iters && p < end; ++it) {
    const bool is_dc = at_dc > 0;
    const bool mcu_start = is_dc && c == 0;
    jgt::store_shared_if(mcu_start, rec + min(recn, maxrec) * static_cast<int>(kRowBytes), p);
    recn += mcu_start ? 1 : 0;
    const int c_next = c + 1 == bpm ? 0 : c + 1;
    const uint32_t off_same = sm.ac_off[phase(c)];
    const uint32_t off_next = sm.dc_off[phase(c_next)];

    const unsigned char* tables = lut + off;
    const uint32_t sub = (hi >> (16 - 1)) & ((kSubSize - 1) << 1);   // byte offset in a second table
    uint32_t e = *reinterpret_cast<const uint16_t*>(tables + ((hi >> (32 - kLutBits)) << 1));
    if (e & kLutSub)   // a code of more than 10 bits: its second-level table
      e = *reinterpret_cast<const uint16_t*>(tables + (e & (kLutSub - 1)) + sub);
    if (!kComplete && e == kLutMiss) {
      int sym, len;
      jgt::decode_symbol(hi, sm.slots[off / (kSlotEntries * sizeof(uint16_t))], sym, len);
      e = chain_entry(sym, len);
    }
    const int n = static_cast<int>((e >> (is_dc ? 5 : 0)) & 31u);
    const int newk = k + static_cast<int>((e >> 10) & 15u) + 1;
    const bool blk_end = !is_dc && ((e & 0x4000u) != 0 || newk >= 63);
    k = is_dc ? 0 : min(newk, 63);
    off = blk_end ? off_next : off_same;
    c = blk_end ? c_next : c;
    at_dc = blk_end ? 1 : 0;   // after a DC symbol come the block's AC symbols
    p += n;
    hi = __funnelshift_l(lo, hi, n);
    lo <<= n;
    navail -= n;
    const bool need = navail <= 32;
    hi |= __funnelshift_rc(w, 0u, navail);   // w >> navail, 0 from 32 on
    lo |= need ? w << ((32 - navail) & 31) : 0u;
    navail += need ? 32 : 0;
    wp += need ? 1 : 0;
    w = word(wp);
  }
  st.p = p;
  st.c = c;
  st.at_dc = at_dc;
  st.k = k;
  return recn;
}

__device__ __forceinline__ int decode_lane(const WarpSmem& sm, int bpm, int end,
                                           int max_iters, int maxrec, LaneState& st) {
  return sm.complete ? decode_lane_as<true>(sm, bpm, end, max_iters, maxrec, st)
                     : decode_lane_as<false>(sm, bpm, end, max_iters, maxrec, st);
}

// A lane's first min(recn, maxrec) records from shared memory to its column
// `lane_rec` of a (BS, maxrec, 8, 128) tensor.
__device__ __forceinline__ void flush_records(const WarpSmem& sm, int32_t* lane_rec,
                                              int recn, int maxrec) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int kept = min(recn, maxrec);
  const int most = __reduce_max_sync(kFull, kept);
  for (int j = 0; j < most; ++j)
    if (j < kept) lane_rec[static_cast<int64_t>(j) * kLanes] = sm.rec[j * kWarp + lane];
}

// Bits of lane gl's subsequence that hold stream: lanes past the stream end
// get end <= 0 and never decode.
__device__ __forceinline__ int lane_end(int64_t gl, int nbits, int sb_bits) {
  const int64_t left = static_cast<int64_t>(nbits) - gl * sb_bits;
  return left >= sb_bits ? sb_bits : left < INT32_MIN ? INT32_MIN : static_cast<int>(left);
}

// State rows (p, c, at_dc, k) of global lane gl in a (BS, 4, 8, 128) tensor.
__device__ __forceinline__ LaneState load_state(const int32_t* base, int64_t gl) {
  const int32_t* s = base + (gl / kLanes) * 4 * kLanes + gl % kLanes;
  return {__ldcg(s), __ldcg(s + kLanes), __ldcg(s + 2 * kLanes), __ldcg(s + 3 * kLanes)};
}

__device__ __forceinline__ void store_state(int32_t* base, int64_t gl, const LaneState& st) {
  int32_t* s = base + (gl / kLanes) * 4 * kLanes + gl % kLanes;
  s[0] = st.p;
  s[kLanes] = st.c;
  s[2 * kLanes] = st.at_dc;
  s[3 * kLanes] = st.k;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// The whole scan.  Scratch `work` (int32): entry (BS, 4, 1024), two exit
// buffers (BS, 4, 1024) each, record counts (BS * 1024), per-tile record
// sums and overflow flags (BS * 32 each).  `rec` is (BS, maxrec, 1024)
// scratch.  `round_lanes` (max_rounds + 1) must be zero: [r] counts the
// lanes that decoded in pass r (pass 0 every lane that holds stream), and
// doubles as the convergence flag.  Outputs: bitpos (n_mcus), ok (one
// byte), stats (rounds, total records, overflowed).
//
// With `from_entry` the kernel runs one round instead: pass 0 starts from
// the entry states the caller left in `work`, and the kernel ends after it,
// with the exit states in the first exit buffer, the record counts and the
// records where the whole scan keeps them; bitpos, ok and stats are not
// touched.
__global__ void __launch_bounds__(kWarp)
index_scan_kernel(const int32_t* __restrict__ windows, Tables tab,
                  int32_t* work, int32_t* rec, int32_t* round_lanes,
                  int32_t* __restrict__ bitpos, uint8_t* __restrict__ ok,
                  int32_t* __restrict__ stats, int nbatch, int nws, int nbits,
                  int sb, int maxrec, int n_mcus, int max_rounds, int from_entry) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WarpSmem sm = carve(smem_raw, maxrec, nws, tab.bpm);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int ntiles = nbatch * kTilesPerBatch;
  const int64_t nlanes = static_cast<int64_t>(nbatch) * kLanes;
  const int sb_bits = sb * 8;
  const int max_iters = sb_bits + 2;
  int32_t* entry = work;
  int32_t* exits = work + 4 * nlanes;   // two buffers, read and written in turns
  int32_t* recn_of = work + 12 * nlanes;
  int32_t* tile_sum = work + 13 * nlanes;
  int32_t* tile_ovf = tile_sum + ntiles;
  const LaneState start = {0, 0, 1, 0};

  // Pass 0: every lane from the start state, or from the caller's entries.
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tile(t);
    stage_tile(sm, tab, windows, nws, tile);
    LaneState st = start;
    if (from_entry)
      st = load_state(entry, tile.gl);
    else
      store_state(entry, tile.gl, st);
    const int end = lane_end(tile.gl, nbits, sb_bits);
    const int recn = decode_lane(sm, tab.bpm, end, max_iters, maxrec, st);
    __syncwarp();
    flush_records(sm, rec + static_cast<int64_t>(tile.b) * maxrec * kLanes + tile.lane, recn, maxrec);
    recn_of[tile.gl] = recn;
    store_state(exits, tile.gl, st);
    const int live = __popc(__ballot_sync(kFull, end > 0));
    if (tid == 0 && live) atomicAdd(round_lanes, live);
  }
  if (from_entry) return;
  grid.sync();

  // Pass r takes each lane's entry from its left neighbour's exit of pass
  // r - 1 and decodes the lanes whose entry changed.  If none changed, pass
  // r - 1 was the last of `r` Jacobi rounds.
  int rounds = max_rounds;
  bool converged = false;
  for (int r = 1; r <= max_rounds; ++r) {
    const int32_t* prev = exits + ((r - 1) & 1) * 4 * nlanes;
    int32_t* cur = exits + (r & 1) * 4 * nlanes;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const Tile tile(t);
      const int end = lane_end(tile.gl, nbits, sb_bits);
      // Lane 0 and the lanes past the stream end stay pinned to the start
      // state, so the tail lane's exit does not ripple through the padding.
      LaneState want = start;
      if (tile.gl > 0 && end > 0) {
        want = load_state(prev, tile.gl - 1);
        want.p -= sb_bits;
        if (want.at_dc > 0) want.k = 0;   // k is dead at a DC boundary
      }
      LaneState st = load_state(entry, tile.gl);
      const bool changed =
          want.p != st.p || want.c != st.c || want.at_dc != st.at_dc || want.k != st.k;
      const unsigned who = __ballot_sync(kFull, changed);
      if (who) stage_tile(sm, tab, windows, nws, tile);
      int recn = 0;
      if (changed) {
        store_state(entry, tile.gl, want);
        st = want;
        recn = decode_lane(sm, tab.bpm, end, max_iters, maxrec, st);
        recn_of[tile.gl] = recn;
      } else {
        st = load_state(prev, tile.gl);
      }
      store_state(cur, tile.gl, st);
      if (who) {
        __syncwarp();
        flush_records(sm, rec + static_cast<int64_t>(tile.b) * maxrec * kLanes + tile.lane, recn, maxrec);
        if (tid == 0) atomicAdd(round_lanes + r, __popc(who));
      }
    }
    grid.sync();
    if (__ldcg(round_lanes + r) == 0) {
      rounds = r;
      converged = true;
      break;
    }
  }

  // Stitch.  Per-tile record sums first ...
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tile(t);
    const int n = __ldcg(recn_of + tile.gl);
    const int sum = warp_sum(n);
    const unsigned over = __ballot_sync(kFull, n > maxrec);
    if (tid == 0) {
      tile_sum[t] = sum;
      tile_ovf[t] = over != 0;
    }
  }
  grid.sync();
  // ... then each record's global MCU index is the exclusive prefix sum of
  // the counts before it: the tiles before this one, the lanes before this
  // one in the tile, the records before this one in the lane.
  int total = 0, overflow = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tile(t);
    int before = 0;
    total = 0;
    overflow = 0;
    for (int i = tid; i < ntiles; i += kWarp) {
      const int v = __ldcg(tile_sum + i);
      total += v;
      if (i < t) before += v;
      overflow |= __ldcg(tile_ovf + i);
    }
    total = warp_sum(total);
    before = warp_sum(before);
    overflow = __any_sync(kFull, overflow != 0);
    const int n = __ldcg(recn_of + tile.gl);
    int incl = n;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (tid >= d) incl += up;
    }
    const int first = before + incl - n;
    const uint32_t lane_base = static_cast<uint32_t>(tile.gl) * static_cast<uint32_t>(sb_bits);
    const int32_t* rec_lane = rec + static_cast<int64_t>(tile.b) * maxrec * kLanes + tile.lane;
    for (int j = 0; j < n; ++j) {
      const int64_t g = static_cast<int64_t>(first) + j;
      if (g >= n_mcus) break;
      // Counted but dropped records (past maxrec) leave their position 0.
      bitpos[g] = j < maxrec
                      ? static_cast<int32_t>(static_cast<uint32_t>(__ldcg(rec_lane + static_cast<int64_t>(j) * kLanes)) + lane_base)
                      : 0;
    }
  }
  // Positions past the last record, and the verdict.  Every block walked
  // at least one tile (the grid is no larger than the tile count), so
  // `total` and `overflow` are set.
  for (int64_t i = static_cast<int64_t>(total) + blockIdx.x * kWarp + tid; i < n_mcus;
       i += static_cast<int64_t>(gridDim.x) * kWarp)
    bitpos[i] = 0;
  if (blockIdx.x == 0 && tid == 0) {
    *ok = converged && !overflow && total >= n_mcus;
    stats[0] = rounds;
    stats[1] = total;
    stats[2] = overflow;
  }
}

// The row must hold the words of the subsequence's bits and one more: the
// step reads words p / 32 and p / 32 + 1 for any p below the lane's end.
int check_geometry(int nbatch, int nws, int sb, int bpm, int maxrec) {
  const bool ok = nbatch > 0 && sb > 0 && bpm > 0 && maxrec >= 0 &&
                  nws >= ((sb * 8 - 1) >> 5) + 2;
  return ok ? 0 : int(cudaErrorInvalidValue);
}

Tables make_tables(const void* dcslot, const void* acslot, const void* cbase,
                   const void* counts, const void* symbols, const void* lut, int bpm) {
  return {static_cast<const int32_t*>(dcslot), static_cast<const int32_t*>(acslot),
          static_cast<const int32_t*>(cbase),  static_cast<const int32_t*>(counts),
          static_cast<const int32_t*>(symbols), static_cast<const uint16_t*>(lut), bpm};
}

// Enqueue the symbol tables' build into `lut`: (8, 8, 2048) u16 and 64 flags.
int launch_lut(const void* cbase, const void* counts, const void* symbols, void* lut,
               cudaStream_t stream) {
  scan_lut_kernel<<<64, jgt::kLutSize, 0, stream>>>(
      static_cast<const int32_t*>(cbase), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(symbols), static_cast<uint16_t*>(lut));
  return int(cudaGetLastError());
}

}  // namespace

// The symbol tables alone: cbase (8, 16), counts (8, 17), symbols
// (8, 8, 128) i32 -> lut (8, 8, 2048) u16, [sublane][slot][entry], then 64
// u16 flags, [sublane][slot].
extern "C" int jgt_specsync_lut(const void* cbase, const void* counts,
                                const void* symbols, void* lut, void* stream) {
  return launch_lut(cbase, counts, symbols, lut, static_cast<cudaStream_t>(stream));
}

// Number of int32 words of `work` that jgt_specsync_index_scan needs.
extern "C" long long jgt_specsync_work_words(int nbatch) {
  return 13LL * nbatch * kLanes + 2LL * nbatch * kTilesPerBatch;
}

// The whole scan, or one round of it when from_entry != 0: see
// index_scan_kernel for the scratch and the outputs.  windows (BS, NWS, 8,
// 128) i32, NWS at least the words of SB bytes and two more; dcslot/acslot
// (bpm,) i32; cbase (8, 16), counts (8, 17), symbols (8, 8, 128) i32; lut
// 8 * 8 * 2048 + 64 u16: scratch that this call fills with the symbol
// tables, or with lut_given != 0 the tables an earlier jgt_specsync_lut
// built from the same cbase, counts and symbols.  Launches the tables'
// kernel (unless they are given) and one cooperative kernel on `stream`, and
// never synchronises.  Returns the first CUDA error, 0 if none.
extern "C" int jgt_specsync_index_scan(const void* windows, const void* dcslot,
                                       const void* acslot, const void* cbase,
                                       const void* counts, const void* symbols,
                                       void* lut, void* work, void* rec,
                                       void* round_lanes, void* bitpos, void* ok,
                                       void* stats, int nbatch, int nws, int nbits,
                                       int sb, int bpm, int maxrec, int n_mcus,
                                       int max_rounds, int from_entry, int lut_given,
                                       void* stream_) {
  if (check_geometry(nbatch, nws, sb, bpm, maxrec) ||
      (!from_entry && (maxrec <= 0 || n_mcus <= 0 || max_rounds < 0)))
    return int(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  Tables tab = make_tables(dcslot, acslot, cbase, counts, symbols, lut, bpm);
  int rc = lut_given ? 0 : launch_lut(cbase, counts, symbols, lut, stream);
  if (rc) return rc;
  // As many one-warp blocks as the card holds at once, at most one a tile.
  const size_t smem = smem_bytes(nws, maxrec, bpm);
  rc = int(cudaFuncSetAttribute(index_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
  if (rc) return rc;
  int device = 0, sms = 0, per_sm = 0;
  if ((rc = int(cudaGetDevice(&device)))) return rc;
  if ((rc = int(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)))) return rc;
  if ((rc = int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, index_scan_kernel, kWarp, smem)))) return rc;
  if (per_sm < 1) return int(cudaErrorLaunchOutOfResources);
  const int ntiles = nbatch * kTilesPerBatch;
  const int grid = ntiles < per_sm * sms ? ntiles : per_sm * sms;
  const int32_t* windows_ = static_cast<const int32_t*>(windows);
  int32_t* work_ = static_cast<int32_t*>(work);
  int32_t* rec_ = static_cast<int32_t*>(rec);
  int32_t* round_lanes_ = static_cast<int32_t*>(round_lanes);
  int32_t* bitpos_ = static_cast<int32_t*>(bitpos);
  uint8_t* ok_ = static_cast<uint8_t*>(ok);
  int32_t* stats_ = static_cast<int32_t*>(stats);
  void* args[] = {&windows_, &tab,   &work_, &rec_, &round_lanes_, &bitpos_, &ok_,       &stats_,
                  &nbatch,   &nws,   &nbits, &sb,   &maxrec,       &n_mcus,  &max_rounds, &from_entry};
  return int(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(index_scan_kernel), dim3(grid),
                                         dim3(kWarp), args, smem, stream));
}
