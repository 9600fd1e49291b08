// K2 on Hopper: restart-parallel baseline Huffman decode.
//
// Replaces the TPU kernel jpeg_gpu_tpu/ops/entropy_device.py:_entropy_kernel
// (its body _decode_tile), launched by decode_segments_device_multi.
// Input: destuffed big-endian words (B, NW, 8, 128) int32 -- word w of
// segment slot b*1024 + s*128 + l at [b, w, s, l] -- and the canonical-rank
// tables of host/segments.py.  Output: natural-order coefficients
// (B, T, 64, 8, 128) int16 (the caller zero-fills them) and per-segment
// error flags (B, 8, 128) int32.
//
// Bound: each segment is one serial chain (refill -> rank sum -> entry
// lookup -> consume), so a thread's time is its symbol count times the
// chain's latency; the bytes moved (about 1 bit in per coded bit, 2 bytes
// out per written coefficient) are far below the card's bandwidth.
//
// Design (a simple, correct first version):
// * One thread per segment slot.  It walks its T block steps, decodes the
//   DC symbol and then AC symbols until EOB or k = 63, and stores each
//   coefficient straight to its natural-order row.  On the TPU every lane
//   ran all 63 AC iterations in lockstep and accumulated through one-hot
//   rows (Mosaic has no scatter); here a thread stops at EOB and scatters.
// * One warp per CUDA block, all 32 lanes on one sublane row, so the word
//   reads of a warp at [b, w, s, l..l+31] fall on neighbouring addresses
//   and there are 8x more blocks to spread over the SMs than 128-thread
//   blocks would give.
// * The block's image tables (8 slots: cbase, counts and the packed entries
//   of its sublane) sit in shared memory; the rank sum reads them there.
// * Every word read is bounded by NW (a read past the row gives 0, as the
//   TPU's masked fetch did): an out-of-bounds read would kill the context.
// * Flag semantics are the reference's: an invalid window or a DC size
//   > 15 is ERR_BAD_CODE and consumes no bits; an AC symbol of size 0 that
//   is neither EOB nor ZRL is ERR_BAD_CODE; k past 63 is ERR_OVERRUN.  The
//   flags of the short last segment's padded tail steps are suppressed
//   (seg_meta), so flags are exact for every segment.

#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman_bits.cuh"

namespace {

constexpr int kLanes = 1024;        // segment slots per batch (8 x 128)
constexpr int kThreads = 32;        // one warp per block

// Raster index of zig-zag position k (ops/zigzag.py:ZIGZAG).
__constant__ int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

__global__ void __launch_bounds__(kThreads)
entropy_decode_kernel(const int32_t* __restrict__ streams,
                      const int32_t* __restrict__ img_of_batch,
                      const int32_t* __restrict__ comp_map,
                      const int32_t* __restrict__ dcslot_map,
                      const int32_t* __restrict__ acslot_map,
                      const int32_t* __restrict__ seg_meta,
                      const int32_t* __restrict__ cbase,
                      const int32_t* __restrict__ counts,
                      const int32_t* __restrict__ symbols,
                      int16_t* __restrict__ out, int32_t* __restrict__ err,
                      int nw, int nsteps, int nimages) {
  __shared__ jgt::Slot slots[8];
  const int blocks_per_row = 128 / kThreads;
  const int row = blockIdx.x / blocks_per_row;   // b * 8 + s
  const int b = row >> 3, s = row & 7;
  const int lane = s * 128 + (blockIdx.x % blocks_per_row) * kThreads + threadIdx.x;
  const int img = img_of_batch[b];
  if (img < 0 || img >= nimages) {
    // No tables to read: every segment of the batch is flagged and its
    // coefficients stay zero (uniform over the block, before any barrier).
    err[static_cast<int64_t>(b) * kLanes + lane] = jgt::kErrBadCode;
    return;
  }
  jgt::load_slots(slots, cbase + img * 8 * 16, counts + img * 8 * 17,
                  symbols + img * 8 * 8 * 128, s);
  __syncthreads();

  const int32_t* words = streams + static_cast<int64_t>(b) * nw * kLanes + lane;
  int16_t* o = out + static_cast<int64_t>(b) * nsteps * 64 * kLanes + lane;
  const bool last_lane =
      b == seg_meta[img * 3] && lane == seg_meta[img * 3 + 1];
  const int last_steps = seg_meta[img * 3 + 2];

  jgt::Window win;
  int dc[4] = {0, 0, 0, 0};
  int flags = 0;
  for (int t = 0; t < nsteps; ++t) {
    // The masks keep a malformed map inside the arrays (plans never give one).
    const int comp = comp_map[t] & 3;
    const jgt::Slot& dct = slots[dcslot_map[t] & 7];
    const jgt::Slot& act = slots[acslot_map[t] & 7];
    int16_t* blk = o + static_cast<int64_t>(t) * 64 * kLanes;
    int step_flags = 0;
    int sym, len;

    // DC: size = symbol; an invalid code or a size > 15 consumes nothing.
    win.refill(words, nw, kLanes);
    jgt::decode_symbol(win.hi, dct, sym, len);
    const bool bad_dc = len > 16 || sym > 15;
    if (bad_dc) {
      step_flags |= jgt::kErrBadCode;
    } else {
      const int size = sym;
      const int diff = jgt::extend(win.hi, len, size);
      win.consume(len + size);
      dc[comp] += diff;
    }
    blk[0] = static_cast<int16_t>(dc[comp]);

    // AC: until EOB, k = 63, or a fault.
    if (!bad_dc) {
      int k = 0;
      for (int i = 0; i < 63; ++i) {
        win.refill(words, nw, kLanes);
        jgt::decode_symbol(win.hi, act, sym, len);
        if (len > 16) {  // invalid code: treated as EOB, consumes nothing
          step_flags |= jgt::kErrBadCode;
          break;
        }
        if (sym == 0) {  // EOB
          win.consume(len);
          break;
        }
        const int run = sym >> 4, size = sym & 15;
        const int val = jgt::extend(win.hi, len, size);
        const int newk = k + run + 1;
        const bool badsym = size == 0 && run != 15;
        const bool over = newk > 63;
        win.consume(len + size);
        if (badsym) step_flags |= jgt::kErrBadCode;
        if (over) step_flags |= jgt::kErrOverrun;
        if (size > 0 && !over)
          blk[static_cast<int64_t>(kZigzag[newk]) * kLanes] = static_cast<int16_t>(val);
        k = min(newk, 63);
        if (k >= 63 || over || badsym) break;
      }
    }
    if (!(last_lane && t >= last_steps)) flags |= step_flags;
  }
  err[static_cast<int64_t>(b) * kLanes + lane] = flags;
}

}  // namespace

// streams (B, NW, 8, 128) i32; img_of_batch (B,) i32; comp/dcslot/acslot
// maps (T,) i32; seg_meta (NI, 3) i32; cbase (NI, 8, 16), counts
// (NI, 8, 17), symbols (NI, 8, 8, 128) i32; out (B, T, 64, 8, 128) i16,
// zero-filled by the caller; err (B, 8, 128) i32.  Returns
// cudaGetLastError() after the launch.
extern "C" int jgt_entropy_decode(const void* streams, const void* img_of_batch,
                                  const void* comp_map, const void* dcslot_map,
                                  const void* acslot_map, const void* seg_meta,
                                  const void* cbase, const void* counts,
                                  const void* symbols, void* out, void* err,
                                  int nbatch, int nw, int nsteps, int nimages,
                                  void* stream) {
  if (nbatch <= 0 || nsteps <= 0) return int(cudaErrorInvalidValue);
  const int grid = nbatch * kLanes / kThreads;
  entropy_decode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(streams), static_cast<const int32_t*>(img_of_batch),
      static_cast<const int32_t*>(comp_map), static_cast<const int32_t*>(dcslot_map),
      static_cast<const int32_t*>(acslot_map), static_cast<const int32_t*>(seg_meta),
      static_cast<const int32_t*>(cbase), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(symbols), static_cast<int16_t*>(out),
      static_cast<int32_t*>(err), nw, nsteps, nimages);
  return int(cudaGetLastError());
}
