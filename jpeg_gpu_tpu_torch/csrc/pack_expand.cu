// K4 on Hopper: PACK (run, value) streams -> dense natural-order coefficients.
//
// Replaces the TPU kernel jpeg_gpu_tpu/ops/pack_device.py:_pack_kernel
// (launched by expand_pack_device).  Input: (B, NW, 8, 128) int32 words, two
// unsigned 16-bit entries per word, high half first; word w of lane
// b*1024 + s*128 + l at [b, w, s, l] (host/pack_plan.py).  A lane holds the
// entries of K consecutive MCUs, T = K * blocks_per_mcu blocks.  Per block:
// one entry `DC & 0xfff` (absolute DC, 12-bit two's complement), then one
// entry `run << 12 | value & 0xfff` per non-zero AC coefficient, then
// 0x0000 as end of block, left out when the block fills to position 63.
// Output: (B, T, 64, 8, 128) int16, zero-filled by the caller.
//
// Bound: bytes -- the kernel reads 2 bytes per entry and its output is
// written once (the zero-fill) plus one 2-byte store per non-zero value;
// there is one compare and a few shifts per entry.
//
// Design (a simple, correct first version): one thread per lane walks its
// own entries with a running entry index, keeps the current word in a
// register, and stores each value straight to its natural-order row, so
// only non-zero values are touched after the zero-fill.  The TPU kernel's
// masked sweep over all NW words per fetch, its 63-step masked loop, its
// one-hot accumulate and its state scratch between grid steps were there
// because Mosaic has no per-lane addressing or scatter.  The semantics are
// kept: an entry of 0 ends the block whatever it encodes; a run that takes
// the position past 63 writes nothing and ends the block; every read is
// bounded by NW and gives 0 outside (a lane past the last segment, or a
// corrupt stream, decodes DC 0 and end of block and never leaves its row).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 1024;   // lanes per batch (8 x 128)
constexpr int kThreads = 32;   // one warp per block: neighbouring lanes

// Raster index of zig-zag position k (ops/zigzag.py:ZIGZAG).
__constant__ int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// 12-bit two's complement -> int (no shift of a negative value).
__device__ __forceinline__ int sign12(uint32_t v) {
  return v >= 0x800u ? int(v) - 0x1000 : int(v);
}

__global__ void __launch_bounds__(kThreads)
pack_expand_kernel(const int32_t* __restrict__ streams,
                   int16_t* __restrict__ out, int nw, int nsteps) {
  const int64_t g = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t b = g / kLanes;
  const int lane = int(g % kLanes);
  const int32_t* words = streams + b * nw * kLanes + lane;
  int16_t* o = out + b * nsteps * 64 * kLanes + lane;

  int entry_pos = 0;      // running index of the next 16-bit entry
  int cur_word = -1;      // index of the word held in `cur`
  uint32_t cur = 0;
  auto next_entry = [&]() -> uint32_t {
    const int w = entry_pos >> 1;
    if (w != cur_word) {
      cur = w < nw ? uint32_t(words[int64_t(w) * kLanes]) : 0u;
      cur_word = w;
    }
    const uint32_t e = (entry_pos & 1) ? (cur & 0xFFFFu) : (cur >> 16);
    ++entry_pos;
    return e;
  };

  for (int t = 0; t < nsteps; ++t) {
    int16_t* blk = o + int64_t(t) * 64 * kLanes;
    const int dc = sign12(next_entry() & 0xFFFu);
    if (dc != 0) blk[0] = int16_t(dc);
    int k = 0;
    while (k < 63) {
      const uint32_t e = next_entry();
      if (e == 0) break;                       // end of block
      const int newk = k + int(e >> 12) + 1;
      if (newk > 63) break;                    // run past the block: no write
      const int val = sign12(e & 0xFFFu);
      if (val != 0) blk[int64_t(kZigzag[newk]) * kLanes] = int16_t(val);
      k = newk;
    }
  }
}

}  // namespace

// streams (B, NW, 8, 128) int32; out (B, T, 64, 8, 128) int16, zero-filled
// by the caller.  Returns cudaGetLastError() after the launch.
extern "C" int jgt_pack_expand(const void* streams, void* out, int nbatch,
                               int nw, int nsteps, void* stream) {
  if (nbatch <= 0 || nw <= 0 || nsteps <= 0) return int(cudaErrorInvalidValue);
  const int grid = nbatch * (kLanes / kThreads);
  pack_expand_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(streams), static_cast<int16_t*>(out), nw, nsteps);
  return int(cudaGetLastError());
}
