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
// Output: (B, T, 64, 8, 128) int16, every element written by this kernel.
//
// Bound: bytes -- the kernel reads 2 bytes per entry and writes its output
// once as zeros plus one 2-byte store per non-zero value; there is one
// compare and a few shifts per entry.  In practice a lane is one serial
// chain over its entries, and only about a thousand lanes exist, so what
// the design buys is a short step.
//
// Design:
// * One thread per lane, one warp per CUDA block.  The lanes of a warp walk
//   their rows entry by entry in lockstep: entry i of every lane sits in
//   word i / 2, so the addresses do not depend on the data and the rows
//   stream through a three-stage ring in shared memory (cp.async, 16 words
//   x 32 lanes a stage, issued two stages ahead).  The chain never waits on
//   device memory.  A lane's format rules run as a small state machine
//   (block index, position, DC-next), so a warp takes as many steps as its
//   longest lane has entries, not the sum over blocks of the longest block.
// * The zero-fill is part of the kernel: while the first stages are in
//   flight the warp clears its own (T * 64) x 64-byte slice of the output
//   with 16-byte stores, then only non-zero values are stored, each straight
//   to its natural-order row.
// * One warp on an SM hides no latency, so a step costs about as many
//   cycles as it has dependent instructions times the pipeline's depth: the
//   step is written without branches (step()).
// * The semantics are the reference's: an entry of 0 ends the block whatever
//   it encodes; a run that takes the position past 63 writes nothing and
//   ends the block; a block that fills to 63 has no end entry; every read
//   is bounded by NW and gives 0 outside.  Past the row's end every entry
//   is 0 (DC 0, end of block), which stores nothing, so the walk stops
//   there: a lane past the last segment, or a corrupt stream, never leaves
//   its row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stage.cuh"

namespace {

using jgt::kWarp;

constexpr int kLanes = 1024;      // lanes per batch (8 x 128)
constexpr int kStageWords = 16;   // words of every lane in one ring stage
constexpr int kStages = 3;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Raster index of zig-zag position k (ops/zigzag.py:ZIGZAG).
__constant__ uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// 12-bit two's complement -> int (no shift of a negative value).
__device__ __forceinline__ int sign12(uint32_t v) {
  return v >= 0x800u ? int(v) - 0x1000 : int(v);
}

// A lane's place in its stream: the blocks it still has to fill, the
// current block's output, its zig-zag position k, and whether the next entry
// is the block's DC entry.
struct Walk {
  int left;
  int16_t* blk;
  int k = 0;
  bool at_dc = true;
};

// One entry.  The lanes of a warp sit at different places of their blocks,
// and one warp on an SM hides no latency, so the rules are selects and one
// predicated store, not branches: the chain from one entry to the next is
// the few instructions that update k and at_dc, and the store with its
// zig-zag lookup hangs off it.
__device__ __forceinline__ void step(Walk& w, uint32_t e, const uint8_t* zigzag) {
  const bool live = w.left > 0;
  const int val = sign12(e & 0xFFFu);
  const int newk = w.k + int(e >> 12) + 1;
  // An AC entry ends the block as the end entry, or as a run past the block
  // (neither writes), or by filling it to 63 (no end entry follows).
  const bool stop = e == 0 || newk > 63;
  const bool write = live && val != 0 && (w.at_dc || !stop);
  const int pos = w.at_dc ? 0 : newk & 63;
  jgt::store_if(write, w.blk + int(zigzag[pos]) * kLanes, int16_t(val));
  const bool end = live && !w.at_dc && (stop || newk == 63);
  w.k = w.at_dc ? 0 : newk;   // dead after a stop: the next entry is a DC entry
  w.at_dc = end;
  w.blk += end ? 64 * kLanes : 0;
  w.left -= end ? 1 : 0;
}

__global__ void __launch_bounds__(kWarp)
pack_expand_kernel(const int32_t* __restrict__ streams,
                   int16_t* __restrict__ out, int nw, int nsteps) {
  __shared__ __align__(16) uint32_t ring[kStages][kStageWords * kWarp];
  __shared__ uint8_t zigzag[64];
  const int tid = threadIdx.x;
  const int64_t g0 = int64_t(blockIdx.x) * kWarp;   // the warp's first lane
  const int64_t b = g0 / kLanes;
  const int lane0 = int(g0 % kLanes);
  const int32_t* src = streams + b * nw * kLanes + lane0;
  int16_t* warp_out = out + b * nsteps * 64 * kLanes + lane0;

  const int ntiles = (nw + kStageWords - 1) / kStageWords;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) jgt::stage_rows_async(ring[s], src, kLanes, s * kStageWords, kStageWords, nw);
    __pipeline_commit();
  }
  zigzag[tid] = kZigzag[tid];
  zigzag[tid + kWarp] = kZigzag[tid + kWarp];
  // Clear the warp's slice of the output: T * 64 rows of 32 lanes x 2 bytes.
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < nsteps * 64 * 4; i += kWarp)
    *reinterpret_cast<uint4*>(warp_out + int64_t(i >> 2) * kLanes + (i & 3) * 8) = zero;
  __syncwarp();   // the zeros are ordered before any lane's values

  Walk w;
  w.left = nsteps;
  w.blk = warp_out + tid;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int ahead = tile + kStages - 1;
    if (ahead < ntiles)
      jgt::stage_rows_async(ring[ahead % kStages], src, kLanes, ahead * kStageWords, kStageWords, nw);
    __pipeline_commit();
    __pipeline_wait_prior(kStages - 1);   // stage `tile` has landed
    __syncwarp();
    const uint32_t* words = ring[tile % kStages] + tid;
    uint32_t word[kStageWords];
#pragma unroll
    for (int i = 0; i < kStageWords; ++i) word[i] = words[i * kWarp];
#pragma unroll
    for (int i = 0; i < kStageWords; ++i) {
      step(w, word[i] >> 16, zigzag);
      step(w, word[i] & 0xFFFFu, zigzag);
    }
    // Also orders this stage's reads before the copy that reuses it.
    if (__all_sync(kFull, w.left <= 0)) break;
  }
  __pipeline_wait_prior(0);
}

}  // namespace

// streams (B, NW, 8, 128) int32; out (B, T, 64, 8, 128) int16, which the
// kernel fills whole.  Returns cudaGetLastError() after the launch.
extern "C" int jgt_pack_expand(const void* streams, void* out, int nbatch,
                               int nw, int nsteps, void* stream) {
  if (nbatch <= 0 || nw <= 0 || nsteps <= 0) return int(cudaErrorInvalidValue);
  const int grid = nbatch * (kLanes / kWarp);
  pack_expand_kernel<<<grid, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(streams), static_cast<int16_t*>(out), nw, nsteps);
  return int(cudaGetLastError());
}
