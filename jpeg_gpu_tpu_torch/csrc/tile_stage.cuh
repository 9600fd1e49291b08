// Staging of per-lane word rows in shared memory, and predicated stores,
// shared by K3 and K4.
//
// Both kernels give each CUDA thread ("lane") one serial chain that reads
// the words of its own row of a (rows, 8, 128) int32 tensor: word w of lane
// l sits at src[w * stride + l], so the 32 lanes of a warp read 128
// contiguous bytes per word index.  A chain that waits on device memory at
// every word costs hundreds of cycles a step; staged in shared memory a
// word costs a few tens.  The copy is asynchronous (cp.async, 16 bytes per
// thread and instruction, whole 128-byte rows, coalesced), so it overlaps
// with whatever the warp does before it waits.
//
// The staged tile is tile[r * 32 + lane]: lane l reads bank l whatever its
// row, so lanes that have drifted to different words never conflict.

#pragma once

#include <cuda_pipeline.h>
#include <stdint.h>

namespace jgt {

constexpr int kWarp = 32;

// Start the copy of rows [row0, row0 + nrows) of one warp's 32 lanes into
// tile[nrows][32].  `src` points at lane 0's word of row 0 and must be
// 16-byte aligned, as must `tile`; `stride` is the distance between rows in
// words.  Rows at or past `row_limit` are filled with zeros instead of
// being read.  Called by all 32 threads of the warp; the caller commits
// the batch (__pipeline_commit), waits for it (__pipeline_wait_prior) and
// then __syncwarp()s before any thread reads the tile.
__device__ __forceinline__ void stage_rows_async(uint32_t* tile,
                                                 const int32_t* src,
                                                 int64_t stride, int row0,
                                                 int nrows, int row_limit) {
  const int tid = threadIdx.x & (kWarp - 1);
  for (int i = tid; i < nrows * 8; i += kWarp) {
    const int r = i >> 3, q = (i & 7) * 4;
    const int row = row0 + r;
    const bool inside = row < row_limit;
    // A zfill equal to the size copies nothing and writes 16 zero bytes.
    __pipeline_memcpy_async(tile + r * kWarp + q,
                            src + (inside ? row : 0) * stride + q, 16,
                            inside ? 0 : 16);
  }
}

// Store `v` to global memory at `addr` if `p`, as one predicated
// instruction.  Written as `if (p) *addr = v;` the compiler branches around
// the store and its address arithmetic, and in a warp whose lanes take the
// branch at different steps every lane then waits for both sides at every
// step; predicated, the store leaves the chain of dependent instructions.
__device__ __forceinline__ void store_if(bool p, int16_t* addr, int16_t v) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %0, 0;\n\t@q st.global.u16 [%1], %2;\n\t}"
      :
      : "r"(static_cast<uint32_t>(p)), "l"(__cvta_generic_to_global(addr)), "h"(v)
      : "memory");
}

// The same for a 32-bit shared-memory address (__cvta_generic_to_shared).
__device__ __forceinline__ void store_shared_if(bool p, uint32_t addr, int32_t v) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %0, 0;\n\t@q st.shared.s32 [%1], %2;\n\t}"
      :
      : "r"(static_cast<uint32_t>(p)), "r"(addr), "r"(v)
      : "memory");
}

}  // namespace jgt
