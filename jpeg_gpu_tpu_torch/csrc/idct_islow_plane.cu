// K5 on Hopper: coefficient planes -> dequant -> islow IDCT -> raster planes,
// all components of a frame in one launch.
//
// Replaces the TPU kernel
// jpeg_gpu_tpu/ops/idct_islow_pallas.py:_idct_plane_kernel (launched by
// dequant_idct_islow_plane_soa, once per component).  Per 8x8 block: multiply
// the 64 int16 coefficients by the component's quant table, run the two islow
// passes of csrc/idct_islow.cuh, add 128, clamp, and write the block's 8
// rows of 8 bytes into the (n, vb*8, hb*8) uint8 plane.  Bit-exact against
// ops/idct_islow.py:dequant_idct_islow_plane.
//
// Bound: 2 bytes in and 1 byte out per sample and about 10 integer
// operations per sample, so at the card's rates the bytes are the larger of
// the two times, but both are microseconds for a 1080p frame: at these sizes
// the time is launches and occupancy.
//
// Design:
// * One launch for up to four planes (csrc/block_plane.cuh:PlaneSet, by
//   value): each plane brings its own pointers, element strides, grid, quant
//   table (or a table per leading index) and output, and the CUDA blocks are
//   laid over the planes' tiles one plane after the other.  A frame's three
//   components cost one launch instead of three.
// * Eight threads per 8x8 block, 32 blocks (256 threads) per CUDA block: a
//   thread holds one column, then one row -- 8 values, not 64 -- so eight
//   times as many warps are resident as with a thread per block.
// * The tile's coefficients are staged through shared memory, dequantized,
//   by all 256 threads with loads that follow the layout: in the SoA layout
//   (..., 64, vb, hb) the 32 blocks of a tile are neighbours in each
//   coefficient plane, so a warp reads 64 contiguous bytes per coefficient;
//   in the block layout (..., vb, hb, 8, 8) each thread reads one 16-byte row
//   of a block and a warp 512 contiguous bytes (2-byte loads where the base
//   is not 16-byte aligned).  Both passes then run out of shared memory; the
//   eight threads of a block sit in one warp, so between the passes a
//   __syncwarp() is enough.  Rows of 9 words and blocks of 72 keep the column
//   reads, the row reads and the transposing writes free of bank conflicts.
// * A thread writes its row's 8 bytes; the four blocks of a warp that share
//   a pixel row are neighbours, so each store instruction fills 32-byte
//   sectors.
// * The butterfly is jgt::idct8 of csrc/idct_islow.cuh, the one K1 uses.
//   The TPU kernel's band grid, its vb % band padding rule, its packed-word
//   output and the word transpose after it were there for Mosaic's tiling and
//   do not exist here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_plane.cuh"
#include "idct_islow.cuh"

namespace {

constexpr int kThreads = jgt::kTileBlocks * 8;
constexpr int kRow = 9;            // words between the rows of a staged block
constexpr int kBlock = 8 * kRow;   // words between staged blocks

__global__ void __launch_bounds__(kThreads)
idct_islow_planes_kernel(const jgt::PlaneSet set) {
  __shared__ int s[jgt::kTileBlocks * kBlock];
  __shared__ int q[64];
  const int tid = threadIdx.x;
  int n, block0;
  const jgt::PlaneDesc& p = jgt::plane_of_tile(set, blockIdx.x, n, block0);
  const int nblocks = p.vb * p.hb;
  const int16_t* src = p.coefs + n * p.sn;
  if (tid < 64) q[tid] = p.quant[n * p.qstride + tid];   // this tile's leading index
  __syncthreads();

  // Stage the tile, dequantized: coefficient (u, v) of tile block i at
  // s[i * kBlock + u * kRow + v]; blocks past the grid's end as zeros.
  if (p.sj == 1) {
    // Block layout: thread -> (block, row u), eight coefficients.
    const int i = tid >> 3, u = tid & 7, idx = block0 + i;
    int* dst = s + i * kBlock + u * kRow;
    if (idx < nblocks) {
      const int16_t* row = src + (idx / p.hb) * p.sr + (idx % p.hb) * p.sc + u * 8;
      if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
        const int4 w = *reinterpret_cast<const int4*>(row);
        const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          dst[2 * k] = int(int16_t(words[k] & 0xFFFF)) * q[u * 8 + 2 * k];
          dst[2 * k + 1] = (words[k] >> 16) * q[u * 8 + 2 * k + 1];
        }
      } else {
#pragma unroll
        for (int v = 0; v < 8; ++v) dst[v] = int(row[v]) * q[u * 8 + v];
      }
    } else {
#pragma unroll
      for (int v = 0; v < 8; ++v) dst[v] = 0;
    }
  } else {
    // Any other strides (the SoA layout): thread -> (coefficient j, block).
    const int i = tid & (jgt::kTileBlocks - 1), idx = block0 + i;
    const bool inside = idx < nblocks;
    const int16_t* blk = src + (inside ? (idx / p.hb) * p.sr + (idx % p.hb) * p.sc : 0);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = (tid >> 5) + 8 * k;   // kThreads / kTileBlocks = 8 coefficients a pass
      s[i * kBlock + (j >> 3) * kRow + (j & 7)] = inside ? int(blk[j * p.sj]) * q[j] : 0;
    }
  }
  __syncthreads();

  // Columns, then rows: thread (block i, lane-in-block e).
  const int i = tid >> 3, e = tid & 7;
  int* blk = s + i * kBlock;
  int t[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) t[u] = blk[u * kRow + e];
  jgt::idct8(t, jgt::CONST_BITS - jgt::PASS1_BITS);
#pragma unroll
  for (int u = 0; u < 8; ++u) blk[u * kRow + e] = t[u];
  __syncwarp();
#pragma unroll
  for (int v = 0; v < 8; ++v) t[v] = blk[e * kRow + v];
  jgt::idct8(t, jgt::CONST_BITS + jgt::PASS1_BITS + 3);

  const int idx = block0 + i;
  if (idx >= nblocks) return;
  const int r = idx / p.hb, c = idx % p.hb;
  const size_t width = size_t(p.hb) * 8;
  uint8_t* dst = p.out + (size_t(n) * p.vb * 8 + size_t(r) * 8 + e) * width + size_t(c) * 8;
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    lo |= uint32_t(jgt::clamp255(t[v] + 128)) << (8 * v);
    hi |= uint32_t(jgt::clamp255(t[v + 4] + 128)) << (8 * v);
  }
  *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
}

}  // namespace

// `desc`: eleven 64-bit values per plane on the host -- the addresses of the
// int16 coefficients (addressed by the element strides of block_plane.cuh),
// of the int32 quant tables and of the (n, vb*8, hb*8) uint8 output (8-byte
// aligned), then the strides sn, sj, sr, sc, then n, vb, hb, then the table
// stride (0: one (64,) table; 64: an (n, 64) table per leading index) -- for
// 1 to 4 planes.  One launch.  Returns cudaGetLastError() after it, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int jgt_idct_islow_planes(const long long* desc, int nplanes, void* stream) {
  jgt::PlaneSet set = {};
  const long long blocks = jgt::make_plane_set(desc, nplanes, set);
  if (blocks < 1) return int(cudaErrorInvalidValue);
  idct_islow_planes_kernel<<<unsigned(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(set);
  return int(cudaGetLastError());
}
