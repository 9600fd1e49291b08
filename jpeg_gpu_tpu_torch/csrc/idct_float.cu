// K6 on Hopper: dequant -> float 8x8 IDCT -> +128, round, clamp -> u8, all
// planes of a frame in one launch.
//
// Replaces the TPU kernel jpeg_gpu_tpu/ops/idct_pallas.py:_kernel (launched
// by _dequant_idct_tiles for dequant_idct_pixels_fused): the exact=False
// sample path.  Per block, in fp32,
//   Z = M^T (S o Q) M,   out = clip(round(Z + 128), 0, 255),
// with M the orthonormal 8-point DCT-II basis of ops/idct.py, S the integer
// coefficients and Q the quant table.  Rounding is to nearest even, as
// jnp.round and torch.round do.  Not bit-exact against the islow path, and
// allowed to differ by 1 from the plain version (the order of the sums and
// the fused multiply-adds differ).
//
// Bound: 2 bytes in and 1 byte out per sample against 32 fp32 operations
// per sample (two 8-term products); at the card's rates the bytes take
// longer than the operations, and for a 1080p frame both are microseconds.
//
// Design: K5's (idct_islow_plane.cu), with float arithmetic.
// * One launch for up to four planes (csrc/block_plane.cuh:PlaneSet), each
//   with its own strides, grid, output and one quant table or one per
//   leading index: a frame costs one launch, not one per component.
// * 32 blocks and 256 threads a CUDA block, eight threads an 8x8 block.  The
//   tile is staged dequantized (fp32 products, as the plain version's) in
//   shared memory with loads that follow the layout: 16 bytes a thread for
//   views of blocks, 64 contiguous bytes a warp for SoA planes.  Rows of 9
//   words and blocks of 72 keep both passes free of bank conflicts.
// * Thread e takes column e (t = M^T d), __syncwarp(), then row e
//   (z = t M), and stores its pixel row's 8 bytes with one 8-byte store.
//   Every basis entry a thread reads has an index fixed at compile time, the
//   same for all threads, so it is an operand of the FMA out of __constant__
//   memory: no divergent constant reads.
// * fp32 multiply-adds, no tensor cores, no TF32, no library call.  The TPU
//   kernel's 128x128 block-diagonal basis tiles, its 256-block tile layout
//   (blocks_to_tiles, tiles_to_blocks) and the i32 hop of its u8 cast served
//   the MXU and Mosaic, and are left out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_plane.cuh"

namespace {

constexpr int kThreads = jgt::kTileBlocks * 8;
constexpr int kRow = 9;            // words between the rows of a staged block
constexpr int kBlock = 8 * kRow;   // words between staged blocks

// ops/idct.py:dct_basis(float32): kM[u * 8 + n] = c(u) cos((2n + 1) u pi / 16).
__constant__ float kM[64] = {
    3.5355338e-01f, 3.5355338e-01f, 3.5355338e-01f, 3.5355338e-01f, 3.5355338e-01f, 3.5355338e-01f, 3.5355338e-01f, 3.5355338e-01f,
    4.9039263e-01f, 4.157348e-01f, 2.7778512e-01f, 9.754516e-02f, -9.754516e-02f, -2.7778512e-01f, -4.157348e-01f, -4.9039263e-01f,
    4.6193975e-01f, 1.9134171e-01f, -1.9134171e-01f, -4.6193975e-01f, -4.6193975e-01f, -1.9134171e-01f, 1.9134171e-01f, 4.6193975e-01f,
    4.157348e-01f, -9.754516e-02f, -4.9039263e-01f, -2.7778512e-01f, 2.7778512e-01f, 4.9039263e-01f, 9.754516e-02f, -4.157348e-01f,
    3.5355338e-01f, -3.5355338e-01f, -3.5355338e-01f, 3.5355338e-01f, 3.5355338e-01f, -3.5355338e-01f, -3.5355338e-01f, 3.5355338e-01f,
    2.7778512e-01f, -4.9039263e-01f, 9.754516e-02f, 4.157348e-01f, -4.157348e-01f, -9.754516e-02f, 4.9039263e-01f, -2.7778512e-01f,
    1.9134171e-01f, -4.6193975e-01f, 4.6193975e-01f, -1.9134171e-01f, -1.9134171e-01f, 4.6193975e-01f, -4.6193975e-01f, 1.9134171e-01f,
    9.754516e-02f, -2.7778512e-01f, 4.157348e-01f, -4.9039263e-01f, 4.9039263e-01f, -4.157348e-01f, 2.7778512e-01f, -9.754516e-02f,
};

__global__ void __launch_bounds__(kThreads)
idct_float_planes_kernel(const jgt::PlaneSet set) {
  __shared__ float s[jgt::kTileBlocks * kBlock];
  __shared__ float q[64];
  const int tid = threadIdx.x;
  int n, block0;
  const jgt::PlaneDesc& p = jgt::plane_of_tile(set, blockIdx.x, n, block0);
  const int nblocks = p.vb * p.hb;
  const int16_t* src = p.coefs + n * p.sn;
  if (tid < 64) q[tid] = float(p.quant[n * p.qstride + tid]);
  __syncthreads();

  // Stage the tile, dequantized: coefficient (u, v) of tile block i at
  // s[i * kBlock + u * kRow + v]; blocks past the grid's end as zeros.
  if (p.sj == 1) {
    // Block layout: thread -> (block, row u), eight coefficients.
    const int i = tid >> 3, u = tid & 7, idx = block0 + i;
    float* dst = s + i * kBlock + u * kRow;
    if (idx < nblocks) {
      const int16_t* row = src + (idx / p.hb) * p.sr + (idx % p.hb) * p.sc + u * 8;
      if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
        const int4 w = *reinterpret_cast<const int4*>(row);
        const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          dst[2 * k] = float(int16_t(words[k] & 0xFFFF)) * q[u * 8 + 2 * k];
          dst[2 * k + 1] = float(words[k] >> 16) * q[u * 8 + 2 * k + 1];
        }
      } else {
#pragma unroll
        for (int v = 0; v < 8; ++v) dst[v] = float(row[v]) * q[u * 8 + v];
      }
    } else {
#pragma unroll
      for (int v = 0; v < 8; ++v) dst[v] = 0.0f;
    }
  } else {
    // Any other strides (the SoA layout): thread -> (coefficient j, block).
    const int i = tid & (jgt::kTileBlocks - 1), idx = block0 + i;
    const bool inside = idx < nblocks;
    const int16_t* blk = src + (inside ? (idx / p.hb) * p.sr + (idx % p.hb) * p.sc : 0);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = (tid >> 5) + 8 * k;   // kThreads / kTileBlocks = 8 coefficients a pass
      s[i * kBlock + (j >> 3) * kRow + (j & 7)] = inside ? float(blk[j * p.sj]) * q[j] : 0.0f;
    }
  }
  __syncthreads();

  // Thread (block i, lane-in-block e).  Columns: t[i'][e] = sum_u M[u][i'] d[u][e].
  const int i = tid >> 3, e = tid & 7;
  float* blk = s + i * kBlock;
  float d[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) d[u] = blk[u * kRow + e];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float acc = kM[r] * d[0];
#pragma unroll
    for (int u = 1; u < 8; ++u) acc = fmaf(kM[u * 8 + r], d[u], acc);
    blk[r * kRow + e] = acc;
  }
  __syncwarp();
  // Rows: z[e][j] = sum_v t[e][v] M[v][j].
#pragma unroll
  for (int v = 0; v < 8; ++v) d[v] = blk[e * kRow + v];
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float acc = d[0] * kM[j];
#pragma unroll
    for (int v = 1; v < 8; ++v) acc = fmaf(d[v], kM[v * 8 + j], acc);
    const uint32_t px = uint32_t(min(max(__float2int_rn(acc + 128.0f), 0), 255));
    if (j < 4) lo |= px << (8 * j);
    else hi |= px << (8 * (j - 4));
  }

  const int idx = block0 + i;
  if (idx >= nblocks) return;
  const int r = idx / p.hb, c = idx % p.hb;
  const size_t width = size_t(p.hb) * 8;
  uint8_t* dst = p.out + (size_t(n) * p.vb * 8 + size_t(r) * 8 + e) * width + size_t(c) * 8;
  *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
}

}  // namespace

// `desc`: block_plane.cuh's eleven 64-bit values per plane (coefficients,
// quant tables, (n, vb*8, hb*8) uint8 output 8-byte aligned, strides sn, sj,
// sr, sc, n, vb, hb, table stride 0 or 64), for 1 to 4 planes.  One launch.
// Returns cudaGetLastError() after it, or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int jgt_idct_float_planes(const long long* desc, int nplanes, void* stream) {
  jgt::PlaneSet set = {};
  const long long blocks = jgt::make_plane_set(desc, nplanes, set);
  if (blocks < 1) return int(cudaErrorInvalidValue);
  idct_float_planes_kernel<<<unsigned(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(set);
  return int(cudaGetLastError());
}
