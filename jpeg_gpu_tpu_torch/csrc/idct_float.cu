// K6 on Hopper: dequant -> float 8x8 IDCT -> +128, round, clamp -> u8.
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
// longer than the operations, and for one 1080p plane both are microseconds.
//
// Design (a simple, correct first version): one thread per block; the
// products are written out as fp32 multiply-adds against the basis in
// __constant__ memory (every index is a compile-time constant after
// unrolling, so a basis entry is an operand of the FMA); no tensor cores,
// no TF32, no library call.  The kernel writes the raster plane directly
// (the engine wants planes); blocks in, blocks out is the same kernel with
// hb = 1.  The TPU kernel's 128x128 block-diagonal basis tiles, its
// 256-block tile layout (blocks_to_tiles, tiles_to_blocks) and the i32 hop
// of its u8 cast served the MXU and Mosaic, and are left out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_plane.cuh"

namespace {

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

__global__ void __launch_bounds__(jgt::kPlaneThreads)
idct_float_kernel(const jgt::PlaneArgs a) {
  __shared__ int q[64];
  int n, r, c;
  const bool mine = jgt::plane_block(a, n, r, c);
  jgt::load_quant(a, q);
  if (!mine) return;

  int s[64];
  jgt::load_block(a, n, r, c, s);

  // Pass 1, rows of coefficients: y[u][j] = sum_v (S o Q)[u][v] M[v][j].
  float y[64];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float d[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) d[v] = float(s[u * 8 + v]) * float(q[u * 8 + v]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float acc = d[0] * kM[j];
#pragma unroll
      for (int v = 1; v < 8; ++v) acc = fmaf(d[v], kM[v * 8 + j], acc);
      y[u * 8 + j] = acc;
    }
  }

  // Pass 2, one pixel row at a time: z[i][j] = sum_u M[u][i] y[u][j].
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int row[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float acc = kM[i] * y[j];
#pragma unroll
      for (int u = 1; u < 8; ++u) acc = fmaf(kM[u * 8 + i], y[u * 8 + j], acc);
      row[j] = min(max(__float2int_rn(acc + 128.0f), 0), 255);
    }
    jgt::store_row8(a, n, r, c, i, row);
  }
}

}  // namespace

// coefs: int16, addressed by the element strides sn, sj, sr, sc
// (block_plane.cuh); quant (64,) int32; out (n, vb*8, hb*8) uint8.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int jgt_idct_float_plane(const void* coefs, const void* quant, void* out,
                                    int n, int vb, int hb, long long sn, long long sj,
                                    long long sr, long long sc, void* stream) {
  if (n <= 0 || vb <= 0 || hb <= 0 || n > 65535) return int(cudaErrorInvalidValue);
  jgt::PlaneArgs a{static_cast<const int16_t*>(coefs),
                   static_cast<const int32_t*>(quant),
                   static_cast<uint8_t*>(out), sn, sj, sr, sc, n, vb, hb};
  idct_float_kernel<<<jgt::plane_grid(n, vb, hb), jgt::kPlaneThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
