// K5 on Hopper: coefficient planes -> dequant -> islow IDCT -> raster plane.
//
// Replaces the TPU kernel
// jpeg_gpu_tpu/ops/idct_islow_pallas.py:_idct_plane_kernel (launched by
// dequant_idct_islow_plane_soa).  Per 8x8 block: multiply the 64 int16
// coefficients by the component's quant table, run the two islow
// passes of csrc/idct_islow.cuh, add 128, clamp, and write the block's 8
// rows of 8 bytes into the (n, vb*8, hb*8) uint8 plane.  Bit-exact against
// ops/idct_islow.py:dequant_idct_islow_plane.
//
// Bound: 2 bytes in and 1 byte out per sample and about 10 integer
// operations per sample, so at the card's rates the bytes are the larger of
// the two times, but both are microseconds for a 1080p plane: at these
// sizes the kernel's time is launch latency and occupancy.
//
// Design (a simple, correct first version): one thread per block, the whole
// block in registers (the butterfly K1 uses), 8-byte row stores.  Any
// vb, hb >= 1.  The TPU kernel's band grid, its vb % band padding rule, its
// packed-word (band, 8, 2, hb) output and the word transpose after the
// kernel were there for Mosaic's tiling and do not exist here.  Element
// strides come from the wrapper, so a (vb, hb, 8, 8) block tensor goes in
// as a view, with no transposing copy (csrc/block_plane.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_plane.cuh"
#include "idct_islow.cuh"

namespace {

__global__ void __launch_bounds__(jgt::kPlaneThreads)
idct_islow_plane_kernel(const jgt::PlaneArgs a) {
  __shared__ int q[64];
  int n, r, c;
  const bool mine = jgt::plane_block(a, n, r, c);
  jgt::load_quant(a, q);
  if (!mine) return;

  int s[64];
  jgt::load_block(a, n, r, c, s);
#pragma unroll
  for (int j = 0; j < 64; ++j) s[j] *= q[j];
  jgt::idct_block(s);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    int row[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) row[v] = s[u * 8 + v];
    jgt::store_row8(a, n, r, c, u, row);
  }
}

}  // namespace

// coefs: int16, addressed by the element strides sn, sj, sr, sc
// (block_plane.cuh); quant (64,) int32; out (n, vb*8, hb*8) uint8.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int jgt_idct_islow_plane(const void* coefs, const void* quant, void* out,
                                    int n, int vb, int hb, long long sn, long long sj,
                                    long long sr, long long sc, void* stream) {
  if (n <= 0 || vb <= 0 || hb <= 0 || n > 65535) return int(cudaErrorInvalidValue);
  jgt::PlaneArgs a{static_cast<const int16_t*>(coefs),
                   static_cast<const int32_t*>(quant),
                   static_cast<uint8_t*>(out), sn, sj, sr, sc, n, vb, hb};
  idct_islow_plane_kernel<<<jgt::plane_grid(n, vb, hb), jgt::kPlaneThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
