// Coefficient blocks in, raster plane out: the addressing that the two
// standalone IDCT kernels (idct_islow_plane.cu, idct_float.cu) share.
//
// Input: int16 coefficient j of block (r, c) of image n sits at
//   src[n * sn + j * sj + r * sr + c * sc]        (element strides),
// which covers both layouts the engine holds without a transposing copy:
//   SoA planes (n, 64, vb, hb):  sj = vb * hb, sr = hb, sc = 1;
//   blocks     (n, vb, hb, 8, 8): sj = 1,      sr = hb * 64, sc = 64.
// Output: (n, vb * 8, hb * 8) uint8, row-major.  One thread per block: in
// the SoA layout neighbouring threads read neighbouring addresses of each
// coefficient plane; in the block layout a thread reads its own 128
// contiguous bytes with 16-byte loads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jgt {

constexpr int kPlaneThreads = 128;  // blocks (threads) per CUDA block

struct PlaneArgs {
  const int16_t* coefs;
  const int32_t* quant;   // (64,) int32, one table for all n
  uint8_t* out;
  long long sn, sj, sr, sc;
  int n, vb, hb;
};

// The block this thread owns; false past the end of the grid.
__device__ __forceinline__ bool plane_block(const PlaneArgs& a, int& n, int& r,
                                            int& c) {
  const long long idx = (long long)blockIdx.x * kPlaneThreads + threadIdx.x;
  n = blockIdx.y;
  if (idx >= (long long)a.vb * a.hb) return false;
  r = int(idx / a.hb);
  c = int(idx % a.hb);
  return true;
}

// The 64 raw coefficients of block (n, r, c) as ints, natural order.
__device__ __forceinline__ void load_block(const PlaneArgs& a, int n, int r,
                                           int c, int (&s)[64]) {
  const int16_t* src = a.coefs + n * a.sn + r * a.sr + c * a.sc;
  if (a.sj == 1 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4* v = reinterpret_cast<const int4*>(src);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int4 w = v[i];
      const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s[i * 8 + 2 * k] = int(int16_t(words[k] & 0xFFFF));
        s[i * 8 + 2 * k + 1] = words[k] >> 16;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 64; ++j) s[j] = int(src[j * a.sj]);
  }
}

// Eight samples (already in 0..255) of pixel row u of block (n, r, c), as
// one 8-byte store.
__device__ __forceinline__ void store_row8(const PlaneArgs& a, int n, int r,
                                           int c, int u, const int (&p)[8]) {
  const size_t w = size_t(a.hb) * 8;
  uint8_t* dst = a.out + (size_t(n) * a.vb * 8 + size_t(r) * 8 + u) * w + size_t(c) * 8;
  uint2 v;
  v.x = uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
        (uint32_t(p[3]) << 24);
  v.y = uint32_t(p[4]) | (uint32_t(p[5]) << 8) | (uint32_t(p[6]) << 16) |
        (uint32_t(p[7]) << 24);
  *reinterpret_cast<uint2*>(dst) = v;
}

// The quant table into shared memory (64 ints), then a barrier.
__device__ __forceinline__ void load_quant(const PlaneArgs& a, int* q) {
  for (int j = threadIdx.x; j < 64; j += kPlaneThreads) q[j] = a.quant[j];
  __syncthreads();
}

inline dim3 plane_grid(int n, int vb, int hb) {
  const long long blocks = (long long)vb * hb;
  return dim3(unsigned((blocks + kPlaneThreads - 1) / kPlaneThreads), unsigned(n));
}

}  // namespace jgt
