// Coefficient blocks in, raster plane out: the addressing that the two
// standalone IDCT kernels (idct_islow_plane.cu, idct_float.cu) share.
//
// Input: int16 coefficient j of block (r, c) of image n sits at
//   src[n * sn + j * sj + r * sr + c * sc]        (element strides),
// which covers both layouts the engine holds without a transposing copy:
//   SoA planes (n, 64, vb, hb):  sj = vb * hb, sr = hb, sc = 1;
//   blocks     (n, vb, hb, 8, 8): sj = 1,      sr = hb * 64, sc = 64.
// Output: (n, vb * 8, hb * 8) uint8, row-major.
//
// Two ways to spread the work.  One thread per block and one launch per
// plane (PlaneArgs, plane_block, load_block, store_row8: K6 today): in the
// SoA layout neighbouring threads read neighbouring addresses of each
// coefficient plane; in the block layout a thread reads its own 128
// contiguous bytes with 16-byte loads.  Or one launch for up to kMaxPlanes
// planes, each with its own table and output (PlaneSet: K5), the grid laid
// over tiles of kTileBlocks blocks, plane after plane.

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

// Up to kMaxPlanes planes for one launch, passed to the kernel by value.
constexpr int kMaxPlanes = 4;
constexpr int kTileBlocks = 32;   // 8x8 blocks a CUDA block takes

struct PlaneDesc {
  const int16_t* coefs;
  const int32_t* quant;   // (64,) int32, one table for all n
  uint8_t* out;           // (n, vb * 8, hb * 8)
  long long sn, sj, sr, sc;
  int n, vb, hb;
  int tiles;              // per leading index: ceil(vb * hb / kTileBlocks)
};

struct PlaneSet {
  PlaneDesc plane[kMaxPlanes];
  int first_tile[kMaxPlanes + 1];   // plane i owns CUDA blocks [first_tile[i], first_tile[i + 1])
  int nplanes;
};

// The plane, leading index and first block of CUDA block `tile`.
__device__ __forceinline__ const PlaneDesc& plane_of_tile(const PlaneSet& set, int tile,
                                                          int& n, int& block0) {
  int i = 0;
  while (i + 1 < set.nplanes && tile >= set.first_tile[i + 1]) ++i;
  const PlaneDesc& p = set.plane[i];
  const int local = tile - set.first_tile[i];
  n = local / p.tiles;
  block0 = (local % p.tiles) * kTileBlocks;
  return p;
}

// Fill `set` from `d`, ten values per plane: the three pointers, the four
// element strides, n, vb, hb.  Returns the number of CUDA blocks, or -1 for a
// shape the kernels do not take.
inline long long make_plane_set(const long long* d, int nplanes, PlaneSet& set) {
  if (nplanes < 1 || nplanes > kMaxPlanes) return -1;
  long long total = 0;
  set.nplanes = nplanes;
  for (int i = 0; i < nplanes; ++i, d += 10) {
    PlaneDesc& p = set.plane[i];
    p.coefs = reinterpret_cast<const int16_t*>(d[0]);
    p.quant = reinterpret_cast<const int32_t*>(d[1]);
    p.out = reinterpret_cast<uint8_t*>(d[2]);
    p.sn = d[3];
    p.sj = d[4];
    p.sr = d[5];
    p.sc = d[6];
    if (d[7] < 1 || d[8] < 1 || d[9] < 1 || d[8] * d[9] > 0x7FFFFFFF) return -1;
    p.n = int(d[7]);
    p.vb = int(d[8]);
    p.hb = int(d[9]);
    p.tiles = int((d[8] * d[9] + kTileBlocks - 1) / kTileBlocks);
    set.first_tile[i] = int(total);
    total += (long long)p.n * p.tiles;
    if (total > 0x7FFFFFFF) return -1;
  }
  set.first_tile[nplanes] = int(total);
  return total;
}

inline dim3 plane_grid(int n, int vb, int hb) {
  const long long blocks = (long long)vb * hb;
  return dim3(unsigned((blocks + kPlaneThreads - 1) / kPlaneThreads), unsigned(n));
}

}  // namespace jgt
