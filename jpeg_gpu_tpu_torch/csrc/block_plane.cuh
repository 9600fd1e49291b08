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
// One launch takes up to kMaxPlanes planes, each with its own strides, grid,
// quant tables and output (PlaneSet, by value); the grid is laid over tiles
// of kTileBlocks blocks, plane after plane, and a tile never spans two
// leading indices.  A plane has one quant table for all n (qstride 0) or one
// per leading index (qstride 64: table n at quant + 64 n).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jgt {

// Up to kMaxPlanes planes for one launch, passed to the kernel by value.
constexpr int kMaxPlanes = 4;
constexpr int kTileBlocks = 32;   // 8x8 blocks a CUDA block takes
constexpr int kDescWords = 11;    // 64-bit values a plane's descriptor holds

struct PlaneDesc {
  const int16_t* coefs;
  const int32_t* quant;   // (64,) int32 per table
  uint8_t* out;           // (n, vb * 8, hb * 8)
  long long sn, sj, sr, sc;
  int n, vb, hb;
  int qstride;            // 0: one table; 64: a table per leading index
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

// Fill `set` from `d`, kDescWords values per plane: the three pointers, the
// four element strides, n, vb, hb, the table stride (0 or 64).  Returns the
// number of CUDA blocks, or -1 for a shape the kernels do not take.
inline long long make_plane_set(const long long* d, int nplanes, PlaneSet& set) {
  if (nplanes < 1 || nplanes > kMaxPlanes) return -1;
  long long total = 0;
  set.nplanes = nplanes;
  for (int i = 0; i < nplanes; ++i, d += kDescWords) {
    PlaneDesc& p = set.plane[i];
    p.coefs = reinterpret_cast<const int16_t*>(d[0]);
    p.quant = reinterpret_cast<const int32_t*>(d[1]);
    p.out = reinterpret_cast<uint8_t*>(d[2]);
    p.sn = d[3];
    p.sj = d[4];
    p.sr = d[5];
    p.sc = d[6];
    if (d[7] < 1 || d[8] < 1 || d[9] < 1 || d[8] * d[9] > 0x7FFFFFFF) return -1;
    if (d[10] != 0 && d[10] != 64) return -1;
    p.n = int(d[7]);
    p.vb = int(d[8]);
    p.hb = int(d[9]);
    p.qstride = int(d[10]);
    p.tiles = int((d[8] * d[9] + kTileBlocks - 1) / kTileBlocks);
    set.first_tile[i] = int(total);
    total += (long long)p.n * p.tiles;
    if (total > 0x7FFFFFFF) return -1;
  }
  set.first_tile[nplanes] = int(total);
  return total;
}

}  // namespace jgt
