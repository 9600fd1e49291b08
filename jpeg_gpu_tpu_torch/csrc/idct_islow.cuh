// The islow 8x8 inverse DCT (libjpeg's JDCT_ISLOW arithmetic), shared by the
// fused RGB kernel (pixel_fused.cu) and the plane kernel (idct_islow_plane.cu),
// which both run one 8-point pass a thread: columns, then rows.
//
// The same fixed-point steps as ops/idct_islow.py: 13-bit constants, two
// passes, pass-1 descale by CONST_BITS - PASS1_BITS and final descale by
// CONST_BITS + PASS1_BITS + 3, then +128 and a clamp to 0..255.  `>>` on a
// negative int is an arithmetic shift under nvcc, as the reference's is.

#pragma once

#include <stdint.h>

namespace jgt {

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;

__device__ __forceinline__ int descale(int x, int n) {
  return (x + (1 << (n - 1))) >> n;
}

// One 8-point islow IDCT pass, in place (ops/idct_islow.py:_idct8).
__device__ __forceinline__ void idct8(int (&c)[8], int bits) {
  int z1 = (c[2] + c[6]) * 4433;
  const int t2 = z1 - c[6] * 15137;
  const int t3 = z1 + c[2] * 6270;
  const int t0 = (c[0] + c[4]) << CONST_BITS;
  const int t1 = (c[0] - c[4]) << CONST_BITS;
  const int e0 = t0 + t3, e3 = t0 - t3, e1 = t1 + t2, e2 = t1 - t2;

  z1 = c[7] + c[1];
  int z2 = c[5] + c[3];
  int z3 = c[7] + c[3];
  int z4 = c[5] + c[1];
  const int z5 = (z3 + z4) * 9633;
  int o0 = c[7] * 2446;
  int o1 = c[5] * 16819;
  int o2 = c[3] * 25172;
  int o3 = c[1] * 12299;
  z1 = z1 * -7373;
  z2 = z2 * -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  o0 += z1 + z3;
  o1 += z2 + z4;
  o2 += z2 + z3;
  o3 += z1 + z4;

  c[0] = descale(e0 + o3, bits);
  c[1] = descale(e1 + o2, bits);
  c[2] = descale(e2 + o1, bits);
  c[3] = descale(e3 + o0, bits);
  c[4] = descale(e3 - o0, bits);
  c[5] = descale(e2 - o1, bits);
  c[6] = descale(e1 - o2, bits);
  c[7] = descale(e0 - o3, bits);
}

__device__ __forceinline__ int clamp255(int x) { return min(max(x, 0), 255); }

}  // namespace jgt
