// K1 on Hopper: parity-split SoA coefficients -> cropped packed RGB bytes.
//
// Replaces the TPU kernel jpeg_gpu_tpu/ops/pixel_fused.py:_fused_rgb_kernel
// (launched by decode_rgb_fused_soa).  Per MCU it computes dequant -> islow
// IDCT -> +128 and clamp -> chroma upsampling (nearest, or libjpeg's exact
// triangle filters for the true 2x modes) -> libjpeg's integer YCbCr->RGB,
// and writes only the in-bounds pixels of (N, H, W, 3) uint8.
//
// Bound: memory traffic at these sizes is small (2 bytes in per coefficient,
// 3 bytes out per pixel); the islow IDCT is ~10 integer ops per sample and
// the fancy filters a few more, so the kernel is integer-ALU bound rather
// than bandwidth bound.  There is no matrix product (no wgmma).
//
// Design (a simple, correct first version):
// * One CUDA block per (image, MCU row, run of T MCU columns), 128 threads,
//   T = 128 / (sx * sy), so every thread owns exactly one luma block.
// * Phase 1 computes the Cb and Cr samples of the run's chroma blocks into
//   shared memory, plus (fancy only) a one-sample halo taken from the
//   neighbouring chroma blocks on each side that the filter reaches.
//   Every chroma read clamps its coordinates to the TRUE chroma dims
//   (cw, ch), which is libjpeg's edge replication of SAMPLES.
// * Phase 2: each thread runs its luma block's IDCT in registers, looks up
//   (or filters) the chroma value of each pixel in shared memory, converts
//   and stores its RGB bytes.
// The TPU kernel's band padding, h-tiles, band halos, in-kernel word
// interleave and seam repair do not exist here: a block reads its
// neighbours straight from global memory, so there are no seams.

#include <cuda_runtime.h>
#include <stdint.h>

#include "idct_islow.cuh"

namespace {

constexpr int kThreads = 128;    // luma blocks per CUDA block
constexpr int kWinRows = 10;     // one chroma block row + a 1-sample halo

constexpr int SCALEBITS = 16;
constexpr int ONE_HALF = 1 << (SCALEBITS - 1);
constexpr int FIX_1_40200 = 91881;
constexpr int FIX_0_34414 = 22554;
constexpr int FIX_0_71414 = 46802;
constexpr int FIX_1_77200 = 116130;

// The islow IDCT of one block: csrc/idct_islow.cuh.
using jgt::block_samples;
using jgt::clamp255;

// y: (N, SY, SX, 64, vbc, hbc); cb, cr: (N, 64, vbc, hbc) int16.
// qty: (N, 64), qtc: (N, 2, 64) int32.  out: (N, height, width, 3) uint8.
template <int SX, int SY, bool FANCY>
__global__ void __launch_bounds__(kThreads)
fused_rgb_kernel(const int16_t* __restrict__ y, const int16_t* __restrict__ cb,
                 const int16_t* __restrict__ cr, const int32_t* __restrict__ qty,
                 const int32_t* __restrict__ qtc, uint8_t* __restrict__ out,
                 int vbc, int hbc, int cw, int ch, int height, int width) {
  constexpr int T = kThreads / (SX * SY);  // MCU columns per CUDA block
  constexpr int WC = 8 * T + 2;            // window columns, halo included
  constexpr bool HALO_H = FANCY && SX == 2;
  constexpr bool HALO_V = FANCY && SY == 2;
  // Window of chroma samples: row 0 / column 0 is the sample just above /
  // left of the run, rows 1..8 / columns 1..8T the run itself.
  __shared__ uint8_t win[2][kWinRows][WC];
  __shared__ int q[3][64];

  const int n = blockIdx.z;
  const int i = blockIdx.y;
  const int k0 = blockIdx.x * T;
  const size_t plane = size_t(vbc) * hbc;

  for (int t = threadIdx.x; t < 3 * 64; t += kThreads)
    q[t / 64][t % 64] = t < 64 ? qty[n * 64 + t] : qtc[size_t(n) * 128 + t - 64];
  __syncthreads();

  // Phase 1: chroma samples of this run, plus the halo blocks fancy reads.
  const int r_lo = HALO_V ? max(i - 1, 0) : i;
  const int r_hi = HALO_V ? min(i + 1, vbc - 1) : i;
  const int c_lo = HALO_H ? max(k0 - 1, 0) : k0;
  const int c_hi = min(k0 + T - 1 + (HALO_H ? 1 : 0), hbc - 1);
  const int nr = r_hi - r_lo + 1;
  const int nc = c_hi - c_lo + 1;
  for (int item = threadIdx.x; item < 2 * nr * nc; item += kThreads) {
    const int comp = item / (nr * nc);
    const int rem = item - comp * nr * nc;
    const int br = r_lo + rem / nc;
    const int bc = c_lo + rem % nc;
    const int16_t* src =
        (comp ? cr : cb) + size_t(n) * 64 * plane + size_t(br) * hbc + bc;
    int s[64];
    block_samples(src, plane, q[1 + comp], s);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int wr = 8 * (br - i) + u + 1;
      if (wr < 0 || wr >= kWinRows) continue;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int wc = 8 * (bc - k0) + v + 1;
        if (wc >= 0 && wc < WC) win[comp][wr][wc] = uint8_t(s[u * 8 + v]);
      }
    }
  }
  __syncthreads();

  // Phase 2: one luma block per thread.
  const int kk = threadIdx.x % T;
  const int pp = threadIdx.x / T;
  const int pr = pp / SX;
  const int pc = pp % SX;
  const int k = k0 + kk;
  const int Y0 = (i * SY + pr) * 8;
  const int X0 = (k * SX + pc) * 8;
  if (k >= hbc || Y0 >= height || X0 >= width) return;

  const int16_t* src =
      y + ((size_t(n) * SY + pr) * SX + pc) * 64 * plane + size_t(i) * hbc + k;
  int s[64];
  block_samples(src, plane, q[0], s);

  // Chroma sample (r, c) in global sample coordinates; callers pass
  // coordinates already clamped to the true chroma dims.
  auto sample = [&](int comp, int r, int c) -> int {
    return win[comp][r - 8 * i + 1][c - 8 * k0 + 1];
  };
  // Upsampled chroma value at luma pixel (Y, X): ops/color.py's arithmetic.
  auto chroma = [&](int comp, int Y, int X) -> int {
    if constexpr (!FANCY) {
      return sample(comp, Y / SY, X / SX);
    } else if constexpr (SX == 2 && SY == 2) {
      const int r = Y >> 1, c = X >> 1;
      const int rn = (Y & 1) ? min(r + 1, ch - 1) : max(r - 1, 0);
      const int cn = (X & 1) ? min(c + 1, cw - 1) : max(c - 1, 0);
      const int here = 3 * sample(comp, r, c) + sample(comp, rn, c);
      const int there = 3 * sample(comp, r, cn) + sample(comp, rn, cn);
      return (3 * here + there + ((X & 1) ? 7 : 8)) >> 4;
    } else if constexpr (SX == 2) {
      const int c = X >> 1;
      const int cn = (X & 1) ? min(c + 1, cw - 1) : max(c - 1, 0);
      return (3 * sample(comp, Y, c) + sample(comp, Y, cn) + ((X & 1) ? 2 : 1)) >> 2;
    } else {
      const int r = Y >> 1;
      const int rn = (Y & 1) ? min(r + 1, ch - 1) : max(r - 1, 0);
      return (3 * sample(comp, r, X) + sample(comp, rn, X) + ((Y & 1) ? 2 : 1)) >> 2;
    }
  };

#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int Y = Y0 + u;
    if (Y >= height) break;
    uint8_t* row = out + ((size_t(n) * height + Y) * width + X0) * 3;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int X = X0 + v;
      if (X >= width) break;
      const int yv = s[u * 8 + v];
      const int cbi = chroma(0, Y, X) - 128;
      const int cri = chroma(1, Y, X) - 128;
      const int r = yv + ((FIX_1_40200 * cri + ONE_HALF) >> SCALEBITS);
      const int g =
          yv + ((-FIX_0_34414 * cbi + (-FIX_0_71414 * cri + ONE_HALF)) >> SCALEBITS);
      const int b = yv + ((FIX_1_77200 * cbi + ONE_HALF) >> SCALEBITS);
      row[3 * v + 0] = uint8_t(clamp255(r));
      row[3 * v + 1] = uint8_t(clamp255(g));
      row[3 * v + 2] = uint8_t(clamp255(b));
    }
  }
}

template <int SX, int SY, bool FANCY>
void launch(const int16_t* y, const int16_t* cb, const int16_t* cr,
            const int32_t* qty, const int32_t* qtc, uint8_t* out, int n,
            int vbc, int hbc, int cw, int ch, int height, int width,
            cudaStream_t stream) {
  constexpr int T = kThreads / (SX * SY);
  const dim3 grid((hbc + T - 1) / T, vbc, n);
  fused_rgb_kernel<SX, SY, FANCY><<<grid, kThreads, 0, stream>>>(
      y, cb, cr, qty, qtc, out, vbc, hbc, cw, ch, height, width);
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a geometry the kernel does not cover.
extern "C" int jgt_fused_rgb(const void* y, const void* cb, const void* cr,
                             const void* qty, const void* qtc, void* out, int n,
                             int vbc, int hbc, int sx, int sy, int fancy,
                             int cw, int ch, int height, int width,
                             void* stream) {
  const auto* y16 = static_cast<const int16_t*>(y);
  const auto* cb16 = static_cast<const int16_t*>(cb);
  const auto* cr16 = static_cast<const int16_t*>(cr);
  const auto* qy = static_cast<const int32_t*>(qty);
  const auto* qc = static_cast<const int32_t*>(qtc);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define JGT_LAUNCH(SX, SY, F) \
  launch<SX, SY, F>(y16, cb16, cr16, qy, qc, o, n, vbc, hbc, cw, ch, height, width, s)
  const int key = (sx << 8) | (sy << 4) | (fancy ? 1 : 0);
  switch (key) {
    case 0x110: JGT_LAUNCH(1, 1, false); break;
    case 0x210: JGT_LAUNCH(2, 1, false); break;
    case 0x220: JGT_LAUNCH(2, 2, false); break;
    case 0x120: JGT_LAUNCH(1, 2, false); break;
    case 0x410: JGT_LAUNCH(4, 1, false); break;
    case 0x420: JGT_LAUNCH(4, 2, false); break;
    case 0x211: JGT_LAUNCH(2, 1, true); break;
    case 0x221: JGT_LAUNCH(2, 2, true); break;
    case 0x121: JGT_LAUNCH(1, 2, true); break;
    default: return int(cudaErrorInvalidValue);
  }
#undef JGT_LAUNCH
  return int(cudaGetLastError());
}
