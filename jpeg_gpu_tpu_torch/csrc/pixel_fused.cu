// K1 on Hopper: parity-split SoA coefficients -> cropped packed RGB bytes.
//
// Replaces the TPU kernel jpeg_gpu_tpu/ops/pixel_fused.py:_fused_rgb_kernel
// (launched by decode_rgb_fused_soa).  Per MCU it computes dequant -> islow
// IDCT -> +128 and clamp -> chroma upsampling (nearest, or libjpeg's exact
// triangle filters for the true 2x modes) -> libjpeg's integer YCbCr->RGB,
// and writes only the in-bounds pixels of (N, H, W, 3) uint8.
//
// Bound: bytes.  2 bytes in per coefficient (3 B/px at 4:2:0) and 3 bytes
// out per pixel against about 10 integer operations per sample for the IDCT
// and 17 per pixel for the colour: at the card's rates the bytes take about
// twice as long as the operations.  There is no matrix product (no wgmma).
//
// Design.  One CUDA block of 256 threads per (image, tile), a tile being MR
// MCU rows by TC MCU columns: 256 pixels wide in every geometry (TC = 32 /
// SX) and 8 * SY * MR pixel rows, MR 1 for nearest and 2 for fancy, whose
// halo blocks are then paid once per two rows (the fastest of 1, 2 and 4 on
// the H100; PERF.md keeps the readings).  Three phases, all through shared memory:
// 1. The IDCT.  The tile's luma blocks and its chroma blocks (with the halo
//    blocks that fancy's filter reaches above, below and beside the tile)
//    form one work list, built once per tile in shared memory, so no thread
//    waits while others do chroma and no wave computes an index.  Waves
//    of 32 blocks: each block's coefficients are staged dequantized with
//    loads that read 32 contiguous bytes or more of each coefficient plane
//    (neighbouring list entries are neighbouring MCU columns), then eight
//    threads a block run the columns, __syncwarp(), the rows (K5's layout
//    and csrc/idct_islow.cuh's butterfly), and store each pixel row as one
//    8-byte store into the luma tile or the chroma window.  Rows of 9 words,
//    blocks of 72 and a skew of one word per warp keep the staging writes and
//    both passes free of bank conflicts.
// 2. The colour.  A thread takes four neighbouring pixels: their Y in one
//    4-byte read, each chroma sample they share read once, and writes their
//    12 bytes into a staging row whose start has the same offset from a
//    16-byte boundary as the row's start in the output.  Chroma reads clamp
//    to the TRUE chroma dims (cw, ch): libjpeg's edge replication of samples.
// 3. The stores.  A warp takes a row and its lanes the output's 16-byte
//    chunks: 512 contiguous bytes in 16-byte stores at a time; only the head
//    and tail chunk of a row segment (rows and images need not start
//    16-byte aligned: 3 W bytes a row) go out byte by byte.
// Phases 2 and 3 run over 16 pixel rows at a time, so the staging rows fit
// in the space of phase 1's staged coefficients.
// The TPU kernel's band padding, h-tiles, band halos, in-kernel word
// interleave and seam repair do not exist here: a tile reads its halo
// blocks straight from global memory, so there are no seams.

#include <cuda_runtime.h>
#include <stdint.h>

#include "idct_islow.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWave = kThreads / 8;       // 8x8 blocks a wave takes
constexpr int kRow = 9;                   // words between the rows of a staged block
constexpr int kBlock = 8 * kRow;          // words between staged blocks
constexpr int kTileW = 256;               // tile width in pixels, every geometry
constexpr int kYPitch = kTileW + 8;       // bytes between luma tile rows
constexpr int kRgbRows = 16;              // pixel rows per colour pass
constexpr int kRgbPitch = 3 * kTileW + 16;   // staging row: 15 bytes of lead + 768
constexpr int kCb = 8;                    // work-list plane of Cb; Cr's is kCb + 1

constexpr int SCALEBITS = 16;
constexpr int ONE_HALF = 1 << (SCALEBITS - 1);
constexpr int FIX_1_40200 = 91881;
constexpr int FIX_0_34414 = 22554;
constexpr int FIX_0_71414 = 46802;
constexpr int FIX_1_77200 = 116130;

using jgt::clamp255;

constexpr int round16(int x) { return (x + 15) / 16 * 16; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Shared memory of one instantiation, in bytes from the start.  A tile's
// work list holds at most TOTAL blocks: NL luma blocks and the 2 x CR x CC
// chroma blocks of the window, fancy's halo blocks included.
template <int SX, int SY, bool FANCY>
struct Tile {
  static constexpr int MR = FANCY ? 2 : 1;           // MCU rows
  static constexpr int TC = 32 / SX;                 // MCU columns
  static constexpr int TH = 8 * SY * MR;             // pixel rows
  static constexpr int HV = (FANCY && SY == 2) ? 1 : 0;   // halo block rows on each side
  static constexpr int HH = (FANCY && SX == 2) ? 1 : 0;   // halo block columns
  static constexpr int CR = MR + 2 * HV, CC = TC + 2 * HH;
  static constexpr int PADV = 8 * HV, PADH = 8 * HH;      // in samples
  static constexpr int WR = 8 * CR;                  // chroma window rows
  static constexpr int WP = 8 * CC + 8;              // chroma window pitch
  static constexpr int NL = MR * SY * SX * TC;
  static constexpr int TOTAL = NL + 2 * CR * CC;
  static constexpr int Q = 0;                                   // int q[3][64]
  static constexpr int SCRATCH = 3 * 64 * 4;                    // staged coefs / RGB rows
  static constexpr int SCRATCH_BYTES =
      round16(cmax((kWave * kBlock + 8) * 4, kRgbRows * kRgbPitch));
  static constexpr int LUMA = SCRATCH + SCRATCH_BYTES;          // u8 [TH][kYPitch]
  static constexpr int WIN = LUMA + round16(TH * kYPitch);      // u8 [2][WR][WP]
  static constexpr int WORK = WIN + round16(2 * WR * WP);       // int2 [TOTAL]
  static constexpr int BYTES = WORK + TOTAL * 8;
  static_assert(WORK <= 0xFFFF, "sample offsets are kept in 16 bits");
  static_assert(BYTES <= 48 * 1024, "within the default dynamic shared memory");
};

// y: (N, SY, SX, 64, vbc, hbc); cb, cr: (N, 64, vbc, hbc) int16.
// qty: (N, 64), qtc: (N, 2, 64) int32.  out: (N, height, width, 3) uint8.
template <int SX, int SY, bool FANCY>
__global__ void __launch_bounds__(kThreads)
fused_rgb_kernel(const int16_t* __restrict__ y, const int16_t* __restrict__ cb,
                 const int16_t* __restrict__ cr, const int32_t* __restrict__ qty,
                 const int32_t* __restrict__ qtc, uint8_t* __restrict__ out,
                 int vbc, int hbc, int cw, int ch, int height, int width) {
  using L = Tile<SX, SY, FANCY>;
  constexpr int TC = L::TC, MR = L::MR;
  extern __shared__ __align__(16) unsigned char smem[];
  int (*q)[64] = reinterpret_cast<int (*)[64]>(smem + L::Q);
  int* coef = reinterpret_cast<int*>(smem + L::SCRATCH);
  uint8_t* rgb = smem + L::SCRATCH;
  uint8_t* luma = smem + L::LUMA;
  uint8_t* win = smem + L::WIN;
  int2* work = reinterpret_cast<int2*>(smem + L::WORK);

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * MR;          // first MCU row
  const int k0 = blockIdx.x * TC;          // first MCU column
  const int Y0 = i0 * SY * 8, X0 = k0 * SX * 8;
  const int th = min(L::TH, height - Y0);  // pixel rows of the tile in the crop
  const int tw = min(kTileW, width - X0);
  if (th <= 0 || tw <= 0) return;          // the whole CUDA block
  const size_t plane = size_t(vbc) * hbc;

  for (int t = tid; t < 3 * 64; t += kThreads)
    q[t / 64][t % 64] = t < 64 ? qty[n * 64 + t] : qtc[size_t(n) * 128 + t - 64];

  const int mr = min(MR, vbc - i0);        // MCU rows and columns inside the image
  const int tc = min(TC, hbc - k0);
  const int r_lo = max(i0 - L::HV, 0), r_hi = min(i0 + mr - 1 + L::HV, vbc - 1);
  const int c_lo = max(k0 - L::HH, 0), c_hi = min(k0 + tc - 1 + L::HH, hbc - 1);

  // The work list, built once: the tile's luma blocks (MCU row, block row,
  // block column, MCU column), then its chroma blocks (component, block row,
  // block column), neighbours in the list being neighbours in memory.  An
  // entry is (the block's offset in its coefficient plane, plane << 16 | the
  // byte offset of its samples in shared memory), the plane being luma's
  // (pr, pc) as pr * SX + pc, or kCb and kCb + 1.
  const int n_luma = mr * SY * SX * tc;
  const int nr = r_hi - r_lo + 1, nc = c_hi - c_lo + 1;
  const int total = n_luma + 2 * nr * nc;
  for (int item = tid; item < total; item += kThreads) {
    int blk, sel, at;
    if (item < n_luma) {
      const int run = item / tc, kk = item - run * tc;
      const int mi = run / (SY * SX), sub = run % (SY * SX);
      blk = (i0 + mi) * hbc + k0 + kk;
      sel = sub;
      at = L::LUMA + (mi * SY + sub / SX) * 8 * kYPitch + (kk * SX + sub % SX) * 8;
    } else {
      const int rem = item - n_luma, c = rem / (nr * nc), rc = rem - c * nr * nc;
      const int br = r_lo + rc / nc, bc = c_lo + rc % nc;
      blk = br * hbc + bc;
      sel = kCb + c;
      at = L::WIN + (c * L::WR + 8 * (br - i0) + L::PADV) * L::WP + 8 * (bc - k0) + L::PADH;
    }
    work[item] = make_int2(blk, (sel << 16) | at);
  }
  __syncthreads();

  // -- 1. the IDCT, in waves of kWave blocks --------------------------------
  for (int base = 0; base < total; base += kWave) {
    {
      // Staging: thread -> (block b, coefficient column v); a warp reads
      // coefficient (u, v) of 32 neighbouring list entries.
      const int b = tid & (kWave - 1), v = tid >> 5;
      int* dst = coef + b * kBlock + (b >> 2);
      if (base + b < total) {
        const int2 w = work[base + b];
        const int sel = w.y >> 16;
        const int16_t* src =
            (sel < kCb ? y + (size_t(n) * SY * SX + sel) * 64 * plane
                       : (sel == kCb ? cb : cr) + size_t(n) * 64 * plane) + w.x;
        const int* qc = q[sel < kCb ? 0 : sel - kCb + 1];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          dst[u * kRow + v] = int(src[(u * 8 + v) * plane]) * qc[u * 8 + v];
      }
    }
    __syncthreads();
    {
      // Thread (block b, lane-in-block e): column e, then row e.
      const int b = tid >> 3, e = tid & 7;
      int* blk = coef + b * kBlock + (b >> 2);
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
      if (base + b < total) {
        const int2 w = work[base + b];
        const int pitch = (w.y >> 16) < kCb ? kYPitch : L::WP;
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          lo |= uint32_t(clamp255(t[v] + 128)) << (8 * v);
          hi |= uint32_t(clamp255(t[v + 4] + 128)) << (8 * v);
        }
        *reinterpret_cast<uint2*>(smem + (w.y & 0xFFFF) + e * pitch) = make_uint2(lo, hi);
      }
    }
    __syncthreads();
  }

  // Pixel row r of chroma component `comp` in the window (global sample
  // coordinates; column c at [c - 8 * k0 + PADH]).
  auto wrow = [&](int comp, int r) -> const uint8_t* {
    return win + (comp * L::WR + r - 8 * i0 + L::PADV) * L::WP;
  };
  // Upsampled chroma of the four pixels (Y, Xq .. Xq + 3), Xq a multiple of
  // 4: ops/color.py's arithmetic, each sample read once.  Coordinates clamp
  // to the true chroma dims (cw, ch).
  auto chroma4 = [&](int comp, int Y, int Xq, int (&v)[4]) {
    if constexpr (!FANCY) {
      const uint8_t* p = wrow(comp, Y / SY) + Xq / SX - 8 * k0;
      if constexpr (SX == 1) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = (w >> (8 * j)) & 255;
      } else if constexpr (SX == 2) {
        const uint32_t w = *reinterpret_cast<const uint16_t*>(p);
        v[0] = v[1] = w & 255;
        v[2] = v[3] = w >> 8;
      } else {
        v[0] = v[1] = v[2] = v[3] = *p;
      }
    } else if constexpr (SX == 2) {
      // Columns c0 - 1 .. c0 + 2 around c0 = Xq / 2, clamped.
      const int c0 = Xq >> 1;
      const int ca = max(c0 - 1, 0) - 8 * k0 + L::PADH, cb0 = c0 - 8 * k0 + L::PADH;
      const int cd = min(c0 + 2, cw - 1) - 8 * k0 + L::PADH;
      int A, B, C, D;
      if constexpr (SY == 2) {
        const int r = Y >> 1, rn = (Y & 1) ? min(r + 1, ch - 1) : max(r - 1, 0);
        const uint8_t* p = wrow(comp, r);
        const uint8_t* o = wrow(comp, rn);
        A = 3 * p[ca] + o[ca];
        B = 3 * p[cb0] + o[cb0];
        C = 3 * p[cb0 + 1] + o[cb0 + 1];
        D = 3 * p[cd] + o[cd];
      } else {
        const uint8_t* p = wrow(comp, Y);
        A = p[ca];
        B = p[cb0];
        C = p[cb0 + 1];
        D = p[cd];
      }
      const int E = (c0 + 1 <= cw - 1) ? C : B;   // the odd pixel's neighbour of c0
      if constexpr (SY == 2) {
        v[0] = (3 * B + A + 8) >> 4;
        v[1] = (3 * B + E + 7) >> 4;
        v[2] = (3 * C + B + 8) >> 4;
        v[3] = (3 * C + D + 7) >> 4;
      } else {
        v[0] = (3 * B + A + 1) >> 2;
        v[1] = (3 * B + E + 2) >> 2;
        v[2] = (3 * C + B + 1) >> 2;
        v[3] = (3 * C + D + 2) >> 2;
      }
    } else {
      // h1v2: rows r and its neighbour, four columns in one word each.
      const int r = Y >> 1, rn = (Y & 1) ? min(r + 1, ch - 1) : max(r - 1, 0);
      const uint32_t a = *reinterpret_cast<const uint32_t*>(wrow(comp, r) + Xq - 8 * k0);
      const uint32_t b = *reinterpret_cast<const uint32_t*>(wrow(comp, rn) + Xq - 8 * k0);
      const int bias = (Y & 1) ? 2 : 1;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = (3 * int((a >> (8 * j)) & 255) + int((b >> (8 * j)) & 255) + bias) >> 2;
    }
  };

  // Row ty of the tile starts at base + ty * 3 W in the output; its offset
  // from a 16-byte boundary is (lead0 + ty * step) & 15.
  uint8_t* const base = out + ((size_t(n) * height + Y0) * width + X0) * 3;
  const int lead0 = int(reinterpret_cast<uintptr_t>(base) & 15);
  const int step = (3 * width) & 15;
  for (int p0 = 0; p0 < th; p0 += kRgbRows) {
    // -- 2. colour into the staging rows, four pixels a thread ---------------
    const int tx = 4 * (tid & 63);
    for (int ry = tid >> 6; ry < kRgbRows; ry += kThreads / 64) {
      const int ty = p0 + ry;
      if (ty >= th || tx >= tw) continue;
      const int Y = Y0 + ty, Xq = X0 + tx;
      const uint32_t y4 = *reinterpret_cast<const uint32_t*>(luma + ty * kYPitch + tx);
      int cbv[4], crv[4];
      chroma4(0, Y, Xq, cbv);
      chroma4(1, Y, Xq, crv);
      uint8_t* px = rgb + ry * kRgbPitch + ((lead0 + ty * step) & 15) + 3 * tx;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int yv = (y4 >> (8 * j)) & 255;
        const int cbi = cbv[j] - 128, cri = crv[j] - 128;
        const int r = yv + ((FIX_1_40200 * cri + ONE_HALF) >> SCALEBITS);
        const int g = yv + ((-FIX_0_34414 * cbi + (-FIX_0_71414 * cri + ONE_HALF)) >> SCALEBITS);
        const int bl = yv + ((FIX_1_77200 * cbi + ONE_HALF) >> SCALEBITS);
        px[3 * j] = uint8_t(clamp255(r));
        px[3 * j + 1] = uint8_t(clamp255(g));
        px[3 * j + 2] = uint8_t(clamp255(bl));
      }
    }
    __syncthreads();
    // -- 3. 16-byte stores: warp -> row, lane -> chunk ----------------------
    for (int ry = tid >> 5; ry < kRgbRows && p0 + ry < th; ry += kThreads / 32) {
      uint8_t* g = base + size_t(p0 + ry) * (size_t(width) * 3);
      const int lead = int(reinterpret_cast<uintptr_t>(g) & 15);
      const int end = lead + 3 * tw;          // staging bytes [lead, end) are the row's
      uint8_t* gb = g - lead;                 // 16-byte aligned
      const uint8_t* srow = rgb + ry * kRgbPitch;
      for (int s0 = 16 * (tid & 31); s0 < end; s0 += 16 * 32) {
        if (s0 >= lead && s0 + 16 <= end) {
          *reinterpret_cast<uint4*>(gb + s0) = *reinterpret_cast<const uint4*>(srow + s0);
        } else {
          for (int s = max(s0, lead); s < min(s0 + 16, end); ++s) gb[s] = srow[s];
        }
      }
    }
    __syncthreads();
  }
}

template <int SX, int SY, bool FANCY>
int launch(const void* y, const void* cb, const void* cr, const void* qty, const void* qtc,
           void* out, int n, int vbc, int hbc, int cw, int ch, int height, int width,
           void* stream) {
  using L = Tile<SX, SY, FANCY>;
  const dim3 grid((hbc + L::TC - 1) / L::TC, (vbc + L::MR - 1) / L::MR, n);
  auto s = static_cast<cudaStream_t>(stream);
  fused_rgb_kernel<SX, SY, FANCY><<<grid, kThreads, L::BYTES, s>>>(
      static_cast<const int16_t*>(y), static_cast<const int16_t*>(cb),
      static_cast<const int16_t*>(cr), static_cast<const int32_t*>(qty),
      static_cast<const int32_t*>(qtc), static_cast<uint8_t*>(out), vbc, hbc, cw, ch, height,
      width);
  return int(cudaGetLastError());
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a geometry the kernel does not cover.
extern "C" int jgt_fused_rgb(const void* y, const void* cb, const void* cr,
                             const void* qty, const void* qtc, void* out, int n,
                             int vbc, int hbc, int sx, int sy, int fancy,
                             int cw, int ch, int height, int width,
                             void* stream) {
  if (n < 1 || n > 65535 || vbc < 1 || hbc < 1) return int(cudaErrorInvalidValue);
#define JGT_LAUNCH(SX, SY, F) \
  return launch<SX, SY, F>(y, cb, cr, qty, qtc, out, n, vbc, hbc, cw, ch, height, width, stream)
  switch ((sx << 8) | (sy << 4) | (fancy ? 1 : 0)) {
    case 0x110: JGT_LAUNCH(1, 1, false);
    case 0x210: JGT_LAUNCH(2, 1, false);
    case 0x220: JGT_LAUNCH(2, 2, false);
    case 0x120: JGT_LAUNCH(1, 2, false);
    case 0x410: JGT_LAUNCH(4, 1, false);
    case 0x420: JGT_LAUNCH(4, 2, false);
    case 0x211: JGT_LAUNCH(2, 1, true);
    case 0x221: JGT_LAUNCH(2, 2, true);
    case 0x121: JGT_LAUNCH(1, 2, true);
    default: return int(cudaErrorInvalidValue);
  }
#undef JGT_LAUNCH
}
