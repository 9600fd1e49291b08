// K3 on Hopper: one round of the speculative self-synchronising index scan.
//
// Replaces the TPU kernel jpeg_gpu_tpu/ops/specsync_device.py:_scan_kernel,
// launched by _scan_round.  The destuffed stream of a stream without
// restart markers is cut into subsequences of SB bytes, one per lane slot
// b*1024 + s*128 + l; lane (b, s, l) reads its own window row
// [b, :, s, l] of NWS words.  From its entry state (p, c, at_dc, k) -- bit
// position relative to its window, block phase in the MCU, whether the
// next symbol is a DC symbol, zig-zag index -- each lane decodes code
// lengths only (no amplitudes) until p passes its end, and writes its exit
// state.  In the record pass it also writes the bit position of every MCU
// start it meets: up to `maxrec` of them, while its count keeps counting
// past maxrec (the caller's overflow check and fallback depend on it).
//
// Bound: a serial chain per lane, as in K2; one round is about SB * 8 /
// (bits per symbol) chain steps, and the caller runs a few rounds.
//
// Design (a simple, correct first version):
// * One thread per lane, one warp per CUDA block, the block's 8 table slots
//   (its sublane's packed entries) in shared memory.  The table slot is
//   picked per thread from the block phase; the TPU kernel needed masked
//   sums over every used slot because Mosaic has no per-lane scalar.
// * Records are plain stores at [b, j, s, l]; the TPU kernel carried them
//   in one-hot register rows because Mosaic has no scatter.
// * The loop is bounded by SB * 8 + 2 iterations (every active step
//   consumes at least one bit), and every word read is bounded by NWS.
// * An invalid code consumes 17 bits, as in the reference: off the true
//   path any deterministic rule that consumes at least one bit will do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman_bits.cuh"

namespace {

constexpr int kLanes = 1024;
constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
specsync_scan_kernel(const int32_t* __restrict__ windows,
                     const int32_t* __restrict__ entry,
                     const int32_t* __restrict__ dcslot,
                     const int32_t* __restrict__ acslot,
                     const int32_t* __restrict__ cbase,
                     const int32_t* __restrict__ counts,
                     const int32_t* __restrict__ symbols,
                     int32_t* __restrict__ exit_state,
                     int32_t* __restrict__ rec, int32_t* __restrict__ recn_out,
                     int nws, int nbits, int sb, int bpm, int maxrec,
                     int record) {
  __shared__ jgt::Slot slots[8];
  const int blocks_per_row = 128 / kThreads;
  const int row = blockIdx.x / blocks_per_row;   // b * 8 + s
  const int b = row >> 3, s = row & 7;
  const int lane = s * 128 + (blockIdx.x % blocks_per_row) * kThreads + threadIdx.x;
  jgt::load_slots(slots, cbase, counts, symbols, s);
  __syncthreads();

  const int sb_bits = sb * 8;
  const int64_t gl = static_cast<int64_t>(b) * kLanes + lane;
  // Lanes past the stream end get end <= 0 and never decode.
  const int64_t left = static_cast<int64_t>(nbits) - gl * sb_bits;
  const int end = left >= sb_bits ? sb_bits : left < INT32_MIN ? INT32_MIN : static_cast<int>(left);
  const int32_t* words = windows + static_cast<int64_t>(b) * nws * kLanes + lane;
  const int32_t* ent = entry + static_cast<int64_t>(b) * 4 * kLanes + lane;
  int p = ent[0], c = ent[kLanes], at_dc = ent[2 * kLanes], k = ent[3 * kLanes];

  // The 64-bit window at the (arbitrary) entry bit p.
  jgt::Window win;
  const int wp0 = static_cast<int>(static_cast<uint32_t>(p) >> 5);
  const int sh = p & 31;
  const uint32_t w0 = wp0 < nws ? static_cast<uint32_t>(words[static_cast<int64_t>(wp0) * kLanes]) : 0u;
  const uint32_t w1 = wp0 + 1 < nws ? static_cast<uint32_t>(words[static_cast<int64_t>(wp0 + 1) * kLanes]) : 0u;
  win.hi = (w0 << sh) | jgt::lsr_safe(w1, 32 - sh);
  win.lo = jgt::shl_safe(w1, sh);
  win.navail = 64 - sh;
  win.wp = wp0 + 2;

  int32_t* rec_lane = record ? rec + static_cast<int64_t>(b) * maxrec * kLanes + lane : nullptr;
  int recn = 0;
  const int max_iters = sb_bits + 2;
  for (int it = 0; it < max_iters && p < end; ++it) {
    if (record && at_dc > 0 && c == 0) {
      if (recn < maxrec) rec_lane[static_cast<int64_t>(recn) * kLanes] = p;
      ++recn;
    }
    win.refill(words, nws, kLanes);
    // A phase outside [0, bpm) selects slot 0, as the reference's masked
    // select does.
    const int phase_slot = (c >= 0 && c < bpm) ? (at_dc > 0 ? dcslot[c] : acslot[c]) : 0;
    int sym, len;
    jgt::decode_symbol(win.hi, slots[phase_slot & 7], sym, len);
    if (len > 16) {  // invalid: decodes as EOB, 17 bits
      sym = 0;
      len = 17;
    }
    int consume;
    if (at_dc > 0) {
      consume = len + min(sym, 15);
      k = 0;
      at_dc = 0;
    } else {
      const int newk = k + (sym >> 4) + 1;
      const bool blk_end = sym == 0 || newk >= 63;
      consume = len + (sym & 15);
      k = min(newk, 63);
      if (blk_end) {
        c = c + 1 == bpm ? 0 : c + 1;
        at_dc = 1;
      }
    }
    win.consume(consume);
    p += consume;
  }

  int32_t* ex = exit_state + static_cast<int64_t>(b) * 4 * kLanes + lane;
  ex[0] = p;
  ex[kLanes] = c;
  ex[2 * kLanes] = at_dc;
  ex[3 * kLanes] = k;
  if (record) recn_out[static_cast<int64_t>(b) * kLanes + lane] = recn;
}

}  // namespace

// windows (BS, NWS, 8, 128) i32; entry (BS, 4, 8, 128) i32 rows p, c, at_dc,
// k; dcslot/acslot (bpm,) i32; cbase (8, 16), counts (8, 17), symbols
// (8, 8, 128) i32; exit_state (BS, 4, 8, 128) i32; when record != 0, rec
// (BS, maxrec, 8, 128) i32 zero-filled by the caller and recn (BS, 1, 8, 128)
// i32.  Returns cudaGetLastError() after the launch.
extern "C" int jgt_specsync_scan(const void* windows, const void* entry,
                                 const void* dcslot, const void* acslot,
                                 const void* cbase, const void* counts,
                                 const void* symbols, void* exit_state,
                                 void* rec, void* recn, int nbatch, int nws,
                                 int nbits, int sb, int bpm, int maxrec,
                                 int record, void* stream) {
  if (nbatch <= 0 || bpm <= 0 || (record && maxrec <= 0)) return int(cudaErrorInvalidValue);
  const int grid = nbatch * kLanes / kThreads;
  specsync_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(windows), static_cast<const int32_t*>(entry),
      static_cast<const int32_t*>(dcslot), static_cast<const int32_t*>(acslot),
      static_cast<const int32_t*>(cbase), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(symbols), static_cast<int32_t*>(exit_state),
      static_cast<int32_t*>(rec), static_cast<int32_t*>(recn), nws, nbits, sb,
      bpm, maxrec, record);
  return int(cudaGetLastError());
}
