"""K2: restart-parallel baseline Huffman decode, and its post-passes.

The port of ``jpeg_gpu_tpu/ops/entropy_device.py``.  Restart segments are
independent by construction (the bit buffer and DC predictors reset at
each marker), so every segment slot decodes on its own.  The layouts are
the reference's:

* streams ``(B, NW, 8, 128)`` int32 -- destuffed big-endian words, word w of
  segment slot ``b*1024 + s*128 + l`` at ``[b, w, s, l]``, 1-padded
  (host/segments.py);
* coefficients ``(B, T, 64, 8, 128)`` int16 -- natural-order coefficients
  of block step t of that slot;
* flags ``(B, 8, 128)`` int32 -- ``ERR_BAD_CODE`` / ``ERR_OVERRUN`` per slot.

On a CUDA tensor :func:`decode_segments_device_multi` launches the
hand-written kernel ``csrc/entropy_decode.cu`` (one thread per segment
slot, early exit at EOB, direct stores); on a CPU tensor it runs the plain
PyTorch version :func:`decode_segments_reference`, which advances all
slots in lockstep as the JAX interpret path does.  Both give identical
coefficients and flags.

Bit arithmetic in the plain version is done on int64 tensors holding
unsigned 32-bit values, so shifts are logical and a shift by 32 gives 0
(torch's ``>>`` on int32 is arithmetic).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from jpeg_gpu_tpu_torch.info import scan_to_frame_order
from jpeg_gpu_tpu_torch.ops.zigzag import DEZIGZAG

LANES = 128
SUBLANES = 8
SLOTS = SUBLANES * LANES  # segment slots per batch

ERR_BAD_CODE = 1
ERR_OVERRUN = 2

_U32 = 0xFFFFFFFF

# Kernel launches since the last reset (set to 0 to start counting).
launches = 0


# -- bit arithmetic on unsigned 32-bit values held in int64 -----------------

def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> the same bits as an unsigned value in int64."""
    return x.to(torch.int64) & _U32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values in int64 -> the int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _shl(x: torch.Tensor, n) -> torch.Tensor:
    """Logical shift left of u32 values; any n >= 32 gives 0."""
    return (x << n) & _U32


class _Tables:
    """The canonical-rank tables of host/segments.py as int64, indexed by
    the caller per lane: ``cbase`` (..., 16), ``counts`` (..., 17), the
    packed entries of ``symbols`` (..., 128) as u32, and ``limit`` (...),
    the invalid-window bound on the unsigned window."""

    def __init__(self, cbase, counts, symbols):
        self.cbase = cbase.to(torch.int64)
        self.counts = counts.to(torch.int64)
        self.symbols = u32(symbols)
        # The XOR-biased signed limit as an unsigned bound on the window:
        # (hi ^ 2^31) >= lim (signed)  <=>  hi >= lim ^ 2^31 (unsigned).
        self.limit = (self.counts[..., 16] & _U32) ^ 0x80000000


def decode_symbol(hi, cbase, counts, entries, limit):
    """Canonical-rank decode of the code at the top of ``hi`` (u32).

    ``cbase`` (..., 16), ``counts`` (..., 17), ``entries`` (..., 128) packed
    words and ``limit`` (...) belong to each lane's slot.  Returns
    (sym, len); len 17 marks an invalid window, and a rank that lands on an
    invalid entry gives len 31.
    """
    # top[..., L-1] = the first L bits of the window, L = 1..16.
    top = hi.unsqueeze(-1) >> (32 - torch.arange(1, 17, device=hi.device))
    rank = torch.minimum(torch.clamp(top - cbase, min=0), counts[..., :16]).sum(-1)
    idx = torch.clamp(rank - 1, 0, 255)
    word = torch.gather(entries, -1, (idx >> 1).unsqueeze(-1)).squeeze(-1)
    ent = (word >> ((idx & 1) * 16)) & 0xFFFF
    bad = hi >= limit
    ln = torch.where(bad, 17, ent >> 8)
    return ent & 0xFF, ln


def extend(hi, ln, size):
    """The ``size`` amplitude bits after an ``ln``-bit code, EXTENDed."""
    raw = _shl(hi, torch.clamp(ln, max=31)) >> (32 - size)
    half = 1 << torch.clamp(size - 1, min=0)
    full = 1 << torch.clamp(size, max=30)
    return torch.where((size > 0) & (raw < half), raw - full + 1, raw)


class BitWindow:
    """Lockstep 64-bit windows (hi, lo as u32 in int64) over ``rows``.

    ``rows`` is ``(N, NW)`` u32 words per lane; a word index outside
    ``[0, NW)`` reads 0, as the TPU kernel's masked fetch did.
    """

    def __init__(self, rows, hi, lo, navail, wp):
        self.rows = rows
        self.hi, self.lo, self.navail, self.wp = hi, lo, navail, wp

    def fetch(self, wp):
        nw = self.rows.shape[-1]
        inside = (wp >= 0) & (wp < nw)
        w = torch.gather(self.rows, -1, torch.clamp(wp, 0, nw - 1).unsqueeze(-1))
        return torch.where(inside, w.squeeze(-1), 0)

    def refill(self):
        w = self.fetch(self.wp)
        need = self.navail <= 32
        self.hi = torch.where(need, self.hi | (w >> self.navail), self.hi)
        self.lo = torch.where(need, self.lo | _shl(w, 32 - self.navail), self.lo)
        self.navail = torch.where(need, self.navail + 32, self.navail)
        self.wp = torch.where(need, self.wp + 1, self.wp)

    def consume(self, n):
        """Advance every lane by its n bits, 0 <= n <= 31."""
        self.hi = _shl(self.hi, n) | (self.lo >> (32 - n))
        self.lo = _shl(self.lo, n)
        self.navail = self.navail - n


def _check_decode_args(streams, img_of_batch, comp_map, dcslot_map, acslot_map,
                       seg_meta, cbase, counts, symbols):
    if streams.dim() != 4 or tuple(streams.shape[2:]) != (SUBLANES, LANES):
        raise ValueError(f"streams must be (B, NW, 8, 128), got {tuple(streams.shape)}")
    b = streams.shape[0]
    ni = cbase.shape[0]
    want = {
        "img_of_batch": (img_of_batch, (b,)),
        "seg_meta": (seg_meta, (ni, 3)),
        "cbase": (cbase, (ni, 8, 16)),
        "counts": (counts, (ni, 8, 17)),
        "symbols": (symbols, (ni, 8, SUBLANES, LANES)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if comp_map.dim() != 1 or dcslot_map.shape != comp_map.shape or (
            acslot_map.shape != comp_map.shape):
        raise ValueError("comp_map, dcslot_map and acslot_map must all be (T,)")
    for t in (streams, img_of_batch, comp_map, dcslot_map, acslot_map, seg_meta,
              cbase, counts, symbols):
        if t.dtype != torch.int32:
            raise TypeError(f"K2 takes int32 tensors, got {t.dtype}")


def decode_segments_reference(
    streams, img_of_batch, comp_map, dcslot_map, acslot_map, seg_meta,
    cbase, counts, symbols,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2, on any device.

    Every segment slot advances in lockstep, block step by block step and
    one symbol per iteration, as the JAX kernel's interpret path runs;
    the AC loop stops once every slot has reached EOB.  A batch whose image
    index has no tables flags all its segments and decodes nothing, as the
    kernel does.
    """
    dev = streams.device
    b, nw = streams.shape[0], streams.shape[1]
    nsteps = comp_map.shape[0]
    n = b * SLOTS
    rows = u32(streams.reshape(b, nw, SLOTS).permute(0, 2, 1).reshape(n, nw))
    ni = cbase.shape[0]
    img_ok = ((img_of_batch >= 0) & (img_of_batch < ni)).repeat_interleave(SLOTS)
    img = torch.where(img_ok, img_of_batch.repeat_interleave(SLOTS), 0).to(torch.int64)
    sub = torch.arange(SLOTS, device=dev).repeat(b) // LANES             # (N,)
    tab = _Tables(cbase, counts, symbols)
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    win = BitWindow(rows, zero, zero, zero, zero)
    dc = torch.zeros((4, n), dtype=torch.int32, device=dev)
    flags = torch.zeros(n, dtype=torch.int32, device=dev)
    out = torch.zeros((b, nsteps, 64, SLOTS), dtype=torch.int16, device=dev)
    lane = torch.arange(n, device=dev)
    meta = seg_meta.to(torch.int64)[img]                                 # (N, 3)
    last_lane = (lane // SLOTS == meta[:, 0]) & (lane % SLOTS == meta[:, 1])
    natural = torch.as_tensor(DEZIGZAG, dtype=torch.int64, device=dev)
    comps = comp_map.tolist()
    dcs, acs = dcslot_map.tolist(), acslot_map.tolist()

    def slot_tables(slot):
        return (tab.cbase[img, slot], tab.counts[img, slot],
                tab.symbols[img, slot, sub], tab.limit[img, slot])

    for t in range(nsteps):
        comp = comps[t]
        step_flags = torch.zeros(n, dtype=torch.int32, device=dev)
        # DC
        win.refill()
        sym, ln = decode_symbol(win.hi, *slot_tables(dcs[t]))
        bad_dc = (ln > 16) | (sym > 15)
        size = torch.clamp(sym, max=15)
        diff = extend(win.hi, ln, size)
        win.consume(torch.where(bad_dc, 0, ln + size))
        dc[comp] += torch.where(bad_dc, 0, diff).to(torch.int32)
        step_flags |= torch.where(bad_dc, ERR_BAD_CODE, 0).to(torch.int32)
        coef = torch.zeros((n, 64), dtype=torch.int32, device=dev)
        coef[:, 0] = dc[comp]
        # AC: one symbol per iteration for every still-active slot.
        ac_tab = slot_tables(acs[t])
        k = torch.zeros(n, dtype=torch.int64, device=dev)
        active = ~bad_dc
        for _ in range(63):
            if not bool(active.any()):
                break
            win.refill()
            sym, ln = decode_symbol(win.hi, *ac_tab)
            bad = active & (ln > 16)
            sym = torch.where(bad, 0, sym)  # treated as EOB: no bits consumed
            run, size = sym >> 4, sym & 15
            is_eob = sym == 0
            coded = active & ~is_eob
            badsym = coded & (size == 0) & (run != 15)
            val = extend(win.hi, ln, size)
            newk = k + run + 1
            over = coded & (newk > 63)
            write = coded & (size > 0) & ~over
            coef.scatter_add_(
                1, torch.clamp(newk, max=63).unsqueeze(1),
                torch.where(write, val, 0).to(torch.int32).unsqueeze(1),
            )
            win.consume(torch.where(active & ~bad, ln + size, 0))
            k = torch.where(coded, torch.clamp(newk, max=63), k)
            step_flags |= (
                torch.where(bad | badsym, ERR_BAD_CODE, 0)
                | torch.where(over, ERR_OVERRUN, 0)
            ).to(torch.int32)
            active = coded & (k < 63) & ~over & ~badsym
        out[:, t] = coef[:, natural].to(torch.int16).reshape(b, SLOTS, 64).permute(0, 2, 1)
        # The short last segment's padded tail steps raise meaningless flags.
        suppress = last_lane & (t >= meta[:, 2])
        flags = torch.where(suppress, flags, flags | step_flags)
    out = torch.where(img_ok.reshape(b, 1, 1, SLOTS), out, 0)
    out = out.reshape(b, nsteps, 64, SUBLANES, LANES)
    flags = torch.where(img_ok, flags, ERR_BAD_CODE)
    return out, flags.reshape(b, SUBLANES, LANES)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from jpeg_gpu_tpu_torch import cuda_build

        lib = cuda_build.load("entropy_decode")
        lib.jgt_entropy_decode.restype = ctypes.c_int
        lib.jgt_entropy_decode.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        _lib = lib
    return _lib


def decode_segments_device_multi(
    streams: torch.Tensor,       # (B, NW, 8, 128) int32
    img_of_batch: torch.Tensor,  # (B,) int32: image index of segment batch b
    comp_map: torch.Tensor,      # (T,) int32
    dcslot_map: torch.Tensor,    # (T,) int32
    acslot_map: torch.Tensor,    # (T,) int32
    seg_meta: torch.Tensor,      # (NI, 3) int32: last segment (batch, lane, steps)
    cbase: torch.Tensor,         # (NI, 8, 16) int32
    counts: torch.Tensor,        # (NI, 8, 17) int32 (slot 16: invalid limit)
    symbols: torch.Tensor,       # (NI, 8, 8, 128) int32, (sym|len<<8) 2/word
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device entropy decode with per-image Huffman tables.

    A corpus batch stacks every image's segment batches on the leading
    axis; ``img_of_batch`` routes each batch to its image's tables.

    Returns (coefs, err): coefs (B, T, 64, 8, 128) int16 natural-order,
    err (B, 8, 128) int32 per-segment error flags (0 = clean).  CPU tensors
    run the plain version; CUDA tensors launch the kernel.
    """
    _check_decode_args(streams, img_of_batch, comp_map, dcslot_map, acslot_map,
                       seg_meta, cbase, counts, symbols)
    dev = streams.device
    if dev.type == "cpu":
        return decode_segments_reference(
            streams, img_of_batch, comp_map, dcslot_map, acslot_map, seg_meta,
            cbase, counts, symbols,
        )
    if dev.type != "cuda":
        raise RuntimeError(f"decode_segments_device: no kernel for device {dev}")
    args = [streams, img_of_batch, comp_map, dcslot_map, acslot_map, seg_meta,
            cbase, counts, symbols]
    if any(t.device != dev for t in args):
        raise ValueError(f"decode_segments_device: all inputs must be on {dev}")
    args = [t.contiguous() for t in args]
    b, nw = streams.shape[0], streams.shape[1]
    nsteps = comp_map.shape[0]
    out = torch.zeros((b, nsteps, 64, SUBLANES, LANES), dtype=torch.int16, device=dev)
    err = torch.empty((b, SUBLANES, LANES), dtype=torch.int32, device=dev)
    if b == 0 or nsteps == 0:
        return out, err.zero_()
    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jgt_entropy_decode(
            *(t.data_ptr() for t in args), out.data_ptr(), err.data_ptr(),
            b, nw, nsteps, cbase.shape[0], stream,
        )
    if rc != 0:
        raise RuntimeError(f"entropy_decode kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out, err


def decode_segments_device(
    streams: torch.Tensor,       # (B, NW, 8, 128) int32
    comp_map: torch.Tensor,      # (T,) int32
    dcslot_map: torch.Tensor,    # (T,) int32
    acslot_map: torch.Tensor,    # (T,) int32
    seg_meta: torch.Tensor,      # (3,) int32: last segment (batch, lane, steps)
    cbase: torch.Tensor,         # (8, 16) int32
    counts: torch.Tensor,        # (8, 17) int32 (slot 16: invalid limit)
    symbols: torch.Tensor,       # (8, 8, 128) int32, (sym|len<<8) 2/word
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-image device entropy decode (tables: DeviceScanPlan.kernel_tables).

    Returns (coefs, err) as :func:`decode_segments_device_multi` does.
    """
    b = streams.shape[0]
    return decode_segments_device_multi(
        streams,
        torch.zeros((b,), dtype=torch.int32, device=streams.device),
        comp_map, dcslot_map, acslot_map, seg_meta[None],
        cbase[None], counts[None], symbols[None],
    )


def apply_dc_base(kernel_out, dc_base, comp_map):
    """Add per-pseudo-segment DC predictor bases (DRI-less streams).

    A pseudo segment starts mid-stream, so its true DC predictors are the
    running values the index scan found; the kernel decoded from 0, which
    offsets every block's DC in the segment by exactly the base.

    kernel_out (B, T, 64, 8, 128) int16 is updated in place (int16
    wrap-around, as the reference's int16 add) and returned; dc_base
    (B, 8, 128, C) int32; comp_map (T,) int32.
    """
    add = dc_base[..., comp_map.to(torch.int64)]          # (B, 8, 128, T)
    add = add.movedim(-1, 1).to(torch.int16)              # (B, T, 8, 128)
    kernel_out[:, :, 0] += add
    return kernel_out


def assemble_components(
    kernel_out: torch.Tensor,       # (B, T, 64, 8, 128) int16
    n_segments: int,
    mcus_per_segment: int,
    n_mcus: int,
    nhmb: int,
    nvmb: int,
    comp_geometry: Tuple[Tuple[int, int], ...],  # per SCAN comp (hsamp, vsamp)
    soa: bool = False,
    force_general: bool = False,
    frame_order: Optional[Tuple[int, ...]] = None,
):
    """Kernel output -> per-component coefficient tensors (contiguous).

    ``comp_geometry`` follows the scan's component order (the MCU
    interleave); ``frame_order`` (the scan's ``comp_idx``) reorders the
    result to frame positions; None means scan order is frame order.

    The default layout is (vb, hb, 8, 8) blocks (the QUANT-stage contract);
    ``soa=True`` gives parity-split planes (vs, hs, 64, nvmb, nhmb), the
    layout K1 consumes.  For one-MCU segments the slot order is the MCU
    raster order, so the SoA planes need only outer-axis moves; that fast
    path picks itself, and ``force_general`` exists for the test that
    holds it to the general relayout.
    """
    b, t = kernel_out.shape[:2]
    nseg_slots = b * SLOTS
    bpm = sum(hs * vs for hs, vs in comp_geometry)
    assert t == mcus_per_segment * bpm
    out = []
    if soa and mcus_per_segment == 1 and not force_general:
        # Slot (b, s, l) holds exactly MCU b*1024 + s*128 + l, and block
        # step t is the block-in-MCU index.
        assert n_segments == n_mcus
        x = kernel_out.reshape(b, bpm, 64, SLOTS).permute(1, 2, 0, 3)
        x = x.reshape(bpm, 64, nseg_slots)[:, :, :n_mcus]
        off = 0
        for hs, vs in comp_geometry:
            nb = hs * vs
            out.append(x[off:off + nb].reshape(vs, hs, 64, nvmb, nhmb).contiguous())
            off += nb
    else:
        x = kernel_out.reshape(b, t, 64, SLOTS).permute(0, 3, 1, 2)
        x = x.reshape(nseg_slots, t, 64)[:n_segments]
        # (nseg, R, bpm, 64) -> (nseg*R MCUs, bpm, 64), drop padding MCUs.
        x = x.reshape(n_segments * mcus_per_segment, bpm, 64)[:n_mcus]
        off = 0
        for hs, vs in comp_geometry:
            nb = hs * vs
            yc = x[:, off:off + nb, :].reshape(nvmb, nhmb, vs, hs, 64)
            off += nb
            if soa:
                # Block (vs*i + pr, hs*k + pc) is MCU (i, k) sub-block (pr, pc).
                out.append(yc.permute(2, 3, 4, 0, 1).contiguous())
            else:
                yc = yc.permute(0, 2, 1, 3, 4)              # (nvmb, vs, nhmb, hs, 64)
                out.append(yc.reshape(nvmb * vs, nhmb * hs, 8, 8).contiguous())
    if frame_order is not None:
        out = scan_to_frame_order(out, frame_order)
    return tuple(out)


def plan_tensors(arrays, device) -> Tuple[torch.Tensor, ...]:
    """numpy plan arrays -> int32 tensors on ``device`` (copies, so the
    read-only cached table arrays never alias a tensor)."""
    return tuple(
        torch.tensor(np.asarray(a, dtype=np.int32), device=device) for a in arrays
    )
