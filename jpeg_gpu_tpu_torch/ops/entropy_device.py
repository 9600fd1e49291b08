"""K2: baseline Huffman decode on the device, and its post-passes.

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

Two entries reach the hand-written kernel ``csrc/entropy_decode.cu`` on a
CUDA tensor.  :func:`decode_segments_device_multi` is the row form, for
restart-marked plans and the serial-scan fallback.
:func:`decode_mcus_at_bitpos` is the fused form for streams without restart
markers: after the index scan (K3) it decodes MCU m straight out of the
scan's window tensor from bit ``bitpos[m]`` on and finishes the DC
predictors on the card, in place of the chain :func:`gather_entropy_streams`
-> row form -> :func:`dc_base_from_coefs` -> :func:`apply_dc_base`.  Both
look symbols up in two-level tables (:func:`symbol_lut`,
``csrc/symbol_lut.cuh``) that a small kernel builds once per table set.

On a CPU tensor each entry runs its plain PyTorch version
(:func:`decode_segments_reference`, which advances all slots in lockstep as
the JAX interpret path does, and :func:`decode_mcus_at_bitpos_reference`,
the chain above).  Kernel and plain version give identical coefficients and
flags.

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

# Kernel launches since the last reset (set to 0 to start counting): one per
# row-form decode, two per fused decode (the decode, then the DC predictors),
# one per build of the symbol tables.
launches = 0

# The two-level symbol tables (csrc/symbol_lut.cuh), per (sublane, slot): a
# first level indexed by the window's top LUT_BITS bits, then SUB_TABLES
# second-level tables indexed by the SUB_BITS bits after them.  A 16-bit entry
# is what the kernel needs of the symbol (K2: :func:`symbol_entry`; K3: its
# chain entry), LUT_SUB | the byte offset of a second-level table among the
# slot's entries (in the first level: look there) or LUT_MISS (use
# decode_symbol).
LUT_BITS = 10
SUB_BITS = 6
SUB_TABLES = 16
LUT_WORDS = (1 << LUT_BITS) + SUB_TABLES * (1 << SUB_BITS)
LUT_MISS = 0
LUT_SUB = 0x8000
# 16-bit entries of one table set on the card: the 64 (sublane, slot) tables,
# then one flag each (the tables answer every window).
LUT_IMAGE = SUBLANES * 8 * (LUT_WORDS + 1)


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


class StreamWindow(BitWindow):
    """Lockstep windows over the destuffed stream that the index scan's
    window tensor ``windows`` (BS, NWS, 8, 128) tiles, lane m from stream bit
    ``start[m]`` on: flat stream word W sits at ``[W // spw // 1024, W % spw,
    (W // spw) % 1024]``, and words past the grid read 0xFFFFFFFF, as K2's
    fused form reads them.  Each word is looked up when a lane needs it, so
    nothing is sized by the words a lane might read."""

    def __init__(self, windows, spw: int, start):
        self.flat = windows.reshape(-1)
        self.nws, self.spw = windows.shape[1], spw
        self.grid = windows.shape[0] * SLOTS * spw
        wp, sh = start >> 5, start & 31
        w0, w1 = self.fetch(wp), self.fetch(wp + 1)
        super().__init__(None, _shl(w0, sh) | (w1 >> (32 - sh)), _shl(w1, sh), 64 - sh, wp + 2)

    def fetch(self, wp):
        w = torch.clamp(wp, max=self.grid - 1)
        g = w // self.spw
        idx = ((g // SLOTS) * self.nws + (w - g * self.spw)) * SLOTS + g % SLOTS
        return torch.where(wp < self.grid, u32(self.flat[idx]), _U32)


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
):
    """Plain PyTorch version of K2's row form, on any device.

    Every segment slot advances in lockstep, block step by block step and
    one symbol per iteration, as the JAX kernel's interpret path runs;
    the AC loop stops once every slot has reached EOB.  A batch whose image
    index has no tables flags all its segments and decodes nothing, as the
    kernel does.  Returns (coefs, err).
    """
    b, nw = streams.shape[0], streams.shape[1]
    rows = u32(streams.reshape(b, nw, SLOTS).permute(0, 2, 1).reshape(b * SLOTS, nw))
    zero = torch.zeros(b * SLOTS, dtype=torch.int64, device=streams.device)
    win = BitWindow(rows, zero, zero, zero, zero)
    return _decode_lanes(win, b, img_of_batch, comp_map, dcslot_map, acslot_map,
                         seg_meta, cbase, counts, symbols)


def _decode_lanes(win, b, img_of_batch, comp_map, dcslot_map, acslot_map, seg_meta,
                  cbase, counts, symbols):
    """The lockstep decode of :func:`decode_segments_reference` from the bit
    windows ``win`` of its ``b * 1024`` lanes; ``win`` is left where each
    lane stopped.  Returns (coefs, err)."""
    dev = img_of_batch.device
    nsteps = comp_map.shape[0]
    n = b * SLOTS
    ni = cbase.shape[0]
    img_ok = ((img_of_batch >= 0) & (img_of_batch < ni)).repeat_interleave(SLOTS)
    img = torch.where(img_ok, img_of_batch.repeat_interleave(SLOTS), 0).to(torch.int64)
    sub = torch.arange(SLOTS, device=dev).repeat(b) // LANES             # (N,)
    tab = _Tables(cbase, counts, symbols)
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
    flags = torch.where(img_ok, flags, ERR_BAD_CODE).reshape(b, SUBLANES, LANES)
    return out, flags


def _rank(hi, cbase, counts):
    """The canonical rank decode_symbol looks its entry up with."""
    top = hi.unsqueeze(-1) >> (32 - torch.arange(1, 17, device=hi.device))
    return torch.minimum(torch.clamp(top - cbase, min=0), counts[..., :16]).sum(-1)


def symbol_entry(sym, ln):
    """What K2's step needs of a decoded symbol, in 14 bits: bits 0-4 the
    code length (17 for any invalid code, whose symbol is then 0), bits 5-12
    the symbol, bit 13 set.  Never 0, the tables' miss marker."""
    invalid = ln > 16
    sym = torch.where(invalid, 0, sym)
    ln = torch.where(invalid, 17, ln)
    return ln | ((sym & 255) << 5) | 0x2000


def lut_reference(cbase, counts, symbols, entry=symbol_entry) -> torch.Tensor:
    """Plain PyTorch version of the symbol tables of one table set.

    Returns (8, 8, LUT_WORDS) int32 holding 16-bit entries, ``[sublane,
    slot, entry]``.  The first 2**LUT_BITS entries, one per prefix of
    LUT_BITS bits: ``entry(*decode_symbol(...))`` where every window with
    that prefix decodes alike; else ``LUT_SUB |`` the byte offset of the j-th
    second-level table, where this is the j-th such prefix in rising order;
    else (more than SUB_TABLES of them) ``LUT_MISS``.  Then the second-level
    tables, one entry per prefix of LUT_BITS + SUB_BITS bits under the
    table's own prefix: the entry, or ``LUT_MISS``.  The rank and the invalid
    test are both monotone in the window, so "alike" is decided at the two
    ends of a prefix's range, whatever the tables hold.
    """
    tab = _Tables(cbase, counts, symbols)
    dev = cbase.device
    n, nsub = 1 << LUT_BITS, 1 << SUB_BITS
    cb, cn = tab.cbase[None, :, None], tab.counts[None, :, None]
    limit = tab.limit[None, :, None]
    entries = tab.symbols.permute(1, 0, 2)[:, :, None].expand(SUBLANES, 8, n, LANES)

    def range_entry(lo, bits):
        hi = lo | ((1 << (32 - bits)) - 1)
        alike = (_rank(lo, cb, cn) == _rank(hi, cb, cn)) & ((lo >= limit) == (hi >= limit))
        return torch.where(
            alike, entry(*decode_symbol(lo, cb, cn, entries, limit)), LUT_MISS)

    prefix = torch.arange(n, dtype=torch.int64, device=dev)
    first = range_entry((prefix << (32 - LUT_BITS)).expand(SUBLANES, 8, n), LUT_BITS)
    deep = first == LUT_MISS
    j = torch.cumsum(deep, -1) - 1
    sub = deep & (j < SUB_TABLES)
    first = torch.where(sub, LUT_SUB | ((n + j * nsub) * 2), first)
    # The prefix of each second-level table; n marks a table that is not used.
    own = torch.where(sub, prefix, n).sort(-1).values[..., :SUB_TABLES]
    assert SUB_TABLES * nsub == n   # entries and the rest broadcast as above
    lo = ((own[..., None] << SUB_BITS) | torch.arange(nsub, device=dev)) << 16
    second = range_entry(lo.reshape(SUBLANES, 8, n) & 0xFFFFFFFF, LUT_BITS + SUB_BITS)
    second = torch.where((own == n).repeat_interleave(nsub, -1), LUT_MISS, second)
    return torch.cat([first, second], -1).to(torch.int32)


def lut_lookup(lut, hi):
    """The kernels' lookup in plain PyTorch: the entries of the windows ``hi``
    (..., N) in their tables ``lut`` (..., LUT_WORDS), or LUT_MISS where a
    kernel calls decode_symbol."""
    lut = lut.to(torch.int64)
    e = torch.gather(lut, -1, hi >> (32 - LUT_BITS))
    deep = (e & LUT_SUB) != 0
    at = ((e & (LUT_SUB - 1)) >> 1) + ((hi >> 16) & ((1 << SUB_BITS) - 1))
    return torch.where(deep, torch.gather(lut, -1, torch.where(deep, at, 0)), e)


def lut_complete(lut) -> torch.Tensor:
    """(8, 8) bool: the tables of that (sublane, slot) answer every window,
    so a kernel runs its step without the call of decode_symbol: no LUT_MISS
    in the first level nor in a second-level table the first level points to."""
    lut = lut.to(torch.int64)
    n, nsub = 1 << LUT_BITS, 1 << SUB_BITS
    first, second = lut[..., :n], lut[..., n:].reshape(*lut.shape[:-1], SUB_TABLES, nsub)
    used = ((first & LUT_SUB) != 0).sum(-1)                   # tables 0..used-1
    holes = (second == LUT_MISS) & (torch.arange(SUB_TABLES, device=lut.device)[:, None]
                                    < used[..., None, None])
    return ~((first == LUT_MISS).any(-1) | holes.any(-1).any(-1))


def lut_views(raw: torch.Tensor):
    """A kernel's table buffer (NI * LUT_IMAGE int16) -> (tables, complete):
    the tables widened to (NI, 8, 8, LUT_WORDS) int32 as
    :func:`lut_reference` gives them, the flags as :func:`lut_complete`."""
    raw = raw.reshape(-1, LUT_IMAGE)
    tables = raw[:, : SUBLANES * 8 * LUT_WORDS].reshape(-1, SUBLANES, 8, LUT_WORDS)
    return tables.to(torch.int32) & 0xFFFF, raw[:, SUBLANES * 8 * LUT_WORDS:].reshape(
        -1, SUBLANES, 8) != 0


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from jpeg_gpu_tpu_torch import cuda_build

        lib = cuda_build.load("entropy_decode")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.jgt_entropy_lut.restype = ctypes.c_int
        lib.jgt_entropy_lut.argtypes = [ptr] * 4 + [i32, ptr]
        lib.jgt_entropy_decode.restype = ctypes.c_int
        lib.jgt_entropy_decode.argtypes = [ptr] * 12 + [i32] * 4 + [ptr]
        lib.jgt_entropy_decode_fused.restype = ctypes.c_int
        lib.jgt_entropy_decode_fused.argtypes = [ptr] * 13 + [i32] * 6 + [ptr]
        _lib = lib
    return _lib


def symbol_lut(cbase, counts, symbols) -> torch.Tensor:
    """K2's symbol tables as the kernel builds them on the card, for one
    table set (cbase (8, 16), counts (8, 17), symbols (8, 8, 128)) or NI of
    them stacked on a leading axis: (NI * LUT_IMAGE,) int16, what
    :func:`decode_segments_device_multi` and :func:`decode_mcus_at_bitpos`
    take as ``lut`` (:func:`lut_views` unpacks it).  Build once per table
    set.  CUDA tensors only."""
    dev = cbase.device
    if dev.type != "cuda":
        raise RuntimeError(f"symbol_lut: no kernel for device {dev}")
    ni = 1 if cbase.dim() == 2 else cbase.shape[0]
    tabs = []
    for name, t, shape in (("cbase", cbase, (8, 16)), ("counts", counts, (8, 17)),
                           ("symbols", symbols, (8, SUBLANES, LANES))):
        if tuple(t.shape) not in (shape, (ni,) + shape):
            raise ValueError(f"{name} must be {shape} or {(ni,) + shape}, got {tuple(t.shape)}")
        if t.dtype != torch.int32 or t.device != dev:
            raise TypeError(f"symbol_lut takes int32 tensors on {dev}")
        tabs.append(t.contiguous())
    lut = torch.empty(ni * LUT_IMAGE, dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        rc = _kernel().jgt_entropy_lut(
            *(t.data_ptr() for t in tabs), lut.data_ptr(), ni,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"entropy_decode table kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return lut


def _check_lut(lut, ni: int, dev):
    if lut.dtype != torch.int16 or lut.numel() != ni * LUT_IMAGE or lut.device != dev:
        raise ValueError(
            f"lut must be symbol_lut's ({ni * LUT_IMAGE},) int16 on {dev}, got "
            f"{tuple(lut.shape)} {lut.dtype} on {lut.device}")
    return lut.contiguous()


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
    lut: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device entropy decode with per-image Huffman tables (the row form).

    A corpus batch stacks every image's segment batches on the leading
    axis; ``img_of_batch`` routes each batch to its image's tables.  ``lut``
    is :func:`symbol_lut` of the same tables, kept by a caller that decodes
    with them again; None builds it in this call (CUDA only; the plain
    version has no use for it).

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
    # The kernel writes every coefficient, zeros included.
    out = torch.empty((b, nsteps, 64, SUBLANES, LANES), dtype=torch.int16, device=dev)
    err = torch.empty((b, SUBLANES, LANES), dtype=torch.int32, device=dev)
    if b == 0 or nsteps == 0 or nw == 0:
        return out.zero_(), err.zero_()
    ni = cbase.shape[0]
    lut = symbol_lut(*args[6:]) if lut is None else _check_lut(lut, ni, dev)
    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jgt_entropy_decode(
            *(t.data_ptr() for t in args), lut.data_ptr(), out.data_ptr(), err.data_ptr(),
            b, nw, nsteps, ni, stream,
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
    lut: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-image device entropy decode (tables: DeviceScanPlan.kernel_tables).

    Returns (coefs, err) as :func:`decode_segments_device_multi` does.
    """
    b = streams.shape[0]
    return decode_segments_device_multi(
        streams,
        torch.zeros((b,), dtype=torch.int32, device=streams.device),
        comp_map, dcslot_map, acslot_map, seg_meta[None],
        cbase[None], counts[None], symbols[None], lut=lut,
    )


def gather_entropy_streams(
    windows: torch.Tensor,   # (BS, NWS, 8, 128) int32
    bitpos: torch.Tensor,    # (n_mcus,) int32
    *,
    nw: int,
    spw: int,                # non-overlapping words per window row (SB // 4)
    nws: int,                # words per window row (spw + overlap)
) -> torch.Tensor:
    """Bit-aligned per-MCU streams for K2's row form, built on the device.

    One gather pulls each pseudo segment's ``nw + 1`` words out of the
    window tensor from word ``bitpos >> 5`` (the first ``spw`` words of the
    window rows tile the destuffed stream, so flat word W lives at
    [W // spw, W % spw] in lane layout), then a per-lane shift aligns bit
    ``bitpos & 31`` to bit 0.  Returns (B2, nw, 8, 128) int32,
    B2 = ceil(n_mcus / 1024); padding lanes replay segment 0.

    Words past the window grid read 0xFFFFFFFF, the bit reader's padding.
    The reference clamps them to the last word instead, which repeats real
    data when the stream exactly fills the grid.
    """
    bs = windows.shape[0]
    n_mcus = bitpos.shape[0]
    b2 = -(-n_mcus // SLOTS)
    seg = torch.zeros(b2 * SLOTS, dtype=torch.int64, device=windows.device)
    seg[:n_mcus] = u32(bitpos)
    sh = (seg & 31).reshape(b2, 1, SUBLANES, LANES)
    w0 = seg >> 5
    last = bs * SLOTS * spw - 1
    word = w0[:, None] + torch.arange(nw + 1, device=windows.device)[None, :]
    past = word > last
    word = torch.clamp(word, max=last)       # (S2, nw+1) flat stream word
    g = word // spw
    w_in = word - g * spw
    flat_idx = ((g // SLOTS) * nws + w_in) * SLOTS + g % SLOTS
    rows = u32(windows.reshape(-1)[flat_idx])
    rows = torch.where(past, 0xFFFFFFFF, rows)
    rows = rows.reshape(b2, SUBLANES, LANES, nw + 1).movedim(-1, 1)  # (b2, nw+1, 8, 128)
    aligned = _shl(rows[:, :nw], sh) | (rows[:, 1:] >> (32 - sh))
    return to_i32(aligned)


def dc_base_from_coefs(
    kernel_out: torch.Tensor,     # (B2, T, 64, 8, 128) int16 K2 output
    t_last: Tuple[int, ...],      # last block step of each scan component
) -> torch.Tensor:
    """Per-pseudo-segment DC predictor bases from the decode itself.

    With one MCU per pseudo segment K2's row form accumulates DC diffs from
    0 inside each segment, so component c's last block step holds the
    segment's total DC diff; the predictor entering segment m is the
    exclusive prefix sum in segment order.  Returns (B2, 8, 128, C) int32
    for apply_dc_base.
    """
    b2 = kernel_out.shape[0]
    cols = []
    for t in t_last:
        tot = kernel_out[:, t, 0].to(torch.int32).reshape(b2 * SLOTS)
        base = torch.cumsum(tot, 0, dtype=torch.int32) - tot     # exclusive
        cols.append(base.reshape(b2, SUBLANES, LANES))
    return torch.stack(cols, dim=-1)


def _check_fused_args(windows, bitpos, n_bits, comp_map, dcslot_map, acslot_map,
                      cbase, counts, symbols, spw):
    if windows.dim() != 4 or tuple(windows.shape[2:]) != (SUBLANES, LANES):
        raise ValueError(f"windows must be (BS, NWS, 8, 128), got {tuple(windows.shape)}")
    if windows.shape[0] < 1 or not 1 <= spw <= windows.shape[1]:
        raise ValueError(f"bad window geometry: {tuple(windows.shape)} with spw {spw}")
    if bitpos.dim() != 1 or bitpos.shape[0] < 1:
        raise ValueError(f"bitpos must be (n_mcus,), n_mcus >= 1, got {tuple(bitpos.shape)}")
    if not 0 <= n_bits < 2**31:
        raise ValueError(f"bad stream length: {n_bits} bits")
    want = {"cbase": (cbase, (8, 16)), "counts": (counts, (8, 17)),
            "symbols": (symbols, (8, SUBLANES, LANES))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if comp_map.dim() != 1 or comp_map.shape[0] < 1 or dcslot_map.shape != comp_map.shape or (
            acslot_map.shape != comp_map.shape):
        raise ValueError("comp_map, dcslot_map and acslot_map must all be (T,), T >= 1")
    args = [windows, bitpos, comp_map, dcslot_map, acslot_map, cbase, counts, symbols]
    for t in args:
        if t.dtype != torch.int32:
            raise TypeError(f"K2 takes int32 tensors, got {t.dtype}")
        if t.device != windows.device:
            raise ValueError(f"decode_mcus_at_bitpos: all inputs must be on {windows.device}")
    return [t.contiguous() for t in args]


def decode_mcus_at_bitpos_reference(
    windows, bitpos, n_bits: int, comp_map, dcslot_map, acslot_map,
    cbase, counts, symbols, *, spw: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2's fused form, on any device: the chain
    the kernel replaces, with the gather done word by word.  Lane m reads the
    stream from bit ``bitpos[m]`` through a :class:`StreamWindow` (the
    windows :func:`gather_entropy_streams` would copy out, looked up as the
    lane needs them, so no index over every word a lane might read is
    built); :func:`decode_segments_reference`'s lockstep decode runs from DC
    0; a lane that consumed more bits than its MCU holds is flagged; the
    exclusive cumulative sums of the lanes' DC totals are added to their DC
    rows.  Lanes past ``n_mcus`` give zeros and no flag."""
    args = _check_fused_args(windows, bitpos, n_bits, comp_map, dcslot_map, acslot_map,
                             cbase, counts, symbols, spw)
    dev = windows.device
    n_mcus = bitpos.shape[0]
    b2 = -(-n_mcus // SLOTS)
    start = torch.zeros(b2 * SLOTS, dtype=torch.int64, device=dev)
    start[:n_mcus] = u32(bitpos)        # padding lanes replay bit 0
    win = StreamWindow(windows, spw, start)
    # No short last segment: every lane holds one whole MCU.
    seg_meta = torch.tensor([[-1, -1, 0]], dtype=torch.int32, device=dev)
    out, err = _decode_lanes(
        win, b2, torch.zeros(b2, dtype=torch.int32, device=dev), *args[2:5], seg_meta,
        cbase[None], counts[None], symbols[None])
    used = win.wp * 32 - win.navail - start
    start = start[:n_mcus]
    end = torch.cat([start[1:], start.new_tensor([n_bits])])
    real = torch.arange(b2 * SLOTS, device=dev) < n_mcus
    err = err.reshape(-1)
    err[:n_mcus] |= torch.where(start + used[:n_mcus] > end, ERR_OVERRUN, 0).to(torch.int32)
    err = torch.where(real, err, 0).reshape(b2, SUBLANES, LANES)
    out = torch.where(real.reshape(b2, 1, 1, SUBLANES, LANES), out, 0)
    cm = (comp_map & 3).tolist()
    t_last = [max((t for t, x in enumerate(cm) if x == c), default=None) for c in range(4)]
    comps = [c for c in range(4) if t_last[c] is not None]
    dcb = torch.zeros((b2, SUBLANES, LANES, 4), dtype=torch.int32, device=dev)
    dcb[..., comps] = dc_base_from_coefs(out, [t_last[c] for c in comps])
    dcb = torch.where(real.reshape(b2, SUBLANES, LANES, 1), dcb, 0)
    return apply_dc_base(out, dcb, comp_map & 3), err


def decode_mcus_at_bitpos(
    windows: torch.Tensor,       # (BS, NWS, 8, 128) int32: the index scan's window rows
    bitpos: torch.Tensor,        # (n_mcus,) int32: the stream bit each MCU starts at
    n_bits: int,                 # real stream bits
    comp_map: torch.Tensor,      # (T,) int32: component of each block step of one MCU
    dcslot_map: torch.Tensor,    # (T,) int32
    acslot_map: torch.Tensor,    # (T,) int32
    cbase: torch.Tensor,         # (8, 16) int32
    counts: torch.Tensor,        # (8, 17) int32
    symbols: torch.Tensor,       # (8, 8, 128) int32
    *,
    spw: int,                    # words of a window row that tile the stream (SB // 4)
    lut: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's fused form, for a stream without restart markers after its index
    scan: lane m decodes MCU m from bit ``bitpos[m]`` of the stream, read
    straight from the scan's window tensor (flat stream word W sits at
    ``[W // spw // 1024, W % spw, (W // spw) % 1024]``; words past the grid
    read 0xFFFFFFFF), and the DC predictor each MCU starts from -- the sum of
    the DC differences of all MCUs before it, per component -- is added on
    the card, wrapping in int16 as :func:`apply_dc_base` does.  ``lut`` is
    :func:`symbol_lut` of the same tables; None builds it in this call.

    Returns (coefs, err): coefs (B, T, 64, 8, 128) int16 with the DC
    predictors applied, B = ceil(n_mcus / 1024), and err (B, 8, 128) int32;
    lanes past ``n_mcus`` hold zeros and no flag.  CPU tensors run the plain
    version; CUDA tensors launch the kernel: two launches, the decode and the
    DC predictors.

    Flags against the chain gather -> row form -> DC bases it replaces: there
    is no row, so no row can be too narrow and no width test exists; a lane
    is instead held to its own MCU's end (``bitpos[m + 1]``, ``n_bits`` for
    the last) and flagged ERR_OVERRUN if it consumed more.  A lane that
    raises no other flag decodes exactly the bits the scan gave its MCU, so
    on a valid stream all flags are 0 on both sides, and on a corrupt one the
    same lanes are flagged with the same coefficients wherever the chain's
    rows held all the bits a lane read; a flagged lane may carry ERR_OVERRUN
    besides.
    """
    args = _check_fused_args(windows, bitpos, n_bits, comp_map, dcslot_map, acslot_map,
                             cbase, counts, symbols, spw)
    dev = windows.device
    if dev.type == "cpu":
        return decode_mcus_at_bitpos_reference(
            windows, bitpos, n_bits, comp_map, dcslot_map, acslot_map,
            cbase, counts, symbols, spw=spw)
    if dev.type != "cuda":
        raise RuntimeError(f"decode_mcus_at_bitpos: no kernel for device {dev}")
    bs, nws = windows.shape[:2]
    n_mcus, nsteps = bitpos.shape[0], comp_map.shape[0]
    b2 = -(-n_mcus // SLOTS)
    lut = symbol_lut(*args[5:]) if lut is None else _check_lut(lut, 1, dev)
    out = torch.empty((b2, nsteps, 64, SUBLANES, LANES), dtype=torch.int16, device=dev)
    err = torch.empty((b2, SUBLANES, LANES), dtype=torch.int32, device=dev)
    # Per-lane DC totals (4, B * 1024), then per-warp sums (4, B * 32).
    scratch = torch.empty(4 * b2 * (SLOTS + SLOTS // 32), dtype=torch.int32, device=dev)
    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jgt_entropy_decode_fused(
            *(t.data_ptr() for t in args), lut.data_ptr(), out.data_ptr(), err.data_ptr(),
            scratch.data_ptr(), scratch[4 * b2 * SLOTS:].data_ptr(),
            bs, nws, spw, int(n_bits), n_mcus, nsteps, stream,
        )
    if rc != 0:
        raise RuntimeError(f"entropy_decode fused kernel launch failed: CUDA error {rc}")
    global launches
    launches += 2
    return out, err


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
    kernel_out: torch.Tensor,       # ([NI,] B, T, 64, 8, 128) int16
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

    A leading image axis (a corpus bucket: ``kernel_out`` of shape (NI, B,
    ...), each image's B segment batches in a row) carries through every
    step, and each result gains it in front: one call for the bucket, equal
    image by image to a call per image.
    """
    *lead, b, t = kernel_out.shape[:-3]
    nseg_slots = b * SLOTS
    bpm = sum(hs * vs for hs, vs in comp_geometry)
    assert t == mcus_per_segment * bpm
    out = []
    if soa and mcus_per_segment == 1 and not force_general:
        # Slot (b, s, l) holds exactly MCU b*1024 + s*128 + l, and block
        # step t is the block-in-MCU index.
        assert n_segments == n_mcus
        x = kernel_out.reshape(*lead, b, bpm, 64, SLOTS).movedim(-4, -2)
        x = x.reshape(*lead, bpm, 64, nseg_slots)[..., :n_mcus]
        off = 0
        for hs, vs in comp_geometry:
            nb = hs * vs
            out.append(x[..., off:off + nb, :, :].reshape(*lead, vs, hs, 64, nvmb, nhmb)
                       .contiguous())
            off += nb
    else:
        x = kernel_out.reshape(*lead, b, t, 64, SLOTS).movedim(-1, -3)
        x = x.reshape(*lead, nseg_slots, t, 64)[..., :n_segments, :, :]
        # (nseg, R, bpm, 64) -> (nseg*R MCUs, bpm, 64), drop padding MCUs.
        x = x.reshape(*lead, n_segments * mcus_per_segment, bpm, 64)[..., :n_mcus, :, :]
        off = 0
        for hs, vs in comp_geometry:
            nb = hs * vs
            yc = x[..., off:off + nb, :].reshape(*lead, nvmb, nhmb, vs, hs, 64)
            off += nb
            if soa:
                # Block (vs*i + pr, hs*k + pc) is MCU (i, k) sub-block (pr, pc).
                out.append(yc.movedim((-5, -4), (-2, -1)).contiguous())
            else:
                yc = yc.transpose(-4, -3)                   # (nvmb, vs, nhmb, hs, 64)
                out.append(yc.reshape(*lead, nvmb * vs, nhmb * hs, 8, 8).contiguous())
    if frame_order is not None:
        out = scan_to_frame_order(out, frame_order)
    return tuple(out)


def plan_tensors(arrays, device) -> Tuple[torch.Tensor, ...]:
    """numpy plan arrays -> int32 tensors on ``device``, as copies (the
    read-only cached table arrays never alias a tensor).  For a CUDA device
    the arrays are packed into one pinned buffer and go up in one copy on the
    current stream; the tensors are views of that one upload, each aligned to
    16 bytes."""
    arrays = [np.asarray(a, dtype=np.int32) for a in arrays]
    device = torch.device(device)
    if device.type != "cuda":
        return tuple(torch.tensor(a, device=device) for a in arrays)
    starts, total = [], 0
    for a in arrays:
        starts.append(total)
        total += -(-a.size // 4) * 4
    host = torch.empty(total, dtype=torch.int32, pin_memory=True)
    view = host.numpy()
    for a, at in zip(arrays, starts):
        view[at: at + a.size] = a.reshape(-1)
    # The pinned block returns to torch's host cache only after the copy.
    dev = torch.empty(total, dtype=torch.int32, device=device).copy_(host, non_blocking=True)
    return tuple(dev[at: at + a.size].reshape(a.shape) for a, at in zip(arrays, starts))
