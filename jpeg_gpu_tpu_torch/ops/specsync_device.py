"""K3: the speculative self-synchronising index scan, and its glue.

The port of ``jpeg_gpu_tpu/ops/specsync_device.py``.  For a stream without
restart markers the destuffed stream is cut into subsequences of SB bytes,
one per lane slot ``b*1024 + s*128 + l``.  A Jacobi fixed-point iteration
on the lanes' entry states (bit position, block phase c, at_dc, zig-zag k)
runs one scan round per iteration: each lane decodes code lengths from its
entry to its first token boundary past its end, and lane s+1's next entry
is lane s's exit.  Lane 0 is pinned to the true scan start, so at the fixed
point the chain is the serial decode; every MCU start a lane met on the way
is a record, and the exclusive prefix sum of the record counts gives each
record its MCU index.

On a CUDA tensor :func:`device_index_scan` is one call into the hand-written
kernel ``csrc/specsync_scan.cu``: the rounds, the shift of exit states, the
convergence test and the stitch all run on the device in one cooperative
launch, with no host sync; a lane decodes only when its entry changed and
records whenever it decodes, so there is no separate record pass; the step
reads its window rows and two levels of symbol tables from shared memory.
On a CPU tensor, and with ``plain=True`` on any device, it runs the plain
PyTorch version: :func:`scan_round_reference` for every lane in every round
(all lanes in lockstep, stopping once no lane is active), a record pass from
the final entries, and the stitch as a cumsum and a scatter.
:func:`device_index_scan_lazy_reference` is the kernel's scheme in plain
PyTorch, and :func:`scan_lut_reference` with :func:`lut_lookup` its symbol
tables; the tests hold them to the plain version.  :func:`scan_round` runs
one round (the same kernel, stopped after its first pass, on a CUDA tensor).
:func:`gather_entropy_streams` (bit-aligned per-MCU streams for K2) and
:func:`dc_base_from_coefs` are plain torch ops, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from jpeg_gpu_tpu_torch.ops.entropy_device import (
    LANES,
    SLOTS,
    SUBLANES,
    BitWindow,
    _Tables,
    _shl,
    decode_symbol,
    to_i32,
    u32,
)

# Kernel launches since the last reset (set to 0 to start counting): two per
# call that reaches the card, whole scan or single round -- the kernel that
# builds the symbol tables and the cooperative kernel that scans.
launches = 0

# K3's symbol tables, per (sublane, slot): a first level indexed by the
# window's top LUT_BITS bits, then SUB_TABLES second-level tables indexed by
# the SUB_BITS bits after them.  An entry is a chain entry, LUT_SUB | the
# byte offset of a second-level table among the slot's 16-bit entries (in the
# first level: look there) or LUT_MISS (use decode_symbol).
LUT_BITS = 10
SUB_BITS = 6
SUB_TABLES = 16
LUT_WORDS = (1 << LUT_BITS) + SUB_TABLES * (1 << SUB_BITS)
LUT_MISS = 0
LUT_SUB = 0x8000


def scan_round_reference(
    windows, entry, nbits: int, dcslot, acslot, cbase, counts, symbols,
    *, sb: int, maxrec: int, record: bool,
):
    """Plain PyTorch version of K3 (one round), on any device.

    Returns the exit state (BS, 4, 8, 128) int32, plus, when ``record``,
    the MCU-start records (BS, maxrec, 8, 128) and their counts
    (BS, 1, 8, 128), as the kernel does.
    """
    dev = windows.device
    bs, nws = windows.shape[0], windows.shape[1]
    n = bs * SLOTS
    bpm = dcslot.shape[0]
    rows = u32(windows.reshape(bs, nws, SLOTS).permute(0, 2, 1).reshape(n, nws))
    ent = entry.reshape(bs, 4, SLOTS).permute(1, 0, 2).reshape(4, n).to(torch.int64)
    p, c, at_dc, k = ent[0], ent[1], ent[2], ent[3]
    sb_bits = sb * 8
    lane = torch.arange(n, device=dev)
    end = torch.clamp(nbits - lane * sb_bits, max=sb_bits)
    sub = (lane % SLOTS) // LANES
    tab = _Tables(cbase, counts, symbols)
    # Slot of each block phase, DC and AC; a phase outside [0, bpm) reads
    # slot 0 as the reference's masked select does.
    phase_dc = torch.cat([dcslot.to(torch.int64), dcslot.new_zeros(1, dtype=torch.int64)])
    phase_ac = torch.cat([acslot.to(torch.int64), acslot.new_zeros(1, dtype=torch.int64)])

    # The 64-bit window at each lane's entry bit p.
    win = BitWindow(rows, None, None, None, None)
    wp0 = (p & 0xFFFFFFFF) >> 5
    sh = p & 31
    w0, w1 = win.fetch(wp0), win.fetch(wp0 + 1)
    win.hi = _shl(w0, sh) | (w1 >> (32 - sh))
    win.lo = _shl(w1, sh)
    win.navail = 64 - sh
    win.wp = wp0 + 2

    recn = torch.zeros(n, dtype=torch.int64, device=dev)
    rec = torch.zeros((maxrec if record else 0, n), dtype=torch.int64, device=dev)
    rec_row = torch.arange(rec.shape[0], device=dev)[:, None]
    for it in range(sb_bits + 2):
        act = p < end
        if it % 16 == 0 and not bool(act.any()):
            break
        if record:
            # Record j of a lane is its j-th MCU start; the count runs on
            # past maxrec so that the caller can see the overflow.
            is_mcu = act & (at_dc > 0) & (c == 0)
            rec = torch.where(is_mcu[None] & (rec_row == recn[None]), p[None], rec)
            recn = recn + is_mcu.to(torch.int64)
        win.refill()
        phase = torch.where((c >= 0) & (c < bpm), c, bpm)
        slot = torch.where(at_dc > 0, phase_dc[phase], phase_ac[phase])
        sym, ln = decode_symbol(
            win.hi, tab.cbase[slot], tab.counts[slot], tab.symbols[slot, sub],
            tab.limit[slot],
        )
        invalid = ln > 16
        sym = torch.where(invalid, 0, sym)
        ln = torch.where(invalid, 17, ln)
        dc_size = torch.clamp(sym, max=15)
        newk = k + (sym >> 4) + 1
        blk_end = (at_dc == 0) & ((sym == 0) | (newk >= 63))
        consume = torch.where(at_dc > 0, ln + dc_size, ln + (sym & 15))
        consume = torch.where(act, consume, 0)
        win.consume(consume)
        p = p + consume
        k = torch.where(act & (at_dc > 0), 0, torch.where(act, torch.clamp(newk, max=63), k))
        newc = torch.where(blk_end, c + 1, c)
        newc = torch.where(newc == bpm, 0, newc)
        c = torch.where(act, newc, c)
        at_dc = torch.where(act, torch.where(at_dc > 0, 0, blk_end.to(torch.int64)), at_dc)

    def lanes_to_grid(x, rows_):
        return x.reshape(rows_, bs, SLOTS).permute(1, 0, 2).reshape(
            bs, rows_, SUBLANES, LANES).to(torch.int32)

    exit_state = lanes_to_grid(torch.stack([p, c, at_dc, k]), 4)
    if not record:
        return (exit_state,)
    return exit_state, lanes_to_grid(rec, maxrec), lanes_to_grid(recn[None], 1)


def _rank(hi, cbase, counts):
    """The canonical rank decode_symbol looks its entry up with."""
    top = hi.unsqueeze(-1) >> (32 - torch.arange(1, 17, device=hi.device))
    return torch.minimum(torch.clamp(top - cbase, min=0), counts[..., :16]).sum(-1)


def chain_entry(sym, ln):
    """What K3's step needs of a decoded symbol, in 15 bits: an invalid code
    (length above 16) counts as EOB with 17 bits; then bits 0-4 = the bits
    an AC symbol consumes (length + low nibble), bits 5-9 = the bits a DC
    symbol consumes (length + min(symbol, 15)), bits 10-13 = the zero run
    (high nibble), bit 14 = the symbol is 0 (EOB).  Never 0, the tables'
    miss marker."""
    invalid = ln > 16
    sym = torch.where(invalid, 0, sym)
    ln = torch.where(invalid, 17, ln)
    return ((ln + (sym & 15)) | ((ln + torch.clamp(sym, max=15)) << 5) | ((sym >> 4) << 10)
            | ((sym == 0).to(torch.int64) << 14))


def scan_lut_reference(cbase, counts, symbols) -> torch.Tensor:
    """Plain PyTorch version of K3's symbol tables.

    Returns (8, 8, LUT_WORDS) int32 holding 16-bit entries, ``[sublane,
    slot, entry]``.  The first 2**LUT_BITS entries, one per prefix of
    LUT_BITS bits: the :func:`chain_entry` of what :func:`decode_symbol`
    gives where every window with that prefix decodes alike; else ``LUT_SUB
    |`` the byte offset of the j-th second-level table, where this is the
    j-th such prefix in rising order; else (more than SUB_TABLES of them)
    ``LUT_MISS``.  Then the second-level tables, one entry per prefix of
    LUT_BITS + SUB_BITS bits under the table's own prefix: the chain entry,
    or ``LUT_MISS``.  The rank and the invalid test are both monotone in the
    window, so "alike" is decided at the two ends of a prefix's range,
    whatever the tables hold.
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
            alike, chain_entry(*decode_symbol(lo, cb, cn, entries, limit)), LUT_MISS)

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
    """K3's lookup in plain PyTorch: the chain entries of the windows ``hi``
    (..., N) in their tables ``lut`` (..., LUT_WORDS), or LUT_MISS where K3
    calls decode_symbol."""
    lut = lut.to(torch.int64)
    e = torch.gather(lut, -1, hi >> (32 - LUT_BITS))
    deep = (e & LUT_SUB) != 0
    at = ((e & (LUT_SUB - 1)) >> 1) + ((hi >> 16) & ((1 << SUB_BITS) - 1))
    return torch.where(deep, torch.gather(lut, -1, torch.where(deep, at, 0)), e)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from jpeg_gpu_tpu_torch import cuda_build

        lib = cuda_build.load("specsync_scan")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.jgt_specsync_lut.restype = ctypes.c_int
        lib.jgt_specsync_lut.argtypes = [ptr] * 5
        lib.jgt_specsync_work_words.restype = ctypes.c_longlong
        lib.jgt_specsync_work_words.argtypes = [i32]
        lib.jgt_specsync_index_scan.restype = ctypes.c_int
        lib.jgt_specsync_index_scan.argtypes = [ptr] * 13 + [i32] * 9 + [ptr]
        _lib = lib
    return _lib


def _check_scan_args(windows, nbits, dcslot, acslot, cbase, counts, symbols, sb, maxrec):
    """Shapes, types and devices of a scan's inputs; returns them contiguous."""
    if windows.dim() != 4 or tuple(windows.shape[2:]) != (SUBLANES, LANES):
        raise ValueError(f"windows must be (BS, NWS, 8, 128), got {tuple(windows.shape)}")
    if windows.shape[0] < 1 or windows.shape[1] < 1:
        raise ValueError(f"empty windows {tuple(windows.shape)}")
    want = {"cbase": (cbase, (8, 16)), "counts": (counts, (8, 17)),
            "symbols": (symbols, (8, SUBLANES, LANES))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if dcslot.dim() != 1 or dcslot.shape[0] < 1 or acslot.shape != dcslot.shape:
        raise ValueError("dcslot and acslot must both be (bpm,), bpm >= 1")
    if not 0 <= nbits < 2**31 or sb < 1 or maxrec < 0:
        raise ValueError(f"bad scan geometry: nbits {nbits}, sb {sb}, maxrec {maxrec}")
    if windows.device.type == "cuda":
        # A step reads the word of its bit and the next one.
        if windows.shape[1] < ((sb * 8 - 1) >> 5) + 2:
            raise ValueError(
                f"K3 takes window rows of the subsequence's words and one more: "
                f"{windows.shape[1]} words for {sb} bytes")
    args = [windows, dcslot, acslot, cbase, counts, symbols]
    for t in args:
        if t.dtype != torch.int32:
            raise TypeError(f"K3 takes int32 tensors, got {t.dtype}")
        if t.device != windows.device:
            raise ValueError(f"K3: all inputs must be on {windows.device}")
    return [t.contiguous() for t in args]


def lut_complete(lut) -> torch.Tensor:
    """(8, 8) bool: the tables of that (sublane, slot) answer every window,
    so K3 runs its step without the call of decode_symbol: no LUT_MISS in
    the first level nor in a second-level table the first level points to."""
    lut = lut.to(torch.int64)
    n, nsub = 1 << LUT_BITS, 1 << SUB_BITS
    first, second = lut[..., :n], lut[..., n:].reshape(*lut.shape[:-1], SUB_TABLES, nsub)
    used = ((first & LUT_SUB) != 0).sum(-1)                   # tables 0..used-1
    holes = (second == LUT_MISS) & (torch.arange(SUB_TABLES, device=lut.device)[:, None]
                                    < used[..., None, None])
    return ~((first == LUT_MISS).any(-1) | holes.any(-1).any(-1))


def _lut_scratch(dev) -> torch.Tensor:
    """Room for the kernel's tables: (8, 8, LUT_WORDS) 16-bit entries, then
    one flag per (sublane, slot)."""
    return torch.empty(SUBLANES * 8 * (LUT_WORDS + 1), dtype=torch.int16, device=dev)


def scan_lut(cbase, counts, symbols):
    """K3's symbol tables as the kernel builds them on the card: (tables,
    complete), the tables widened to (8, 8, LUT_WORDS) int32 as
    :func:`scan_lut_reference` gives them, and the kernel's flags as
    :func:`lut_complete` gives them.  CUDA tensors only."""
    if cbase.device.type != "cuda":
        raise RuntimeError(f"scan_lut: no kernel for device {cbase.device}")
    lut = _lut_scratch(cbase.device)
    lib = _kernel()
    with torch.cuda.device(cbase.device):
        rc = lib.jgt_specsync_lut(
            cbase.contiguous().data_ptr(), counts.contiguous().data_ptr(),
            symbols.contiguous().data_ptr(), lut.data_ptr(),
            torch.cuda.current_stream(cbase.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"specsync_scan table kernel launch failed: CUDA error {rc}")
    tables = lut[: SUBLANES * 8 * LUT_WORDS].reshape(SUBLANES, 8, LUT_WORDS)
    return tables.to(torch.int32) & 0xFFFF, lut[SUBLANES * 8 * LUT_WORDS:].reshape(SUBLANES, 8) != 0


def scan_round(
    windows: torch.Tensor,   # (BS, NWS, 8, 128) int32
    entry: torch.Tensor,     # (BS, 4, 8, 128) int32
    nbits: int,              # real stream bits
    dcslot: torch.Tensor,    # (bpm,) int32
    acslot: torch.Tensor,    # (bpm,) int32
    cbase: torch.Tensor,     # (8, 16) int32
    counts: torch.Tensor,    # (8, 17) int32
    symbols: torch.Tensor,   # (8, 8, 128) int32
    *,
    sb: int,
    maxrec: int,
    record: bool,
):
    """One scan round: the exit state, plus records and their counts when
    ``record``.  CPU tensors run the plain version; CUDA tensors launch K3."""
    bs = windows.shape[0]
    if record and maxrec < 1:
        raise ValueError(f"bad scan geometry: maxrec {maxrec} with record")
    args = _check_scan_args(windows, nbits, dcslot, acslot, cbase, counts, symbols, sb, maxrec)
    if tuple(entry.shape) != (bs, 4, SUBLANES, LANES):
        raise ValueError(f"entry must be {(bs, 4, SUBLANES, LANES)}, got {tuple(entry.shape)}")
    if entry.dtype != torch.int32:
        raise TypeError(f"K3 takes int32 tensors, got {entry.dtype}")
    dev = windows.device
    if dev.type == "cpu":
        return scan_round_reference(
            windows, entry, nbits, dcslot, acslot, cbase, counts, symbols,
            sb=sb, maxrec=maxrec, record=record,
        )
    if dev.type != "cuda":
        raise RuntimeError(f"scan_round: no kernel for device {dev}")
    if entry.device != dev:
        raise ValueError(f"scan_round: all inputs must be on {dev}")
    n = bs * SLOTS
    work, rec, _ = _launch_scan(args, nbits, sb=sb, maxrec=maxrec, entry=entry)
    exit_state = work[4 * n: 8 * n].reshape(bs, 4, SUBLANES, LANES)
    if not record:
        return (exit_state,)
    return exit_state, rec, work[12 * n: 13 * n].reshape(bs, 1, SUBLANES, LANES)


def _launch_scan(args, nbits, *, sb, maxrec, n_mcus=0, max_rounds=0, entry=None,
                 outputs=(None, None, None)):
    """Enqueue K3 on the checked CUDA inputs ``args``: the whole scan into
    ``outputs`` (bitpos, ok, stats), or with ``entry`` one round from those
    entry states.  Never waits for the card.  Returns the kernel's scratch:
    ``work`` (int32: entries, then two exit buffers of (BS, 4, 8, 128) each,
    then the record counts (BS, 8, 128)), the records (BS, maxrec, 8, 128)
    and the lanes that decoded in each pass (max_rounds + 1,)."""
    windows = args[0]
    dev = windows.device
    bs, nws = windows.shape[0], windows.shape[1]
    lib = _kernel()
    i32 = dict(dtype=torch.int32, device=dev)
    lut = _lut_scratch(dev)
    work = torch.empty(lib.jgt_specsync_work_words(bs), **i32)
    round_lanes = torch.zeros(max_rounds + 1, **i32)   # the kernel counts from 0
    if entry is None:
        rec = torch.empty((bs, maxrec, SUBLANES, LANES), **i32)
    else:
        # One round hands the records out: unused places read 0.
        rec = torch.zeros((bs, maxrec, SUBLANES, LANES), **i32)
        work[: 4 * bs * SLOTS] = entry.reshape(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jgt_specsync_index_scan(
            *(t.data_ptr() for t in args), lut.data_ptr(), work.data_ptr(), rec.data_ptr(),
            round_lanes.data_ptr(), *(None if t is None else t.data_ptr() for t in outputs),
            bs, nws, int(nbits), sb, args[1].shape[0], maxrec, n_mcus, max_rounds,
            int(entry is not None), stream,
        )
    if rc != 0:
        raise RuntimeError(f"specsync_scan kernel launch failed: CUDA error {rc}")
    global launches
    launches += 2
    return work, rec, round_lanes


def _start_entry(bs: int, dev) -> torch.Tensor:
    """The scan's start state (p 0, c 0, at_dc 1, k 0) for every lane."""
    entry = torch.zeros((bs, 4, SUBLANES, LANES), dtype=torch.int32, device=dev)
    entry[:, 2] = 1
    return entry


def _pin_and_shift(exit_state, nbits: int, sb_bits: int):
    """Exit states -> the next round's entries: normalise dead k at DC
    boundaries, shift by one lane in global (b, s, l) order, re-base p to
    the next lane's window, pin lane 0.  Lanes at or past the stream end
    never decode; their entries stay pinned to the start state too, so the
    shift chain does not ripple the tail lane's exit through the padding
    lanes one per round."""
    bs = exit_state.shape[0]
    n_slots = bs * SLOTS
    dev = exit_state.device
    live = (torch.arange(n_slots, device=dev) * sb_bits < nbits)[None, :]
    pin_col = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    pin_col[2] = 1
    p, c, at_dc, k = (exit_state[:, i] for i in range(4))
    k = torch.where(at_dc > 0, 0, k)
    p = p - sb_bits
    flat = torch.stack([x.reshape(n_slots) for x in (p, c, at_dc, k)])  # (4, S)
    shifted = torch.cat([pin_col, flat[:, :-1]], dim=1)
    shifted = torch.where(live, shifted, pin_col)
    return shifted.reshape(4, bs, SUBLANES, LANES).permute(1, 0, 2, 3).contiguous()


def _stitch(rec, recn, rounds: int, converged: bool, *, sb: int, maxrec: int, n_mcus: int):
    """Records and counts of the final entries -> (bitpos, ok, stats): the
    exclusive cumsum of the per-lane counts gives each record's global MCU
    index; one scatter places the bit positions."""
    dev = rec.device
    bs = rec.shape[0]
    n_slots = bs * SLOTS
    recn_flat = recn.reshape(n_slots).to(torch.int64)
    first = torch.cumsum(recn_flat, 0) - recn_flat
    total = recn_flat.sum()
    overflow = (recn_flat > maxrec).any()
    lane_base = (torch.arange(n_slots, device=dev, dtype=torch.int64) * (sb * 8)).reshape(
        bs, 1, SUBLANES, LANES)
    j = torch.arange(maxrec, device=dev, dtype=torch.int64)[None, :, None, None]
    gidx = first.reshape(bs, 1, SUBLANES, LANES) + j              # (BS, maxrec, 8, 128)
    valid = j < recn.reshape(bs, 1, SUBLANES, LANES)
    gidx = torch.where(valid, torch.clamp(gidx, max=n_mcus), n_mcus)  # dump slot n_mcus
    abs_pos = rec.to(torch.int64) + lane_base
    bitpos = torch.zeros(n_mcus + 1, dtype=torch.int64, device=dev)
    bitpos.scatter_(0, gidx.reshape(-1), abs_pos.reshape(-1))
    ok = (~overflow) & (total >= n_mcus) & converged
    stats = torch.stack([
        torch.full((), rounds, dtype=torch.int64, device=dev), total,
        overflow.to(torch.int64),
    ]).to(torch.int32)
    return to_i32(bitpos[:n_mcus] & 0xFFFFFFFF), ok, stats


def device_index_scan(
    windows: torch.Tensor,   # (BS, NWS, 8, 128) int32 per-lane word windows
    nbits: int,              # real stream bits
    dcslot: torch.Tensor,    # (bpm,) int32
    acslot: torch.Tensor,    # (bpm,) int32
    cbase: torch.Tensor,     # (8, 16) int32
    counts: torch.Tensor,    # (8, 17) int32
    symbols: torch.Tensor,   # (8, 8, 128) int32
    *,
    sb: int,
    maxrec: int,
    n_mcus: int,
    max_rounds: int = 16,
    plain: bool = False,
):
    """Parallel index scan: converged per-MCU bit offsets, on the device.

    CUDA tensors go through K3 in one call that never waits for the card;
    CPU tensors, and any tensors with ``plain=True`` (to hold K3 against it
    on the card), run the plain version round by round.

    Returns (bitpos, ok, stats) as tensors on the windows' device:
      bitpos (n_mcus,) int32 -- destuffed-stream bit offset of each MCU
        (garbage unless ok);
      ok () bool -- converged AND no record overflow AND at least n_mcus
        records (the caller falls back to the serial scan when False);
      stats (3,) int32 -- (rounds, total_records, overflowed).
    """
    dev = windows.device
    if not plain and dev.type != "cpu":
        return index_scan_kernel(windows, nbits, dcslot, acslot, cbase, counts, symbols, sb=sb,
                                 maxrec=maxrec, n_mcus=n_mcus, max_rounds=max_rounds)[:3]
    if maxrec < 1 or n_mcus < 1 or max_rounds < 0:
        raise ValueError(
            f"bad scan geometry: maxrec {maxrec}, n_mcus {n_mcus}, max_rounds {max_rounds}")
    _check_scan_args(windows, nbits, dcslot, acslot, cbase, counts, symbols, sb, maxrec)
    sb_bits = sb * 8
    tables = (dcslot, acslot, cbase, counts, symbols)
    entry = _start_entry(windows.shape[0], dev)
    rounds, changed = 0, True
    while changed and rounds < max_rounds:
        exit_state = scan_round_reference(windows, entry, nbits, *tables,
                                          sb=sb, maxrec=maxrec, record=False)[0]
        new_entry = _pin_and_shift(exit_state, nbits, sb_bits)
        changed = bool((new_entry != entry).any())
        entry = new_entry
        rounds += 1
    # Record pass from the final entries.
    _, rec, recn = scan_round_reference(windows, entry, nbits, *tables,
                                        sb=sb, maxrec=maxrec, record=True)
    return _stitch(rec, recn, rounds, not changed, sb=sb, maxrec=maxrec, n_mcus=n_mcus)


def index_scan_kernel(
    windows, nbits: int, dcslot, acslot, cbase, counts, symbols,
    *, sb: int, maxrec: int, n_mcus: int, max_rounds: int = 16,
):
    """K3's whole scan on CUDA tensors: (bitpos, ok, stats, round_lanes), the
    first three as :func:`device_index_scan` gives them and ``round_lanes``
    (max_rounds + 1,) int32 on the device, the lanes that decoded in each
    pass, pass 0 first (diagnostics)."""
    dev = windows.device
    if dev.type != "cuda":
        raise RuntimeError(f"device_index_scan: no kernel for device {dev}")
    if maxrec < 1 or n_mcus < 1 or max_rounds < 0:
        raise ValueError(
            f"bad scan geometry: maxrec {maxrec}, n_mcus {n_mcus}, max_rounds {max_rounds}")
    args = _check_scan_args(windows, nbits, dcslot, acslot, cbase, counts, symbols, sb, maxrec)
    bitpos = torch.empty(n_mcus, dtype=torch.int32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    stats = torch.empty(3, dtype=torch.int32, device=dev)
    round_lanes = _launch_scan(args, nbits, sb=sb, maxrec=maxrec, n_mcus=n_mcus,
                               max_rounds=max_rounds, outputs=(bitpos, ok, stats))[2]
    return bitpos, ok, stats, round_lanes


def device_index_scan_lazy_reference(
    windows, nbits: int, dcslot, acslot, cbase, counts, symbols,
    *, sb: int, maxrec: int, n_mcus: int, max_rounds: int = 16,
):
    """K3's scheme in plain PyTorch: a lane decodes only in the passes in
    which its entry changed, records whenever it decodes, and keeps its exit
    state and records otherwise; no record pass follows.

    Returns (bitpos, ok, stats, round_lanes, rec, recn): the first three as
    :func:`device_index_scan` gives them, ``round_lanes`` the list of lanes
    that decoded in each pass (pass 0: every lane that holds stream), and
    the records (BS, maxrec, 8, 128) and counts (BS, 1, 8, 128) each lane
    holds at the end.
    """
    sb_bits = sb * 8
    bs = windows.shape[0]
    tables = (dcslot, acslot, cbase, counts, symbols)
    entry = _start_entry(bs, windows.device)
    exit_state, rec, recn = scan_round_reference(
        windows, entry, nbits, *tables, sb=sb, maxrec=maxrec, record=True)
    round_lanes = [min(bs * SLOTS, -(-nbits // sb_bits))]
    rounds, converged = max_rounds, False
    for r in range(1, max_rounds + 1):
        new_entry = _pin_and_shift(exit_state, nbits, sb_bits)
        changed = (new_entry != entry).any(dim=1, keepdim=True)    # (BS, 1, 8, 128)
        round_lanes.append(int(changed.sum()))
        if round_lanes[-1] == 0:
            rounds, converged = r, True
            break
        entry = new_entry
        decoded = scan_round_reference(
            windows, entry, nbits, *tables, sb=sb, maxrec=maxrec, record=True)
        exit_state, rec, recn = (
            torch.where(changed, new, old) for new, old in zip(decoded, (exit_state, rec, recn)))
    out = _stitch(rec, recn, rounds, converged, sb=sb, maxrec=maxrec, n_mcus=n_mcus)
    return (*out, round_lanes, rec, recn)


def gather_entropy_streams(
    windows: torch.Tensor,   # (BS, NWS, 8, 128) int32
    bitpos: torch.Tensor,    # (n_mcus,) int32
    *,
    nw: int,
    spw: int,                # non-overlapping words per window row (SB // 4)
    nws: int,                # words per window row (spw + overlap)
) -> torch.Tensor:
    """Bit-aligned per-MCU streams for K2, built on the device.

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

    With one MCU per pseudo segment K2 accumulates DC diffs from 0 inside
    each segment, so component c's last block step holds the segment's
    total DC diff; the predictor entering segment m is the exclusive prefix
    sum in segment order.  Returns (B2, 8, 128, C) int32 for apply_dc_base.
    """
    b2 = kernel_out.shape[0]
    cols = []
    for t in t_last:
        tot = kernel_out[:, t, 0].to(torch.int32).reshape(b2 * SLOTS)
        base = torch.cumsum(tot, 0, dtype=torch.int32) - tot     # exclusive
        cols.append(base.reshape(b2, SUBLANES, LANES))
    return torch.stack(cols, dim=-1)
