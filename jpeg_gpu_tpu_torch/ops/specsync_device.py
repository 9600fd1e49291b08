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
:func:`gather_entropy_streams` (bit-aligned per-MCU streams) and
:func:`dc_base_from_coefs`, the plain torch ops the JAX package leaves to
XLA, live in ``ops/entropy_device.py`` beside K2's fused form, which does
their work on the card; the names stay importable from here.  The symbol
tables can be built once per table set (:func:`build_scan_lut`) and handed to
every scan with those tables.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from jpeg_gpu_tpu_torch.ops.entropy_device import (  # noqa: F401  (names kept for callers)
    LANES,
    LUT_BITS,
    LUT_IMAGE,
    LUT_MISS,
    LUT_SUB,
    LUT_WORDS,
    SLOTS,
    SUB_BITS,
    SUB_TABLES,
    SUBLANES,
    BitWindow,
    _Tables,
    _rank,
    _shl,
    dc_base_from_coefs,
    decode_symbol,
    gather_entropy_streams,
    lut_complete,
    lut_lookup,
    lut_reference,
    lut_views,
    to_i32,
    u32,
)

# Kernel launches since the last reset (set to 0 to start counting): one per
# call that reaches the card, whole scan or single round (the cooperative
# kernel that scans), and one per build of the symbol tables -- inside a call
# that was not given them, or by :func:`build_scan_lut`.
launches = 0


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
    """Plain PyTorch version of K3's symbol tables: the two-level tables of
    :func:`entropy_device.lut_reference` with :func:`chain_entry` entries,
    (8, 8, LUT_WORDS) int32."""
    return lut_reference(cbase, counts, symbols, chain_entry)


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
        lib.jgt_specsync_index_scan.argtypes = [ptr] * 13 + [i32] * 10 + [ptr]
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


def build_scan_lut(cbase, counts, symbols) -> torch.Tensor:
    """K3's symbol tables as the kernel builds them on the card: (LUT_IMAGE,)
    int16, what :func:`device_index_scan` takes as ``lut`` (:func:`scan_lut`
    unpacks it).  Build once per table set.  CUDA tensors only."""
    dev = cbase.device
    if dev.type != "cuda":
        raise RuntimeError(f"build_scan_lut: no kernel for device {dev}")
    lut = torch.empty(LUT_IMAGE, dtype=torch.int16, device=dev)
    lib = _kernel()
    with torch.cuda.device(dev):
        rc = lib.jgt_specsync_lut(
            cbase.contiguous().data_ptr(), counts.contiguous().data_ptr(),
            symbols.contiguous().data_ptr(), lut.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"specsync_scan table kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return lut


def scan_lut(cbase, counts, symbols):
    """:func:`build_scan_lut`, unpacked: (tables, complete), the tables
    widened to (8, 8, LUT_WORDS) int32 as :func:`scan_lut_reference` gives
    them, and the kernel's flags as :func:`lut_complete` gives them."""
    tables, complete = lut_views(build_scan_lut(cbase, counts, symbols))
    return tables[0], complete[0]


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
    lut=None,
):
    """One scan round: the exit state, plus records and their counts when
    ``record``.  CPU tensors run the plain version; CUDA tensors launch K3
    (``lut``: :func:`build_scan_lut` of the tables, None builds them here)."""
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
    work, rec, _ = _launch_scan(args, nbits, sb=sb, maxrec=maxrec, entry=entry, lut=lut)
    exit_state = work[4 * n: 8 * n].reshape(bs, 4, SUBLANES, LANES)
    if not record:
        return (exit_state,)
    return exit_state, rec, work[12 * n: 13 * n].reshape(bs, 1, SUBLANES, LANES)


def _launch_scan(args, nbits, *, sb, maxrec, n_mcus=0, max_rounds=0, entry=None,
                 outputs=(None, None, None), lut=None):
    """Enqueue K3 on the checked CUDA inputs ``args``: the whole scan into
    ``outputs`` (bitpos, ok, stats), or with ``entry`` one round from those
    entry states.  ``lut`` is :func:`build_scan_lut` of the same tables;
    None builds them in this call.  Never waits for the card.  Returns the
    kernel's scratch:
    ``work`` (int32: entries, then two exit buffers of (BS, 4, 8, 128) each,
    then the record counts (BS, 8, 128)), the records (BS, maxrec, 8, 128)
    and the lanes that decoded in each pass (max_rounds + 1,)."""
    windows = args[0]
    dev = windows.device
    bs, nws = windows.shape[0], windows.shape[1]
    lib = _kernel()
    i32 = dict(dtype=torch.int32, device=dev)
    given = lut is not None
    if given and (lut.dtype != torch.int16 or lut.numel() != LUT_IMAGE or lut.device != dev):
        raise ValueError(f"lut must be build_scan_lut's ({LUT_IMAGE},) int16 on {dev}")
    lut = lut.contiguous() if given else torch.empty(LUT_IMAGE, dtype=torch.int16, device=dev)
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
            int(entry is not None), int(given), stream,
        )
    if rc != 0:
        raise RuntimeError(f"specsync_scan kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1 if given else 2
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
    lut=None,
):
    """Parallel index scan: converged per-MCU bit offsets, on the device.

    CUDA tensors go through K3 in one call that never waits for the card;
    CPU tensors, and any tensors with ``plain=True`` (to hold K3 against it
    on the card), run the plain version round by round.  ``lut`` is
    :func:`build_scan_lut` of the same tables, kept by a caller that scans
    with them again; None builds the symbol tables in this call.

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
                                 maxrec=maxrec, n_mcus=n_mcus, max_rounds=max_rounds,
                                 lut=lut)[:3]
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
    *, sb: int, maxrec: int, n_mcus: int, max_rounds: int = 16, lut=None,
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
                               max_rounds=max_rounds, outputs=(bitpos, ok, stats), lut=lut)[2]
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
