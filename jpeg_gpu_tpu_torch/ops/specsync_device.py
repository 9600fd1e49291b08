"""K3: the speculative self-synchronising index scan, and its glue.

The port of ``jpeg_gpu_tpu/ops/specsync_device.py``.  For a stream without
restart markers the destuffed stream is cut into subsequences of SB bytes,
one per lane slot ``b*1024 + s*128 + l``.  A Jacobi fixed-point iteration
on the lanes' entry states (bit position, block phase c, at_dc, zig-zag k)
runs one scan round per iteration: each lane decodes code lengths from its
entry to its first token boundary past its end, and lane s+1's next entry
is lane s's exit.  Lane 0 is pinned to the true scan start, so at the fixed
point the chain is the serial decode; a record pass then writes every MCU
start, and one exclusive cumsum and scatter give each MCU's bit offset.

On a CUDA tensor :func:`scan_round` launches the hand-written kernel
``csrc/specsync_scan.cu``; on a CPU tensor it runs the plain PyTorch
version :func:`scan_round_reference` (all lanes in lockstep, stopping once
no lane is active).  The rounds run as a Python loop with one host sync
per round.  :func:`gather_entropy_streams` (bit-aligned per-MCU streams for
K2) and :func:`dc_base_from_coefs` are plain torch ops, as the JAX package
leaves them to XLA.
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

# Kernel launches since the last reset (set to 0 to start counting).
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


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from jpeg_gpu_tpu_torch import cuda_build

        lib = cuda_build.load("specsync_scan")
        lib.jgt_specsync_scan.restype = ctypes.c_int
        lib.jgt_specsync_scan.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p
        ]
        _lib = lib
    return _lib


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
    bs, nws = windows.shape[0], windows.shape[1]
    if windows.dim() != 4 or tuple(windows.shape[2:]) != (SUBLANES, LANES):
        raise ValueError(f"windows must be (BS, NWS, 8, 128), got {tuple(windows.shape)}")
    if tuple(entry.shape) != (bs, 4, SUBLANES, LANES):
        raise ValueError(f"entry must be {(bs, 4, SUBLANES, LANES)}, got {tuple(entry.shape)}")
    want = {"cbase": (cbase, (8, 16)), "counts": (counts, (8, 17)),
            "symbols": (symbols, (8, SUBLANES, LANES))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if dcslot.dim() != 1 or dcslot.shape[0] < 1 or acslot.shape != dcslot.shape:
        raise ValueError("dcslot and acslot must both be (bpm,), bpm >= 1")
    if not 0 <= nbits < 2**31 or sb < 1 or (record and maxrec < 1):
        raise ValueError(f"bad scan geometry: nbits {nbits}, sb {sb}, maxrec {maxrec}")
    args = [windows, entry, dcslot, acslot, cbase, counts, symbols]
    for t in args:
        if t.dtype != torch.int32:
            raise TypeError(f"K3 takes int32 tensors, got {t.dtype}")
    dev = windows.device
    if dev.type == "cpu":
        return scan_round_reference(
            windows, entry, nbits, dcslot, acslot, cbase, counts, symbols,
            sb=sb, maxrec=maxrec, record=record,
        )
    if dev.type != "cuda":
        raise RuntimeError(f"scan_round: no kernel for device {dev}")
    if any(t.device != dev for t in args):
        raise ValueError(f"scan_round: all inputs must be on {dev}")
    args = [t.contiguous() for t in args]
    exit_state = torch.empty((bs, 4, SUBLANES, LANES), dtype=torch.int32, device=dev)
    rec = recn = None
    if record:
        rec = torch.zeros((bs, maxrec, SUBLANES, LANES), dtype=torch.int32, device=dev)
        recn = torch.empty((bs, 1, SUBLANES, LANES), dtype=torch.int32, device=dev)
    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jgt_specsync_scan(
            *(t.data_ptr() for t in args), exit_state.data_ptr(),
            rec.data_ptr() if record else None, recn.data_ptr() if record else None,
            bs, nws, int(nbits), sb, dcslot.shape[0], maxrec, int(bool(record)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"specsync_scan kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return (exit_state,) if not record else (exit_state, rec, recn)


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

    ``plain=True`` runs every round through the plain version on any
    device (to hold K3 against it on the card).

    Returns (bitpos, ok, stats) as tensors on the windows' device:
      bitpos (n_mcus,) int32 -- destuffed-stream bit offset of each MCU
        (garbage unless ok);
      ok () bool -- converged AND no record overflow AND at least n_mcus
        records (the caller falls back to the serial scan when False);
      stats (3,) int32 -- (rounds, total_records, overflowed).
    """
    dev = windows.device
    bs = windows.shape[0]
    sb_bits = sb * 8
    n_slots = bs * SLOTS
    # Lanes at or past the stream end never decode; pin their entries to
    # the start state so the shift chain does not ripple the tail lane's
    # exit through the padding lanes one per round.
    live = (torch.arange(n_slots, device=dev) * sb_bits < nbits)[None, :]
    pin_col = torch.tensor([0, 0, 1, 0], dtype=torch.int32, device=dev)[:, None]

    def pin_and_shift(exit_state):
        # Normalise dead k at DC boundaries, shift by one lane in global
        # (b, s, l) order, re-base p to the next lane's window, pin lane 0.
        p, c, at_dc, k = (exit_state[:, i] for i in range(4))
        k = torch.where(at_dc > 0, 0, k)
        p = p - sb_bits
        flat = torch.stack([x.reshape(n_slots) for x in (p, c, at_dc, k)])  # (4, S)
        shifted = torch.cat([pin_col, flat[:, :-1]], dim=1)
        shifted = torch.where(live, shifted, pin_col)
        return shifted.reshape(4, bs, SUBLANES, LANES).permute(1, 0, 2, 3).contiguous()

    entry = torch.zeros((bs, 4, SUBLANES, LANES), dtype=torch.int32, device=dev)
    entry[:, 2] = 1
    tables = (dcslot, acslot, cbase, counts, symbols)
    round_fn = scan_round_reference if plain else scan_round
    rounds, changed = 0, True
    while changed and rounds < max_rounds:
        exit_state = round_fn(windows, entry, nbits, *tables,
                                sb=sb, maxrec=maxrec, record=False)[0]
        new_entry = pin_and_shift(exit_state)
        changed = bool((new_entry != entry).any())
        entry = new_entry
        rounds += 1
    converged = not changed

    # Record pass from the converged entries.
    _, rec, recn = round_fn(windows, entry, nbits, *tables,
                              sb=sb, maxrec=maxrec, record=True)

    # Stitch: the exclusive cumsum of the per-lane counts gives each
    # record's global MCU index; one scatter places the bit positions.
    recn_flat = recn.reshape(n_slots).to(torch.int64)
    first = torch.cumsum(recn_flat, 0) - recn_flat
    total = recn_flat.sum()
    overflow = (recn_flat > maxrec).any()
    lane_base = (torch.arange(n_slots, device=dev, dtype=torch.int64) * sb_bits).reshape(
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
        torch.tensor(rounds, device=dev), total, overflow.to(torch.int64)
    ]).to(torch.int32)
    return to_i32(bitpos[:n_mcus] & 0xFFFFFFFF), ok, stats


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
