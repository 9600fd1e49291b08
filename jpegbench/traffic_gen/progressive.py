"""Progressive JPEG files of given quantized coefficients: the ten scans of
libjpeg's ``jpeg_simple_progression`` (jcparam.c) for a YCbCr image, which
``cjpeg -progressive`` and Pillow's ``save(progressive=True)`` write, each
scan with Huffman tables optimised for it, as libjpeg always makes them in
progressive mode (jcmaster.c).

The coding follows ITU T.81 Annex G as libjpeg's ``jcphuff.c`` does it:
DC first scans code the differences of the DC values shifted right by Al
(G.1.2.1) and DC refinement scans one bit of each (G.1.2.1); AC first scans
code each band's values, magnitudes shifted right by Al, with runs of
blocks that end in an EOB sent as one EOBRUN symbol (G.1.2.2); AC
refinement scans code the values that become non-zero at this bit and send
one correction bit for each value that was non-zero already, after the next
symbol or after the EOBRUN that ends its block (G.1.2.3).  An EOBRUN is
sent before the next symbol, when it reaches 0x7FFF, when more than 937
correction bits wait behind it (libjpeg's bound), at every restart marker
and at the end of the scan.  A scan of one component codes the blocks of
that component's own size, ceil(w / 8) x ceil(h / 8) (A.2.2), not the MCU
grid of the interleaved scans.

Every symbol is built in array calls: each item of a scan (a Huffman
symbol with its extra bits, or a bare bit) gets a sort key that places it
in the stream, then :func:`frames.scan_bytes` lays the bits out.  Nothing
here imports the program or JAX.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from jpegbench import reference
from jpegbench.traffic_gen import frames, huffman

# jpeg_simple_progression for three YCbCr components: (components, Ss, Se,
# Ah, Al); component 0 is Y, 1 Cb, 2 Cr.
SIMPLE_PROGRESSION = (
    ((0, 1, 2), 0, 0, 0, 1),      # DC first, all components
    ((0,), 1, 5, 0, 2),           # Y AC 1-5
    ((2,), 1, 63, 0, 1),          # Cr AC
    ((1,), 1, 63, 0, 1),          # Cb AC
    ((0,), 6, 63, 0, 2),          # Y AC 6-63
    ((0,), 1, 63, 2, 1),          # Y AC refinement
    ((0, 1, 2), 0, 0, 1, 0),      # DC refinement
    ((2,), 1, 63, 1, 0),          # Cr AC refinement
    ((1,), 1, 63, 1, 0),          # Cb AC refinement
    ((0,), 1, 63, 1, 0),          # Y AC refinement, the last bit
)

MAX_EOBRUN = 0x7FFF
# libjpeg sends a pending EOBRUN once more correction bits than this wait
# behind it (jcphuff.c: MAX_CORR_BITS - DCTSIZE2 + 1).
MAX_CORRECTION_BITS = 1000 - 64 + 1
_END = 64                         # a key position after every coefficient of a block


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _Items:
    """The items of one scan, in any order: a sort key (block, position,
    then three tie-breakers), the Huffman table (-1: a bare bit), the
    symbol, and the extra bits (value, count) that follow its code."""

    def __init__(self):
        self.parts: List[Tuple[np.ndarray, ...]] = []

    def add(self, block, pos, s1, s2, s3, table, symbol, raw, nraw) -> None:
        n = np.size(block)
        if n:
            self.parts.append(tuple(np.broadcast_to(np.asarray(a, dtype=np.int64), (n,))
                                    for a in (block, pos, s1, s2, s3, table, symbol, raw, nraw)))

    def ordered(self):
        """(table, symbol, raw, nraw, block) in stream order."""
        cols = [np.concatenate(c) for c in zip(*self.parts)]
        order = np.lexsort(cols[4::-1])
        return tuple(c[order] for c in cols[5:]) + (cols[0][order],)


def _amplitude(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(size category, extra bits) of signed values (T.81 F.1.2.1)."""
    size = frames._CSIZE[np.abs(v)]
    return size, frames._AMP[v + frames._MAX_AMPLITUDE]


def _dc_scan(coefs, samp, nvmb: int, nhmb: int, restart: int, ah: int, al: int, items: _Items):
    """A DC scan of all components, interleaved in MCUs; returns the
    segment of each MCU-ordered block."""
    per = [c[..., 0, 0].reshape(nvmb, vs, nhmb, hs).transpose(0, 2, 1, 3).reshape(nvmb, nhmb, -1)
           for c, (hs, vs) in zip(coefs, samp)]
    dc = np.concatenate(per, axis=2).reshape(nvmb * nhmb, -1).astype(np.int64) >> al
    comp_of_slot = np.concatenate([np.full(hs * vs, ci) for ci, (hs, vs) in enumerate(samp)])
    n_mcus, bpm = dc.shape
    seg_of_mcu = np.arange(n_mcus) // restart if restart else np.zeros(n_mcus, np.int64)
    block = np.arange(n_mcus * bpm)
    if ah:
        items.add(block, 0, 0, 0, 0, -1, 0, (dc & 1).reshape(-1), 1)
    else:
        # The previous block of the same component, 0 at a segment's start.
        pred = np.zeros_like(dc)
        same = seg_of_mcu[1:] == seg_of_mcu[:-1]
        for ci in range(len(samp)):
            slots = np.flatnonzero(comp_of_slot == ci)
            pred[:, slots[1:]] = dc[:, slots[:-1]]
            pred[1:, slots[0]] = np.where(same, dc[:-1, slots[-1]], 0)
        size, raw = _amplitude((dc - pred).reshape(-1))
        items.add(block, 0, 0, 0, 0, np.tile(np.minimum(comp_of_slot, 1), n_mcus), size, raw,
                  size)
    return np.repeat(seg_of_mcu, bpm)


def _chunks(starts: np.ndarray, inc: np.ndarray, waiting: np.ndarray) -> np.ndarray:
    """The EOBRUN each block's EOB joins.  A run starts at ``starts`` (a
    block that sends a symbol, or a segment's first) and is cut after the
    block at which it counts MAX_EOBRUN EOBs or holds more than
    MAX_CORRECTION_BITS bits; ``inc``: the block ends in an EOB;
    ``waiting``: its correction bits that wait for the EOBRUN."""
    group = np.cumsum(starts) - 1
    first = np.flatnonzero(starts)
    end = np.append(first[1:], starts.size)
    over = ((np.bincount(group, inc, first.size) >= MAX_EOBRUN)
            | (np.bincount(group, waiting, first.size) > MAX_CORRECTION_BITS))
    cut = starts.copy()
    for g in np.flatnonzero(over):
        lo, hi = first[g], end[g]
        while lo < hi:
            hit = np.flatnonzero(inc[lo:hi] & ((np.cumsum(inc[lo:hi]) == MAX_EOBRUN)
                                               | (np.cumsum(waiting[lo:hi]) > MAX_CORRECTION_BITS)))
            if not hit.size:
                break
            lo += int(hit[0]) + 1
            if lo < hi:
                cut[lo] = True
    return np.cumsum(cut) - 1


def _ac_scan(band: np.ndarray, table: int, restart: int, ah: int, al: int, items: _Items):
    """An AC scan of one component's blocks (``band``: (blocks, Se - Ss + 1)
    values in zigzag order); returns the segment of each block."""
    n, length = band.shape
    mag = np.abs(band) >> al
    newly = (mag > 0) if ah == 0 else (mag == 1)
    blk, k = np.nonzero(mag)                    # by block, then position
    m = blk.size
    idx = np.arange(m)
    is_sym = newly[blk, k]
    first_of_block = np.searchsorted(blk, np.arange(n))
    zeros_before = k - (idx - first_of_block[blk])
    # Zeros since the block's previous symbol (a bare correction bit is no
    # symbol and its value no zero: G.1.2.3).
    prev_sym = np.concatenate([[-1], np.maximum.accumulate(np.where(is_sym, idx, -1))])[:m]
    prev_sym = np.where(prev_sym >= first_of_block[blk], prev_sym, -1)
    zr = zeros_before - np.where(prev_sym >= 0, zeros_before[prev_sym], 0)
    last_sym = np.full(n, -1)
    np.maximum.at(last_sym, blk[is_sym], idx[is_sym])
    body = idx <= last_sym[blk]                 # at or before the block's last symbol
    # ZRLs go out at the non-zero values up to the last symbol: every 16
    # zeros not yet sent (F) less those sent at the value before in this run.
    f = zr >> 4
    before = np.where((idx > first_of_block[blk]) & ~np.roll(is_sym, 1), np.roll(f, 1), 0)
    zrl = np.where(body, f - before, 0)

    # Per block: does it send a symbol, end in an EOB, and how many of its
    # correction bits follow the block's last symbol.
    sends = last_sym >= 0
    last_k = np.full(n, -1)
    last_k[sends] = k[last_sym[sends]]
    eob = (last_k < length - 1).astype(np.int64)
    tail = ~body
    waiting = np.bincount(blk[tail], minlength=n)
    unit = np.arange(n)
    seg = unit // restart if restart else np.zeros(n, np.int64)
    chunk = _chunks(sends | (unit % restart == 0 if restart else unit == 0), eob, waiting)

    # The symbols of values that become non-zero, after their ZRLs.
    s = np.flatnonzero(is_sym)
    if ah == 0:
        size, raw = _amplitude(np.sign(band[blk[s], k[s]]) * mag[blk[s], k[s]])
    else:
        size, raw = np.ones(s.size, np.int64), (band[blk[s], k[s]] > 0).astype(np.int64)
    items.add(blk[s], k[s], 8, 0, 0, table, (zr[s] & 15) << 4 | size, raw, size)
    z = np.repeat(idx, zrl)
    items.add(blk[z], k[z], 2 * (np.arange(z.size) - np.repeat(np.cumsum(zrl) - zrl, zrl)), 0, 0,
              table, 0xF0, 0, 0)
    # Correction bits: after the first ZRL or the symbol of the next value
    # that sends one, or after the EOBRUN of their block's run.
    c = np.flatnonzero(~is_sym & body)
    anchor = np.minimum.accumulate(np.where(body & (is_sym | (zrl > 0)), idx, m)[::-1])[::-1]
    a = np.append(anchor[1:], m)[c]
    items.add(blk[a], k[a], np.where(zrl[a] > 0, 1, 9), 0, k[c], -1, 0, mag[blk[c], k[c]] & 1, 1)
    last_of_chunk = np.append(np.flatnonzero(np.diff(chunk)), n - 1)
    t = np.flatnonzero(tail)
    items.add(last_of_chunk[chunk[blk[t]]], _END, 1, blk[t], k[t], -1, 0,
              mag[blk[t], k[t]] & 1, 1)
    # Each run's EOBRUN after its last block: symbol 16 x (bits - 1), then
    # the count's bits below its top one.
    run = np.bincount(chunk, eob, chunk[-1] + 1).astype(np.int64)
    r = np.flatnonzero(run)
    nb = np.frexp(run[r])[1].astype(np.int64) - 1
    items.add(last_of_chunk[r], _END, 0, 0, 0, table, nb << 4, run[r] - (1 << nb), nb)
    return seg


def encode(coefs: Sequence[np.ndarray], qtables, samp, height: int, width: int,
           restart: int) -> Tuple[bytes, frames.Facts]:
    """A progressive JFIF file (SOF2) of exactly these quantized coefficients
    (per component (vb, hb, 8, 8) on the MCU-aligned grid, natural order;
    the luma and chroma tables ``qtables``), in :data:`SIMPLE_PROGRESSION`'s
    scans, a restart marker every ``restart`` MCUs of each scan (0: none),
    each Huffman-coded scan after a DHT of the tables optimised for it: luma
    table 0, chroma table 1.  Returns (bytes, facts): the facts count every
    scan's bytes, symbols (EOBRUN and ZRL included) and segments."""
    if len(samp) != 3:
        raise ValueError("the simple progression here is the one for three components")
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    nhmb, nvmb = _ceil_div(width, 8 * hmax), _ceil_div(height, 8 * vmax)
    out = bytearray(b"\xff\xd8")
    out += frames._marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t, q in enumerate(qtables):
        zigzag = q.reshape(64)[reference.ZIGZAG].astype(np.uint8)
        out += frames._marker(0xDB, bytes([t]) + zigzag.tobytes())
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([len(samp)])
    for ci, (hs, vs) in enumerate(samp):
        sof += bytes([ci + 1, (hs << 4) | vs, min(ci, 1)])
    out += frames._marker(0xC2, sof)
    scan_total = symbols = segments = 0
    for n_scan, (comps, ss, se, ah, al) in enumerate(SIMPLE_PROGRESSION):
        items = _Items()
        if ss == 0:
            seg = _dc_scan(coefs, samp, nvmb, nhmb, restart, ah, al, items)
        else:
            (ci,) = comps
            hs, vs = samp[ci]
            bh = _ceil_div(_ceil_div(height * vs, vmax), 8)
            bw = _ceil_div(_ceil_div(width * hs, hmax), 8)
            band = coefs[ci][:bh, :bw].reshape(-1, 64)[:, reference.ZIGZAG[ss:se + 1]]
            seg = _ac_scan(band.astype(np.int64), min(ci, 1), restart, ah, al, items)
        table, symbol, raw, nraw, block = items.ordered()
        coded = table >= 0
        cls = 0 if ss == 0 else 1
        code = np.zeros((2, 256), dtype=np.int64)
        length = np.zeros((2, 256), dtype=np.int64)
        for t in np.unique(table[coded]):
            tab = huffman.optimal(np.bincount(symbol[table == t], minlength=256))
            code[t], length[t] = huffman.codes(tab)
            out += frames._marker(0xC4, bytes([cls << 4 | int(t)]) + tab[0].tobytes()
                                  + tab[1].tobytes())
        if restart and n_scan == 0:
            out += frames._marker(0xDD, restart.to_bytes(2, "big"))
        sel = np.where(coded, table, 0)
        bits = np.where(coded, length[sel, symbol], 0) + nraw
        value = np.where(coded, code[sel, symbol] << nraw, 0) | raw
        n_segments = int(seg[-1]) + 1
        scan = frames.scan_bytes(value, bits, seg[block], n_segments)
        sos = bytes([len(comps)])
        for ci in comps:
            t = min(ci, 1)
            sos += bytes([ci + 1, (t << 4 if ss == 0 and ah == 0 else 0) | (t if ss else 0)])
        out += frames._marker(0xDA, sos + bytes([ss, se, ah << 4 | al])) + scan.tobytes()
        scan_total += scan.size
        symbols += int(coded.sum())
        segments += n_segments
    out += b"\xff\xd9"
    n_mcus = nvmb * nhmb
    facts = frames.Facts(bytes=len(out), scan_bytes=scan_total, pixels=height * width,
                         mcus=n_mcus, blocks=n_mcus * sum(h * v for h, v in samp),
                         symbols=symbols, segments=segments, quant_bytes=2 * 64 * len(qtables))
    return bytes(out), facts


def make_frame(seed: int, index: int, height: int, width: int, sampling: str, quality: int,
               restart: int) -> frames.Frame:
    """Frame ``index`` of a run with ``seed``: the coefficients of
    :func:`frames.make_frame`'s frame of the same arguments, in a
    progressive file (:func:`encode`)."""
    coefs, qtables, samp = frames.frame_coefficients(seed, index, height, width, sampling, quality)
    data, facts = encode(coefs, qtables, samp, height, width, restart)
    return frames.Frame(data, facts, tuple(coefs), (qtables[0],) + (qtables[1],) * 2, samp,
                        height, width)
