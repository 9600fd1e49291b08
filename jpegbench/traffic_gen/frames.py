"""Seeded JPEG frames at any size: tiles of a committed source's quantized
coefficients, entropy-coded in NumPy.

A frame is not encoded from pixels: no floating point lies on the way to
its bytes.  Its coefficients are tiles of a committed source frame's
(``src/``, quality 85; decoded once a process by the plain reference's
Huffman decoder), laid over the frame's block grid with a cyclic shift and
a mirror chosen per tile by an integer hash of the tile's place, the
``--seed`` and the frame's index, so that neighbouring tiles, frames and
seeds differ (a mirror negates the odd frequencies of every block: an
exact transform).  They are entropy-coded with the Annex K.3 tables or
with tables optimised for the frame, every symbol of every block at once,
and the bits packed as integers.  So the bytes depend on the committed
sources, the seed and this code only.

Beside the bytes the generator returns what it knows of the stream, which
the roofline counts need (:class:`Facts`), and the coefficients and tables
themselves, which the plain reference turns into the expected RGB.

(A frozen copy of the program's ``testing/fullsize.py`` tiler and coder,
with the seed in the hash, the sources decoded once a process, the Annex
K.3 tables and the RFC 2435 header added.)
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib
from typing import List, Sequence, Tuple

import numpy as np

from jpegbench import reference
from jpegbench.traffic_gen import huffman

SOURCES = pathlib.Path(__file__).parent / "src"
SOURCE_OF = {"4:2:0": "src-420.jpg", "4:4:4": "src-444.jpg"}
SAMPLING = {"4:2:0": ((2, 2), (1, 1), (1, 1)), "4:4:4": ((1, 1), (1, 1), (1, 1))}

# T.81 Table K.1 and K.2, natural order: the tables RFC 2435 and libjpeg scale.
K1_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]).reshape(8, 8)
K2_CHROMA = np.full((8, 8), 99)
K2_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]

# Amplitude categories of a DC difference go up to 11, of an AC value to 10.
_MAX_AMPLITUDE = 2047
_V = np.arange(-_MAX_AMPLITUDE, _MAX_AMPLITUDE + 1)
_CSIZE = np.array([int(v).bit_length() for v in range(_MAX_AMPLITUDE + 1)], dtype=np.int64)
_AMP = np.where(_V >= 0, _V, _V + (1 << _CSIZE[np.abs(_V)]) - 1).astype(np.int64)


def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """RFC 2435's MakeTables(Q), which is libjpeg's quality scaling of the
    Annex K tables: factor 5000 / Q below 50, else 200 - 2 Q; each entry
    (K * factor + 50) // 100, clamped to 1..255."""
    factor = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * factor + 50) // 100, 1, 255) for t in (K1_LUMA, K2_CHROMA))


@dataclasses.dataclass(frozen=True)
class Facts:
    """What the generator knows of a stream: its length, the entropy-coded
    bytes of its scan (stuffing and restart markers included), pixels, MCUs,
    8x8 blocks, Huffman symbols (every DC, AC, ZRL and EOB code), restart
    segments and the bytes of its quantization tables as 16-bit entries."""

    bytes: int
    scan_bytes: int
    pixels: int
    mcus: int
    blocks: int
    symbols: int
    segments: int
    quant_bytes: int


@dataclasses.dataclass(frozen=True)
class Frame:
    """A generated JPEG, its facts, and what the plain reference needs to
    work out its RGB: per component ``(vb, hb, 8, 8)`` int16 coefficients
    and (8, 8) tables, the sampling and the size."""

    data: bytes
    facts: Facts
    coefs: Tuple[np.ndarray, ...]
    qtables: Tuple[np.ndarray, ...]
    sampling: Tuple[Tuple[int, int], ...]
    height: int
    width: int


@functools.lru_cache(maxsize=None)
def source_coefficients(sampling: str) -> Tuple[Tuple[np.ndarray, ...], Tuple[np.ndarray, ...]]:
    """(coefficients, tables) of the committed source of a sampling, decoded
    once a process by the plain reference, read-only."""
    hdr, coefs = reference.decode_coefficients((SOURCES / SOURCE_OF[sampling]).read_bytes())
    for c in coefs:
        c.setflags(write=False)
    return tuple(coefs), tuple(hdr.quant(ci) for ci in range(len(coefs)))


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser on uint64 (wrapping arithmetic)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def frame_key(seed: int, index: int) -> int:
    """The hash key of frame ``index`` of a run with ``seed`` (any integer)."""
    k = _mix(np.array([seed % (1 << 64)], dtype=np.uint64))
    return int(_mix(k ^ np.uint64(index % (1 << 64)))[0])


def tile_coefficients(src: Sequence[np.ndarray], samp, nvmb: int, nhmb: int,
                      key: int) -> List[np.ndarray]:
    """The frame's (nvmb * vs, nhmb * hs, 8, 8) int16 grid per component:
    tiles of the source's MCU grid, each cyclically shifted by whole MCUs
    and mirrored (vertically, horizontally) as an integer hash of its tile
    position and ``key`` says."""
    svmb = src[0].shape[0] // samp[0][1]
    shmb = src[0].shape[1] // samp[0][0]
    ty, tx = np.meshgrid(np.arange(-(-nvmb // svmb), dtype=np.uint64),
                         np.arange(-(-nhmb // shmb), dtype=np.uint64), indexing="ij")
    h = _mix((ty * np.uint64(1 << 20) + tx) ^ np.uint64(key))
    shift_y = (h % np.uint64(svmb)).astype(np.int64)
    shift_x = ((h >> np.uint64(16)) % np.uint64(shmb)).astype(np.int64)
    flip_v = ((h >> np.uint64(32)) & np.uint64(1)).astype(np.int64)
    flip_h = ((h >> np.uint64(33)) & np.uint64(1)).astype(np.int64)
    odd = (np.arange(8) % 2).astype(bool)
    # signs[fv, fh]: a vertical mirror negates odd vertical frequencies, a
    # horizontal one odd horizontal frequencies.
    signs = np.ones((2, 2, 8, 8), dtype=np.int16)
    signs[1, :, odd, :] *= -1
    signs[:, 1, :, odd] *= -1
    out = []
    for c, (hs, vs) in zip(src, samp):
        my, sub_y = np.divmod(np.arange(nvmb * vs), vs)
        mx, sub_x = np.divmod(np.arange(nhmb * hs), hs)
        t_y, i_y = np.divmod(my, svmb)
        t_x, i_x = np.divmod(mx, shmb)
        fv = flip_v[t_y[:, None], t_x[None, :]]
        fh = flip_h[t_y[:, None], t_x[None, :]]
        sy = (i_y[:, None] + shift_y[t_y[:, None], t_x[None, :]]) % svmb
        sx = (i_x[None, :] + shift_x[t_y[:, None], t_x[None, :]]) % shmb
        row = np.where(fv, (svmb - 1 - sy) * vs + (vs - 1 - sub_y[:, None]), sy * vs + sub_y[:, None])
        col = np.where(fh, (shmb - 1 - sx) * hs + (hs - 1 - sub_x[None, :]), sx * hs + sub_x[None, :])
        grid = c[row, col] * signs[fv, fh]
        out.append(grid)
    return out


def _marker(m: int, payload: bytes = b"") -> bytes:
    return bytes([0xFF, m]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _header(height, width, samp, qtables, tables, restart, rfc2435: bool) -> bytes:
    """SOI to SOS.  ``rfc2435``: the header an RFC 2435 receiver rebuilds
    (its appendix B, MakeHeaders: DQT 0 and 1, DRI, SOF0 with components 0,
    1, 2, the four DHTs, SOS); else a JFIF file's (APP0, components 1, 2, 3)."""
    out = bytearray(b"\xff\xd8")
    if not rfc2435:
        out += _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t, q in enumerate(qtables):
        out += _marker(0xDB, bytes([t]) + q.reshape(64)[reference.ZIGZAG].astype(np.uint8).tobytes())
    if restart and rfc2435:
        out += _marker(0xDD, restart.to_bytes(2, "big"))
    first_id = 0 if rfc2435 else 1
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([len(samp)])
    for ci, (hs, vs) in enumerate(samp):
        sof += bytes([first_id + ci, (hs << 4) | vs, min(ci, 1)])
    out += _marker(0xC0, sof)
    for sel, (counts, symbols) in enumerate(tables):     # DC 0, DC 1, AC 0, AC 1
        out += _marker(0xC4, bytes([(sel // 2) << 4 | sel % 2]) + counts.tobytes()
                       + symbols.tobytes())
    if restart and not rfc2435:
        out += _marker(0xDD, restart.to_bytes(2, "big"))
    sos = bytes([len(samp)])
    for ci in range(len(samp)):
        t = min(ci, 1)
        sos += bytes([first_id + ci, (t << 4) | t])
    out += _marker(0xDA, sos + bytes([0, 63, 0]))
    return bytes(out)


def scan_bytes(value: np.ndarray, bits: np.ndarray, seg: np.ndarray,
               n_segments: int) -> np.ndarray:
    """The entropy-coded bytes of one scan: item ``i`` (in order) is the
    ``bits[i]`` (1..33) low bits of ``value[i]``, in restart segment
    ``seg[i]`` (non-decreasing, every one of ``n_segments`` holding some
    bits).  Each item is laid at its bit offset in 32-bit words, each
    segment padded with 1 bits to a byte, the bytes stuffed and split by
    RST0..RST7 markers, numbered from 0 in every scan."""
    # Bit offsets: each segment starts on a byte, its tail padded with 1s.
    seg_bits = np.bincount(seg, weights=bits, minlength=n_segments).astype(np.int64)
    seg_bytes = (seg_bits + 7) // 8
    seg_at = 8 * (np.cumsum(seg_bytes) - seg_bytes)
    offset = np.cumsum(bits) - bits
    offset += (seg_at - (np.cumsum(seg_bits) - seg_bits))[seg]
    pad = 8 * seg_bytes - seg_bits
    padded = np.flatnonzero(pad)
    offset = np.concatenate([offset, seg_at[padded] + seg_bits[padded]])
    bits = np.concatenate([bits, pad[padded]])
    value = np.concatenate([value, (1 << pad[padded]) - 1])

    total = int(seg_bytes.sum())
    word = offset >> 5
    x = value.astype(np.uint64) << (64 - (offset & 31) - bits).astype(np.uint64)
    n_words = total // 4 + 2
    # Disjoint bits summed as float64: every word's sum is below 2**32, exact.
    acc = (np.bincount(word, weights=(x >> np.uint64(32)).astype(np.float64), minlength=n_words)
           + np.bincount(word + 1, weights=(x & np.uint64(0xFFFFFFFF)).astype(np.float64),
                         minlength=n_words))
    raw = np.frombuffer(acc[:n_words].astype(np.uint32).astype(">u4").tobytes(), np.uint8)[:total]

    # Stuff a zero after every 0xFF; put RST(s - 1) & 7 before segment s.
    ff = raw == 0xFF
    seg_of_byte = np.repeat(np.arange(n_segments), seg_bytes)
    pos = np.arange(total) + (np.cumsum(ff) - ff) + 2 * seg_of_byte
    scan = np.zeros(total + int(ff.sum()) + 2 * (n_segments - 1), dtype=np.uint8)
    scan[pos] = raw
    m = pos[seg_at[1:] // 8] - 2
    scan[m] = 0xFF
    scan[m + 1] = 0xD0 + (np.arange(n_segments - 1) & 7)
    return scan


def encode(coefs: Sequence[np.ndarray], qtables, samp, height: int, width: int,
           restart: int, tables: str, rfc2435: bool) -> Tuple[bytes, Facts]:
    """A baseline JPEG of exactly these quantized coefficients (per component
    (vb, hb, 8, 8) on the MCU-aligned grid, natural order), interleaved, one
    scan, a restart marker every ``restart`` MCUs (0: none), with the Annex
    K.3 tables (``tables="annex_k"``) or tables optimised for this frame
    (``"optimal"``): luma set 0, chroma set 1.  Every symbol of every block
    is made at once: the DC differences, each non-zero AC value's run (with
    ZRLs for runs over 15) and an EOB where the block ends before position
    63; then each symbol's code and amplitude bits are laid at their bit
    offsets in 32-bit words, each segment padded with 1 bits to a byte,
    stuffed, and split by RSTn markers.  Returns (bytes, facts)."""
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    nhmb, nvmb = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    per = [c.reshape(nvmb, vs, nhmb, hs, 64).transpose(0, 2, 1, 3, 4).reshape(nvmb, nhmb, vs * hs, 64)
           for c, (hs, vs) in zip(coefs, samp)]
    rows = np.concatenate(per, axis=2).reshape(-1, 64)[:, reference.ZIGZAG]
    comp_of_slot = np.concatenate([np.full(hs * vs, ci) for ci, (hs, vs) in enumerate(samp)])
    bpm = comp_of_slot.size
    n_blocks = rows.shape[0]
    n_mcus = n_blocks // bpm
    tab = np.tile(np.minimum(comp_of_slot, 1), n_mcus)

    # DC differences: the previous block of the same component, 0 at a
    # segment's start.
    dc = rows[:, 0].astype(np.int64).reshape(n_mcus, bpm)
    seg_of_mcu = (np.arange(n_mcus) // restart) if restart else np.zeros(n_mcus, np.int64)
    pred = np.zeros_like(dc)
    for ci in range(len(samp)):
        slots = np.flatnonzero(comp_of_slot == ci)
        pred[:, slots[1:]] = dc[:, slots[:-1]]
        same = seg_of_mcu[1:] == seg_of_mcu[:-1]
        pred[1:, slots[0]] = np.where(same, dc[:-1, slots[-1]], 0)
    diff = (dc - pred).reshape(-1)

    # AC symbols: run of zeros (ZRL per 16) and size of each non-zero value.
    blk, k = np.nonzero(rows[:, 1:])
    idx = k + 1
    val = rows[blk, idx].astype(np.int64)
    first = np.ones(blk.size, dtype=bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.zeros(blk.size, dtype=np.int64)
    prev[1:] = idx[:-1]
    prev[first] = 0
    run = idx - prev - 1
    n_zrl = run >> 4
    last = np.zeros(n_blocks, dtype=np.int64)
    last[blk] = idx                 # the last write per block is its last non-zero
    eob = last < 63
    per_nz = 1 + n_zrl
    count = 1 + np.bincount(blk, weights=per_nz, minlength=n_blocks).astype(np.int64) + eob
    start = np.cumsum(count) - count
    n_events = int(count.sum())
    sel = np.empty(n_events, dtype=np.int64)     # Huffman table: 0-1 DC, 2-3 AC
    sym = np.empty(n_events, dtype=np.int64)
    amp = np.zeros(n_events, dtype=np.int64)
    size = np.zeros(n_events, dtype=np.int64)
    block_of = np.empty(n_events, dtype=np.int64)

    dsize = _CSIZE[np.abs(diff)]
    sel[start], sym[start] = tab, dsize
    amp[start], size[start] = _AMP[diff + _MAX_AMPLITUDE], dsize
    block_of[start] = np.arange(n_blocks)

    cum = np.cumsum(per_nz) - per_nz
    within = cum - np.maximum.accumulate(np.where(first, cum, 0))
    at = start[blk] + 1 + within + n_zrl
    asize = _CSIZE[np.abs(val)]
    sel[at], sym[at] = 2 + tab[blk], (run & 15) << 4 | asize
    amp[at], size[at] = _AMP[val + _MAX_AMPLITUDE], asize
    block_of[at] = blk
    if n_zrl.any():
        z = np.repeat(np.arange(blk.size), n_zrl)
        j = np.arange(z.size) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
        zat = start[blk[z]] + 1 + within[z] + j
        sel[zat], sym[zat], block_of[zat] = 2 + tab[blk[z]], 0xF0, blk[z]
    e = np.flatnonzero(eob)
    eat = start[e] + count[e] - 1
    sel[eat], sym[eat], block_of[eat] = 2 + tab[e], 0x00, e

    if tables == "annex_k":
        sets = huffman.ANNEX_K
    elif tables == "optimal":
        freq = np.bincount(sel * 256 + sym, minlength=4 * 256).reshape(4, 256)
        sets = tuple(huffman.optimal(freq[s]) for s in range(4))
    else:
        raise ValueError(f"tables must be 'annex_k' or 'optimal', got {tables!r}")
    code = np.zeros((4, 256), dtype=np.int64)
    length = np.zeros((4, 256), dtype=np.int64)
    for s, table in enumerate(sets):
        code[s], length[s] = huffman.codes(table)
    if not (length[sel, sym] > 0).all():
        raise ValueError("a symbol has no code in the tables")
    bits = length[sel, sym] + size
    value = (code[sel, sym] << size) | amp

    seg = (block_of // bpm // restart) if restart else np.zeros(n_events, np.int64)
    n_segments = int(seg_of_mcu[-1]) + 1
    scan = scan_bytes(value, bits, seg, n_segments)
    data = (_header(height, width, samp, qtables, sets, restart, rfc2435)
            + scan.tobytes() + b"\xff\xd9")
    facts = Facts(bytes=len(data), scan_bytes=int(scan.size), pixels=height * width, mcus=n_mcus,
                  blocks=n_blocks, symbols=n_events, segments=n_segments,
                  quant_bytes=2 * 64 * len(qtables))
    return data, facts


def frame_coefficients(seed: int, index: int, height: int, width: int, sampling: str,
                       quality: int):
    """(coefficients, the luma and chroma tables, sampling) of frame ``index``
    of a run with ``seed``: tiles of the committed source of ``sampling``,
    whose tables must be those of ``quality``."""
    src, src_q = source_coefficients(sampling)
    qtables = quant_tables(quality)
    if not all(np.array_equal(a, b) for a, b in zip(src_q, (qtables[0],) + (qtables[1],) * 2)):
        raise ValueError(f"the committed source of {sampling} was not quantized at Q={quality}")
    samp = SAMPLING[sampling]
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    coefs = tile_coefficients(src, samp, -(-height // (8 * vmax)), -(-width // (8 * hmax)),
                              frame_key(seed, index))
    return coefs, qtables, samp


def make_frame(seed: int, index: int, height: int, width: int, sampling: str, quality: int,
               restart: int, tables: str, rfc2435: bool) -> Frame:
    """Frame ``index`` of a run with ``seed`` (:func:`frame_coefficients`),
    a baseline file (:func:`encode`)."""
    coefs, qtables, samp = frame_coefficients(seed, index, height, width, sampling, quality)
    data, facts = encode(coefs, qtables, samp, height, width, restart, tables, rfc2435)
    return Frame(data, facts, tuple(coefs), (qtables[0],) + (qtables[1],) * 2, samp, height, width)
