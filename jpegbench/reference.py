"""The plain reference: baseline sequential JPEG decoding as ITU T.81 and
libjpeg define it, in NumPy and plain Python.

It imports nothing of the program under test (``jpeg_gpu_tpu_torch``) and
nothing of JAX, and takes nothing the program made: it parses the bytes
itself, decodes the Huffman codes itself and works out every table again.

* :func:`parse` and :func:`decode_coefficients` read a baseline JPEG into
  its quantized coefficients (per component a ``(vb, hb, 8, 8)`` int16 grid
  over the MCU-aligned block grid, natural order).  Plain Python, one
  symbol at a time: it serves the committed sources of the traffic
  generator and the tests, never a timed path.
* :func:`rgb` turns coefficients and quantization tables into RGB as
  libjpeg does with ``JDCT_ISLOW``: dequantization and the islow IDCT
  (``jidctint.c``, with its wrap-around range limit), chroma upsampling
  ``nearest`` (replication, as the program's default) or ``fancy``
  (libjpeg's triangle filter, ``jdsample.c``, edges replicated), and the
  integer YCbCr -> RGB conversion of ``jdcolor.c``.  Vectorised over all
  blocks; this is what a run's outputs are compared with.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _zigzag() -> np.ndarray:
    """ZIGZAG[k] = raster index (row * 8 + col) of the k-th coefficient of
    the bitstream (T.81 figure A.6)."""
    order = []
    for s in range(15):
        cells = [(r, s - r) for r in range(8) if 0 <= s - r < 8]
        order.extend(r * 8 + c for r, c in (cells[::-1] if s % 2 == 0 else cells))
    return np.array(order, dtype=np.int64)


ZIGZAG = _zigzag()


# -- parsing -------------------------------------------------------------------

@dataclasses.dataclass
class Header:
    height: int
    width: int
    components: List[Tuple[int, int, int, int]]     # (id, hsamp, vsamp, quant table id)
    qtables: Dict[int, np.ndarray]                  # id -> (8, 8) natural order
    huffman: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]]   # (class, id) -> (counts, symbols)
    restart_interval: int
    scan: List[Tuple[int, int, int]]                # (component index, DC table, AC table)
    entropy: bytes                                  # the scan's bytes, stuffed, RSTn included

    @property
    def sampling(self) -> Tuple[Tuple[int, int], ...]:
        return tuple((h, v) for _, h, v, _ in self.components)

    def mcu_grid(self) -> Tuple[int, int]:
        """(MCU rows, MCU columns) of the interleaved scan."""
        hmax = max(h for _, h, _, _ in self.components)
        vmax = max(v for _, _, v, _ in self.components)
        return -(-self.height // (8 * vmax)), -(-self.width // (8 * hmax))

    def quant(self, ci: int) -> np.ndarray:
        return self.qtables[self.components[ci][3]]


def parse(data: bytes) -> Header:
    """The frame and scan header of a baseline, single-scan, interleaved JPEG
    (SOF0), and its entropy-coded bytes.  Raises ValueError otherwise."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("no SOI")
    qtables, huffman = {}, {}
    frame = None
    restart = 0
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"no marker at {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDB:
            at = 0
            while at < len(body):
                pq, tq = body[at] >> 4, body[at] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[at + 1:at + 1 + n], dtype=">u2" if pq else np.uint8)
                table = np.zeros(64, dtype=np.int64)
                table[ZIGZAG] = vals
                qtables[tq] = table.reshape(8, 8)
                at += 1 + n
        elif marker == 0xC4:
            at = 0
            while at < len(body):
                tc, th = body[at] >> 4, body[at] & 15
                counts = np.frombuffer(body[at + 1:at + 17], dtype=np.uint8).copy()
                n = int(counts.sum())
                huffman[(tc, th)] = (counts, np.frombuffer(body[at + 17:at + 17 + n],
                                                           dtype=np.uint8).copy())
                at += 17 + n
        elif marker == 0xDD:
            restart = int.from_bytes(body[:2], "big")
        elif marker == 0xC0:
            height = int.from_bytes(body[1:3], "big")
            width = int.from_bytes(body[3:5], "big")
            comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15, body[8 + 3 * i])
                     for i in range(body[5])]
            frame = (height, width, comps)
        elif 0xC1 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"not a baseline JPEG (SOF{marker - 0xC0})")
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("SOS before SOF")
            ids = [c[0] for c in frame[2]]
            scan = [(ids.index(body[1 + 2 * i]), body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15)
                    for i in range(body[0])]
            end = data.rfind(b"\xff\xd9")
            if end < pos:
                raise ValueError("no EOI after the scan")
            if len(scan) != len(frame[2]):
                raise ValueError("only single-scan interleaved JPEGs are handled")
            return Header(frame[0], frame[1], frame[2], qtables, huffman, restart, scan,
                          bytes(data[pos:end]))
    raise ValueError("no SOS")


# -- Huffman decoding ------------------------------------------------------------

def _lookup(counts: np.ndarray, symbols: np.ndarray) -> Tuple[list, list]:
    """Per 16-bit window the (code length, symbol) of the canonical code it
    starts with (T.81 Annex C): two lists of 65536, length 0 for no code."""
    length = np.zeros(1 << 16, dtype=np.int64)
    value = np.zeros(1 << 16, dtype=np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(int(counts[n - 1])):
            lo, hi = code << (16 - n), (code + 1) << (16 - n)
            length[lo:hi], value[lo:hi] = n, symbols[k]
            code, k = code + 1, k + 1
        code <<= 1
    return length.tolist(), value.tolist()


def _segments(entropy: bytes) -> List[np.ndarray]:
    """The scan's restart intervals, each destuffed (FF00 -> FF)."""
    raw = np.frombuffer(entropy, dtype=np.uint8)
    ff = np.flatnonzero(raw[:-1] == 0xFF)
    nxt = raw[ff + 1]
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    bounds = [0, *(int(r) for r in rst), len(raw)]
    out = []
    for s, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg = raw[a + (2 if s else 0):b]
        stuffed = np.flatnonzero(seg[:-1] == 0xFF) + 1
        out.append(np.delete(seg, stuffed[seg[stuffed] == 0]))
    return out


def _windows16(seg: np.ndarray) -> list:
    """The 16 bits that start at each bit of a segment (1s past its end)."""
    bits = np.concatenate([np.unpackbits(seg), np.ones(32, dtype=np.uint8)]).astype(np.int64)
    w = np.zeros(bits.size - 16, dtype=np.int64)
    for k in range(16):
        w = (w << 1) | bits[k:k + w.size]
    return w.tolist()


def decode_coefficients(data: bytes) -> Tuple[Header, List[np.ndarray]]:
    """The header and the quantized coefficients of a baseline JPEG: per
    component a ``(vb, hb, 8, 8)`` int16 grid over the MCU-aligned block
    grid, natural order.  Raises ValueError on a stream that runs out."""
    hdr = parse(data)
    nvmb, nhmb = hdr.mcu_grid()
    out = [np.zeros((nvmb * v, nhmb * h, 64), dtype=np.int64) for _, h, v, _ in hdr.components]
    luts = {key: _lookup(*t) for key, t in hdr.huffman.items()}
    n_mcus = nvmb * nhmb
    per_seg = hdr.restart_interval or n_mcus
    segs = _segments(hdr.entropy)
    if len(segs) < -(-n_mcus // per_seg):
        raise ValueError("fewer restart intervals than the frame needs")
    zz = ZIGZAG.tolist()
    for s in range(-(-n_mcus // per_seg)):
        w = _windows16(segs[s])
        limit = len(w)
        pos = 0
        pred = [0] * len(hdr.components)
        for m in range(s * per_seg, min(n_mcus, (s + 1) * per_seg)):
            my, mx = divmod(m, nhmb)
            for ci, td, ta in hdr.scan:
                _, hs, vs, _ = hdr.components[ci]
                dcl, dcv = luts[(0, td)]
                acl, acv = luts[(1, ta)]
                for v in range(vs):
                    for h in range(hs):
                        if pos >= limit:
                            raise ValueError("the scan ran out of bits")
                        blk = out[ci][my * vs + v, mx * hs + h]
                        n = dcl[w[pos]]
                        if not n:
                            raise ValueError("no DC code")
                        size = dcv[w[pos]]
                        pos += n
                        diff = 0
                        if size:
                            diff = w[pos] >> (16 - size)
                            if diff < 1 << (size - 1):
                                diff -= (1 << size) - 1
                            pos += size
                        pred[ci] += diff
                        blk[0] = pred[ci]
                        k = 1
                        while k < 64:
                            n = acl[w[pos]]
                            if not n:
                                raise ValueError("no AC code")
                            rs = acv[w[pos]]
                            pos += n
                            run, size = rs >> 4, rs & 15
                            if not size:
                                if run != 15:
                                    break
                                k += 16
                                continue
                            k += run
                            val = w[pos] >> (16 - size)
                            if val < 1 << (size - 1):
                                val -= (1 << size) - 1
                            pos += size
                            blk[zz[k]] = val
                            k += 1
    return hdr, [c.reshape(c.shape[0], c.shape[1], 8, 8).astype(np.int16) for c in out]


# -- pixels ------------------------------------------------------------------------

# jidctint.c's constants: FIX(x) = round(x * 2**13).
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _butterfly(x: Sequence[np.ndarray]) -> List[np.ndarray]:
    """One 1-D pass of jpeg_idct_islow on inputs x[0..7] (frequency order),
    before descaling: 12 multiplications and 32 additions, then 8 more to
    form the outputs."""
    z1 = (x[2] + x[6]) * _F0541
    tmp2 = z1 - x[6] * _F1847
    tmp3 = z1 + x[2] * _F0765
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * _F1175
    o0, o1, o2, o3 = o0 * _F0298, o1 * _F2053, o2 * _F3072, o3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]


def idct_islow(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(..., 8, 8) quantized coefficients and an (8, 8) table -> (..., 8, 8)
    uint8 samples, bit for bit as libjpeg's jpeg_idct_islow: columns first
    (descaled by 11 bits), then rows (by 18), then its range limit, which
    wraps the 10-bit value and clamps it (``& RANGE_MASK`` into
    ``IDCT_range_limit``)."""
    c = coefs.astype(np.int64) * qtable.astype(np.int64)
    cols = _butterfly([c[..., k, :] for k in range(8)])
    ws = np.stack([(v + (1 << 10)) >> 11 for v in cols], axis=-2)
    rows = _butterfly([ws[..., k] for k in range(8)])
    out = np.stack([(v + (1 << 17)) >> 18 for v in rows], axis=-1) & 1023
    out = np.where(out >= 512, out - 1024, out)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _plane(blocks: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """A component's (vb, hb, 8, 8) coefficients -> its (8 vb, 8 hb) samples."""
    px = idct_islow(blocks, qtable)
    vb, hb = blocks.shape[:2]
    return px.transpose(0, 2, 1, 3).reshape(vb * 8, hb * 8)


def _fancy_h2v2(c: np.ndarray) -> np.ndarray:
    """libjpeg's h2v2_fancy_upsample of a (ch, cw) plane (its downsampled
    size; the rows above the first and below the last are the edge rows
    themselves) -> (2 ch, 2 cw): each output is 9/16, 3/16, 3/16, 1/16 of
    its four nearest inputs, the bias alternating 8 and 7."""
    c = c.astype(np.int64)
    above = np.concatenate([c[:1], c[:-1]])
    below = np.concatenate([c[1:], c[-1:]])
    out = np.empty((2 * c.shape[0], 2 * c.shape[1]), dtype=np.int64)
    for r, near in ((0, above), (1, below)):
        s = 3 * c + near
        left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        out[r::2, 0::2] = (3 * s + left + 8) >> 4
        out[r::2, 1::2] = (3 * s + right + 7) >> 4
    return out


def _fix16(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix16(1.40200) * _X + (1 << 15)) >> 16
_CB_B = (_fix16(1.77200) * _X + (1 << 15)) >> 16
_CR_G = -_fix16(0.71414) * _X
_CB_G = -_fix16(0.34414) * _X + (1 << 15)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert on (H, W) sample planes -> (H, W, 3) uint8."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def rgb(coefs: Sequence[np.ndarray], qtables: Sequence[np.ndarray],
        sampling: Sequence[Tuple[int, int]], height: int, width: int,
        upsample: str = "nearest") -> np.ndarray:
    """The (height, width, 3) uint8 RGB of a 3-component YCbCr frame from its
    quantized coefficients (per component ``(vb, hb, 8, 8)``, natural order)
    and each component's (8, 8) table.  ``upsample`` is "nearest" (each
    chroma sample repeated over the luma samples it covers) or "fancy"
    (libjpeg's filter; 2x2 chroma only, or none)."""
    if upsample not in ("nearest", "fancy"):
        raise ValueError(f"upsample must be 'nearest' or 'fancy', got {upsample!r}")
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    planes = []
    for blocks, q, (hs, vs) in zip(coefs, qtables, sampling):
        p = _plane(blocks, q)
        fx, fy = hmax // hs, vmax // vs
        if (fx, fy) != (1, 1):
            if upsample == "fancy":
                if (fx, fy) != (2, 2):
                    raise ValueError("fancy upsampling is implemented for 2x2 chroma only")
                # libjpeg filters the component at its own size: ceil(W * hs / hmax).
                p = _fancy_h2v2(p[:-(-height * vs // vmax), :-(-width * hs // hmax)])
            else:
                p = np.repeat(np.repeat(p, fy, axis=0), fx, axis=1)
        planes.append(p[:height, :width])
    return ycc_to_rgb(*planes)


def decode(data: bytes, upsample: str = "nearest") -> np.ndarray:
    """A baseline 3-component JPEG's RGB, entirely by this module."""
    hdr, coefs = decode_coefficients(data)
    return rgb(coefs, [hdr.quant(ci) for ci in range(len(coefs))], hdr.sampling,
               hdr.height, hdr.width, upsample)
