"""BASELINE configs 3 and 5 at their published sizes: four full-size frames,
the same bytes on every machine, and every card path over them.

    python -m jpeg_gpu_tpu_torch.testing.fullsize [--device cuda] [--out PATH]

========== ================== ================= ==============================
frame      size, sampling     restart markers   stands for
========== ================== ================= ==============================
8k-420-r1  7680x4320 4:2:0    one every MCU     config 5 ("8K ... restart
                              (129,600          segments"), as bench.py's 8K
                              segments)         rows build it
8k-420-r0  the same content   none              the real-file case: K3 at 8K
4k-444-r1  3840x2160 4:4:4    one every MCU     config 3's 4:4:4 half
4k-444-r0  the same content   none              4:4:4 through K3
========== ================== ================= ==============================

A frame is not encoded from pixels: no floating point lies on the way to
its bytes.  Its quantized coefficients are tiles of a committed source
frame's (``fullsize_src/``, quality 85, from the package's encoder; exact
integers out of the host entropy decode), laid over the frame's block grid
with a cyclic shift and a mirror chosen per tile by an integer hash, so
that neighbouring tiles differ (a mirror negates the odd frequencies of
every block: an exact transform).  They are entropy-coded here with
optimised Huffman tables (``encoder.gen_huffman_table``), the symbols and
amplitude bits of all blocks at once in numpy, and the bits packed as
integers.  So the bytes depend on the committed sources and this code only.

``fullsize_manifest.json`` holds each frame's sha256, byte length, MCU and
segment counts, and the checksums of the JAX package's decode (RGB nearest,
RGB fancy, the ``out="yuv"`` planes; its host path on the CPU, which is
bit-identical to its device path) and of libjpeg's fancy RGB.  The port
never imports the JAX package: :func:`build_manifest` takes the reference's
decode as an argument (``tests/test_torch_fullsize.py`` passes it; run that
file as a script to rebuild the manifest).

:func:`run` decodes every frame on a device through every path of the
single-image decoder -- host entropy, ``entropy="device"`` (K2's row form
at R=1; K3 and K2's fused form at R=0), ``out="yuv"`` (K5),
``upload="pack"`` (K4 then K5), ``exact=False`` (K6) and the sharded
``decode_image_device_sharded`` -- and holds each output to the manifest,
to the CPU port's decode of the same bytes and, sharded, to the unsharded
decode.  ``chip_smoke.py`` phase 12 runs it on the card; on the CPU it runs
at a reduced size in the tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import pathlib
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jpeg_gpu_tpu_torch.info import ceil_div
from jpeg_gpu_tpu_torch.ops.zigzag import ZIGZAG
from jpeg_gpu_tpu_torch.testing.encoder import (
    SAMPLING,
    _amplitude,
    _assign_codes,
    _csize,
    gen_huffman_table,
)

SOURCES = pathlib.Path(__file__).parent / "fullsize_src"
MANIFEST = pathlib.Path(__file__).parent / "fullsize_manifest.json"


@dataclasses.dataclass(frozen=True)
class Frame:
    name: str
    height: int
    width: int
    sampling: str
    restart: int     # MCUs per restart interval; 0 = no restart markers
    source: str      # file under SOURCES
    reduced: Tuple[int, int]   # (height, width) of the tests' frame: 18x30 MCUs


FRAMES = (
    Frame("8k-420-r1", 4320, 7680, "4:2:0", 1, "src-420.jpg", (288, 480)),
    Frame("8k-420-r0", 4320, 7680, "4:2:0", 0, "src-420.jpg", (288, 480)),
    Frame("4k-444-r1", 2160, 3840, "4:4:4", 1, "src-444.jpg", (144, 240)),
    Frame("4k-444-r0", 2160, 3840, "4:4:4", 0, "src-444.jpg", (144, 240)),
)
BY_NAME = {f.name: f for f in FRAMES}

# The committed sources: synthetic_rgb(h, w, seed=SOURCE_SEED) through the
# package's encoder at quality 85 (build_sources writes them).  16x24 MCUs
# each, so the reduced frames of the tests cross tile seams too.
SOURCE_SHAPES = {"src-420.jpg": ("4:2:0", 256, 384), "src-444.jpg": ("4:4:4", 128, 192)}
SOURCE_SEED = 12
SOURCE_QUALITY = 85

# Amplitude categories of a DC difference go up to 11, of an AC value to 10.
_MAX_AMPLITUDE = 2047
_CSIZE = np.array([_csize(v) for v in range(_MAX_AMPLITUDE + 1)], dtype=np.int64)
_AMP = np.array([_amplitude(v, _csize(v)) for v in range(-_MAX_AMPLITUDE, _MAX_AMPLITUDE + 1)],
                dtype=np.int64)


# -- the frames ----------------------------------------------------------------

def build_sources(out_dir=SOURCES) -> None:
    """Write the two source frames (how the committed files were made)."""
    from jpeg_gpu_tpu_torch.testing import corpus

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for name, (mode, h, w) in SOURCE_SHAPES.items():
        enc = corpus.own_jpeg(corpus.synthetic_rgb(h, w, seed=SOURCE_SEED), mode,
                              quality=SOURCE_QUALITY)
        (out / name).write_bytes(enc.data)


def source_coefficients(name: str):
    """(per-component (vb, hb, 8, 8) int16 coefficients, per-component (8, 8)
    quant tables) of a committed source, from the Python host entropy
    decode: exact integers on every machine."""
    from jpeg_gpu_tpu_torch.host import entropy
    from jpeg_gpu_tpu_torch.host.parser import parse

    parsed = parse((SOURCES / name).read_bytes())
    coefs = entropy.decode_scan(parsed).coefs
    hdr = parsed.header
    return ([np.asarray(c, dtype=np.int16) for c in coefs],
            [hdr.quant_for(c).values.astype(np.uint16) for c in hdr.components])


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser on uint64 (wrapping arithmetic)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def tile_coefficients(src: Sequence[np.ndarray], samp, nvmb: int, nhmb: int) -> List[np.ndarray]:
    """The frame's (nvmb * vs, nhmb * hs, 8, 8) int16 grid per component:
    tiles of the source's MCU grid, each cyclically shifted by whole MCUs
    and mirrored (vertically, horizontally) as an integer hash of its tile
    position says."""
    svmb = src[0].shape[0] // samp[0][1]
    shmb = src[0].shape[1] // samp[0][0]
    ty, tx = np.meshgrid(np.arange(ceil_div(nvmb, svmb), dtype=np.uint64),
                         np.arange(ceil_div(nhmb, shmb), dtype=np.uint64), indexing="ij")
    h = _mix(ty * np.uint64(1 << 20) + tx)
    shift_y = (h % np.uint64(svmb)).astype(np.int64)
    shift_x = ((h >> np.uint64(16)) % np.uint64(shmb)).astype(np.int64)
    flip_v = ((h >> np.uint64(32)) & np.uint64(1)).astype(np.int64)
    flip_h = ((h >> np.uint64(33)) & np.uint64(1)).astype(np.int64)
    u = np.arange(8)
    odd = (u % 2).astype(bool)
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
        grid = c[row, col]
        grid *= signs[fv, fh]
        out.append(grid)
    return out


def _scan_rows(coefs: Sequence[np.ndarray], samp, nvmb: int, nhmb: int):
    """Every block in scan order as (N, 64) zig-zag rows, with the Huffman
    table set of each row's component (0 luma, 1 chroma) per MCU slot."""
    per = [c.reshape(nvmb, vs, nhmb, hs, 64).transpose(0, 2, 1, 3, 4).reshape(nvmb, nhmb, vs * hs, 64)
           for c, (hs, vs) in zip(coefs, samp)]
    rows = np.concatenate(per, axis=2).reshape(-1, 64)[:, ZIGZAG]
    comp_of_slot = np.concatenate([np.full(hs * vs, ci) for ci, (hs, vs) in enumerate(samp)])
    return rows, comp_of_slot


def _marker(m: int, payload: bytes = b"") -> bytes:
    return bytes([0xFF, m]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _header(height, width, samp, qtables, dc_tables, ac_tables, restart) -> bytes:
    out = bytearray(b"\xff\xd8")
    out += _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    q_ids = [0] + [1] * (len(samp) - 1)
    for qi in sorted(set(q_ids)):
        q = qtables[q_ids.index(qi)]
        assert int(q.max()) <= 255
        out += _marker(0xDB, bytes([qi]) + q.reshape(64)[ZIGZAG].astype(np.uint8).tobytes())
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([len(samp)])
    for ci, (hs, vs) in enumerate(samp):
        sof += bytes([ci + 1, (hs << 4) | vs, q_ids[ci]])
    out += _marker(0xC0, sof)
    for cls, tables in ((0x00, dc_tables), (0x10, ac_tables)):
        for t, (counts, symbols) in enumerate(tables):
            out += _marker(0xC4, bytes([cls | t]) + counts.tobytes() + symbols.tobytes())
    if restart:
        out += _marker(0xDD, restart.to_bytes(2, "big"))
    sos = bytes([len(samp)])
    for ci in range(len(samp)):
        t = min(ci, 1)
        sos += bytes([ci + 1, (t << 4) | t])
    out += _marker(0xDA, sos + bytes([0, 63, 0]))
    return bytes(out)


def encode_coefficients(coefs: Sequence[np.ndarray], qtables, samp, height: int, width: int,
                        restart: int) -> bytes:
    """A baseline JPEG of exactly these quantized coefficients (per component
    (vb, hb, 8, 8) on the MCU-aligned grid, natural order), interleaved, one
    scan, optimised Huffman tables (luma set 0, chroma set 1), a restart
    marker every ``restart`` MCUs.  Every symbol of every block is made at
    once: the DC differences, each non-zero AC value's run (with ZRLs for
    runs over 15) and an EOB where the block ends before position 63; then
    each symbol's code and amplitude bits are laid at their bit offsets in
    32-bit words, each segment padded with 1 bits to a byte, stuffed, and
    split by RSTn markers."""
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    nhmb, nvmb = ceil_div(width, 8 * hmax), ceil_div(height, 8 * vmax)
    rows, comp_of_slot = _scan_rows(coefs, samp, nvmb, nhmb)
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

    n_tabs = 1 if len(samp) == 1 else 2
    freq = np.bincount(sel * 256 + sym, minlength=4 * 256).reshape(4, 256)
    tables = [gen_huffman_table(freq[s]) for s in range(4)]
    code = np.zeros((4, 256), dtype=np.int64)
    length = np.zeros((4, 256), dtype=np.int64)
    for s, (counts, symbols) in enumerate(tables):
        if s % 2 >= n_tabs:
            continue
        for v, (c, n) in _assign_codes(counts, symbols).items():
            code[s, v], length[s, v] = c, n
    bits = length[sel, sym] + size
    value = (code[sel, sym] << size) | amp
    assert (length[sel, sym] > 0).all()

    # Bit offsets: each segment starts on a byte, its tail padded with 1s.
    seg = (block_of // bpm // restart) if restart else np.zeros(n_events, np.int64)
    n_segments = int(seg_of_mcu[-1]) + 1
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
    return (_header(height, width, samp, qtables, tables[0:2][:n_tabs], tables[2:4][:n_tabs],
                    restart) + scan.tobytes() + b"\xff\xd9")


def frame_coefficients(frame: Frame, size: Optional[Tuple[int, int]] = None):
    """(coefficients, quant tables, sampling, height, width) of a frame, at
    its full size or at ``size`` = (height, width)."""
    height, width = size or (frame.height, frame.width)
    samp = list(SAMPLING[frame.sampling])
    src, qtables = source_coefficients(frame.source)
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    coefs = tile_coefficients(src, samp, ceil_div(height, 8 * vmax), ceil_div(width, 8 * hmax))
    return coefs, qtables, samp, height, width


def build(name: str, size: Optional[Tuple[int, int]] = None) -> bytes:
    """The bytes of frame ``name`` (:data:`FRAMES`), at full size or at
    ``size`` = (height, width)."""
    frame = BY_NAME[name]
    coefs, qtables, samp, height, width = frame_coefficients(frame, size)
    return encode_coefficients(coefs, qtables, samp, height, width, frame.restart)


# -- checksums and the manifest ----------------------------------------------------

def checksum(out) -> str:
    """sha256 of a decode's bytes: an RGB array, or the planes of
    ``out="yuv"`` one after another (anything with ``.planes``, or a list)."""
    planes = getattr(out, "planes", None)
    if planes is None:
        planes = out if isinstance(out, (list, tuple)) else [out]
    h = hashlib.sha256()
    for p in planes:
        h.update(np.ascontiguousarray(np.asarray(p)).tobytes())
    return h.hexdigest()


# The exact decodes held to the JAX package's checksums: kind -> (stage, upsample).
KINDS = {"rgb-nearest": ("rgb", "nearest"), "rgb-fancy": ("rgb", "fancy"),
         "yuv": ("yuv", "nearest")}


def facts(data: bytes) -> dict:
    """What the manifest records of a stream itself."""
    from jpeg_gpu_tpu_torch.host.parser import parse

    parsed = parse(data)
    return {"bytes": len(data), "sha256": hashlib.sha256(data).hexdigest(),
            "mcus": parsed.header.n_mcus, "segments": len(parsed.segments)}


def cpu_reference(data: bytes) -> dict:
    """The CPU port's decodes of ``data`` (host entropy): the checksum of each
    kind of :data:`KINDS`, and the ``exact=False`` RGB array itself."""
    import jpeg_gpu_tpu_torch as jt

    out = {kind: checksum(jt.decode(data, out=stage, device="cpu", upsample=ups))
           for kind, (stage, ups) in KINDS.items()}
    out["float"] = jt.decode(data, device="cpu", exact=False)
    return out


def build_manifest(reference: Callable[[bytes, str, str], object]) -> dict:
    """Build every frame, record its facts, the JAX package's checksums
    (``reference(data, stage, upsample)`` returns that package's decode) and
    libjpeg's fancy RGB (Pillow), and write :data:`MANIFEST`."""
    import jpeg_gpu_tpu_torch as jt

    entries = {}
    for f in FRAMES:
        data = build(f.name)
        entries[f.name] = {
            **dataclasses.asdict(f), **facts(data),
            "jax": {kind: checksum(reference(data, stage, ups))
                    for kind, (stage, ups) in KINDS.items()},
            "libjpeg": {"rgb-fancy": checksum(jt.decode(data, impl="pil"))},
        }
    manifest = {
        "sources": {name: hashlib.sha256((SOURCES / name).read_bytes()).hexdigest()
                    for name in SOURCE_SHAPES},
        "checksums": "sha256 of the decode's bytes; yuv: of the cropped planes in frame order",
        "jax": "the JAX package's host path on the CPU (jpeg_gpu_tpu.decode(impl='host'))",
        "libjpeg": "Pillow's RGB (libjpeg-turbo, fancy upsampling)",
        "frames": entries,
    }
    MANIFEST.write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


def load_manifest() -> dict:
    return json.loads(MANIFEST.read_text())


# -- every card path over the frames ------------------------------------------------

# (name, decoder options, output stage): the single-image paths.
PATHS = (
    ("auto nearest", {}, "rgb"),
    ("auto fancy", {"upsample": "fancy"}, "rgb"),
    ("device nearest", {"entropy": "device"}, "rgb"),
    ("device fancy", {"entropy": "device", "upsample": "fancy"}, "rgb"),
    ("device yuv", {"entropy": "device"}, "yuv"),
    ("pack fancy", {"upload": "pack", "upsample": "fancy"}, "rgb"),
    ("device float", {"entropy": "device", "exact": False}, "rgb"),
)
# (data, space) of the meshes of the sharded decode; each frame has 270 MCU
# rows, which space 4 does not divide.
MESHES = ((2, 2), (1, 2), (2, 1))
FLOAT_TO_CPU, FLOAT_TO_EXACT = 2, 4


def kernel_modules():
    """The modules of K1..K6, whose ``launches`` count each kernel launch."""
    from jpeg_gpu_tpu_torch.ops import (
        entropy_device, idct_float, idct_islow_plane, pack_device, pixel_fused,
        specsync_device,
    )

    return (pixel_fused, entropy_device, specsync_device, pack_device, idct_islow_plane,
            idct_float)


def expected_launches(path: str, restart: int) -> List[int]:
    """K1..K6 launches of one decode of ``path`` from an empty table cache:
    K2 decodes once per frame at R=1 (its row form) and twice without
    restart markers (its fused form and the DC predictors), K3 scans once;
    each builds its symbol tables once (K2's table kernel is counted as K2,
    K3's as K3).  Host entropy launches neither."""
    k = [0] * 6
    if "device" in path:
        k[1] = (1 if restart else 2) + 1
        k[2] = 0 if restart else 2
    if "pack" in path:
        k[3], k[4] = 1, 1
    elif "yuv" in path:
        k[4] = 1
    elif "float" in path:
        k[5] = 1
    else:
        k[0] = 1
    return k


def sharded_launches(data_shards: int, space: int, upsample: str, restart: int) -> List[int]:
    """K1..K6 launches of one decode_image_device_sharded on a mesh of one
    card, from an empty table cache: K2's row form once a data shard and its
    table kernel once, K3 once with its tables (no restart markers), K1
    (nearest) or K5 (fancy) once a space shard."""
    k = [0] * 6
    k[1] = data_shards + 1
    k[2] = 0 if restart else 2
    k[0 if upsample == "nearest" else 4] = space
    return k


def _max_diff(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def run(device=None, frames: Optional[Dict[str, bytes]] = None,
        expected: Optional[Dict[str, dict]] = None, cpu: Optional[Dict[str, dict]] = None,
        reps: int = 3, log=print) -> dict:
    """Decode every frame on ``device`` through :data:`PATHS` and the sharded
    decode on :data:`MESHES` (of that one device), and hold each output to
    its checks.  ``frames`` (name -> bytes) are built at full size when not
    given; ``expected`` (name -> manifest entry) is the manifest unless given
    (the tests give the JAX package's checksums of their reduced frames);
    ``cpu`` (name -> :func:`cpu_reference`) is computed when not given.  Each path's first decode is counted (its
    launches from an empty table cache, on the card its peak memory) and
    checked; then it is timed, best of ``reps`` (host clock, after a
    synchronize).  Returns the report: ``ok`` and ``failures``, and per
    frame its facts and per path and mesh what was seen."""
    import jpeg_gpu_tpu_torch as jt
    from jpeg_gpu_tpu_torch.engine import device_entropy
    from jpeg_gpu_tpu_torch.host import segments
    from jpeg_gpu_tpu_torch.host.parser import parse
    from jpeg_gpu_tpu_torch.parallel.mesh import make_mesh
    from jpeg_gpu_tpu_torch.utils.device import resolve_device

    device = resolve_device(device, "fullsize.run")
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    t_start = time.perf_counter()
    kernels = kernel_modules()
    if expected is None:
        expected = load_manifest()["frames"]
    failures: List[str] = []
    total = [0] * 6
    report = {"device": str(device), "frames": {}}

    def check(ok: bool, what: str) -> bool:
        if not ok:
            failures.append(what)
            log(f"FAILED: {what}")
        return ok

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def counted(fn):
        """fn() from an empty table cache, counts at 0: (out, launches, the
        most device memory it held at once beyond what was allocated before)."""
        device_entropy._DEVICE_TABLES.clear()
        sync()
        for mod in kernels:
            mod.launches = 0
        base = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        out = fn()
        sync()
        counts = [mod.launches for mod in kernels]
        total[:] = [a + b for a, b in zip(total, counts)]
        return out, counts, torch.cuda.max_memory_allocated(device) - base if cuda else None

    def best_of(fn) -> List[float]:
        runs = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            runs.append((time.perf_counter() - t0) * 1e3)
        return runs

    for f in FRAMES:
        data = frames[f.name] if frames else build(f.name)
        want = expected[f.name]
        fact = facts(data)
        rec = {"facts": fact, "paths": {}, "sharded": {}}
        report["frames"][f.name] = rec
        if not check(fact["sha256"] == want["sha256"],
                     f"{f.name}: sha256 {fact['sha256']} is not the manifest's {want['sha256']}"):
            continue
        ref = (cpu or {}).get(f.name) or cpu_reference(data)
        parsed = parse(data)
        hdr = parsed.header
        rec["facts"].update(
            height=hdr.height, width=hdr.width,
            coefficient_bytes=sum(c.vblocks * c.hblocks for c in hdr.components) * 128,
            rgb_bytes=hdr.height * hdr.width * 3)
        log(f"{f.name}: {json.dumps(rec['facts'])}")
        if not f.restart:
            inp = segments.build_spec_scan_input(parsed, sb_target=device_entropy.SCAN_SB_TARGET)
            rec["scan"] = {"windows": list(inp.windows.shape), "subseq_bytes": inp.subseq_bytes,
                           "lanes": -(-inp.n_bits // (8 * inp.subseq_bytes))}
        outs = {}
        for name, kw, stage in PATHS:
            dec = jt.get_decoder(data, device=device, **kw)
            out, counts, peak = counted(lambda: dec.decode(stage))
            outs[name] = out
            p = {"launches": counts, "peak_bytes": peak}
            rec["paths"][name] = p
            what = f"{f.name} {name}"
            if cuda:
                want_k = expected_launches(name, f.restart)
                check(counts == want_k, f"{what}: launches {counts}, expected {want_k}")
            if kw.get("entropy") == "device":
                # Neither the host fallback nor the serial index scan ran.
                check(dec._scan is None and dec._scan_soa is None,
                      f"{what}: the host entropy decode ran")
                p["specsync_stats"] = (None if dec.specsync_stats is None
                                       else [int(x) for x in dec.specsync_stats])
                if not f.restart:
                    check(dec.specsync_stats is not None, f"{what}: the index scan fell back")
            if kw.get("exact", True):
                kind = f"rgb-{kw.get('upsample', 'nearest')}" if stage == "rgb" else "yuv"
                got = checksum(out)
                p["checksum"] = got
                check(got == want["jax"][kind], f"{what}: checksum is not the JAX package's")
                check(got == ref[kind], f"{what}: not equal to the CPU port's decode")
                if kind in want.get("libjpeg", {}):
                    check(got == want["libjpeg"][kind], f"{what}: not equal to libjpeg's")
            else:
                p["max_diff_cpu"] = _max_diff(out, ref["float"])
                p["max_diff_exact"] = _max_diff(out, outs["device nearest"])
                check(p["max_diff_cpu"] <= FLOAT_TO_CPU and p["max_diff_exact"] <= FLOAT_TO_EXACT,
                      f"{what}: {p['max_diff_cpu']} from the CPU port's exact=False (allowed "
                      f"{FLOAT_TO_CPU}), {p['max_diff_exact']} from the exact decode (allowed "
                      f"{FLOAT_TO_EXACT})")
            p["ms"] = best_of(lambda: jt.get_decoder(data, device=device, **kw).decode(stage))
            log(f"{what}: launches {counts}, peak {peak} B, ms {p['ms']}"
                + (f", scan stats {p['specsync_stats']}" if "specsync_stats" in p else ""))
        for d, s in MESHES:
            mesh = make_mesh(devices=[device] * (d * s), space=s)
            for ups in ("nearest", "fancy"):
                got, counts, peak = counted(lambda: device_entropy.decode_image_device_sharded(
                    parse(data), mesh, upsample=ups))
                what = f"{f.name} sharded (data={d}, space={s}) {ups}"
                rec["sharded"][f"({d}, {s}) {ups}"] = {"launches": counts, "peak_bytes": peak}
                check(np.array_equal(got, outs[f"device {ups}"]),
                      f"{what}: not equal to the unsharded decode")
                if cuda:
                    want_k = sharded_launches(d, s, ups, f.restart)
                    check(counts == want_k, f"{what}: launches {counts}, expected {want_k}")
                log(f"{what}: equal {np.array_equal(got, outs[f'device {ups}'])}, launches "
                    f"{counts}, peak {peak} B")
        if not f.restart:
            # The sharded decode's index scan path, not the serial scan's.
            d, s = MESHES[0]
            check(device_entropy._spec_decode_sharded_try(
                parse(data), make_mesh(devices=[device] * (d * s), space=s), True, "nearest",
                True) is not None, f"{f.name}: the sharded index scan fell back")
    report.update(ok=not failures, failures=failures, launches=total,
                  seconds=time.perf_counter() - t_start)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The four full-size frames through every path")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="write the report as JSON here")
    args = ap.parse_args(argv)
    from jpeg_gpu_tpu_torch import cuda_build
    from jpeg_gpu_tpu_torch.utils.device import resolve_device

    t0 = time.perf_counter()
    if resolve_device(args.device, "fullsize").type == "cuda":
        from jpeg_gpu_tpu_torch.testing.sweep import card_line

        print(f"card: {card_line()}")
        cuda_build.load_all(["pixel_fused", "entropy_decode", "specsync_scan", "pack_expand",
                             "idct_islow_plane", "idct_float"])
        print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    frames = {}
    for f in FRAMES:
        t = time.perf_counter()
        frames[f.name] = build(f.name)
        print(f"built {f.name}: {len(frames[f.name])} B in {time.perf_counter() - t:.2f} s")
    report = run(args.device, frames=frames)
    print(f"{'ok' if report['ok'] else 'FAILED'}: launches {report['launches']} (K1..K6), "
          f"{time.perf_counter() - t0:.1f} s")
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
