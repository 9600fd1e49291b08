"""Garbage in on every path of the port: a seeded fuzz and its runner.

The JAX package promises that arbitrary bytes raise ``JpegError`` or decode,
never anything else (``tests/test_fuzz.py``).  There the device side keeps
the promise by construction: XLA clamps gather indices and the Pallas
kernels fetch through masks.  In the port K2 and K3 are hand-written CUDA
whose addresses come from the bitstream, so the promise has to be shown on
the card, through every entry point a user calls.

:func:`cases` makes the inputs from ``numpy.random.default_rng(seed)`` alone:
the 20 committed SWEEP_r05 frames and frames of the port's own encoder, with
and without restart markers, each mutated in one named way (the
reference's random bytes, truncations and bit flips, and marker-aware
mutations of DQT, DHT, SOF, SOS, DRI, the restart markers, the byte
stuffing, a second SOS and a cut EOI).  :func:`run` sends every case through
the paths of :data:`PATHS` and records, per (case, path), "decoded", the
name of the ``JpegError`` class, or a violation (anything else).  On a CUDA
device it synchronises after each case; a CUDA error stops the run, since
the context is gone.  With ``compare_cpu`` each card outcome is held to the
port's own CPU outcome on the same bytes.  Run it as

    python -m jpeg_gpu_tpu_torch.testing.fuzz [--device cuda] [--seed S] [--n N] [--kernels K]

``--device`` is the card by default; the CPU runs only with ``--device
cpu``.  The command exits 1 on any violation, CPU mismatch or CUDA error.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from jpeg_gpu_tpu_torch.errors import JpegError

# Marker codes (host/parser.py).
SOF0, DHT, EOI, SOS, DQT, DRI = 0xC0, 0xC4, 0xD9, 0xDA, 0xDB, 0xDD
RST0, RST7 = 0xD0, 0xD7

KINDS = (
    "random", "truncate", "bitflip",
    "dqt", "dht_overfill", "dht_sum", "dht_symbol",
    "sof_dims", "sof_samp", "sos_table", "dri",
    "rst_remove", "rst_dup", "rst_order", "stuff_drop", "sos_second", "eoi_cut",
)
# Kinds that need restart markers in the source's scan.
RST_KINDS = ("rst_remove", "rst_dup", "rst_order")

# Frames of the port's encoder: (name, geometry, (h, w), restart interval, seed).
OWN_SOURCES = (
    ("own-420-r0", "4:2:0", (40, 48), 0, 1),
    ("own-420-r1", "4:2:0", (24, 32), 1, 1),
    ("own-422-r0", "4:2:2", (40, 56), 0, 2),
    ("own-422-r2", "4:2:2", (32, 48), 2, 2),
    ("own-gray-r0", "gray", (24, 24), 0, 2),
    ("own-h2v4-r1", "h2v4", (24, 24), 1, 3),
    ("own-411-r0", "4:1:1", (24, 64), 0, 4),
)

PATHS = (
    "auto", "python", "device", "pack", "float", "yuv", "zero",
    "batch", "batch_device", "resident", "batch_mesh", "batch_device_mesh",
)
# Paths whose output is exact: on the card equal to the CPU bit for bit.
# "float" (exact=False) is held within FLOAT_TOL on RGB (ROADMAP.md Queue 3,
# "Float path across packages": sums in another order).
FLOAT_TOL = 2


class Source(NamedTuple):
    """A valid frame the mutations start from."""

    name: str
    geometry: str
    restart: int
    data: bytes


def sources() -> List[Source]:
    """The 20 SWEEP_r05 frames, then :data:`OWN_SOURCES`, in that order."""
    from jpeg_gpu_tpu_torch.testing import corpus, sweep

    manifest = sweep.load_manifest()
    out = []
    for e in manifest["sweep"]:
        out.append(Source(f"sweep{e['i']:02d}", e["mode"], e["restart"],
                          sweep.read_fixture(sweep.FIXTURES, e)))
    for name, geom, (h, w), restart, seed in OWN_SOURCES:
        img = (corpus.synthetic_gray(h, w, seed=seed) if geom == "gray"
               else corpus.synthetic_rgb(h, w, seed=seed))
        enc = corpus.own_jpeg(img, subsampling="4:2:0" if geom == "gray" else geom,
                              quality=85, restart_interval=restart)
        out.append(Source(name, geom, restart, enc.data))
    return out


# -- the stream's layout ------------------------------------------------------

def markers(data: bytes) -> Tuple[List[Tuple[int, int, int]], int, int]:
    """The marker segments before the scan data, as (marker, start, end)
    with ``start`` at the 0xFF and ``end`` past the segment, and the scan
    data's span [scan_start, scan_end): from after the SOS header to the
    first marker that is neither a stuffed 0xFF00 nor RSTn.  A stream
    without an SOS gives scan_start = scan_end = len(data)."""
    segs = []
    i = 2
    n = len(data)
    while i + 4 <= n and data[i] == 0xFF:
        m = data[i + 1]
        if m == 0xFF:        # fill byte
            i += 1
            continue
        end = i + 2 + (data[i + 2] << 8 | data[i + 3])
        segs.append((m, i, min(end, n)))
        if m == SOS:
            j = end
            while j + 1 < n and not (data[j] == 0xFF and data[j + 1] != 0
                                     and not RST0 <= data[j + 1] <= RST7):
                j += 1
            return segs, min(end, n), min(j, n) if j + 1 < n else n
        i = end
    return segs, n, n


def _find(segs, marker):
    return [(s, e) for m, s, e in segs if m == marker]


def _rst_positions(data: bytes, lo: int, hi: int) -> List[int]:
    return [j for j in range(lo, hi - 1) if data[j] == 0xFF and RST0 <= data[j + 1] <= RST7]


def _mcu_size(data: bytes, sof: Tuple[int, int]) -> Tuple[int, int]:
    """(height, width) in pixels of one MCU of the frame's SOF0."""
    s = sof[0]
    nf = data[s + 9]
    hmax = max(data[s + 11 + 3 * c] >> 4 for c in range(nf)) or 1
    vmax = max(data[s + 11 + 3 * c] & 15 for c in range(nf)) or 1
    return (8 * vmax, 8 * hmax) if nf > 1 else (8, 8)


# -- the mutations ------------------------------------------------------------

def _mutate(kind: str, src: Source, rng: np.random.Generator) -> Optional[Tuple[str, bytes]]:
    """One mutation of ``src``: (detail, bytes), or None where the source
    has nothing for this kind to mutate."""
    data = src.data
    buf = bytearray(data)
    segs, scan0, scan1 = markers(data)
    if kind == "truncate":
        cut = int(rng.integers(1, len(data)))
        return f"at={cut}", data[:cut]
    if kind == "bitflip":
        nflip = int(rng.integers(1, 4))
        where = []
        for _ in range(nflip):
            pos = int(rng.integers(scan0, scan1))
            bit = int(rng.integers(0, 8))
            buf[pos] ^= 1 << bit
            where.append(f"{pos}.{bit}")
        return "flip=" + ",".join(where), bytes(buf)
    if kind == "dqt":
        (s, e), = _find(segs, DQT)[:1] or [(None, None)]
        if s is None:
            return None
        value = int(rng.choice([0, 0xFF]))
        # The first table's 64 entries (8-bit precision in every source).
        first = s + 5
        if rng.integers(0, 2):
            idx = np.arange(64)
        else:
            idx = rng.choice(64, size=int(rng.integers(1, 9)), replace=False)
        for k in idx:
            buf[first + int(k)] = value
        return f"value={value:#x},entries={len(idx)}", bytes(buf)
    dhts = _find(segs, DHT)
    if kind in ("dht_overfill", "dht_sum", "dht_symbol"):
        if not dhts:
            return None
        s, e = dhts[int(rng.integers(len(dhts)))]
        counts_at = s + 5                   # the first table of the segment
        counts = list(buf[counts_at:counts_at + 16])
        tc = buf[s + 4] >> 4
        if kind == "dht_overfill":
            # More codes of length L than L bits can hold, the sum kept so
            # that the segment's symbols still line up.
            length = int(rng.integers(1, 5))
            want = (1 << length) + 1
            extra = want - counts[length - 1]
            counts[length - 1] = want
            for j in range(15, -1, -1):
                if j == length - 1 or extra <= 0:
                    continue
                take = min(counts[j], extra)
                counts[j] -= take
                extra -= take
            buf[counts_at:counts_at + 16] = bytes(counts)
            return f"L={length},count={want},tc={tc}", bytes(buf)
        if kind == "dht_sum":
            a, b = (int(x) for x in rng.choice(16, size=2, replace=False))
            counts[a] = counts[b] = 255
            buf[counts_at:counts_at + 16] = bytes(counts)
            return f"counts[{a}]=counts[{b}]=255,tc={tc}", bytes(buf)
        nsym = sum(counts)
        if nsym == 0:
            return None
        k = int(rng.integers(nsym))
        # DC: a size above 15 (or 11, baseline's bound); AC: size 0 with a
        # run other than 0 (EOB) or 15 (ZRL), or a size above 10.
        sym = int(rng.choice([0x10, 0x1F, 0xFF, 0x0C]) if tc == 0
                  else rng.choice([0x50, 0x0B, 0x0F, 0xFF, 0x30]))
        buf[counts_at + 16 + k] = sym
        return f"tc={tc},symbol[{k}]={sym:#x}", bytes(buf)
    sofs = _find(segs, SOF0)
    if kind in ("sof_dims", "sof_samp"):
        if not sofs:
            return None
        s, _ = sofs[0]
        if kind == "sof_dims":
            mh, mw = _mcu_size(data, sofs[0])
            choices = [0, 1, 16000, 65535]
            h = int(rng.choice(choices + [mh - 1, mh + 1]))
            w = int(rng.choice(choices + [mw - 1, mw + 1]))
            if rng.integers(0, 4) == 0:
                h = w = 16000
            which = int(rng.integers(0, 3))      # height, width or both
            old_h, old_w = data[s + 5] << 8 | data[s + 6], data[s + 7] << 8 | data[s + 8]
            h = h if which != 1 else old_h
            w = w if which != 0 else old_w
            buf[s + 5:s + 9] = bytes([h >> 8, h & 255, w >> 8, w & 255])
            return f"h={h},w={w}", bytes(buf)
        nf = data[s + 9]
        c = int(rng.integers(nf))
        value = int(rng.choice([0, 3]))
        vertical = int(rng.integers(0, 2))
        at = s + 11 + 3 * c
        buf[at] = (buf[at] & 0xF0) | value if vertical else (buf[at] & 0x0F) | (value << 4)
        return f"comp={c},{'v' if vertical else 'h'}={value}", bytes(buf)
    soss = _find(segs, SOS)
    if kind == "sos_table":
        if not soss:
            return None
        s, _ = soss[0]
        ns = data[s + 4]
        c = int(rng.integers(ns))
        ac = int(rng.integers(0, 2))
        defined = set()
        for ds, de in dhts:
            j = ds + 4
            while j + 17 <= de:
                tcth = data[j]
                if (tcth >> 4) == ac:
                    defined.add(tcth & 15)
                j += 17 + sum(data[j + 1:j + 17])
        free = [t for t in range(4) if t not in defined] or [3]
        tid = int(rng.choice(free))
        at = s + 6 + 2 * c
        buf[at] = (buf[at] & 0xF0) | tid if ac else (buf[at] & 0x0F) | (tid << 4)
        return f"comp={c},{'ac' if ac else 'dc'}={tid}", bytes(buf)
    if kind == "dri":
        interval = int(rng.choice([0, 1, 65535]))
        dris = _find(segs, DRI)
        if dris:
            s, _ = dris[0]
            buf[s + 4:s + 6] = bytes([interval >> 8, interval & 255])
            return f"interval={interval}", bytes(buf)
        if not soss:
            return None
        s, _ = soss[0]
        seg = bytes([0xFF, DRI, 0, 4, interval >> 8, interval & 255])
        return f"interval={interval},inserted", bytes(buf[:s]) + seg + bytes(buf[s:])
    if kind in RST_KINDS:
        rsts = _rst_positions(data, scan0, scan1)
        if not rsts:
            return None
        at = rsts[int(rng.integers(len(rsts)))]
        if kind == "rst_remove":
            return f"at={at}", bytes(buf[:at] + buf[at + 2:])
        if kind == "rst_dup":
            return f"at={at}", bytes(buf[:at + 2] + buf[at:])
        new = RST0 + (buf[at + 1] - RST0 + int(rng.integers(1, 8))) % 8
        buf[at + 1] = new
        return f"at={at},rst{new - RST0}", bytes(buf)
    if kind == "stuff_drop":
        stuffed = [j for j in range(scan0, scan1 - 1) if data[j] == 0xFF and data[j + 1] == 0]
        if not stuffed:
            return None
        at = stuffed[int(rng.integers(len(stuffed)))]
        return f"at={at}", bytes(buf[:at + 1] + buf[at + 2:])
    if kind == "sos_second":
        if not soss:
            return None
        s, e = soss[0]
        if rng.integers(0, 2):
            at = int(rng.integers(scan0, scan1 + 1))
            where = f"mid={at}"
        else:
            at = scan1
            where = "end"
        return where, bytes(buf[:at]) + data[s:e] + bytes(buf[at:])
    if kind == "eoi_cut":
        if data[-2:] != bytes([0xFF, EOI]):
            return None
        cut = int(rng.integers(0, 3))       # the marker, and up to 2 bytes before it
        return f"bytes={2 + cut}", data[: len(data) - 2 - cut]
    raise ValueError(f"unknown mutation {kind!r}")


def cases(seed: int, n: int, srcs: Optional[Sequence[Source]] = None) -> Iterator[Tuple[str, bytes]]:
    """``n`` seeded garbage inputs as (name, bytes); the same seed gives the
    same bytes.  Case i takes mutation ``KINDS[i % len(KINDS)]`` and a
    source drawn from ``srcs`` (default :func:`sources`), a restart-marked
    one for the RST kinds; a name reads ``i:source:kind:detail``.  The
    random-bytes kind has no source (its lengths are the reference's: 0, 1,
    2, 16, 256, 4096, or any up to 4096)."""
    srcs = list(sources() if srcs is None else srcs)
    rng = np.random.default_rng(seed)
    with_rst = [s for s in srcs if s.restart]
    for i in range(n):
        kind = KINDS[i % len(KINDS)]
        if kind == "random":
            size = int(rng.choice([0, 1, 2, 16, 256, 4096, int(rng.integers(0, 4097))]))
            yield f"{i}:-:random:n={size}", rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            continue
        pool = with_rst if kind in RST_KINDS else srcs
        while True:
            src = pool[int(rng.integers(len(pool)))]
            made = _mutate(kind, src, rng)
            if made is not None:
                break
        detail, data = made
        yield f"{i}:{src.name}:{kind}:{detail}", data


def claimed_frame_case(size: int = 16000) -> bytes:
    """The stream that once made the port allocate by a claimed frame size:
    a 48x40 4:2:0 frame without restart markers (about 1 KB of scan) whose
    SOF claims ``size`` x ``size``.  The reference raises JpegFormatError on
    it at 16000."""
    from jpeg_gpu_tpu_torch.testing import corpus

    enc = corpus.own_jpeg(corpus.synthetic_rgb(40, 48, seed=1), "4:2:0", quality=85)
    buf = bytearray(enc.data)
    (s, _), = _find(markers(enc.data)[0], SOF0)
    buf[s + 5:s + 9] = bytes([size >> 8, size & 255] * 2)
    return bytes(buf)


def two_segment_case() -> bytes:
    """Two mutations at once, which one case of :func:`cases` never makes: a
    32x16 4:2:0 frame with a restart marker after its first MCU (two
    segments), its DRI raised to 65535 and its SOF claiming 41120x816, that
    is 131070 MCUs or two intervals.  No single segment is refused, and a
    plan of it sizes K2's output by the interval: 51 GB."""
    from jpeg_gpu_tpu_torch.testing import corpus

    enc = corpus.own_jpeg(corpus.synthetic_rgb(16, 32, seed=1), "4:2:0", quality=85,
                          restart_interval=1)
    buf = bytearray(enc.data)
    segs = markers(enc.data)[0]
    (s, _), = _find(segs, SOF0)
    buf[s + 5:s + 9] = bytes([816 >> 8, 816 & 255, 41120 >> 8, 41120 & 255])
    (d, _), = _find(segs, DRI)
    buf[d + 4:d + 6] = bytes([0xFF, 0xFF])
    return bytes(buf)


# -- the runner ---------------------------------------------------------------

def _single(path: str, data: bytes, device):
    import jpeg_gpu_tpu_torch as jt

    kwargs = {
        "auto": {}, "python": {"entropy": "python"}, "device": {"entropy": "device"},
        "pack": {"upload": "pack"}, "float": {"exact": False}, "yuv": {},
        "zero": {"entropy": "device", "on_error": "zero"},
    }[path]
    out = jt.decode(data, out="yuv" if path == "yuv" else "rgb", device=device, **kwargs)
    return out.planes if path == "yuv" else [out]


def _block_rows_even(data: bytes) -> bool:
    """Every component's block rows split over a space axis of 2 (a frame
    that does not parse answers True: it fails before the mesh is used)."""
    from jpeg_gpu_tpu_torch.engine.decoder import decode_header

    try:
        hdr = decode_header(data)
    except JpegError:
        return True
    return all((hdr.nvmb * c.vsamp) % 2 == 0 for c in hdr.components)


def _one_bucket(corpus: List[bytes]) -> bool:
    from jpeg_gpu_tpu_torch.engine.batch import _device_buckets

    try:
        buckets, _ = _device_buckets(corpus, True, "nearest")
    except JpegError:
        return True
    return len(buckets) <= 1


def _corpus(path: str, data: bytes, valid: bytes, device):
    """A corpus path on [valid, case]: the case beside a valid frame of its
    source.  decode_batch_device_resident takes one bucket, so where the
    case's header or restart structure puts it in another bucket, it gets
    [case, case].  The mesh paths use a (2, 2) mesh that names ``device``
    four times, or (4, 1) where a frame's block rows do not split in two."""
    from jpeg_gpu_tpu_torch.engine import batch
    from jpeg_gpu_tpu_torch.parallel.mesh import make_mesh

    corpus = [valid, data]
    if path == "batch":
        return batch.decode_batch(corpus, device=device)
    if path == "batch_device":
        return batch.decode_batch_device(corpus, device=device)
    if path == "resident":
        if not _one_bucket(corpus):
            corpus = [data, data]
        rgb, err = batch.decode_batch_device_resident(corpus, device=device)
        return [rgb.cpu().numpy(), err.cpu().numpy()]
    space = 2 if all(_block_rows_even(d) for d in corpus) else 1
    mesh = make_mesh(devices=[device] * 4, space=space)
    if path == "batch_mesh":
        return batch.decode_batch(corpus, mesh=mesh)
    if path == "batch_device_mesh":
        return batch.decode_batch_device(corpus, mesh=mesh)
    raise ValueError(f"unknown path {path!r}")


def call(path: str, data: bytes, valid: bytes, device) -> Tuple[str, Optional[list]]:
    """One (case, path): ("decoded", arrays) or (the JpegError class name,
    None).  Anything else propagates."""
    try:
        if path in ("batch", "batch_device", "resident", "batch_mesh", "batch_device_mesh"):
            arrays = _corpus(path, data, valid, device)
        else:
            arrays = _single(path, data, device)
    except JpegError as e:
        return type(e).__name__, None
    return "decoded", [np.asarray(a) for a in arrays]


def _is_cuda_error(e: BaseException) -> bool:
    accel = getattr(torch, "AcceleratorError", None)
    return (accel is not None and isinstance(e, accel)) or "CUDA error" in str(e)


def _same(a: list, b: list, tol: int) -> Optional[str]:
    """None where two calls' arrays agree within ``tol``, else what differs."""
    if len(a) != len(b):
        return f"{len(a)} arrays against {len(b)}"
    for j, (x, y) in enumerate(zip(a, b)):
        if x.shape != y.shape:
            return f"array {j}: shape {x.shape} against {y.shape}"
        diff = np.abs(x.astype(np.int64) - y.astype(np.int64)).max(initial=0)
        if diff > tol:
            return f"array {j}: max abs diff {int(diff)}"
    return None


# The two bytes every CUDA tensor from torch.empty holds at birth in the two
# calls of a poisoned (case, path), and the red zone on each side of it.
POISON = (0xA5, 0x5A)
RED_ZONE = 4096


class RedZones:
    """The red zones of the CUDA tensors that ``torch.empty`` made inside a
    :func:`poisoned_empty` block: each tensor is the middle of a buffer whose
    first and last RED_ZONE bytes hold the poison byte."""

    def __init__(self, byte: int):
        self.byte = byte
        self.buffers: List[torch.Tensor] = []

    def written(self) -> int:
        """How many tensors had a byte of a red zone changed (a write past
        either end); the buffers are released."""
        bad = sum(not bool(((b[:RED_ZONE] == self.byte) & (b[-RED_ZONE:] == self.byte)).all())
                  for b in self.buffers)
        self.buffers = []
        return bad


@contextlib.contextmanager
def poisoned_empty(byte: int):
    """Within the block every CUDA tensor that ``torch.empty`` makes -- each
    kernel wrapper's outputs and scratch, and the engine's uploads
    (``plan_tensors``) -- starts filled with ``byte`` and sits between two
    red zones of RED_ZONE bytes of ``byte``.  An output slot that no kernel
    writes, or a read past either end of such a tensor, then shows the byte;
    a write past either end changes a red zone.  Yields the
    :class:`RedZones` to check after the block."""
    real = torch.empty
    zones = RedZones(byte)

    def empty(*args, **kwargs):
        t = real(*args, **kwargs)
        if not t.is_cuda or not t.numel():
            return t
        nbytes = t.numel() * t.element_size()
        buf = real(nbytes + 2 * RED_ZONE, dtype=torch.uint8, device=t.device)
        buf.fill_(byte)
        zones.buffers.append(buf)
        return buf[RED_ZONE:RED_ZONE + nbytes].view(t.dtype).view(t.shape)

    torch.empty = empty
    try:
        yield zones
    finally:
        torch.empty = real


def run(device=None, seed: int = 0, n: int = 100, paths: Sequence[str] = PATHS,
        compare_cpu=False, srcs: Optional[Sequence[Source]] = None,
        clean: bool = False, poisoned: Sequence[str] = ()) -> dict:
    """Every case of ``cases(seed, n)`` through every path of ``paths`` on
    ``device`` (None: the card, which raises without one).  With ``clean``
    the cases are the sources themselves, unmutated (``n`` and ``seed`` are
    not used): the valid frames through the same paths, which reach every
    kernel (K4 through "pack", K6 through "float").

    ``compare_cpu``: True holds every (case, path) to the port's CPU outcome
    on the same bytes, a collection of path names only those paths; False
    none.  The outcome names must agree and decoded arrays must be equal
    (within FLOAT_TOL on "float").

    ``poisoned`` (a CUDA device only): paths whose every case runs twice,
    under :func:`poisoned_empty` with each byte of POISON, and must give the
    same outcome and the same arrays bit for bit both times, with every red
    zone intact: the stand-in, inside the process, for compute-sanitizer's
    initcheck (a slot of a kernel's output or scratch that nothing writes
    before it is read) and for memcheck on the tensors torch.empty makes (a
    read or write past either end).  Both calls' launches count.

    Returns a dict: ``pairs`` run, ``by_path`` (path -> outcome -> count),
    ``launches`` (path -> K1..K6 launches), ``device_decoded_via`` (how many
    "decoded" on the ``device`` and ``zero`` paths launched K2, and how many
    took the host fallback), ``violations`` (case, path, exception) and
    ``mismatches`` against the CPU, ``cuda_error`` (the case and path at
    which the context was lost, and the error; the run stops there) and
    ``poisoned_pairs`` and ``poison_mismatches``, and ``ok``: no violation,
    no mismatch of either kind, no CUDA error.
    """
    from jpeg_gpu_tpu_torch.testing import sweep
    from jpeg_gpu_tpu_torch.utils.device import resolve_device

    device = resolve_device(device, "fuzz.run")
    cuda = device.type == "cuda"
    cpu = torch.device("cpu")
    compare = set(paths) if compare_cpu is True else set(compare_cpu or ())
    srcs = list(sources() if srcs is None else srcs)
    valid_of = {s.name: s.data for s in srcs}
    default_valid = valid_of.get("own-420-r1", srcs[0].data)
    by_path: Dict[str, Dict[str, int]] = {p: {} for p in paths}
    launches = {p: [0] * 6 for p in paths}
    via = {p: {"kernel": 0, "host_fallback": 0} for p in ("device", "zero") if p in paths}
    poisoned = set(poisoned) if cuda else set()
    violations, mismatches, poison_mismatches = [], [], []
    cuda_error = None
    pairs = compared = n_poisoned = 0
    t0 = time.perf_counter()
    inputs = ([(f"{s.name}:clean", s.data) for s in srcs] if clean
              else cases(seed, n, srcs))

    def attempt(name, path, data, valid):
        """call() on the device: (outcome, arrays), a violation recorded, or
        None where the CUDA context is lost (cuda_error set)."""
        nonlocal cuda_error
        try:
            outcome, arrays = call(path, data, valid, device)
            if cuda:
                torch.cuda.synchronize(device)
            return outcome, arrays
        except Exception as e:   # noqa: BLE001 -- every other exception is the finding
            error = {"case": name, "path": path, "error": f"{type(e).__name__}: {e}"[:500]}
            if cuda and _is_cuda_error(e):
                cuda_error = error
                return None
            violations.append(error)
            return f"violation:{type(e).__name__}", None

    for name, data in inputs:
        valid = valid_of.get(name.split(":")[1], default_valid)
        for path in paths:
            before = sweep.launch_counts()
            with poisoned_empty(POISON[0]) if path in poisoned else contextlib.nullcontext() as z0:
                got = attempt(name, path, data, valid)
            if got is None:
                break
            outcome, arrays = got
            if path in poisoned and not outcome.startswith("violation"):
                with poisoned_empty(POISON[1]) as z1:
                    again = attempt(name, path, data, valid)
                if again is None:
                    break
                n_poisoned += 1
                written = z0.written() + z1.written()
                why = (f"{written} red zones written" if written
                       else f"{outcome}, then {again[0]}" if again[0] != outcome
                       else None if arrays is None else _same(arrays, again[1], 0))
                if why:
                    poison_mismatches.append({"case": name, "path": path, "why": why})
            delta = [a - b for a, b in zip(sweep.launch_counts(), before)]
            launches[path] = [x + d for x, d in zip(launches[path], delta)]
            if path in via and outcome == "decoded":
                via[path]["kernel" if delta[1] else "host_fallback"] += 1
            by_path[path][outcome] = by_path[path].get(outcome, 0) + 1
            pairs += 1
            if cuda and path in compare and not outcome.startswith("violation"):
                try:
                    cpu_outcome, cpu_arrays = call(path, data, valid, cpu)
                except Exception as e:   # noqa: BLE001
                    cpu_outcome, cpu_arrays = f"violation:{type(e).__name__}", None
                    violations.append({"case": name, "path": f"cpu:{path}",
                                       "error": f"{type(e).__name__}: {e}"[:500]})
                compared += 1
                why = None
                if cpu_outcome != outcome:
                    why = f"card {outcome}, CPU {cpu_outcome}"
                elif arrays is not None:
                    why = _same(arrays, cpu_arrays, FLOAT_TOL if path == "float" else 0)
                if why:
                    mismatches.append({"case": name, "path": path, "why": why})
        if cuda_error:
            break
    return {
        "device": str(device),
        "gpu": torch.cuda.get_device_name(device) if cuda else None,
        "seed": seed,
        "n_cases": len(srcs) if clean else n,
        "paths": list(paths),
        "pairs": pairs,
        "compared_cpu": compared,
        "seconds": time.perf_counter() - t0,
        "by_path": by_path,
        "launches": {p: {f"K{k + 1}": v for k, v in enumerate(c)} for p, c in launches.items()},
        "device_decoded_via": via,
        "violations": violations,
        "mismatches": mismatches,
        "poisoned_pairs": n_poisoned,
        "poison_mismatches": poison_mismatches,
        "cuda_error": cuda_error,
        "ok": (not violations and not mismatches and not poison_mismatches
               and cuda_error is None),
    }


# -- the kernels at their wrappers ---------------------------------------------

KERNEL_FORMS = ("scan", "fused", "row")


def _spoil(words: np.ndarray, rng: np.random.Generator) -> Tuple[str, np.ndarray]:
    """A copy of an int32 word tensor with garbage in it: bits flipped,
    words replaced by random ones, or a span set to all ones or all zeros."""
    flat = words.reshape(-1).copy()
    kind = str(rng.choice(["flips", "words", "ones", "zeros"]))
    if kind in ("flips", "words"):
        at = rng.integers(0, flat.size, size=int(rng.integers(1, 33)))
        if kind == "flips":
            flat[at] ^= (np.int64(1) << rng.integers(0, 32, size=at.size)).astype(np.uint32).view(
                np.int32)
        else:
            flat[at] = rng.integers(-2**31, 2**31, size=at.size, dtype=np.int64).astype(np.int32)
    else:
        lo = int(rng.integers(0, flat.size))
        flat[lo:lo + int(rng.integers(1, 257))] = -1 if kind == "ones" else 0
    return kind, flat.reshape(words.shape)


def _garbage_bitpos(bitpos: np.ndarray, n_bits: int, rng: np.random.Generator):
    """Bit positions the index scan would never give K2's fused form."""
    kind = str(rng.choice(["perturb", "random", "past", "reverse"]))
    if kind == "perturb":
        out = bitpos + rng.integers(-64, 65, size=bitpos.size)
    elif kind == "random":
        out = rng.integers(-2**31, 2**31, size=bitpos.size, dtype=np.int64)
    elif kind == "past":
        out = rng.integers(n_bits, n_bits + (1 << 20), size=bitpos.size)
    else:
        out = bitpos[::-1]
    return kind, np.asarray(out, dtype=np.int64).astype(np.int32)


def kernel_case(form: str, src: Source, rng: np.random.Generator):
    """One garbage input for K3 (``scan``), K2's fused form or K2's row form
    at its wrapper, built from ``src``: (detail, fn(device, plain) -> outputs).
    ``fn`` uploads the inputs to the device and calls the wrapper, or with
    ``plain`` its plain version on the same device."""
    from jpeg_gpu_tpu_torch.host import entropy_native, segments
    from jpeg_gpu_tpu_torch.host.parser import parse
    from jpeg_gpu_tpu_torch.ops import entropy_device, specsync_device

    parsed = parse(src.data)

    def up(arrays, device):
        """int32 tensors on ``device``, each from torch.empty (so with red
        zones inside a poisoned_empty block)."""
        out = []
        for a in arrays:
            host = torch.from_numpy(np.array(a, dtype=np.int32))
            out.append(torch.empty(host.shape, dtype=torch.int32, device=device).copy_(host))
        return out

    if form in ("scan", "fused"):
        inp = segments.build_spec_scan_input(parsed, subseq_bytes=32 if form == "scan" else None)
        spoil, windows = (_spoil(inp.windows, rng) if form == "scan" or rng.integers(0, 2)
                          else ("none", inp.windows))
    if form == "scan":
        def fn(device, plain):
            w, dc, ac, cb, cn, sy = up((windows, inp.dcslot_of_c, inp.acslot_of_c, inp.cbase,
                                        inp.counts, inp.symbols), device)
            return specsync_device.device_index_scan(
                w, inp.n_bits, dc, ac, cb, cn, sy, sb=inp.subseq_bytes, maxrec=inp.maxrec,
                n_mcus=inp.n_mcus, plain=plain)
        return f"windows {spoil}", fn
    if form == "fused":
        how, bitpos = _garbage_bitpos(entropy_native.index_scan(parsed, 1)[0], inp.n_bits, rng)

        def fn(device, plain):
            t = up((windows, bitpos, inp.comp_of_step, inp.dc_slot_of_step, inp.ac_slot_of_step,
                    inp.cbase, inp.counts, inp.symbols), device)
            call = (entropy_device.decode_mcus_at_bitpos_reference if plain
                    else entropy_device.decode_mcus_at_bitpos)
            return call(t[0], t[1], inp.n_bits, *t[2:], spw=inp.spw)
        return f"windows {spoil}, bitpos {how}", fn
    plan = segments.build_plan(parsed)
    spoil, streams = _spoil(plan.streams, rng)
    nb = streams.shape[0]
    img = np.zeros(nb, dtype=np.int32)
    meta = plan.seg_meta.reshape(1, 3).copy()
    extra = str(rng.choice(["", "dead batch", "seg_meta"]))
    if extra == "dead batch":
        img[int(rng.integers(nb))] = int(rng.choice([-1, 1, 2**31 - 1]))
    elif extra == "seg_meta":
        meta[0] = rng.integers(-2**31, 2**31, size=3, dtype=np.int64).astype(np.int32)

    def fn(device, plain):
        t = up((streams, img, *plan.kernel_tables[:3], meta, plan.cbase[None], plan.counts[None],
                plan.symbols[None]), device)
        call = (entropy_device.decode_segments_reference if plain
                else entropy_device.decode_segments_device_multi)
        return call(*t)
    return f"streams {spoil}" + (f", {extra}" if extra else ""), fn


def kernel_run(device=None, seed: int = 0, n: int = 30,
               srcs: Optional[Sequence[Source]] = None) -> dict:
    """K3 and K2's two forms at their wrappers on ``device``, on garbage
    that the engine's checks never let through: spoiled window and stream
    words, bit positions that are no MCU's (negative, past the stream,
    reversed), batches routed to no table set, a nonsense last-segment
    record.  Case i takes form ``KERNEL_FORMS[i % 3]`` and a source drawn
    with ``default_rng(seed)`` (without restart markers for the scan and the
    fused form).  Each case runs the wrapper twice under
    :func:`poisoned_empty`, its inputs too made by torch.empty (on a CUDA
    device: the kernel, which must give the same outputs both times and
    leave every red zone intact), and its plain version once on the same
    device; all must be equal bit for bit.  On the CPU the wrapper is the plain
    version, so only the harness and the plain versions are exercised.

    Returns ``cases``, ``by_form``, ``launches`` (K2, K3), ``mismatches``,
    ``violations`` (an exception from a wrapper), ``cuda_error`` and ``ok``."""
    from jpeg_gpu_tpu_torch.testing import sweep
    from jpeg_gpu_tpu_torch.utils.device import resolve_device

    device = resolve_device(device, "fuzz.kernel_run")
    cuda = device.type == "cuda"
    srcs = list(sources() if srcs is None else srcs)
    pools = {"scan": [s for s in srcs if not s.restart], "row": [s for s in srcs if s.restart]}
    pools["fused"] = pools["scan"]
    rng = np.random.default_rng(seed)
    by_form = {f: 0 for f in KERNEL_FORMS}
    mismatches, violations = [], []
    cuda_error = None
    before = sweep.launch_counts()
    t0 = time.perf_counter()
    for i in range(n):
        form = KERNEL_FORMS[i % len(KERNEL_FORMS)]
        src = pools[form][int(rng.integers(len(pools[form])))]
        detail, fn = kernel_case(form, src, rng)
        name = f"{i}:{src.name}:{form}:{detail}"
        try:
            runs, written = [], 0
            for byte in POISON:
                with poisoned_empty(byte) as zones:
                    runs.append([t.cpu() for t in fn(device, False)])
                written += zones.written()
            plain = [t.cpu() for t in fn(device, True)]
            if cuda:
                torch.cuda.synchronize(device)
        except Exception as e:   # noqa: BLE001 -- every exception is the finding
            error = {"case": name, "error": f"{type(e).__name__}: {e}"[:500]}
            if cuda and _is_cuda_error(e):
                cuda_error = error
                break
            violations.append(error)
            continue
        by_form[form] += 1
        if written:
            mismatches.append({"case": name, "against": f"{written} red zones written"})
        for what, got in (("poisoned twice", runs[1]), ("plain", plain)):
            differ = [j for j, (a, b) in enumerate(zip(runs[0], got)) if not torch.equal(a, b)]
            if differ:
                mismatches.append({"case": name, "against": what, "outputs": differ})
    counts = [a - b for a, b in zip(sweep.launch_counts(), before)]
    return {
        "device": str(device),
        "seed": seed,
        "cases": sum(by_form.values()),
        "by_form": by_form,
        "seconds": time.perf_counter() - t0,
        "launches": {"K2": counts[1], "K3": counts[2]},
        "mismatches": mismatches,
        "violations": violations,
        "cuda_error": cuda_error,
        "ok": not mismatches and not violations and cuda_error is None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; the CPU only with --device cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=100, help="cases (each through every path)")
    ap.add_argument("--paths", default=",".join(PATHS), help="comma-separated paths")
    ap.add_argument("--compare-cpu", default="",
                    help="comma-separated paths to hold to the CPU outcome")
    ap.add_argument("--clean", action="store_true",
                    help="the 20 SWEEP_r05 frames as they are, instead of garbage")
    ap.add_argument("--poison", default="",
                    help="comma-separated paths to run twice, torch.empty's CUDA tensors "
                         "filled with 0xA5 and then 0x5A between red zones")
    ap.add_argument("--kernels", type=int, default=0,
                    help="then this many cases of K3 and K2 at their wrappers (kernel_run)")
    ap.add_argument("--out", default=None, help="write the result as JSON here")
    args = ap.parse_args(argv)
    paths = [p for p in args.paths.split(",") if p]
    compare = [p for p in args.compare_cpu.split(",") if p]
    srcs = sources()[:20] if args.clean else None
    result = run(args.device, seed=args.seed, n=args.n, paths=paths, compare_cpu=compare,
                 srcs=srcs, clean=args.clean, poisoned=[p for p in args.poison.split(",") if p])
    for path in paths:
        print(f"{path}: {json.dumps(result['by_path'][path])} launches "
              f"{json.dumps(result['launches'][path])}")
    for v in result["violations"] + result["mismatches"] + result["poison_mismatches"]:
        print(json.dumps(v))
    if result["cuda_error"]:
        print("CUDA error: " + json.dumps(result["cuda_error"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(f"fuzz on {result['device']}: {result['pairs']} pairs, "
          f"{len(result['violations'])} violations, {len(result['mismatches'])} CPU mismatches, "
          f"{result['poisoned_pairs']} poisoned pairs with {len(result['poison_mismatches'])} "
          f"mismatches, cuda_error {result['cuda_error'] is not None}, "
          f"{result['seconds']:.1f} s")
    if not args.kernels or result["cuda_error"]:
        return 0 if result["ok"] else 1
    kres = kernel_run(args.device, seed=args.seed, n=args.kernels)
    for v in kres["violations"] + kres["mismatches"]:
        print(json.dumps(v))
    print(f"kernels on {kres['device']}: {kres['cases']} cases {json.dumps(kres['by_form'])}, "
          f"{len(kres['mismatches'])} mismatches, {len(kres['violations'])} violations, "
          f"cuda_error {kres['cuda_error'] is not None}, launches {json.dumps(kres['launches'])}, "
          f"{kres['seconds']:.1f} s")
    return 0 if result["ok"] and kres["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
