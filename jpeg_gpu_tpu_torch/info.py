"""Decoder-independent JPEG header model.

TPU-native analogue of the reference's ``jpeg_header`` / component model
(jpeg_info.h:35-64) and subsampling classifier (jpeg_wrap.c:32-52).

Geometry conventions
--------------------
All per-component coefficient storage lives on the *MCU-aligned block grid*:
a component with sampling factors (hsamp, vsamp) in an image with
``nhmb x nvmb`` MCUs owns a dense block grid of shape
``(nvmb * vsamp, nhmb * hsamp)`` 8x8 blocks.  This over-allocates relative to
the minimal ``ceil(comp_width / 8)`` grid exactly like an interleaved scan
produces data, keeps every tensor shape static, and is cropped only at the
pixel stage.  The reference instead packs chroma rows into a stacked
"coefficient texture" at luma width (image.c:68-95) -- a GL texture-ism we
deliberately drop: TPU kernels want dense per-plane ``(by, bx, 8, 8)`` tiles.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple

import numpy as np


class Subsampling(enum.Enum):
    """Chroma subsampling classification (mirrors jpeg_info.h:22-31)."""

    MONO = "mono"    # 1 component
    S444 = "4:4:4"   # chroma at full resolution
    S422 = "4:2:2"   # chroma halved horizontally
    S420 = "4:2:0"   # chroma halved both ways
    S440 = "4:4:0"   # chroma halved vertically
    S411 = "4:1:1"   # chroma quartered horizontally
    UNKNOWN = "unknown"


def classify_subsampling(comps: Sequence["Component"]) -> Subsampling:
    """Classify per-component sampling factors (cf. jpeg_wrap.c:32-52)."""
    if len(comps) == 1:
        return Subsampling.MONO
    if len(comps) != 3:
        return Subsampling.UNKNOWN
    y, cb, cr = comps
    if (cb.hsamp, cb.vsamp) != (cr.hsamp, cr.vsamp):
        return Subsampling.UNKNOWN
    hs = y.hsamp // cb.hsamp if cb.hsamp and y.hsamp % cb.hsamp == 0 else 0
    vs = y.vsamp // cb.vsamp if cb.vsamp and y.vsamp % cb.vsamp == 0 else 0
    table = {
        (1, 1): Subsampling.S444,
        (2, 1): Subsampling.S422,
        (2, 2): Subsampling.S420,
        (1, 2): Subsampling.S440,
        (4, 1): Subsampling.S411,
    }
    return table.get((hs, vs), Subsampling.UNKNOWN)


@dataclasses.dataclass(frozen=True)
class QuantTable:
    """One quantization table (DQT payload, xjpeg.c:219-256).

    ``values`` is in *natural raster order* as an (8, 8) uint16 array; the
    bitstream's zig-zag order is undone at parse time.
    """

    precision: int  # 0 = 8-bit entries, 1 = 16-bit entries
    values: np.ndarray  # (8, 8) uint16, raster order

    def __post_init__(self):
        assert self.values.shape == (8, 8)


@dataclasses.dataclass(frozen=True)
class HuffmanSpec:
    """One Huffman table spec as transmitted (DHT payload, xjpeg.c:258-345).

    ``counts[i]`` is the number of codes of length ``i+1`` (1..16);
    ``symbols`` are the code values in canonical order.
    """

    table_class: int  # 0 = DC, 1 = AC
    counts: np.ndarray  # (16,) uint8
    symbols: np.ndarray  # (sum(counts),) uint8

    def __post_init__(self):
        assert self.counts.shape == (16,)
        assert len(self.symbols) == int(self.counts.sum())


@dataclasses.dataclass(frozen=True)
class Component:
    """One frame component (SOF0 entry, xjpeg.c:350-410)."""

    comp_id: int
    hsamp: int
    vsamp: int
    quant_idx: int
    # Derived geometry (filled by the parser):
    width: int = 0        # ceil(image_width * hsamp / hmax) -- true sample width
    height: int = 0
    hblocks: int = 0      # MCU-aligned block grid width  = nhmb * hsamp
    vblocks: int = 0      # MCU-aligned block grid height = nvmb * vsamp
    xdec: int = 0         # log2 horizontal decimation vs luma (image.h:25-38)
    ydec: int = 0


@dataclasses.dataclass(frozen=True)
class ScanHeader:
    """SOS scan header (xjpeg.c:634-695). Baseline: one scan, Ss=0 Se=63."""

    comp_idx: Tuple[int, ...]      # frame-component index per scan component
    dc_tbl: Tuple[int, ...]
    ac_tbl: Tuple[int, ...]


def scan_to_frame_order(items: Sequence, comp_idx: Sequence[int]) -> list:
    """Reorder per-scan-component products to frame-component positions.

    The MCU interleave (and therefore every entropy decoder's natural
    output order) follows the SOS component order, which T.81 B.2.3 says
    must match the frame header but spec-violating streams may permute
    (libjpeg rejects those; we decode them).  Every decode surface emits
    frame order, so the reorder happens exactly once, here, at each
    decoder's boundary.
    """
    out = [None] * len(items)
    for si, fi in enumerate(comp_idx):
        out[fi] = items[si]
    return out


@dataclasses.dataclass(frozen=True)
class JpegHeader:
    """Everything needed to decode one baseline JPEG (cf. jpeg_info.h:53-64)."""

    width: int
    height: int
    bits: int
    components: Tuple[Component, ...]
    quant_tables: Tuple[Optional[QuantTable], ...]      # 4 slots
    dc_tables: Tuple[Optional[HuffmanSpec], ...]        # 4 slots
    ac_tables: Tuple[Optional[HuffmanSpec], ...]        # 4 slots
    restart_interval: int                               # MCUs per segment; 0 = none
    scan: Optional[ScanHeader]
    nhmb: int                                           # MCUs across
    nvmb: int                                           # MCUs down

    @property
    def ncomps(self) -> int:
        return len(self.components)

    @property
    def subsampling(self) -> Subsampling:
        return classify_subsampling(self.components)

    @property
    def hmax(self) -> int:
        return max(c.hsamp for c in self.components)

    @property
    def vmax(self) -> int:
        return max(c.vsamp for c in self.components)

    @property
    def n_mcus(self) -> int:
        return self.nhmb * self.nvmb

    @property
    def mcu_width(self) -> int:
        return 8 * self.hmax

    @property
    def mcu_height(self) -> int:
        return 8 * self.vmax

    def blocks_per_mcu(self) -> int:
        return sum(c.hsamp * c.vsamp for c in self.components)

    def quant_for(self, comp: Component) -> QuantTable:
        table = self.quant_tables[comp.quant_idx]
        if table is None:
            from jpeg_gpu_tpu_torch.errors import JpegFormatError

            raise JpegFormatError(
                f"component {comp.comp_id} references undefined quant table "
                f"{comp.quant_idx}"
            )
        return table

    def describe(self) -> str:
        """Human-readable summary (mirrors the -H header print, jpeg_gpu.c:614-636)."""
        lines = [
            f"size    : {self.width} x {self.height}",
            f"bits    : {self.bits}",
            f"ncomps  : {self.ncomps} ({self.subsampling.value})",
            f"restart : {self.restart_interval}",
            f"mcus    : {self.nhmb} x {self.nvmb}",
        ]
        for i, c in enumerate(self.components):
            lines.append(
                f"comp {i}  : id={c.comp_id} samp={c.hsamp}x{c.vsamp} "
                f"quant={c.quant_idx} {c.width}x{c.height} px "
                f"blocks={c.hblocks}x{c.vblocks} dec={c.xdec}x{c.ydec}"
            )
        return "\n".join(lines)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def derive_geometry(
    width: int, height: int, comps: Sequence[Component]
) -> Tuple[Tuple[Component, ...], int, int]:
    """Fill derived per-component geometry; return (components, nhmb, nvmb).

    Mirrors what image_init computes (image.c:24-95) but on the MCU-aligned
    grid (see module docstring).
    """
    hmax = max(c.hsamp for c in comps)
    vmax = max(c.vsamp for c in comps)
    nhmb = ceil_div(width, 8 * hmax)
    nvmb = ceil_div(height, 8 * vmax)
    out = []
    for c in comps:
        cw = ceil_div(width * c.hsamp, hmax)
        ch = ceil_div(height * c.vsamp, vmax)
        out.append(
            dataclasses.replace(
                c,
                width=cw,
                height=ch,
                hblocks=nhmb * c.hsamp,
                vblocks=nvmb * c.vsamp,
                xdec=(hmax // c.hsamp).bit_length() - 1,
                ydec=(vmax // c.vsamp).bit_length() - 1,
            )
        )
    return tuple(out), nhmb, nvmb
