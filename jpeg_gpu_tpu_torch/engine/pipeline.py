"""The device pipeline: coefficient tensors -> pixels, in PyTorch.

The port of ``jpeg_gpu_tpu/engine/pipeline.py``.  Every function takes
tensors that already sit on the target device (see :func:`to_torch_inputs`)
and returns tensors on that device.  The fused RGB path
(:func:`decode_rgb_soa`) goes through the K1 kernel; the other geometries
and the YUV stage go through a standalone IDCT kernel -- K5 (islow, exact)
or K6 (float, ``exact=False``), one call for all components -- followed by
plain PyTorch upsampling and colour ops, as the reference leaves those to
XLA.
Every op accepts leading batch dimensions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from jpeg_gpu_tpu_torch.engine.stages import OutputStage
from jpeg_gpu_tpu_torch.info import JpegHeader
from jpeg_gpu_tpu_torch.ops import color as color_ops
from jpeg_gpu_tpu_torch.ops import idct_float
from jpeg_gpu_tpu_torch.ops import idct_islow_plane
from jpeg_gpu_tpu_torch.ops import pixel_fused
from jpeg_gpu_tpu_torch.ops.block_plane import blocks_as_soa
from jpeg_gpu_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Static decode geometry."""

    width: int
    height: int
    comp_sizes: Tuple[Tuple[int, int], ...]  # per comp (width, height) in samples
    comp_decs: Tuple[Tuple[int, int], ...]   # per comp (xdec, ydec)
    comp_samps: Optional[Tuple[Tuple[int, int], ...]] = None  # (hsamp, vsamp)
    exact: bool = True                        # islow + integer colour, or float
    use_kernel: bool = True                   # fused K1 kernel on the RGB path
    upsample: str = "nearest"                 # "nearest" or "fancy" (libjpeg)

    @classmethod
    def from_header(
        cls,
        header: JpegHeader,
        exact: bool = True,
        use_kernel: bool = True,
        upsample: str = "nearest",
    ) -> "PipelineSpec":
        return cls(
            width=header.width,
            height=header.height,
            comp_sizes=tuple((c.width, c.height) for c in header.components),
            comp_decs=tuple((c.xdec, c.ydec) for c in header.components),
            comp_samps=tuple((c.hsamp, c.vsamp) for c in header.components),
            exact=exact,
            use_kernel=use_kernel,
            upsample=upsample,
        )

    @property
    def ncomps(self) -> int:
        return len(self.comp_sizes)


def to_torch_inputs(
    coefs: Sequence[np.ndarray],
    qtables: Sequence[np.ndarray],
    device,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """The reference's numpy layouts -> the port's tensors on ``device``.

    ``coefs`` are per-component coefficient arrays in either layout the
    entropy decoders write -- native SoA planes ``(vsamp, hsamp, 64, nvmb,
    nhmb)`` or blocks ``(vb, hb, 8, 8)`` -- kept int16; ``qtables`` are the
    ``(64,)`` or ``(8, 8)`` quant tables, as int32.
    """
    cts = tuple(
        torch.from_numpy(np.ascontiguousarray(c, dtype=np.int16)).to(device)
        for c in coefs
    )
    qts = tuple(
        torch.from_numpy(np.ascontiguousarray(q, dtype=np.int32)).to(device)
        for q in qtables
    )
    return cts, qts


def _sample_planes(spec: PipelineSpec, coefs, qtables):
    """Per-component full (MCU-aligned) sample planes, uint8: K5 for the
    exact path, K6 for the float one, one launch for all components.  The
    (..., vb, hb, 8, 8) blocks go in as strided views of coefficient planes,
    without a copy; the tables as given, one per component or one per image
    ((N, 1, 1, 8, 8), as the batch code passes them)."""
    views = [blocks_as_soa(coefs[ci]) for ci in range(spec.ncomps)]
    tables = list(qtables[: spec.ncomps])
    if spec.exact:
        return idct_islow_plane.dequant_idct_islow_planes_soa(views, tables)
    return idct_float.dequant_idct_float_planes_soa(views, tables)


def decode_yuv(spec: PipelineSpec, coefs, qtables):
    """YUV stage: per-component sample planes cropped to true comp dims."""
    planes = _sample_planes(spec, coefs, qtables)
    return tuple(
        p[..., : spec.comp_sizes[ci][1], : spec.comp_sizes[ci][0]]
        for ci, p in enumerate(planes)
    )


def decode_rgb(spec: PipelineSpec, coefs, qtables):
    """RGB stage from blocks: full decode to (..., H, W, 3) uint8.

    Grayscale replicates Y into all three channels.
    """
    planes = _sample_planes(spec, coefs, qtables)
    h, w = spec.height, spec.width
    if spec.ncomps == 1:
        y = planes[0][..., :h, :w]
        return y[..., None].expand(*y.shape, 3)
    up = []
    for ci, p in enumerate(planes):
        xdec, ydec = spec.comp_decs[ci]
        if spec.upsample == "fancy":
            cw, ch = spec.comp_sizes[ci]
            p = color_ops.upsample_fancy_padded(p, xdec, ydec, cw, ch)
        else:
            p = color_ops.upsample_nearest(p, xdec, ydec)
        up.append(p[..., :h, :w])
    if spec.exact:
        return color_ops.ycbcr_to_rgb_exact(*up)
    return color_ops.ycbcr_to_rgb_float(*up)


def fused_rgb_geometry(spec: PipelineSpec):
    """(sx, sy) for the fused SoA RGB kernel, or None when not applicable.

    The fused path covers the exact RGB decode of 3-component images whose
    luma is sampled (sx, sy) with sx in {1, 2, 4}, sy in {1, 2}, and whose
    chroma is sampled exactly (1, 1), for both upsample modes.  The SoA
    layout is built from the raw sampling factors, so decimations alone are
    not enough: 2x2/2x2/2x2 (all-zero decimations) is not 4:4:4.
    """
    if spec.ncomps != 3 or not spec.exact or not spec.use_kernel:
        return None
    if spec.upsample not in ("nearest", "fancy"):
        return None
    (xd0, yd0), c1, c2 = spec.comp_decs
    if (xd0, yd0) != (0, 0) or c1 != c2:
        return None
    sx, sy = 1 << c1[0], 1 << c1[1]
    if sx not in (1, 2, 4) or sy not in (1, 2):
        return None
    if spec.comp_samps is None:
        return None
    if spec.comp_samps[0] != (sx, sy):
        return None
    if spec.comp_samps[1] != (1, 1) or spec.comp_samps[2] != (1, 1):
        return None
    return sx, sy


def decode_rgb_soa(spec: PipelineSpec, geom, comps_soa, qtables):
    """Fused RGB decode from parity-split SoA coefficient planes.

    ``comps_soa`` is the native decoder's SoA output: luma
    (..., sy, sx, 64, vbC, hbC), chroma (..., 1, 1, 64, vbC, hbC).
    Returns the (..., H, W, 3) uint8 tensor on the planes' device;
    bit-identical to decode_rgb.  Span ``pipeline.decode_rgb_soa``, of the
    frame its thread last decoded.
    """
    with trace.span("pipeline.decode_rgb_soa"):
        args, kwargs = fused_soa_args(spec, geom, comps_soa, qtables)
        return pixel_fused.decode_rgb_fused_soa(*args, **kwargs)


def fused_soa_args(spec: PipelineSpec, geom, comps_soa, qtables):
    """(args, kwargs) of the K1 call that decode_rgb_soa makes -- the same
    call works for its plain version, decode_rgb_fused_soa_reference."""
    sx, sy = geom
    y_soa, cb_soa, cr_soa = comps_soa
    *lead, _, _, _, vbc, hbc = cb_soa.shape
    cb = cb_soa.reshape(*lead, 64, vbc, hbc)
    cr = cr_soa.reshape(*lead, 64, vbc, hbc)
    qty = qtables[0].reshape(-1, 64)
    qtc = torch.stack(
        [qtables[1].reshape(-1, 64), qtables[2].reshape(-1, 64)], dim=1
    )
    # Fancy differs from nearest only for the true 2x modes; (1,1) is an
    # identity either way and 4:1:1 fancy is replication by definition.
    fancy = spec.upsample == "fancy" and (sx, sy) in pixel_fused.FANCY_MODES
    return (y_soa, cb, cr, qty, qtc, sx, sy), dict(
        fancy=fancy,
        chroma_true=spec.comp_sizes[1] if fancy else None,
        size=(spec.height, spec.width),
    )


def decode_dct(spec: PipelineSpec, coefs, qtables):
    """DCT stage: dequantized coefficients, int32."""
    return tuple(
        coefs[ci].to(torch.int32) * qtables[ci].to(torch.int32).reshape(8, 8)
        for ci in range(spec.ncomps)
    )


def run(
    spec: PipelineSpec,
    stage: OutputStage,
    coefs: Sequence[torch.Tensor],
    qtables: Sequence[torch.Tensor],
):
    """Dispatch one decode through the device pipeline at the given cut."""
    coefs = tuple(coefs)
    qtables = tuple(qtables)
    if stage == OutputStage.QUANT:
        return coefs
    if stage == OutputStage.DCT:
        return decode_dct(spec, coefs, qtables)
    if stage == OutputStage.YUV:
        return decode_yuv(spec, coefs, qtables)
    if stage == OutputStage.RGB:
        return decode_rgb(spec, coefs, qtables)
    raise ValueError(f"stage {stage} not handled by the coefficient pipeline")
