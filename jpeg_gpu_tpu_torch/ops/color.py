"""Chroma upsampling + exact YCbCr -> RGB conversion, in PyTorch.

The same integer arithmetic as ``jpeg_gpu_tpu/ops/color.py``:

* :func:`upsample_nearest` -- replication (libjpeg's
  ``do_fancy_upsampling=FALSE``);
* :func:`upsample_fancy` and the ``*_padded`` forms -- libjpeg's triangle
  filters, bit-exact, with edge samples replicated at the true plane edge;
* :func:`ycbcr_to_rgb_exact` -- libjpeg's fixed-point colour converter;
* :func:`ycbcr_to_rgb_float` -- the float JFIF matrix of the ``exact=False``
  fast path.
"""

from __future__ import annotations

import torch

SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)
# FIX(x) = round(x * 2^16) of the JFIF constants.
FIX_1_40200 = 91881
FIX_0_34414 = 22554
FIX_0_71414 = 46802
FIX_1_77200 = 116130


def upsample_nearest(plane: torch.Tensor, xdec: int, ydec: int) -> torch.Tensor:
    """Replicate a chroma plane 2^xdec x 2^ydec (the `s >> xdec` semantics)."""
    if ydec:
        plane = plane.repeat_interleave(1 << ydec, dim=-2)
    if xdec:
        plane = plane.repeat_interleave(1 << xdec, dim=-1)
    return plane


def _edge_neighbors(x: torch.Tensor, dim: int, true_n: int):
    """(prev, next) of ``x`` along ``dim``, edge-replicated at index 0 and
    at ``true_n - 1`` (the TRUE plane edge, which may sit inside the MCU
    padding; entries past it are garbage the caller crops)."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim=dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim=dim)
    if true_n < n:
        nxt = nxt.clone()
        nxt.narrow(dim, true_n - 1, 1).copy_(x.narrow(dim, true_n - 1, 1))
    return prev, nxt


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    """Interleave two equal tensors along ``dim`` (even phase first)."""
    dim = dim % even.ndim
    out = torch.stack([even, odd], dim=dim + 1)
    shape = list(even.shape)
    shape[dim] *= 2
    return out.reshape(shape)


def upsample_fancy_h2_padded(
    plane: torch.Tensor, dim: int, true_n: int
) -> torch.Tensor:
    """Triangle-filter 2x upsample along ``dim`` (libjpeg 'fancy' mode).

    Nearer neighbour weight 3, farther weight 1; the two output phases
    round with 1 and 2; the sample at ``true_n - 1`` replicates as its own
    right neighbour.  Outputs beyond 2*true_n are garbage the caller crops.
    """
    x = plane.to(torch.int16)
    left, right = _edge_neighbors(x, dim, true_n)
    even = (3 * x + left + 1) >> 2
    odd = (3 * x + right + 2) >> 2
    return _interleave(even, odd, dim).to(plane.dtype)


def upsample_fancy_h2v2_padded(
    plane: torch.Tensor, true_h: int, true_w: int
) -> torch.Tensor:
    """Fancy 2x2 upsample (4:2:0): vertical triangle pass into 10-bit
    column sums, then horizontal pass with 16-way rounding, edges clamped
    at the true plane dims.  Outputs past (2*true_h, 2*true_w) are garbage
    the caller crops."""
    x = plane.to(torch.int16)
    above, below = _edge_neighbors(x, -2, true_h)
    colsum = _interleave(3 * x + above, 3 * x + below, -2)
    left, right = _edge_neighbors(colsum, -1, true_w)
    even = (3 * colsum + left + 8) >> 4
    odd = (3 * colsum + right + 7) >> 4
    return _interleave(even, odd, -1).to(plane.dtype)


def upsample_fancy_padded(
    plane: torch.Tensor, xdec: int, ydec: int, true_w: int, true_h: int
) -> torch.Tensor:
    """Fancy dispatch on the MCU-padded plane with the true edges clamped;
    factors the filters do not define (e.g. 4:1:1) replicate."""
    if (xdec, ydec) == (0, 0):
        return plane
    if (xdec, ydec) == (1, 1):
        return upsample_fancy_h2v2_padded(plane, true_h, true_w)
    if (xdec, ydec) == (1, 0):
        return upsample_fancy_h2_padded(plane, -1, true_w)
    if (xdec, ydec) == (0, 1):
        return upsample_fancy_h2_padded(plane, -2, true_h)
    return upsample_nearest(plane, xdec, ydec)


def upsample_fancy_h2(plane: torch.Tensor, dim: int) -> torch.Tensor:
    """Triangle 2x upsample of a cropped plane (edge = the plane's edge)."""
    return upsample_fancy_h2_padded(plane, dim, plane.shape[dim])


def upsample_fancy_h2v2(plane: torch.Tensor) -> torch.Tensor:
    """Fancy 2x2 upsample of a cropped plane (edges = the plane's edges)."""
    return upsample_fancy_h2v2_padded(plane, plane.shape[-2], plane.shape[-1])


def upsample_fancy(plane: torch.Tensor, xdec: int, ydec: int) -> torch.Tensor:
    """Fancy upsampling of a cropped plane, dispatched by decimation."""
    return upsample_fancy_padded(
        plane, xdec, ydec, plane.shape[-1], plane.shape[-2]
    )


def ycbcr_to_rgb_exact(
    y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
) -> torch.Tensor:
    """Fixed-point YCbCr->RGB, bit-exact vs libjpeg's integer converter.

    R and B round their single chroma product; G sums both products with
    one rounding constant folded into the Cr term.
    """
    yi = y.to(torch.int32)
    cbi = cb.to(torch.int32) - 128
    cri = cr.to(torch.int32) - 128
    r = yi + ((FIX_1_40200 * cri + ONE_HALF) >> SCALEBITS)
    b = yi + ((FIX_1_77200 * cbi + ONE_HALF) >> SCALEBITS)
    g = yi + ((-FIX_0_34414 * cbi + (-FIX_0_71414 * cri + ONE_HALF)) >> SCALEBITS)
    rgb = torch.stack([r, g, b], dim=-1)
    return rgb.clamp(0, 255).to(torch.uint8)


def ycbcr_to_rgb_float(
    y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
) -> torch.Tensor:
    """Float JFIF conversion (fast path): round half to even, then clamp."""
    yf = y.to(torch.float32)
    cbf = cb.to(torch.float32) - 128.0
    crf = cr.to(torch.float32) - 128.0
    r = yf + 1.402 * crf
    g = yf - 0.34414 * cbf - 0.71414 * crf
    b = yf + 1.772 * cbf
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.round(rgb).clamp(0.0, 255.0).to(torch.uint8)
