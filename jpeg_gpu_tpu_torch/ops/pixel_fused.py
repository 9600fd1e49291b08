"""K1: parity-split SoA coefficients -> RGB bytes, one fused pass.

The port of ``jpeg_gpu_tpu/ops/pixel_fused.py``.  ``decode_rgb_fused_soa``
runs dequant + islow IDCT + chroma upsampling (nearest, or libjpeg's exact
triangle filters) + integer YCbCr->RGB for a 3-component image whose chroma
is sampled 1x1 and whose luma is sampled (sx, sy), sx in {1, 2, 4},
sy in {1, 2}.

Coefficients arrive as the native entropy decoder writes them:

* luma ``(..., sy, sx, 64, vbC, hbC)`` -- plane [pr, pc, j] at (i, k)
  holds natural-order coefficient j of luma block (sy*i + pr, sx*k + pc);
* chroma ``(..., 64, vbC, hbC)``.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/pixel_fused.cu``; on a CPU tensor it runs the plain PyTorch version
(``decode_rgb_fused_soa_reference``), which turns SoA back into blocks and
runs the unfused ops.  Both give identical bytes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from jpeg_gpu_tpu_torch.ops import color as color_ops
from jpeg_gpu_tpu_torch.ops import idct_islow

# (sx, sy) of the modes whose fancy upsampling is a triangle filter; every
# other mode's fancy output equals its nearest output.
FANCY_MODES = ((2, 2), (2, 1), (1, 2))

# Kernel launches since the last reset (set to 0 to start counting).
launches = 0


def blocks_to_soa_split(coefs: torch.Tensor, sx: int, sy: int) -> torch.Tensor:
    """(..., vb, hb, 8, 8) luma blocks -> (..., sy, sx, 64, vb/sy, hb/sx).

    Plane [pr, pc, j] at tile (i, k) is coefficient j of block
    (sy*i + pr, sx*k + pc).
    """
    *lead, vb, hb, _, _ = coefs.shape
    assert vb % sy == 0 and hb % sx == 0, (vb, hb, sx, sy)
    x = coefs.reshape(*lead, vb // sy, sy, hb // sx, sx, 64)
    a = len(lead)
    order = list(range(a))
    # (..., vbC, sy, hbC, sx, 64) -> (..., sy, sx, 64, vbC, hbC)
    return x.permute(order + [a + 1, a + 3, a + 4, a, a + 2]).contiguous()


def blocks_to_soa(coefs: torch.Tensor) -> torch.Tensor:
    """(..., vb, hb, 8, 8) -> (..., 64, vb, hb) coefficient planes."""
    *lead, vb, hb, _, _ = coefs.shape
    return coefs.reshape(*lead, vb, hb, 64).movedim(-1, -3).contiguous()


def soa_split_to_blocks(soa: torch.Tensor) -> torch.Tensor:
    """Inverse of blocks_to_soa_split: (..., sy, sx, 64, vbC, hbC) ->
    (..., vbC*sy, hbC*sx, 8, 8)."""
    *lead, sy, sx, _, vbc, hbc = soa.shape
    a = len(lead)
    order = list(range(a))
    # (..., sy, sx, 64, vbC, hbC) -> (..., vbC, sy, hbC, sx, 64)
    x = soa.permute(order + [a + 3, a, a + 4, a + 1, a + 2])
    return x.reshape(*lead, vbc * sy, hbc * sx, 8, 8)


def _geometry(y_soa, cb_soa, cr_soa, qty, qtc, sx, sy, fancy, chroma_true, size):
    """Check the arguments; return (lead, n, vbc, hbc, qty, qtc, h, w) with
    the tables broadcast to (n, 64) and (n, 2, 64) int32."""
    *lead, _sy, _sx, sixtyfour, vbc, hbc = y_soa.shape
    if (_sy, _sx, sixtyfour) != (sy, sx, 64):
        raise ValueError(f"luma SoA shape {tuple(y_soa.shape)} is not (..., {sy}, {sx}, 64, vbC, hbC)")
    for c in (cb_soa, cr_soa):
        if tuple(c.shape) != (*lead, 64, vbc, hbc):
            raise ValueError(f"chroma SoA shape {tuple(c.shape)} != {(*lead, 64, vbc, hbc)}")
    for c in (y_soa, cb_soa, cr_soa):
        if c.dtype != torch.int16:
            raise TypeError(f"coefficients must be int16, got {c.dtype}")
    if (sx, sy) not in ((1, 1), (2, 1), (4, 1), (1, 2), (2, 2), (4, 2)):
        raise ValueError(f"unsupported luma sampling (sx, sy) = {(sx, sy)}")
    if fancy and (sx, sy) not in FANCY_MODES:
        raise ValueError(f"fancy upsampling applies to {FANCY_MODES}, not {(sx, sy)}")
    if fancy and chroma_true is None:
        raise ValueError("fancy upsampling needs chroma_true=(cw, ch)")
    n = 1
    for d in lead:
        n *= d
    qty = torch.broadcast_to(qty.reshape(-1, 64), (n, 64)).to(torch.int32)
    qtc = torch.broadcast_to(qtc.reshape(-1, 2, 64), (n, 2, 64)).to(torch.int32)
    full = (vbc * sy * 8, hbc * sx * 8)
    h, w = full if size is None else size
    if not (0 < h <= full[0] and 0 < w <= full[1]):
        raise ValueError(f"size {(h, w)} outside the coefficient grid {full}")
    return lead, n, vbc, hbc, qty, qtc, h, w


def decode_rgb_fused_soa_reference(
    y_soa: torch.Tensor,
    cb_soa: torch.Tensor,
    cr_soa: torch.Tensor,
    qty: torch.Tensor,
    qtc: torch.Tensor,
    sx: int,
    sy: int,
    fancy: bool = False,
    chroma_true: Optional[Tuple[int, int]] = None,
    size: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1, on any device: SoA back to blocks, then
    the unfused islow IDCT, upsampling and colour ops."""
    lead, n, vbc, hbc, qty, qtc, h, w = _geometry(
        y_soa, cb_soa, cr_soa, qty, qtc, sx, sy, fancy, chroma_true, size
    )
    y = soa_split_to_blocks(y_soa.reshape(n, sy, sx, 64, vbc, hbc))
    planes = [idct_islow.dequant_idct_islow_plane(y, qty.view(n, 1, 1, 8, 8))]
    for ci, c in enumerate((cb_soa, cr_soa)):
        blocks = c.reshape(n, 64, vbc, hbc).movedim(1, -1).reshape(n, vbc, hbc, 8, 8)
        q = qtc[:, ci].reshape(n, 1, 1, 8, 8)
        plane = idct_islow.dequant_idct_islow_plane(blocks, q)
        xdec, ydec = sx.bit_length() - 1, sy.bit_length() - 1
        if fancy:
            cw, ch = chroma_true
            plane = color_ops.upsample_fancy_padded(plane, xdec, ydec, cw, ch)
        else:
            plane = color_ops.upsample_nearest(plane, xdec, ydec)
        planes.append(plane)
    rgb = color_ops.ycbcr_to_rgb_exact(*(p[:, :h, :w] for p in planes))
    return rgb.reshape(*lead, h, w, 3)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from jpeg_gpu_tpu_torch import cuda_build

        lib = cuda_build.load("pixel_fused")
        lib.jgt_fused_rgb.restype = ctypes.c_int
        lib.jgt_fused_rgb.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p
        ]
        _lib = lib
    return _lib


def decode_rgb_fused_soa(
    y_soa: torch.Tensor,    # (..., sy, sx, 64, vbC, hbC) int16
    cb_soa: torch.Tensor,   # (..., 64, vbC, hbC) int16
    cr_soa: torch.Tensor,   # (..., 64, vbC, hbC) int16
    qty: torch.Tensor,      # (64,) / (8, 8), or per image (..., 64) int32
    qtc: torch.Tensor,      # (2, 64) / (2, 8, 8), or per image (..., 2, 64)
    sx: int,
    sy: int,
    fancy: bool = False,
    chroma_true: Optional[Tuple[int, int]] = None,  # (cw, ch), fancy only
    size: Optional[Tuple[int, int]] = None,  # (H, W); default the full grid
) -> torch.Tensor:
    """SoA coefficients -> (..., H, W, 3) uint8 RGB, already cropped.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    dev = y_soa.device
    if dev.type == "cpu":
        return decode_rgb_fused_soa_reference(
            y_soa, cb_soa, cr_soa, qty, qtc, sx, sy, fancy, chroma_true, size
        )
    if dev.type != "cuda":
        raise RuntimeError(f"decode_rgb_fused_soa: no kernel for device {dev}")
    lead, n, vbc, hbc, qty, qtc, h, w = _geometry(
        y_soa, cb_soa, cr_soa, qty, qtc, sx, sy, fancy, chroma_true, size
    )
    if any(t.device != dev for t in (cb_soa, cr_soa, qty, qtc)):
        raise ValueError(f"decode_rgb_fused_soa: all inputs must be on {dev}")
    for name, t in (("y_soa", y_soa), ("cb_soa", cb_soa), ("cr_soa", cr_soa)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    qty = qty.contiguous()
    qtc = qtc.contiguous()
    out = torch.empty((*lead, h, w, 3), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    cw, ch = chroma_true if fancy else (hbc * 8, vbc * 8)
    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jgt_fused_rgb(
            y_soa.data_ptr(), cb_soa.data_ptr(), cr_soa.data_ptr(),
            qty.data_ptr(), qtc.data_ptr(), out.data_ptr(),
            n, vbc, hbc, sx, sy, int(bool(fancy)), cw, ch, h, w, stream,
        )
    if rc != 0:
        raise RuntimeError(f"pixel_fused kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out
