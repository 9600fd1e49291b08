"""K6: dequant + float 8x8 IDCT + level shift + clamp, one fused pass.

The port of ``jpeg_gpu_tpu/ops/idct_pallas.py``: the ``exact=False`` sample
path.  ``dequant_idct_float_planes_soa`` takes the SoA coefficient planes of
all components of a frame, each with its own grid and quant table (or a
table per leading index), and writes the raster planes (what the engine
wants, as the reference's ``dequant_idct_float_plane``);
``dequant_idct_float_plane_soa`` is its one-plane case and
``dequant_idct_pixels_fused`` the reference's blocks-in, blocks-out form,
served by the same kernel (a list of N blocks is a plane one block wide).

On CUDA tensors the wrappers launch the hand-written kernel in
``csrc/idct_float.cu`` once for up to four planes (fp32 multiply-adds, no
tensor cores, no TF32); on CPU tensors they run the plain PyTorch versions
in ``ops/idct.py``.  Kernel and plain version may differ by 1 where
``Z + 128`` lands within rounding noise of a half (the sums run in another
order).

The reference's 128x128 block-diagonal basis tiles, ``blocks_to_tiles`` /
``tiles_to_blocks`` and ``BLOCKS_PER_TILE`` shaped the work for the TPU's
matrix unit; they have no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from jpeg_gpu_tpu_torch.ops import idct as idct_ops
from jpeg_gpu_tpu_torch.ops.block_plane import (
    PLANES_ARGTYPES,
    blocks_as_soa,
    check_plane_args,
    dispatch_planes,
    soa_as_blocks,
    table_blocks,
)

# Kernel launches since the last reset (set to 0 to start counting).
launches = 0


def dequant_idct_float_plane_soa_reference(
    coefs_soa: torch.Tensor, qtable: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of K6's plane form, on any device."""
    lead, *_, q = check_plane_args(coefs_soa, qtable)
    return idct_ops.dequant_idct_float_plane(soa_as_blocks(coefs_soa), table_blocks(q, lead))


def dequant_idct_pixels_reference(
    coefs: torch.Tensor, qtable: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of K6's block form: (..., 8, 8) -> uint8 blocks."""
    return idct_ops.dequant_idct_pixels(coefs, qtable.reshape(8, 8))


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from jpeg_gpu_tpu_torch import cuda_build

        lib = cuda_build.load("idct_float")
        lib.jgt_idct_float_planes.restype = ctypes.c_int
        lib.jgt_idct_float_planes.argtypes = PLANES_ARGTYPES
        _lib = lib
    return _lib


def dequant_idct_float_planes_soa(coefs_list, qtables):
    """Up to four SoA coefficient planes (..., 64, vb, hb) int16, any strides
    and each with its own leading axes and grid, and their quant tables
    ((64,) or (8, 8) each, or one per leading index: (..., 64), (..., 8, 8)
    or (..., 1, 1, 8, 8)) -> the list of (..., vb*8, hb*8) uint8 sample
    planes (float IDCT).

    CPU tensors run the plain version plane by plane; CUDA tensors launch the
    kernel once for all planes.
    """
    outs, launched = dispatch_planes(
        "dequant_idct_float_planes_soa", coefs_list, qtables,
        dequant_idct_float_plane_soa_reference, lambda: _kernel().jgt_idct_float_planes)
    if launched:
        global launches
        launches += 1
    return outs


def dequant_idct_float_plane_soa(
    coefs_soa: torch.Tensor,   # (..., 64, vb, hb) int16, any strides
    qtable: torch.Tensor,      # (64,) or (8, 8), or one per leading index
) -> torch.Tensor:
    """SoA coefficients -> (..., vb*8, hb*8) uint8 samples (float IDCT):
    :func:`dequant_idct_float_planes_soa` for one plane."""
    return dequant_idct_float_planes_soa([coefs_soa], [qtable])[0]


def dequant_idct_pixels_fused(coefs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Fused dequant + IDCT + shift + clamp over (..., 8, 8) int blocks ->
    uint8 blocks of the same shape (float path; meets IEEE-1180)."""
    if coefs.dim() < 2 or tuple(coefs.shape[-2:]) != (8, 8):
        raise ValueError(f"blocks must be (..., 8, 8), got {tuple(coefs.shape)}")
    if qtable.numel() != 64:
        raise ValueError(f"one (8, 8) quant table, got {tuple(qtable.shape)}")
    # N blocks are a plane N blocks high and one block wide: its raster
    # (N*8, 8) is the blocks' own memory order.
    blocks = coefs.reshape(-1, 1, 8, 8)
    plane = dequant_idct_float_plane_soa(blocks_as_soa(blocks), qtable)
    return plane.reshape(coefs.shape)
