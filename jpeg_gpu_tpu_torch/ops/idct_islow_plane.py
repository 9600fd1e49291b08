"""K5: SoA coefficient planes -> dequant + islow IDCT -> raster sample planes.

The port of ``jpeg_gpu_tpu/ops/idct_islow_pallas.py``.
``dequant_idct_islow_planes_soa`` serves the exact YUV stage, grayscale RGB
and every 3-component geometry the fused RGB kernel does not take: all
components of a frame in one call, each with its own grid and quant table
(or a table per leading index, as the batch code passes them), bit-exact
against ``ops/idct_islow.dequant_idct_islow_plane``.
``dequant_idct_islow_plane_soa`` is its one-plane case.

On CUDA tensors the wrapper launches the hand-written kernel in
``csrc/idct_islow_plane.cu`` once for up to four planes; on CPU tensors it
runs the plain PyTorch version (``dequant_idct_islow_plane_soa_reference``)
plane by plane.  Both give identical bytes.  Any ``vb, hb >= 1``: the
reference's ``band`` argument and its ``vb % band == 0`` rule were TPU
tiling and are gone.
"""

from __future__ import annotations

import ctypes

import torch

from jpeg_gpu_tpu_torch.ops import idct_islow
from jpeg_gpu_tpu_torch.ops.block_plane import (
    PLANES_ARGTYPES,
    check_plane_args,
    dispatch_planes,
    soa_as_blocks,
    table_blocks,
)

# Kernel launches since the last reset (set to 0 to start counting).
launches = 0


def dequant_idct_islow_plane_soa_reference(
    coefs_soa: torch.Tensor, qtable: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of K5, on any device: planes back to blocks,
    then the unfused islow ops."""
    lead, *_, q = check_plane_args(coefs_soa, qtable)
    return idct_islow.dequant_idct_islow_plane(soa_as_blocks(coefs_soa), table_blocks(q, lead))


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from jpeg_gpu_tpu_torch import cuda_build

        lib = cuda_build.load("idct_islow_plane")
        lib.jgt_idct_islow_planes.restype = ctypes.c_int
        lib.jgt_idct_islow_planes.argtypes = PLANES_ARGTYPES
        _lib = lib
    return _lib


def dequant_idct_islow_planes_soa(coefs_list, qtables):
    """Up to four SoA coefficient planes (..., 64, vb, hb) int16, any strides
    and each with its own leading axes and grid, and their quant tables
    ((64,) or (8, 8) each, or one per leading index: (..., 64), (..., 8, 8)
    or (..., 1, 1, 8, 8)) -> the list of (..., vb*8, hb*8) uint8 sample
    planes (bit-exact islow).

    CPU tensors run the plain version plane by plane; CUDA tensors launch the
    kernel once for all planes.
    """
    outs, launched = dispatch_planes(
        "dequant_idct_islow_planes_soa", coefs_list, qtables,
        dequant_idct_islow_plane_soa_reference, lambda: _kernel().jgt_idct_islow_planes)
    if launched:
        global launches
        launches += 1
    return outs


def dequant_idct_islow_plane_soa(
    coefs_soa: torch.Tensor,   # (..., 64, vb, hb) int16, any strides
    qtable: torch.Tensor,      # (64,) or (8, 8), or one per leading index
) -> torch.Tensor:
    """SoA coefficients -> (..., vb*8, hb*8) uint8 samples (bit-exact islow):
    :func:`dequant_idct_islow_planes_soa` for one plane."""
    return dequant_idct_islow_planes_soa([coefs_soa], [qtable])[0]
