"""K5: SoA coefficient planes -> dequant + islow IDCT -> raster sample plane.

The port of ``jpeg_gpu_tpu/ops/idct_islow_pallas.py``.
``dequant_idct_islow_plane_soa`` serves the exact YUV stage, grayscale RGB
and every 3-component geometry the fused RGB kernel does not take: one call
per component, bit-exact against ``ops/idct_islow.dequant_idct_islow_plane``.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/idct_islow_plane.cu``; on a CPU tensor it runs the plain PyTorch
version (``dequant_idct_islow_plane_soa_reference``).  Both give identical
bytes.  Any ``vb, hb >= 1``: the reference's ``band`` argument and its
``vb % band == 0`` rule were TPU tiling and are gone.
"""

from __future__ import annotations

import ctypes

import torch

from jpeg_gpu_tpu_torch.ops import idct_islow
from jpeg_gpu_tpu_torch.ops.block_plane import (
    PLANE_ARGTYPES,
    check_plane_args,
    launch_plane_kernel,
    soa_as_blocks,
)

# Kernel launches since the last reset (set to 0 to start counting).
launches = 0


def dequant_idct_islow_plane_soa_reference(
    coefs_soa: torch.Tensor, qtable: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of K5, on any device: planes back to blocks,
    then the unfused islow ops."""
    *_, q = check_plane_args(coefs_soa, qtable)
    return idct_islow.dequant_idct_islow_plane(soa_as_blocks(coefs_soa), q.reshape(8, 8))


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from jpeg_gpu_tpu_torch import cuda_build

        lib = cuda_build.load("idct_islow_plane")
        lib.jgt_idct_islow_plane.restype = ctypes.c_int
        lib.jgt_idct_islow_plane.argtypes = PLANE_ARGTYPES
        _lib = lib
    return _lib


def dequant_idct_islow_plane_soa(
    coefs_soa: torch.Tensor,   # (..., 64, vb, hb) int16, any strides
    qtable: torch.Tensor,      # (64,) or (8, 8)
) -> torch.Tensor:
    """SoA coefficients -> (..., vb*8, hb*8) uint8 samples (bit-exact islow).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    dev = coefs_soa.device
    if dev.type == "cpu":
        return dequant_idct_islow_plane_soa_reference(coefs_soa, qtable)
    if dev.type != "cuda":
        raise RuntimeError(f"dequant_idct_islow_plane_soa: no kernel for device {dev}")
    out = launch_plane_kernel(
        _kernel().jgt_idct_islow_plane, "idct_islow_plane", coefs_soa, qtable
    )
    global launches
    launches += 1
    return out
