"""K5: SoA coefficient planes -> dequant + islow IDCT -> raster sample planes.

The port of ``jpeg_gpu_tpu/ops/idct_islow_pallas.py``.
``dequant_idct_islow_planes_soa`` serves the exact YUV stage, grayscale RGB
and every 3-component geometry the fused RGB kernel does not take: all
components of a frame in one call, each with its own grid and quant table,
bit-exact against ``ops/idct_islow.dequant_idct_islow_plane``.
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
    MAX_PLANES,
    check_plane_args,
    launch_planes_kernel,
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
        lib.jgt_idct_islow_planes.restype = ctypes.c_int
        lib.jgt_idct_islow_planes.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def dequant_idct_islow_planes_soa(coefs_list, qtables):
    """Up to four SoA coefficient planes (..., 64, vb, hb) int16, any strides
    and each with its own leading axes and grid, and their quant tables
    ((64,) or (8, 8) each) -> the list of (..., vb*8, hb*8) uint8 sample
    planes (bit-exact islow).

    CPU tensors run the plain version plane by plane; CUDA tensors launch the
    kernel once for all planes.
    """
    coefs_list, qtables = list(coefs_list), list(qtables)
    if not 1 <= len(coefs_list) <= MAX_PLANES or len(qtables) != len(coefs_list):
        raise ValueError(
            f"1 to {MAX_PLANES} planes with a quant table each, got {len(coefs_list)} planes "
            f"and {len(qtables)} tables")
    dev = coefs_list[0].device
    if any(t.device != dev for t in coefs_list + qtables):
        raise ValueError(f"dequant_idct_islow_planes_soa: all planes and tables must be on {dev}")
    if dev.type == "cpu":
        return [dequant_idct_islow_plane_soa_reference(c, q)
                for c, q in zip(coefs_list, qtables)]
    if dev.type != "cuda":
        for c, q in zip(coefs_list, qtables):
            check_plane_args(c, q)
        raise RuntimeError(f"dequant_idct_islow_planes_soa: no kernel for device {dev}")
    outs = launch_planes_kernel(
        _kernel().jgt_idct_islow_planes, "idct_islow_plane", coefs_list, qtables)
    global launches
    launches += 1
    return outs


def dequant_idct_islow_plane_soa(
    coefs_soa: torch.Tensor,   # (..., 64, vb, hb) int16, any strides
    qtable: torch.Tensor,      # (64,) or (8, 8)
) -> torch.Tensor:
    """SoA coefficients -> (..., vb*8, hb*8) uint8 samples (bit-exact islow):
    :func:`dequant_idct_islow_planes_soa` for one plane."""
    return dequant_idct_islow_planes_soa([coefs_soa], [qtable])[0]
