"""8x8 inverse DCT in float32 (the ``exact=False`` fast path), in PyTorch.

The float ops of ``jpeg_gpu_tpu/ops/idct.py``: the 2-D IDCT in its matrix
form ``x = M^T S M`` with ``M`` the orthonormal 8-point DCT-II basis.  Meets
IEEE-1180; not bit-exact against the islow path (``ops/idct_islow.py``).

These are the plain versions that the K6 kernel (``ops/idct_float.py``,
``csrc/idct_float.cu``) is checked against.  The products must run in full
float32: on a CUDA tensor the functions raise unless PyTorch's TF32 matmul
mode is off (TF32 keeps about three decimal digits and would break the
IEEE-1180 peak-error bound).
"""

from __future__ import annotations

import numpy as np
import torch


# Orthonormal 8-point DCT-II basis, float32. M[u, n] = c(u) cos((2n+1)u pi/16).
def dct_basis(dtype=np.float32) -> np.ndarray:
    u = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    m = np.sqrt(2.0 / 8.0) * np.cos((2 * n + 1) * u * np.pi / 16.0)
    m[0, :] = np.sqrt(1.0 / 8.0)
    return m.astype(dtype)


IDCT_BASIS = dct_basis()


def _basis(like: torch.Tensor) -> torch.Tensor:
    if like.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the float IDCT needs full float32 products: "
            "torch.backends.cuda.matmul.allow_tf32 must be False"
        )
    return torch.from_numpy(IDCT_BASIS).to(like.device)


def idct8x8(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse 2-D DCT of (..., 8, 8) coefficient blocks (float32 out).

    x[i, j] = sum_{u,v} M[u, i] * S[u, v] * M[v, j], contracting u first.
    """
    m = _basis(blocks)
    s = blocks.to(torch.float32)
    t = torch.einsum("...uv,ui->...vi", s, m)
    return torch.einsum("...vi,vj->...ij", t, m)


def dequant_idct(coefs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Dequantize + IDCT: (..., 8, 8) int coefs, (8, 8) quant -> float32."""
    deq = coefs.to(torch.float32) * qtable.to(torch.float32)
    return idct8x8(deq)


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """+128 level shift, round half to even, clamp -> uint8."""
    return torch.round(x + 128.0).clamp(0.0, 255.0).to(torch.uint8)


def dequant_idct_pixels(coefs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Full float sample path: dequant, IDCT, +128 level shift, clamp -> uint8."""
    return _to_u8(dequant_idct(coefs, qtable))


def dequant_idct_float_plane(coefs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Float sample path emitting the raster plane: (..., vb, hb, 8, 8)
    coefficients -> (..., vb*8, hb*8) uint8.

    The reference's order of contraction: v (sample column j) first, then u
    per pixel row.
    """
    m = _basis(coefs)
    *lead, vb, hb, _, _ = coefs.shape
    deq = coefs.to(torch.float32) * qtable.to(torch.float32)
    y = torch.einsum("...uv,vj->...uj", deq, m)
    z = torch.einsum("...uj,ui->...ij", y, m)
    return blocks_to_plane(_to_u8(z))


def blocks_to_plane(blocks: torch.Tensor) -> torch.Tensor:
    """(..., vb, hb, 8, 8) block grid -> (..., vb*8, hb*8) sample plane."""
    *lead, vb, hb, _, _ = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, vb * 8, hb * 8)


def plane_to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, W) sample plane -> (..., H/8, W/8, 8, 8) block grid."""
    *lead, h, w = plane.shape
    return plane.reshape(*lead, h // 8, 8, w // 8, 8).transpose(-3, -2)
