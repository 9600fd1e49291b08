"""Bit-exact integer inverse DCT ("islow"-compatible), in PyTorch.

The same arithmetic as ``jpeg_gpu_tpu/ops/idct_islow.py``: the
Loeffler-Ligtenberg-Moshovitz 8-point IDCT with 13-bit constants, two
passes, pass-1 descale by CONST_BITS-PASS1_BITS and final descale by
CONST_BITS+PASS1_BITS+3, so decoded samples are bit-identical to libjpeg's
``JDCT_ISLOW`` output.

Everything runs on int32 tensors on any device.  ``>>`` on a signed torch
integer tensor is an arithmetic shift, as jnp's is, and int32 products wrap
the same way.  These are the plain versions that the CUDA kernels sharing
``csrc/idct_islow.cuh`` (K1 ``pixel_fused.cu``, K5 ``idct_islow_plane.cu``)
are checked against.
"""

from __future__ import annotations

import torch

CONST_BITS = 13
PASS1_BITS = 2

# FIX(x) = round(x * 2^13) for the standard rotation constants.
F_0_298631336 = 2446
F_0_390180644 = 3196
F_0_541196100 = 4433
F_0_765366865 = 6270
F_0_899976223 = 7373
F_1_175875602 = 9633
F_1_501321110 = 12299
F_1_847759065 = 15137
F_1_961570560 = 16069
F_2_053119869 = 16819
F_2_562915447 = 20995
F_3_072711026 = 25172


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    """(x + 2^(n-1)) >> n with arithmetic shift (fixed-point rounding)."""
    return (x + (1 << (n - 1))) >> n


def _idct8(c0, c1, c2, c3, c4, c5, c6, c7, descale_bits: int):
    """One 8-point integer IDCT pass over int32 lanes.

    Inputs are the 8 frequency lanes; returns the 8 sample lanes, each
    descaled by ``descale_bits``.
    """
    # Even part: rotate (c2, c6), combine with (c0, c4).
    z1 = (c2 + c6) * F_0_541196100
    t2 = z1 - c6 * F_1_847759065
    t3 = z1 + c2 * F_0_765366865
    t0 = (c0 + c4) << CONST_BITS
    t1 = (c0 - c4) << CONST_BITS
    e0 = t0 + t3
    e3 = t0 - t3
    e1 = t1 + t2
    e2 = t1 - t2

    # Odd part: 4-point section with the 1.175 common rotation.
    z1 = c7 + c1
    z2 = c5 + c3
    z3 = c7 + c3
    z4 = c5 + c1
    z5 = (z3 + z4) * F_1_175875602
    o0 = c7 * F_0_298631336
    o1 = c5 * F_2_053119869
    o2 = c3 * F_3_072711026
    o3 = c1 * F_1_501321110
    z1 = z1 * (-F_0_899976223)
    z2 = z2 * (-F_2_562915447)
    z3 = z3 * (-F_1_961570560) + z5
    z4 = z4 * (-F_0_390180644) + z5
    o0 = o0 + z1 + z3
    o1 = o1 + z2 + z4
    o2 = o2 + z2 + z3
    o3 = o3 + z1 + z4

    return (
        _descale(e0 + o3, descale_bits),
        _descale(e1 + o2, descale_bits),
        _descale(e2 + o1, descale_bits),
        _descale(e3 + o0, descale_bits),
        _descale(e3 - o0, descale_bits),
        _descale(e2 - o1, descale_bits),
        _descale(e1 - o2, descale_bits),
        _descale(e0 - o3, descale_bits),
    )


def idct8x8_islow(deq: torch.Tensor) -> torch.Tensor:
    """Integer IDCT of dequantized (..., 8, 8) blocks -> int32 samples.

    Output samples are centered (level shift NOT applied); callers add 128
    and clamp.
    """
    x = deq.to(torch.int32)
    # Pass 1: columns (along axis -2).
    p1 = _idct8(*x.unbind(-2), descale_bits=CONST_BITS - PASS1_BITS)
    y = torch.stack(p1, dim=-2)
    # Pass 2: rows (axis -1); the final descale folds in the x8 scale.
    p2 = _idct8(*y.unbind(-1), descale_bits=CONST_BITS + PASS1_BITS + 3)
    return torch.stack(p2, dim=-1)


def dequant_idct_islow_pixels(
    coefs: torch.Tensor, qtable: torch.Tensor
) -> torch.Tensor:
    """Bit-exact sample path: int dequant, islow IDCT, +128, clamp -> uint8.

    ``qtable`` is (64,) in raster order, or anything that broadcasts
    against the (..., 8, 8) blocks.
    """
    q = qtable.to(torch.int32)
    deq = coefs.to(torch.int32) * (q.reshape(8, 8) if q.ndim == 1 else q)
    x = idct8x8_islow(deq) + 128
    return x.clamp(0, 255).to(torch.uint8)


def dequant_idct_islow_plane(
    coefs: torch.Tensor, qtable: torch.Tensor
) -> torch.Tensor:
    """(..., vb, hb, 8, 8) coefficients -> (..., vb*8, hb*8) uint8 raster plane."""
    pix = dequant_idct_islow_pixels(coefs, qtable)
    *lead, vb, hb, _, _ = pix.shape
    return pix.transpose(-3, -2).reshape(*lead, vb * 8, hb * 8)
