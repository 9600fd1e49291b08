"""Zig-zag scan order tables (cf. xjpeg.c:33-53).

Generated programmatically by walking the 8x8 anti-diagonals rather than
transcribed, so they are correct by construction.

``ZIGZAG[k]``   = raster index (row*8+col) of the k-th coefficient in
                  zig-zag (bitstream) order.
``DEZIGZAG[r]`` = zig-zag position of raster index r (the inverse permutation).
"""

from __future__ import annotations

import numpy as np


def _make_zigzag() -> np.ndarray:
    order = []
    for s in range(15):  # anti-diagonal index: row + col = s
        rng = range(s + 1) if s < 8 else range(s - 7, 8)
        coords = [(r, s - r) for r in rng]
        # Even diagonals are walked bottom-left -> top-right, odd ones the
        # reverse; diagonal 0 starts at (0, 0) moving right first.
        if s % 2 == 0:
            coords = coords[::-1]
        order.extend(r * 8 + c for r, c in coords)
    return np.array(order, dtype=np.int32)


ZIGZAG: np.ndarray = _make_zigzag()
DEZIGZAG: np.ndarray = np.argsort(ZIGZAG).astype(np.int32)


def zigzag_to_raster(values64: np.ndarray) -> np.ndarray:
    """Reorder a (..., 64) zig-zag-ordered vector into (..., 8, 8) raster."""
    out = np.empty(values64.shape, dtype=values64.dtype)
    out[..., ZIGZAG] = values64
    return out.reshape(values64.shape[:-1] + (8, 8))


def raster_to_zigzag(block: np.ndarray) -> np.ndarray:
    """Reorder (..., 8, 8) raster blocks into (..., 64) zig-zag order."""
    flat = block.reshape(block.shape[:-2] + (64,))
    return flat[..., ZIGZAG]
