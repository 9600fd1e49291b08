"""Golden decoders for differential testing.

The reference treats libjpeg as its always-available oracle behind the same
vtbl (jpeg_wrap.c:61-244, pinned to ``do_fancy_upsampling=FALSE`` and
``JDCT_ISLOW`` for comparability).  Here the oracles are:

* **Pillow (libjpeg-turbo)** for pixel output.  Pillow pins neither knob, so
  exactness expectations are documented per mode:
  - grayscale: bit-exact (islow IDCT, no upsampling/color involved),
  - 4:4:4 RGB: bit-exact (islow + exact integer color convert, no upsample),
  - subsampled RGB: PSNR-bounded only (Pillow uses fancy upsampling;
    we implement the reference's nearest/replication semantics).
* **float64 reference IDCT/pipeline** (this module) as the numerical oracle
  for IEEE-1180 style conformance, mirroring the role of dct.c / test/dct.c.
"""

from __future__ import annotations

import io
from typing import List, Optional

import numpy as np

from jpeg_gpu_tpu_torch.testing.encoder import _M  # orthonormal 8x8 DCT basis


def pil_decode_rgb(data: bytes) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB") if img.mode != "RGB" else img
    return np.asarray(img)


def pil_decode_gray(data: bytes) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    assert img.mode == "L", f"expected grayscale, got {img.mode}"
    return np.asarray(img)


def pil_decode_ycbcr(data: bytes) -> np.ndarray:
    """Decode to raw (upsampled) YCbCr planes, no RGB round trip.

    Uses PIL draft mode so libjpeg emits YCbCr directly; ``convert`` would
    route through RGB and perturb the samples.  Raw planes are bit-exact
    only for 4:4:4 sources (no upsampling in the way).
    """
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img.draft("YCbCr", img.size)
    assert img.mode == "YCbCr"
    return np.asarray(img.convert("YCbCr"))


def idct8x8_float64(blocks: np.ndarray) -> np.ndarray:
    """Reference inverse DCT: x = M.T @ S @ M, float64 (oracle for kernels)."""
    return np.einsum("ui,...uv,vj->...ij", _M, blocks.astype(np.float64), _M)


def reference_idct_pixels(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Dequantize + float64 IDCT + level shift + clamp, (..., 8, 8) -> uint8."""
    deq = coefs.astype(np.float64) * qtable.astype(np.float64)
    pix = idct8x8_float64(deq) + 128.0
    return np.clip(np.round(pix), 0, 255).astype(np.uint8)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0**2 / mse)
