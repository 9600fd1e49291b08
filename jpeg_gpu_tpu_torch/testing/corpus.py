"""Test corpus builder.

Two generation paths, complementary:

* :func:`pil_jpeg` -- Pillow/libjpeg-turbo encodes (standard or optimized
  Huffman tables, 4:4:4/4:2:2/4:2:0, restart markers); fast, used for large
  benchmark images and for cross-encoder coverage.
* :func:`own_jpeg` -- our from-scratch encoder (testing/encoder.py) for the
  modes Pillow cannot emit (4:4:0, 4:1:1, 16-bit DQT) and for ground-truth
  quantized coefficients.

Synthetic image content is deterministic (seeded) and chosen to exercise
the pipeline: smooth gradients (low-frequency), noise (dense spectra),
edges (ringing/clamping), and flat patches (EOB-heavy streams).
"""

from __future__ import annotations

import io
from typing import Optional, Tuple

import numpy as np

from jpeg_gpu_tpu_torch.testing.encoder import EncodeResult, encode

PIL_SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def synthetic_rgb(height: int, width: int, seed: int = 0) -> np.ndarray:
    """Deterministic RGB test content mixing gradients, texture and edges."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    r = 128 + 100 * np.sin(2 * np.pi * xx / max(width, 1) * 3) * np.cos(
        2 * np.pi * yy / max(height, 1) * 2
    )
    g = (xx * 255 / max(width - 1, 1)) * 0.7 + (yy * 255 / max(height - 1, 1)) * 0.3
    b = np.where((xx // 32 + yy // 32) % 2 == 0, 200.0, 40.0)
    img = np.stack([r, g, b], axis=-1)
    img += rng.normal(0, 12, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def synthetic_gray(height: int, width: int, seed: int = 0) -> np.ndarray:
    return synthetic_rgb(height, width, seed)[..., 1].copy()


def pil_jpeg(
    image: np.ndarray,
    quality: int = 85,
    subsampling: str = "4:2:0",
    optimize: bool = False,
    restart_marker_blocks: int = 0,
) -> bytes:
    """Encode via Pillow. Grayscale input -> single-component JPEG."""
    from PIL import Image

    if image.ndim == 2:
        pil = Image.fromarray(image, mode="L")
        kwargs = {}
    else:
        pil = Image.fromarray(image, mode="RGB")
        kwargs = {"subsampling": PIL_SUBSAMPLING[subsampling]}
    if optimize:
        kwargs["optimize"] = True
    if restart_marker_blocks:
        kwargs["restart_marker_blocks"] = restart_marker_blocks
    buf = io.BytesIO()
    pil.save(buf, format="JPEG", quality=quality, **kwargs)
    return buf.getvalue()


def own_jpeg(
    image: np.ndarray,
    subsampling: str = "4:2:0",
    quality: int = 85,
    restart_interval: int = 0,
    force_16bit_qt: bool = False,
    scan_order=None,
) -> EncodeResult:
    return encode(
        image,
        subsampling=subsampling,
        quality=quality,
        restart_interval=restart_interval,
        force_16bit_qt=force_16bit_qt,
        scan_order=scan_order,
    )
