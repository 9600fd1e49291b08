"""Port ops vs the JAX reference: islow IDCT and colour, bit for bit.

The same numpy inputs, drawn from a seed, go through the jnp function and
its PyTorch counterpart in jpeg_gpu_tpu_torch; tolerance 0 (every step is
integer arithmetic).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_gpu_tpu.ops import color as jcolor
from jpeg_gpu_tpu.ops import idct_islow as jidct
from jpeg_gpu_tpu_torch.ops import color as tcolor
from jpeg_gpu_tpu_torch.ops import idct_islow as tidct


def _coefs(seed, shape, lim):
    rng = np.random.default_rng(seed)
    return rng.integers(-lim, lim + 1, size=shape).astype(np.int16)


def _qtable(seed, hi=64):
    return np.random.default_rng(seed).integers(1, hi, size=(8, 8)).astype(np.int32)


def _planes(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.uint8)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed,lim", [(0, 64), (1, 1024), (2, 2047), (3, 8)])
def test_idct8x8_islow(seed, lim):
    deq = _coefs(seed, (50, 8, 8), lim).astype(np.int32) * 8
    _eq(tidct.idct8x8_islow(torch.from_numpy(deq)),
        jidct.idct8x8_islow(jnp.asarray(deq)))


@pytest.mark.parametrize("seed,lim", [(4, 40), (5, 300), (6, 1500)])
def test_dequant_idct_islow_pixels(seed, lim):
    c = _coefs(seed, (3, 5, 8, 8), lim)
    q = _qtable(seed + 10)
    got = tidct.dequant_idct_islow_pixels(torch.from_numpy(c), torch.from_numpy(q))
    assert got.dtype == torch.uint8
    _eq(got, jidct.dequant_idct_islow_pixels(jnp.asarray(c), jnp.asarray(q)))


@pytest.mark.parametrize("shape", [(3, 5), (2, 4, 6), (1, 1)])
def test_dequant_idct_islow_plane(shape):
    c = _coefs(7, shape + (8, 8), 200)
    q = _qtable(8)
    got = tidct.dequant_idct_islow_plane(torch.from_numpy(c), torch.from_numpy(q))
    _eq(got, jidct.dequant_idct_islow_plane(jnp.asarray(c), jnp.asarray(q)))


def test_dequant_accepts_flat_qtable():
    c = torch.from_numpy(_coefs(9, (2, 3, 8, 8), 100))
    q = _qtable(10)
    a = tidct.dequant_idct_islow_plane(c, torch.from_numpy(q))
    b = tidct.dequant_idct_islow_plane(c, torch.from_numpy(q.reshape(64)))
    assert torch.equal(a, b)


@pytest.mark.parametrize("xdec,ydec", [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (2, 1)])
def test_upsample_nearest(xdec, ydec):
    p = _planes(11, (2, 7, 9))
    _eq(tcolor.upsample_nearest(torch.from_numpy(p), xdec, ydec),
        jcolor.upsample_nearest(jnp.asarray(p), xdec, ydec))


@pytest.mark.parametrize("xdec,ydec", [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0)])
@pytest.mark.parametrize("hw", [(7, 9), (1, 1), (16, 5)])
def test_upsample_fancy(xdec, ydec, hw):
    p = _planes(12, hw)
    _eq(tcolor.upsample_fancy(torch.from_numpy(p), xdec, ydec),
        jcolor.upsample_fancy(jnp.asarray(p), xdec, ydec, xp=jnp))


@pytest.mark.parametrize("axis", [-1, -2, 1])
def test_upsample_fancy_h2(axis):
    p = _planes(13, (3, 6, 11))
    _eq(tcolor.upsample_fancy_h2(torch.from_numpy(p), axis),
        jcolor.upsample_fancy_h2(jnp.asarray(p), axis))


def test_upsample_fancy_h2v2():
    p = _planes(14, (2, 9, 13))
    _eq(tcolor.upsample_fancy_h2v2(torch.from_numpy(p)),
        jcolor.upsample_fancy_h2v2(jnp.asarray(p)))


@pytest.mark.parametrize(
    "xdec,ydec,true_w,true_h",
    [(1, 1, 13, 9), (1, 1, 16, 16), (1, 0, 11, 16), (0, 1, 16, 15),
     (0, 0, 16, 16), (2, 0, 10, 16)],
)
def test_upsample_fancy_padded(xdec, ydec, true_w, true_h):
    """On the MCU-padded plane: equal over the true region (past it both
    sides produce garbage that callers crop)."""
    p = _planes(15, (2, 16, 16))
    got = tcolor.upsample_fancy_padded(torch.from_numpy(p), xdec, ydec, true_w, true_h)
    ref = np.asarray(jcolor.upsample_fancy_padded(jnp.asarray(p), xdec, ydec, true_w, true_h))
    h, w = true_h << ydec, true_w << xdec
    np.testing.assert_array_equal(got.numpy()[..., :h, :w], ref[..., :h, :w])


def test_ycbcr_to_rgb_exact():
    y, cb, cr = (_planes(16 + i, (4, 33, 17)) for i in range(3))
    got = tcolor.ycbcr_to_rgb_exact(*(torch.from_numpy(a) for a in (y, cb, cr)))
    assert got.dtype == torch.uint8 and got.shape == (4, 33, 17, 3)
    _eq(got, jcolor.ycbcr_to_rgb_exact(*(jnp.asarray(a) for a in (y, cb, cr))))


@pytest.mark.parametrize("seed", [19, 22])
def test_ycbcr_to_rgb_float(seed):
    """The float matrix: within 1 of the reference (a product that lands on
    a half rounds either way)."""
    y, cb, cr = (_planes(seed + i, (3, 21, 19)) for i in range(3))
    got = tcolor.ycbcr_to_rgb_float(*(torch.from_numpy(a) for a in (y, cb, cr)))
    assert got.dtype == torch.uint8 and got.shape == (3, 21, 19, 3)
    ref = np.asarray(jcolor.ycbcr_to_rgb_float(*(jnp.asarray(a) for a in (y, cb, cr))))
    assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1
    exact = tcolor.ycbcr_to_rgb_exact(*(torch.from_numpy(a) for a in (y, cb, cr)))
    assert (got.int() - exact.int()).abs().max() <= 1
