"""The port against the independent libjpeg-turbo oracle.

The port of ``tests/test_oracle_native.py`` and ``tests/test_fancy.py``:
the port's decoders (``impl="torch"`` on the CPU and ``impl="host"``) equal
libjpeg bit for bit at the QUANT and YUV cuts, and at the RGB cut for
grayscale, 4:4:4 and the fancy-upsampled 4:2:0 and 4:2:2 modes, through
the port's own ``PilDecoder`` and ctypes shim (``host/oracle_native.py``).
Where the shim cannot build (no system libjpeg headers, as on a machine
without them) the tests skip; ``PilDecoder`` then raises
JpegUnsupportedError, which is tested here too.
"""

import sys

import numpy as np
import pytest

from jpeg_gpu_tpu_torch import decode, get_decoder
from jpeg_gpu_tpu_torch.errors import JpegUnsupportedError
from jpeg_gpu_tpu_torch.host import oracle_native
from jpeg_gpu_tpu_torch.testing import corpus, oracle

MODES = ["4:4:4", "4:2:2", "4:2:0"]
IMPLS = [("torch", {"device": "cpu"}), ("host", {})]


@pytest.fixture()
def shim():
    if not oracle_native.available():
        pytest.skip("system libjpeg shim unavailable")


def _foreign(mode, h=48, w=64, seed=21, **kw):
    if mode == "gray":
        return corpus.pil_jpeg(corpus.synthetic_gray(h - 7, w - 7, seed=seed), quality=90)
    img = corpus.synthetic_rgb(h, w, seed=seed)
    return corpus.pil_jpeg(img, quality=87, subsampling=mode, **kw)


@pytest.mark.parametrize("mode", ["gray"] + MODES)
@pytest.mark.parametrize("impl,kw", IMPLS)
def test_quant_and_dct_cuts_match_libjpeg(shim, mode, impl, kw):
    data = _foreign(mode)
    for stage in ("quant", "dct"):
        ours = decode(data, out=stage, impl=impl, **kw)
        ref = decode(data, out=stage, impl="pil")
        assert len(ours.coefs) == len(ref.coefs)
        for a, b in zip(ours.coefs, ref.coefs):
            assert a.shape == b.shape  # both MCU-aligned dense grids
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("mode", ["gray"] + MODES)
@pytest.mark.parametrize("impl,kw", IMPLS + [("torch", {"device": "cpu", "entropy": "device"})])
def test_yuv_cut_matches_libjpeg(shim, mode, impl, kw, restart):
    """Pre-upsample planes: islow IDCT makes these bit-exact."""
    data = _foreign(mode, seed=24, restart_marker_blocks=restart) if mode != "gray" else \
        _foreign(mode, seed=24)
    ours = decode(data, out="yuv", impl=impl, **kw)
    ref = decode(data, out="yuv", impl="libjpeg")
    assert len(ours.planes) == len(ref.planes)
    for a, b in zip(ours.planes, ref.planes):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["gray", "4:4:4"])
@pytest.mark.parametrize("impl,kw", IMPLS)
def test_rgb_cut_without_upsampling_matches_libjpeg(shim, mode, impl, kw):
    """No upsampling in the way: both upsample modes equal the shim and
    Pillow, the PIL backend included."""
    data = _foreign(mode, h=67, w=93, seed=5)
    ref = oracle_native.libjpeg_rgb(data, fancy=False)
    np.testing.assert_array_equal(decode(data, impl="pil"), ref)
    for upsample in ("nearest", "fancy"):
        np.testing.assert_array_equal(decode(data, impl=impl, upsample=upsample, **kw), ref)


@pytest.mark.parametrize("mode", ["4:2:2", "4:2:0"])
@pytest.mark.parametrize("impl,kw", IMPLS + [("torch", {"device": "cpu", "entropy": "device"})])
def test_fancy_rgb_bit_exact_vs_libjpeg(shim, mode, impl, kw):
    """Fancy (triangle) upsampling reproduces libjpeg's default RGB output
    exactly: the shim's pinned islow + fancy decode and Pillow's."""
    data = _foreign(mode, h=67, w=93, seed=26)
    got = decode(data, out="rgb", impl=impl, upsample="fancy", **kw)
    np.testing.assert_array_equal(got, oracle_native.libjpeg_rgb(data, fancy=True))
    np.testing.assert_array_equal(got, oracle.pil_decode_rgb(data))


def test_fancy_batched_matches_libjpeg(shim):
    """The batch decoder's fancy buckets, per-image tables and all."""
    from jpeg_gpu_tpu_torch.engine.batch import decode_batch

    datas = [_foreign("4:2:0", seed=s, restart_marker_blocks=1) for s in (30, 31)]
    datas.append(corpus.pil_jpeg(corpus.synthetic_rgb(48, 64, seed=32), quality=60,
                                 subsampling="4:2:0"))
    for got, data in zip(decode_batch(datas, upsample="fancy", device="cpu"), datas):
        np.testing.assert_array_equal(got, oracle_native.libjpeg_rgb(data, fancy=True))


def test_oracle_helpers():
    img = corpus.synthetic_gray(16, 16, seed=1)
    assert oracle.psnr(img, img) == float("inf")
    coefs = np.zeros((1, 8, 8), np.int16)
    coefs[0, 0, 0] = 8
    px = oracle.reference_idct_pixels(coefs, np.ones((8, 8)))
    np.testing.assert_array_equal(px, np.full((1, 8, 8), 129, np.uint8))


def test_pil_decoder_without_shim_or_pillow(monkeypatch):
    """Every stage raises JpegUnsupportedError cleanly where the shim cannot
    build and Pillow is missing; PACK has no libjpeg analogue at all."""
    data = _foreign("4:2:0")
    monkeypatch.setattr(oracle_native, "_load", lambda: None)
    monkeypatch.setitem(sys.modules, "PIL", None)   # import PIL raises ImportError
    assert not oracle_native.available()
    assert oracle_native.libjpeg_probe(data) == "oracle unavailable"
    for stage in ("quant", "dct", "yuv", "rgb", "pack"):
        with pytest.raises(JpegUnsupportedError):
            decode(data, out=stage, impl="pil")
    dec = get_decoder(data, impl="libjpeg")
    assert dec.host_entropy() is None and dec.io_bytes()["payload"] == "none"


def test_libjpeg_probe(shim):
    assert oracle_native.libjpeg_probe(_foreign("4:2:0")) is None
    assert oracle_native.libjpeg_probe(b"\xff\xd8garbage") is not None
