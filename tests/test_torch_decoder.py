"""The whole port slice vs the JAX reference, on the CPU.

``jpeg_gpu_tpu_torch.decode(data, device="cpu")`` (host entropy -> SoA ->
K1's plain version, or the unfused torch ops for other geometries) must give
the same bytes as ``jpeg_gpu_tpu.decode(data, impl="tpu")`` and
``impl="host"``; tolerance 0.
"""

import numpy as np
import pytest

import jpeg_gpu_tpu as jr
import jpeg_gpu_tpu_torch as jt
from jpeg_gpu_tpu_torch.testing import corpus
from jpeg_gpu_tpu_torch.ops import pixel_fused

ALL_MODES = ["mono", "4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1"]


def _enc(mode, h=33, w=41, seed=4, **kw):
    img = corpus.synthetic_rgb(h, w, seed=seed)
    if mode == "mono":
        img = img[..., 1].copy()
        mode = "4:2:0"
    return corpus.own_jpeg(img, subsampling=mode, quality=75, **kw).data


@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
@pytest.mark.parametrize("mode", ALL_MODES)
def test_rgb_matches_reference(mode, upsample):
    data = _enc(mode, restart_interval=ALL_MODES.index(mode) % 4)
    got = jt.decode(data, device="cpu", upsample=upsample)
    assert got.dtype == np.uint8 and got.shape == (33, 41, 3)
    np.testing.assert_array_equal(got, jr.decode(data, impl="tpu", upsample=upsample))
    np.testing.assert_array_equal(got, jr.decode(data, impl="host", upsample=upsample))


@pytest.mark.parametrize("restart", [0, 1, 2, 3])
def test_restart_intervals(restart):
    data = _enc("4:2:0", restart_interval=restart)
    np.testing.assert_array_equal(
        jt.decode(data, device="cpu"), jr.decode(data, impl="tpu"))


@pytest.mark.parametrize("mode", ["4:2:0", "4:4:4"])
def test_force_16bit_qt(mode):
    data = _enc(mode, force_16bit_qt=True)
    np.testing.assert_array_equal(
        jt.decode(data, device="cpu", upsample="fancy"),
        jr.decode(data, impl="tpu", upsample="fancy"))


@pytest.mark.parametrize("mode", ["4:2:2", "mono"])
def test_python_entropy_still_runs_k1(mode):
    """Blocks from the Python scan decoder are turned into SoA, so the
    fused geometries still go through K1 (its plain version on the CPU)."""
    data = _enc(mode, restart_interval=2)
    before = pixel_fused.launches
    got = jt.decode(data, device="cpu", entropy="python", upsample="fancy")
    assert pixel_fused.launches == before  # CPU tensors never count launches
    np.testing.assert_array_equal(
        got, jr.decode(data, impl="host", entropy="python", upsample="fancy"))


@pytest.mark.parametrize("hw", [(1, 1), (17, 31), (9, 200), (8, 8)])
def test_edge_sizes(hw):
    data = _enc("4:2:0", *hw, seed=1)
    got = jt.decode(data, device="cpu", upsample="fancy")
    assert got.shape == hw + (3,)
    np.testing.assert_array_equal(got, jr.decode(data, impl="host", upsample="fancy"))


@pytest.mark.parametrize("stage", ["yuv", "quant", "dct", "pack"])
def test_stage_cuts(stage):
    data = _enc("4:2:0", restart_interval=1)
    got = jt.decode(data, out=stage, device="cpu")
    ref = jr.decode(data, out=stage, impl="tpu")
    if stage == "pack":
        np.testing.assert_array_equal(got.pack, ref.pack)
        for a, b in zip(got.index, ref.index):
            np.testing.assert_array_equal(a, b)
        return
    for a, b in zip(*(getattr(r, "planes", None) or r.coefs for r in (got, ref))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
def test_host_decoder_matches_reference(upsample):
    data = _enc("4:2:0", 21, 37)
    np.testing.assert_array_equal(
        jt.decode(data, impl="host", upsample=upsample),
        jr.decode(data, impl="host", upsample=upsample))


def test_decoder_reuse_and_reset():
    data = _enc("4:2:2")
    dec = jt.get_decoder(data, device="cpu")
    a = dec.decode()
    dec.reset()
    np.testing.assert_array_equal(a, dec.decode())
    assert dec.decode_header().width == 41


def _error_names(data):
    """Class names of the errors the port and the reference raise."""
    names = []
    for pkg, call in ((jt, lambda: jt.decode(data, device="cpu")),
                      (jr, lambda: jr.decode(data, impl="tpu"))):
        with pytest.raises(pkg.JpegError) as info:
            call()
        names.append(type(info.value).__name__)
    return names


@pytest.mark.parametrize("cut", [2, 30, 200, -40])
def test_truncated_raises_jpeg_error(cut):
    data = _enc("4:2:0", restart_interval=1)
    a, b = _error_names(data[:cut])
    assert a == b


@pytest.mark.parametrize("data", [b"", b"\x00\x01\x02", b"\xff\xd8\xff"])
def test_garbage_raises_jpeg_error(data):
    a, b = _error_names(data)
    assert a == b


def test_progressive_raises_unsupported():
    data = _enc("4:2:0").replace(b"\xff\xc0", b"\xff\xc2", 1)
    assert _error_names(data) == ["JpegUnsupportedError"] * 2


@pytest.mark.parametrize("mode", ALL_MODES)
def test_decode_header_fields_equal(mode):
    data = _enc(mode, restart_interval=2, force_16bit_qt=mode == "4:4:0")
    a, b = jt.decode_header(data), jr.decode_header(data)
    assert a.describe() == b.describe()
    assert a.subsampling.value == b.subsampling.value
    assert [dataclass_tuple(c) for c in a.components] == [
        dataclass_tuple(c) for c in b.components]
    for qa, qb in zip(a.quant_tables, b.quant_tables):
        assert (qa is None) == (qb is None)
        if qa is not None:
            assert qa.precision == qb.precision
            np.testing.assert_array_equal(qa.values, qb.values)


def dataclass_tuple(c):
    return (c.comp_id, c.hsamp, c.vsamp, c.quant_idx, c.width, c.height,
            c.hblocks, c.vblocks, c.xdec, c.ydec)


@pytest.mark.parametrize("kw", [{"upload": "pack"}, {"exact": False}])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jt.TorchDecoder(_enc("4:2:0"), device="cpu", **kw)
