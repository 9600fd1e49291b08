"""The whole port slice vs the JAX reference, on the CPU.

``jpeg_gpu_tpu_torch.decode(data, device="cpu")`` (host entropy -> SoA ->
K1's plain version, or the unfused torch ops for other geometries) must give
the same bytes as ``jpeg_gpu_tpu.decode(data, impl="tpu")`` and
``impl="host"``; tolerance 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jpeg_gpu_tpu as jr
import jpeg_gpu_tpu_torch as jt
from jpeg_gpu_tpu.engine import pipeline as jpipe
from jpeg_gpu_tpu_torch.engine import pipeline as tpipe
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


def _parts(r):
    """The arrays of a stage result (planes, coefficients, or the image)."""
    if isinstance(r, np.ndarray):
        return [r]
    return getattr(r, "planes", None) or r.coefs


def _maxdiff(a, b):
    return max(int(np.abs(x.astype(int) - y.astype(int)).max())
               for x, y in zip(_parts(a), _parts(b)))


@pytest.mark.parametrize("stage", ["quant", "dct", "yuv", "rgb"])
@pytest.mark.parametrize("mode", ["4:2:0", "4:4:4", "mono"])
def test_pack_upload_matches_reference(mode, stage):
    """upload="pack": host Huffman -> packed stream -> K4 (its plain version
    here) -> the unfused pipeline; tolerance 0 at every stage cut."""
    data = _enc(mode, restart_interval=ALL_MODES.index(mode) % 3)
    got = jt.decode(data, out=stage, device="cpu", upload="pack")
    ref = jr.decode(data, out=stage, impl="tpu", upload="pack")
    assert len(_parts(got)) == len(_parts(ref))
    for a, b in zip(_parts(got), _parts(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_parts(got), _parts(jt.decode(data, out=stage, device="cpu"))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
def test_pack_upload_python_entropy_and_fancy(upsample):
    data = _enc("4:2:2", 21, 37)
    got = jt.decode(data, device="cpu", upload="pack", entropy="python", upsample=upsample)
    np.testing.assert_array_equal(
        got, jr.decode(data, impl="tpu", upload="pack", upsample=upsample))


@pytest.mark.parametrize("stage", ["yuv", "rgb"])
@pytest.mark.parametrize("mode", ["4:2:0", "4:4:4", "mono", "4:1:1"])
def test_float_path_matches_reference(mode, stage):
    """exact=False (K6's plain version + the float colour matrix): within 1
    of the reference on planes and 2 on RGB (float sums run in another
    order in the two packages), and within 4 of the exact decode."""
    data = _enc(mode)
    got = jt.decode(data, out=stage, device="cpu", exact=False, upsample="fancy")
    ref = jr.decode(data, out=stage, impl="tpu", exact=False, upsample="fancy")
    exact = jt.decode(data, out=stage, device="cpu", upsample="fancy")
    for a, b in zip(_parts(got), _parts(ref)):
        assert a.dtype == np.uint8 and a.shape == b.shape
    assert _maxdiff(got, ref) <= (2 if stage == "rgb" else 1)
    assert _maxdiff(got, exact) <= 4


def test_float_path_with_pack_upload():
    data = _enc("4:2:0", restart_interval=2)
    got = jt.decode(data, device="cpu", exact=False, upload="pack")
    assert _maxdiff(got, jr.decode(data, impl="tpu", exact=False, upload="pack")) <= 2
    np.testing.assert_array_equal(got, jt.decode(data, device="cpu", exact=False))


@pytest.mark.parametrize("mode", ["h1v4", "h2v4"])
@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
def test_unfused_three_component_geometry(mode, upsample):
    """Luma sampled 4 high is no geometry of the fused kernel: the RGB
    decode runs one plane IDCT per component, then upsampling and colour."""
    img = corpus.synthetic_rgb(40, 48, seed=16)
    data = corpus.own_jpeg(img, subsampling=mode, quality=82, restart_interval=2).data
    got = jt.decode(data, device="cpu", upsample=upsample)
    np.testing.assert_array_equal(got, jr.decode(data, impl="tpu", upsample=upsample))


@pytest.mark.parametrize("mode", ["4:2:0", "mono"])
@pytest.mark.parametrize("stage", ["rgb", "quant"])
def test_io_bytes_pack_equals_reference(mode, stage):
    data = _enc(mode, restart_interval=1)
    got = jt.get_decoder(data, device="cpu", upload="pack").io_bytes(stage)
    assert got == jr.get_decoder(data, impl="tpu", upload="pack").io_bytes(stage)
    assert got["payload"] == "pack"
    dense = jt.get_decoder(data, device="cpu").io_bytes(stage)
    assert dense["payload"] == "host" and dense["download"] == got["download"]


def test_host_entropy_returns_pack_scan():
    dec = jt.get_decoder(_enc("4:2:0"), device="cpu", upload="pack")
    scan = dec.host_entropy("rgb")
    assert scan.pack is not None and scan.pack_index is not None
    assert jt.get_decoder(_enc("4:2:0"), device="cpu").host_entropy("yuv").pack is None


def test_bad_upload_rejected():
    with pytest.raises(ValueError, match="upload"):
        jt.TorchDecoder(_enc("4:2:0"), device="cpu", upload="bits")


def test_default_device_is_the_card():
    """device=None means "cuda": without a card the decoder raises instead
    of decoding on the CPU."""
    import torch

    data = _enc("4:2:0")
    if torch.cuda.is_available():
        assert jt.TorchDecoder(data).device.type == "cuda"
        return
    for make in (lambda: jt.TorchDecoder(data), lambda: jt.decode(data),
                 lambda: jt.get_decoder(data, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.mark.parametrize("name", [
    "entropy_decode_device", "decode_image_device", "expand_pack_device"])
def test_engine_default_device_is_the_card(name):
    """The engine's own entry points follow the decoder: no device named
    means the card, and without one they raise before decoding anything."""
    import torch

    from jpeg_gpu_tpu_torch.engine import device_entropy
    from jpeg_gpu_tpu_torch.host import entropy as host_entropy
    from jpeg_gpu_tpu_torch.host.parser import parse

    parsed = parse(_enc("4:2:0", restart_interval=2))
    args = (parsed,)
    if name == "expand_pack_device":
        args += (host_entropy.decode_scan(parsed, want_pack=True),)
    fn = getattr(device_entropy, name)
    if torch.cuda.is_available():
        out = fn(*args)
        first = out.coefs[0] if name == "entropy_decode_device" else out[0]
        assert first.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(*args)


def test_xjpeg_is_an_alias_of_the_host_decoder():
    """impl="xjpeg" names the host decoder, as in the reference."""
    data = _enc("4:2:0", restart_interval=1)
    dec = jt.get_decoder(data, impl="xjpeg", upsample="fancy")
    assert isinstance(dec, jt.HostDecoder)
    want = jt.get_decoder(data, impl="host", upsample="fancy")
    np.testing.assert_array_equal(dec.decode(), want.decode())
    for a, b in zip(_parts(dec.decode("yuv")), _parts(want.decode("yuv"))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jt.decode(data, impl="xjpeg"), jr.decode(data, impl="xjpeg"))


# -- the unfused pipeline with a quant table per image ------------------------
# (name, luma sampling, exact, upsample): grayscale, a 3-component geometry
# the fused kernel does not take, and the float path.
BATCH_GEOMS = [
    ("gray", None, True, "nearest"),
    ("h2v4", (2, 4), True, "nearest"),
    ("h2v4", (2, 4), True, "fancy"),
    ("4:2:0", (2, 2), False, "nearest"),
    ("4:2:0", (2, 2), False, "fancy"),
]


def _batch_case(samp, h=37, w=45, n=3, seed=31):
    """Random coefficient blocks of ``n`` images of one geometry and a
    different quant table per image and component, (n, 1, 1, 8, 8) each, as
    the reference's batch code hands them to decode_rgb."""
    rng = np.random.default_rng(seed)
    scale = np.maximum(1, 200 >> np.add.outer(np.arange(8), np.arange(8)))
    sx, sy = samp or (1, 1)
    nh, nv = -(-w // (8 * sx)), -(-h // (8 * sy))
    grids = [(nv * sy, nh * sx)] + ([(nv, nh)] * 2 if samp else [])
    coefs, qts = [], []
    for vb, hb in grids:
        c = rng.integers(-1, 2, size=(n, vb, hb, 8, 8)) * rng.integers(
            0, scale + 1, size=(n, vb, hb, 8, 8))
        c[..., 0, 0] = rng.integers(-120, 120, size=(n, vb, hb))
        coefs.append(c.astype(np.int16))
        qts.append(rng.integers(1, 40, size=(n, 1, 1, 8, 8)).astype(np.int32))
    if samp:
        cw, ch = -(-w // sx), -(-h // sy)
        xd, yd = sx.bit_length() - 1, sy.bit_length() - 1
        kw = dict(comp_sizes=((w, h), (cw, ch), (cw, ch)),
                  comp_decs=((0, 0), (xd, yd), (xd, yd)),
                  comp_samps=((sx, sy), (1, 1), (1, 1)))
    else:
        kw = dict(comp_sizes=((w, h),), comp_decs=((0, 0),), comp_samps=((1, 1),))
    return coefs, qts, dict(width=w, height=h, **kw)


@pytest.mark.parametrize("stage", ["yuv", "rgb"])
@pytest.mark.parametrize("name,samp,exact,upsample", BATCH_GEOMS)
def test_pipeline_tables_per_image_vs_reference(name, samp, exact, upsample, stage):
    """pipeline.decode_yuv / decode_rgb on a batch of 3 images whose quant
    tables differ, against the reference's jitted functions on the same
    coefficients: equal on the exact path; within 1 on float planes and 2
    on float RGB (ROADMAP Queue 3)."""
    coefs, qts, kw = _batch_case(samp)
    tspec = tpipe.PipelineSpec(**kw, exact=exact, upsample=upsample)
    jspec = jpipe.PipelineSpec(**kw, exact=exact, upsample=upsample)
    tfn = tpipe.decode_yuv if stage == "yuv" else tpipe.decode_rgb
    jfn = jpipe.decode_yuv if stage == "yuv" else jpipe.decode_rgb
    got = tfn(tspec, [torch.from_numpy(c) for c in coefs], [torch.from_numpy(q) for q in qts])
    ref = jfn(jspec, tuple(jnp.asarray(c) for c in coefs), tuple(jnp.asarray(q) for q in qts))
    got = [got] if stage == "rgb" else list(got)
    ref = [ref] if stage == "rgb" else list(ref)
    tol = 0 if exact else (1 if stage == "yuv" else 2)
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.dtype == np.uint8 and g.shape == r.shape and g.shape[0] == 3
        assert _maxdiff(g, r) <= tol
    # Each image decodes as it would alone, with its own tables.
    for b in range(3):
        one = tfn(tspec, [torch.from_numpy(c[b]) for c in coefs],
                  [torch.from_numpy(q[b, 0, 0]) for q in qts])
        one = [one] if stage == "rgb" else list(one)
        assert all(torch.equal(g[b], o) for g, o in zip(got, one))
