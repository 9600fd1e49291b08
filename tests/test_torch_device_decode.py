"""The whole ``entropy="device"`` slice vs the JAX reference, on the CPU.

``jpeg_gpu_tpu_torch.decode(data, device="cpu", entropy="device")`` (host
destuff and packing -> K3's and K2's plain versions -> assembly -> K1's
plain version or the torch ops) must give the same bytes as
``jpeg_gpu_tpu.decode(data, impl="tpu", entropy="device")`` and
``impl="host"``; tolerance 0.
"""

import numpy as np
import pytest
import torch

import jpeg_gpu_tpu as jr
import jpeg_gpu_tpu_torch as jt
from jpeg_gpu_tpu_torch.host.parser import parse
from jpeg_gpu_tpu_torch.testing import corpus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of tiny ops; one intra-op thread
    keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _enc(h, w, seed, restart=0, mode="4:2:0"):
    img = corpus.synthetic_rgb(h, w, seed=seed)
    return corpus.own_jpeg(img, subsampling=mode, quality=88,
                           restart_interval=restart).data


def test_rgb_without_restart_markers_odd_dims():
    """The device index scan path (K3 -> K2 -> K1), fancy upsampling."""
    data = _enc(41, 67, seed=11)
    dec = jt.get_decoder(data, device="cpu", entropy="device", upsample="fancy")
    got = dec.decode()
    assert dec.specsync_stats is not None  # the index scan ran, no fallback
    assert got.shape == (41, 67, 3) and got.dtype == np.uint8
    ref = jr.decode(data, impl="tpu", entropy="device", upsample="fancy")
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jr.decode(data, impl="host", upsample="fancy"))
    # A clean stream salvages to the same bytes.
    np.testing.assert_array_equal(
        jt.decode(data, device="cpu", entropy="device", upsample="fancy",
                  on_error="zero"), ref)


@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
def test_rgb_restart_marked(upsample):
    data = _enc(35, 50, seed=12, restart=2, mode="4:2:2")
    dec = jt.get_decoder(data, device="cpu", entropy="device", upsample=upsample)
    got = dec.decode()
    assert dec.specsync_stats is None
    np.testing.assert_array_equal(
        got, jr.decode(data, impl="tpu", entropy="device", upsample=upsample))
    np.testing.assert_array_equal(got, jr.decode(data, impl="host", upsample=upsample))


@pytest.mark.parametrize("stage", ["yuv", "quant"])
def test_stage_cuts(stage):
    data = _enc(24, 40, seed=13, restart=1)
    got = jt.decode(data, out=stage, device="cpu", entropy="device")
    ref = jr.decode(data, out=stage, impl="tpu", entropy="device")
    host = jr.decode(data, out=stage, impl="host")
    for r in (ref, host):
        for a, b in zip(*(getattr(x, "planes", None) or x.coefs for x in (got, r))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("restart", [0, 1])
@pytest.mark.parametrize("stage", ["yuv", "rgb"])
def test_float_path_on_device_entropy(stage, restart):
    """entropy="device" with exact=False: K2 (and K3) feed K6's plain
    version; within 1 of the reference on planes and 2 on RGB, and equal to
    the port's host-entropy float decode."""
    data = _enc(24, 40, seed=16, restart=restart)
    got = jt.decode(data, out=stage, device="cpu", entropy="device", exact=False)
    ref = jr.decode(data, out=stage, impl="tpu", entropy="device", exact=False)
    host = jt.decode(data, out=stage, device="cpu", exact=False)
    parts = lambda r: [r] if isinstance(r, np.ndarray) else r.planes  # noqa: E731
    for a, b, c in zip(parts(got), parts(ref), parts(host)):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= (2 if stage == "rgb" else 1)
        np.testing.assert_array_equal(a, c)


def test_gray_rgb_on_device_entropy():
    """Grayscale RGB: K2 -> one plane IDCT (K5) -> the value in three channels."""
    img = corpus.synthetic_rgb(30, 44, seed=17)[..., 1].copy()
    data = corpus.own_jpeg(img, quality=88, restart_interval=1).data
    got = jt.decode(data, device="cpu", entropy="device")
    np.testing.assert_array_equal(got, jr.decode(data, impl="tpu", entropy="device"))
    assert (got[..., 0] == got[..., 2]).all()


def test_salvage_zero_matches_reference():
    data = bytearray(_enc(16, 48, seed=14, restart=1))
    s, e = parse(bytes(data)).segments[1]
    data[s:e] = (b"\xff\x00" * ((e - s) // 2 + 1))[: e - s]
    data = bytes(data)
    got = jt.decode(data, device="cpu", entropy="device", on_error="zero")
    ref = jr.decode(data, impl="tpu", entropy="device", on_error="zero")
    np.testing.assert_array_equal(got, ref)
    for pkg, call in ((jt, lambda: jt.decode(data, device="cpu", entropy="device")),
                      (jr, lambda: jr.decode(data, impl="tpu", entropy="device"))):
        with pytest.raises(pkg.JpegFormatError):
            call()


def test_planner_rejection_falls_back_to_host_entropy(monkeypatch):
    """A stream the device planner rejects decodes through host entropy
    with the same output (the reference's contract)."""
    from jpeg_gpu_tpu_torch.engine import device_entropy
    from jpeg_gpu_tpu_torch.errors import JpegUnsupportedError

    def reject(*a, **kw):
        raise JpegUnsupportedError("forced")

    data = _enc(24, 40, seed=15, restart=1)
    monkeypatch.setattr(device_entropy, "build_plan_auto", reject)
    got = jt.decode(data, device="cpu", entropy="device")
    np.testing.assert_array_equal(got, jr.decode(data, impl="host"))


def test_bad_on_error_rejected():
    with pytest.raises(ValueError):
        jt.TorchDecoder(_enc(16, 16, seed=1), device="cpu", on_error="ignore")


def _spy(monkeypatch, name):
    """Count the calls of ``ops.entropy_device.<name>`` that the engine makes."""
    from jpeg_gpu_tpu_torch.ops import entropy_device

    calls = []
    real = getattr(entropy_device, name)

    def counted(*a, **kw):
        calls.append(name)
        return real(*a, **kw)

    monkeypatch.setattr(entropy_device, name, counted)
    return calls


@pytest.mark.parametrize("mode", ["4:2:0", "4:4:4"])
@pytest.mark.parametrize("stage", ["rgb", "yuv"])
def test_streams_without_restart_markers_take_the_fused_entry(monkeypatch, stage, mode):
    """The engine decodes a stream without restart markers through K2's fused
    form (no gather, no row form, no DC pass in torch) and still gives the
    JAX package's bytes, for the fused RGB kernel and for out="yuv"."""
    fused = _spy(monkeypatch, "decode_mcus_at_bitpos")
    rows = _spy(monkeypatch, "decode_segments_device")
    gathers = _spy(monkeypatch, "gather_entropy_streams")
    data = _enc(43, 61, seed=18, mode=mode)
    dec = jt.get_decoder(data, device="cpu", entropy="device")
    got = dec.decode(stage)
    assert dec.specsync_stats is not None
    assert fused == ["decode_mcus_at_bitpos"] and not rows
    # On the CPU the fused form's plain version is the chain, but it reads
    # each lane's words when the lane needs them: it gathers no rows (a
    # gather of every word a lane might read was 3 GB at a claimed
    # 16000x16000, tests/test_torch_fuzz.py).
    assert not gathers
    ref = jr.decode(data, out=stage, impl="tpu", entropy="device")
    host = jr.decode(data, out=stage, impl="host")
    parts = lambda r: [r] if isinstance(r, np.ndarray) else r.planes  # noqa: E731
    for a, b, c in zip(parts(got), parts(ref), parts(host)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_a_scan_that_falls_back_takes_the_row_form(monkeypatch):
    """A scan that overflows its records: the serial host scan takes over and
    its pseudo segments decode through the row form, with the same bytes."""
    from jpeg_gpu_tpu_torch.engine import device_entropy

    real_build = device_entropy.build_spec_scan_input

    def tiny_maxrec(parsed, **kw):
        inp = real_build(parsed, **kw)
        inp.maxrec = 1
        return inp

    monkeypatch.setattr(device_entropy, "build_spec_scan_input", tiny_maxrec)
    rows = _spy(monkeypatch, "decode_segments_device")
    data = _enc(48, 64, seed=19)
    dec = jt.get_decoder(data, device="cpu", entropy="device")
    got = dec.decode()
    assert dec.specsync_stats is None and rows == ["decode_segments_device"]
    np.testing.assert_array_equal(got, jr.decode(data, impl="host"))


def test_table_sets_stay_on_the_device_between_decodes():
    """The engine uploads a table set once per device: a second decode of the
    same stream finds the same tensors."""
    from jpeg_gpu_tpu_torch.engine import device_entropy
    from jpeg_gpu_tpu_torch.host import segments

    data = _enc(24, 40, seed=20)
    arrays = segments._table_tensors(parse(data).header)
    jt.decode(data, device="cpu", entropy="device")
    first = device_entropy.device_tables(*arrays, "cpu", scan=True)
    jt.decode(data, device="cpu", entropy="device")
    again = device_entropy.device_tables(*arrays, "cpu", scan=True)
    assert again is first and first.k2_lut is None and first.k3_lut is None
    np.testing.assert_array_equal(first.counts.numpy(), arrays[1])
