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
