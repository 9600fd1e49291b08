"""K3 (the device index scan) and its glue in the port vs the JAX reference.

On CPU tensors ``device_index_scan`` runs every round through the plain
PyTorch version of K3; it is held to the JAX package's
``device_index_scan(interpret=True)`` (bitpos, ok and stats) and to the
serial native index scan, tolerance 0.  The engine's index-scan path is
held to the serial-scan path and must fall back to it whenever the scan
cannot be used.  The CUDA kernel itself is compared with the plain version
only where a card is present.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_gpu_tpu.host import segments as jseg
from jpeg_gpu_tpu.host.parser import parse as jparse
from jpeg_gpu_tpu.ops import specsync_device as jsd
from jpeg_gpu_tpu_torch.engine import device_entropy as tde
from jpeg_gpu_tpu_torch.errors import JpegUnsupportedError
from jpeg_gpu_tpu_torch.host import entropy_native as t_native
from jpeg_gpu_tpu_torch.host import segments as tseg
from jpeg_gpu_tpu_torch.host.parser import parse as tparse
from jpeg_gpu_tpu_torch.ops import specsync_device as tsd
from jpeg_gpu_tpu_torch.ops.entropy_device import plan_tensors
from jpeg_gpu_tpu_torch.testing import corpus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of tiny ops; one intra-op thread
    keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _enc(mode, h, w, seed, quality=85, restart=0):
    img = corpus.synthetic_rgb(h, w, seed=seed)
    if mode == "mono":
        img, mode = img[..., 1].copy(), "4:2:0"
    return corpus.own_jpeg(img, subsampling=mode, quality=quality,
                           restart_interval=restart).data


def _torch_scan(inp, device="cpu", **kw):
    w, = plan_tensors((inp.windows,), device)
    tabs = plan_tensors(
        (inp.dcslot_of_c, inp.acslot_of_c, inp.cbase, inp.counts, inp.symbols), device)
    return tsd.device_index_scan(w, inp.n_bits, *tabs, sb=inp.subseq_bytes,
                                 maxrec=inp.maxrec, n_mcus=inp.n_mcus, **kw)


@pytest.mark.parametrize("mode,q", [("4:2:0", 85), ("4:4:4", 92), ("mono", 75)])
def test_plain_k3_matches_jax(mode, q):
    """32-byte subsequences, so several rounds run (4:2:0 here does not
    converge within 16 rounds: ok is False on both sides)."""
    data = _enc(mode, 56, 72, seed=9, quality=q)
    inp = tseg.build_spec_scan_input(tparse(data), subseq_bytes=32)
    bitpos, ok, stats = _torch_scan(inp)
    ji = jseg.build_spec_scan_input(jparse(data), subseq_bytes=32)
    jb, jok, jst = jsd.device_index_scan(
        jnp.asarray(ji.windows), jnp.asarray(np.array([ji.n_bits], np.int32)),
        *(jnp.asarray(x) for x in (ji.dcslot_of_c, ji.acslot_of_c, ji.cbase,
                                   ji.counts, ji.symbols)),
        used_slots=ji.used_slots, bpm=ji.bpm, sb=ji.subseq_bytes,
        maxrec=ji.maxrec, n_mcus=ji.n_mcus, interpret=True)
    assert bitpos.dtype == torch.int32 and stats.dtype == torch.int32
    np.testing.assert_array_equal(bitpos.numpy(), np.asarray(jb))
    assert bool(ok) == bool(jok)
    np.testing.assert_array_equal(stats.numpy(), np.asarray(jst))


@pytest.mark.parametrize("mode", ["4:2:0", "4:2:2", "4:4:4", "mono"])
def test_bitpos_matches_native_index_scan(mode):
    data = _enc(mode, 40, 64, seed=10)
    inp = tseg.build_spec_scan_input(tparse(data), subseq_bytes=64)
    bitpos, ok, stats = _torch_scan(inp)
    assert bool(ok), stats
    ref, _, _ = t_native.index_scan(tparse(data), 1)
    np.testing.assert_array_equal(bitpos.numpy(), ref.astype(np.int32))


def test_round_records_count_past_maxrec():
    """The record count keeps counting past maxrec; records beyond it are
    dropped and the scan reports the overflow."""
    data = _enc("mono", 32, 64, seed=11)
    inp = tseg.build_spec_scan_input(tparse(data), subseq_bytes=64)
    full = _torch_scan(inp)
    inp.maxrec = 1
    bitpos, ok, stats = _torch_scan(inp)
    assert bool(full[1]) and not bool(ok)
    assert int(stats[2]) == 1 and int(stats[1]) == int(full[2][1])


@pytest.mark.parametrize("mode", ["4:2:0", "4:2:2"])
def test_spec_path_equals_serial_scan_path(mode):
    parsed = tparse(_enc(mode, 48, 64, seed=3))
    a = tde.entropy_decode_device(parsed)
    b = tde.entropy_decode_device(parsed, specsync=False)
    assert a.specsync_stats is not None  # the index scan ran
    assert b.specsync_stats is None
    for x, y in zip(a.coefs, b.coefs):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_overflow_falls_back_to_serial(monkeypatch):
    parsed = tparse(_enc("4:2:0", 48, 64, seed=3))
    real_build = tseg.build_spec_scan_input

    def tiny_maxrec(parsed, **kw):
        inp = real_build(parsed, **kw)
        inp.maxrec = 1  # every lane with more than one MCU start overflows
        return inp

    monkeypatch.setattr(tde, "build_spec_scan_input", tiny_maxrec)
    a = tde.entropy_decode_device(parsed)
    assert a.specsync_stats is None  # fell back
    b = tde.entropy_decode_device(parsed, specsync=False)
    for x, y in zip(a.coefs, b.coefs):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_unsupported_size_falls_back(monkeypatch):
    parsed = tparse(_enc("4:2:0", 48, 64, seed=3))

    def raise_unsupported(parsed, **kw):
        raise JpegUnsupportedError("forced")

    monkeypatch.setattr(tde, "build_spec_scan_input", raise_unsupported)
    a = tde.entropy_decode_device(parsed)
    assert a.specsync_stats is None
    b = tde.entropy_decode_device(parsed, specsync=False)
    for x, y in zip(a.coefs, b.coefs):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_restart_streams_skip_the_scan():
    res = tde.entropy_decode_device(tparse(_enc("4:2:0", 48, 48, seed=7, restart=1)))
    assert res.specsync_stats is None


def test_gather_entropy_streams_vs_jax():
    """Inside the window grid the realigned rows equal the reference's;
    words past the grid read 0xFFFFFFFF, where the reference repeats the
    grid's last word."""
    rng = np.random.default_rng(3)
    spw, nws, nw = 8, 11, 5
    windows = rng.integers(-2**31, 2**31, size=(1, nws, 8, 128), dtype=np.int64).astype(np.int32)
    last_bit = 1024 * spw * 32
    bitpos = np.sort(rng.integers(0, last_bit - 32 * (nw + 2), size=700)).astype(np.int32)
    bitpos[-1] = last_bit - 40  # this segment runs past the grid
    got = tsd.gather_entropy_streams(torch.from_numpy(windows), torch.from_numpy(bitpos),
                                     nw=nw, spw=spw, nws=nws).numpy()
    ref = np.asarray(jsd.gather_entropy_streams(jnp.asarray(windows), jnp.asarray(bitpos),
                                                nw=nw, spw=spw, nws=nws))
    flat_got, flat_ref = got.transpose(0, 2, 3, 1).reshape(-1, nw), ref.transpose(0, 2, 3, 1).reshape(-1, nw)
    np.testing.assert_array_equal(flat_got[:699], flat_ref[:699])
    np.testing.assert_array_equal(flat_got[700:], flat_ref[700:])  # padding lanes
    # The last segment: 40 bits left in the grid, then all ones.
    grid_word = int(windows[0, spw - 1, 7, 127]) & 0xFFFFFFFF
    prev_word = int(windows[0, spw - 2, 7, 127]) & 0xFFFFFFFF
    bits = (((prev_word << 32 | grid_word) << 24) | 0xFFFFFF) & (2**64 - 1)
    want = [bits >> 32, bits & 0xFFFFFFFF]
    assert [int(x) & 0xFFFFFFFF for x in flat_got[699, :2]] == want
    assert (flat_got[699, 2:] == -1).all()


def test_dc_base_from_coefs_vs_jax():
    kout = np.random.default_rng(5).integers(
        -2048, 2048, size=(2, 6, 64, 8, 128), dtype=np.int16)
    got = tsd.dc_base_from_coefs(torch.from_numpy(kout), (3, 4, 5))
    ref = jsd.dc_base_from_coefs(jnp.asarray(kout), (3, 4, 5))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wrapper_has_no_fallback_for_other_devices():
    inp = tseg.build_spec_scan_input(tparse(_enc("mono", 16, 32, seed=1)))
    w, e = plan_tensors((inp.windows, np.zeros((1, 4, 8, 128))), "meta")
    tabs = plan_tensors(
        (inp.dcslot_of_c, inp.acslot_of_c, inp.cbase, inp.counts, inp.symbols), "meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tsd.scan_round(w, e, inp.n_bits, *tabs, sb=inp.subseq_bytes,
                       maxrec=inp.maxrec, record=False)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,sb", [("4:2:0", 32), ("4:2:2", 32), ("4:4:4", None), ("mono", 64)])
def test_kernel_vs_plain_on_gpu(mode, sb):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K3 kernel has no CPU mode")
    data = _enc(mode, 130, 1100, seed=13)
    inp = tseg.build_spec_scan_input(tparse(data), subseq_bytes=sb)
    before = tsd.launches
    got = _torch_scan(inp, "cuda")
    rounds = int(got[2][0])
    ref = _torch_scan(inp, "cuda", plain=True)
    torch.cuda.synchronize()
    assert tsd.launches == before + rounds + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
