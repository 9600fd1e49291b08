"""K4 (PACK stream expander) vs the JAX reference.

The same ``PackPlan.streams`` numpy array goes through the JAX Pallas kernel
``pack_device.expand_pack_device`` (interpret mode on the CPU) and the
port's plain version of K4; tolerance 0.  Hand-made streams cover the
corners of the format, with a scalar numpy walk as a second oracle.  On the
CPU the port's wrapper runs the plain version; the CUDA kernel is held to it
by the ``gpu``-marked tests and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_gpu_tpu.host.pack_plan import build_pack_plan as r_build_pack_plan
from jpeg_gpu_tpu.host.entropy import decode_scan as r_decode_scan
from jpeg_gpu_tpu.host.parser import parse as r_parse
from jpeg_gpu_tpu.ops import pack_device as jpack
from jpeg_gpu_tpu_torch.engine import device_entropy as tengine
from jpeg_gpu_tpu_torch.host import entropy as t_entropy
from jpeg_gpu_tpu_torch.host import entropy_native as t_native
from jpeg_gpu_tpu_torch.host.pack_plan import build_pack_plan
from jpeg_gpu_tpu_torch.host.parser import parse
from jpeg_gpu_tpu_torch.ops import pack_device as tpack
from jpeg_gpu_tpu_torch.ops.entropy_device import plan_tensors
from jpeg_gpu_tpu_torch.testing import corpus
from jpeg_gpu_tpu_torch.testing.pack_cases import HANDMADE, lanes_words, random_entries
from jpeg_gpu_tpu_torch.testing.pack_cases import stream_words as _words
from jpeg_gpu_tpu_torch.testing.pack_cases import walk as _walk

ALL_MODES = ["mono", "4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version runs many tiny ops; one intra-op thread keeps them
    from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _enc(mode, h, w, seed, quality=80, **kw):
    img = corpus.synthetic_rgb(h, w, seed=seed)
    if mode == "mono":
        img, mode = img[..., 1].copy(), "4:2:0"
    return corpus.own_jpeg(img, subsampling=mode, quality=quality, **kw)


def _expand_both(streams, t):
    """(port's plain version, JAX kernel in interpret mode) on one array."""
    got = tpack.expand_pack_device(plan_tensors((streams,), "cpu")[0], t)
    ref = jpack.expand_pack_device(jnp.asarray(streams), t, interpret=True)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("mode,hw,quality", [(m, (32, 48), 80) for m in ALL_MODES]
                         + [("mono", (64, 80), 90)])
def test_plain_vs_jax_kernel_on_the_same_plan(mode, hw, quality):
    """The reference's cases: six modes at 32x48 q80, a 64x80 grayscale
    frame without restart markers.  The plan comes from the reference's
    host code and goes to both kernels."""
    enc = _enc(mode, *hw, seed=4, quality=quality)
    parsed = r_parse(enc.data)
    scan = r_decode_scan(parsed, want_pack=True)
    plan = r_build_pack_plan(parsed, scan)
    got, ref = _expand_both(plan.streams, plan.blocks_per_segment)
    assert got.dtype == np.int16 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", list(HANDMADE))
def test_handmade_streams(name):
    entries, t, nw = HANDMADE[name]
    streams = _words(entries, nw)
    got, ref = _expand_both(streams, t)
    np.testing.assert_array_equal(got, ref)
    want = _walk(entries, t)
    np.testing.assert_array_equal(got[0, :, :, 0, 0], want)
    assert not got[0, :, :, 0, 1:].any() and not got[0, :, :, 1:].any()


MIXED_LANES = (0, 1, 31, 32, 33, 640, 1023)


def _mixed_lanes(seed, t, nw):
    """The hand-made streams and random entries side by side in one tensor:
    neighbouring lanes of one warp and lanes of other warps, each at its own
    pace.  Returns (streams, {lane: (t, 64) oracle})."""
    rng = np.random.default_rng(seed)
    rows = {lane: entries for lane, (entries, _, _) in zip(MIXED_LANES, HANDMADE.values())}
    for lane in MIXED_LANES[len(HANDMADE):]:
        rows[lane] = random_entries(rng, int(rng.integers(nw, 2 * nw + 1)))
    return lanes_words(rows, nw), {lane: _walk(e, t) for lane, e in rows.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lanes_at_different_paces(seed):
    """Lanes of one tensor that end their blocks at different entries: each
    equals the scalar walk of its own entries, and the JAX kernel."""
    t, nw = 5, 40
    streams, want = _mixed_lanes(seed, t, nw)
    got, ref = _expand_both(streams, t)
    np.testing.assert_array_equal(got, ref)
    flat = got.reshape(t, 64, 1024)
    for lane, coefs in want.items():
        np.testing.assert_array_equal(flat[:, :, lane], coefs)
    others = np.setdiff1d(np.arange(1024), list(want))
    assert not flat[:, :, others].any()


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("native", [False, True])
def test_engine_expand_equals_host_coefficients(mode, native):
    """build_pack_plan -> K4 -> assemble_components gives the host's dense
    coefficients back, from the Python and the native host decoder."""
    enc = _enc(mode, 40, 56, seed=5, restart_interval=ALL_MODES.index(mode) % 3)
    parsed = parse(enc.data)
    scan = (t_native if native else t_entropy).decode_scan(parsed, want_pack=True)
    coefs = tengine.expand_pack_device(parsed, scan, "cpu")
    assert len(coefs) == len(enc.coefs)
    for got, truth in zip(coefs, enc.coefs):
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), truth.astype(np.int16))


@pytest.mark.parametrize("order", [(2, 0, 1), (1, 0, 2)])
def test_engine_expand_out_of_order_scan(order):
    """A scan whose components are permuted: the MCU starts come from the
    first SCAN component and the result is in frame order."""
    img = corpus.synthetic_rgb(41, 53, seed=11)
    enc = corpus.own_jpeg(img, subsampling="4:2:0", quality=82, scan_order=order)
    parsed = parse(enc.data)
    assert tuple(parsed.header.scan.comp_idx) == order
    scan = t_entropy.decode_scan(parsed, want_pack=True)
    for got, truth in zip(tengine.expand_pack_device(parsed, scan, "cpu"), enc.coefs):
        np.testing.assert_array_equal(got.numpy(), truth.astype(np.int16))


def test_several_mcus_per_lane():
    """More MCUs than lanes: K > 1 MCUs per lane and a short last lane."""
    enc = _enc("4:2:0", 16, 16 * 1100, seed=6)
    parsed = parse(enc.data)
    scan = t_native.decode_scan(parsed, want_pack=True)
    plan = build_pack_plan(parsed, scan)
    assert plan.mcus_per_segment == 2 and plan.n_segments == 550
    for got, truth in zip(tengine.expand_pack_device(parsed, scan, "cpu"), enc.coefs):
        np.testing.assert_array_equal(got.numpy(), truth.astype(np.int16))


@pytest.mark.parametrize("bad", ["shape", "dtype", "steps"])
def test_wrapper_rejects_bad_arguments(bad):
    s = torch.zeros((1, 4, 8, 128), dtype=torch.int32)
    if bad == "shape":
        with pytest.raises(ValueError):
            tpack.expand_pack_device(s.reshape(1, 4, 1024), 2)
    elif bad == "dtype":
        with pytest.raises(TypeError):
            tpack.expand_pack_device(s.to(torch.int64), 2)
    else:
        with pytest.raises(ValueError):
            tpack.expand_pack_device(s, 0)


def test_wrapper_has_no_fallback_for_other_devices():
    s = torch.zeros((1, 4, 8, 128), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError):
        tpack.expand_pack_device(s, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ALL_MODES)
def test_kernel_vs_plain_on_gpu(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K4 kernel has no CPU mode")
    enc = _enc(mode, 130, 250, seed=7, quality=85)
    parsed = parse(enc.data)
    scan = t_native.decode_scan(parsed, want_pack=True)
    plan = build_pack_plan(parsed, scan)
    streams, = plan_tensors((plan.streams,), "cuda")
    before = tpack.launches
    got = tpack.expand_pack_device(streams, plan.blocks_per_segment)
    ref = tpack.expand_pack_reference(streams, plan.blocks_per_segment)
    torch.cuda.synchronize()
    assert tpack.launches == before + 1
    assert torch.equal(got, ref)
    for dev_c, truth in zip(tengine.expand_pack_device(parsed, scan, "cuda"), enc.coefs):
        np.testing.assert_array_equal(dev_c.cpu().numpy(), truth.astype(np.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(HANDMADE))
def test_handmade_streams_on_gpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K4 kernel has no CPU mode")
    entries, t, nw = HANDMADE[name]
    streams, = plan_tensors((_words(entries, nw),), "cuda")
    got = tpack.expand_pack_device(streams, t)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[0, :, :, 0, 0].cpu().numpy(), _walk(entries, t))
    assert torch.equal(got, tpack.expand_pack_reference(streams, t))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lanes_at_different_paces_on_gpu(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K4 kernel has no CPU mode")
    t, nw = 5, 40
    words, want = _mixed_lanes(seed, t, nw)
    streams, = plan_tensors((words,), "cuda")
    got = tpack.expand_pack_device(streams, t)
    torch.cuda.synchronize()
    assert torch.equal(got, tpack.expand_pack_reference(streams, t))
    flat = got.reshape(t, 64, 1024).cpu().numpy()
    for lane, coefs in want.items():
        np.testing.assert_array_equal(flat[:, :, lane], coefs)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,nw", [(1, 3, 1), (2, 7, 17), (1, 12, 100)])
def test_random_entries_in_every_lane_on_gpu(b, t, nw):
    """Every lane full of entries no encoder would write, rows shorter and
    longer than the kernel's staging tile; the output starts as garbage, so
    the kernel's own zero-fill is held too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K4 kernel has no CPU mode")
    rng = np.random.default_rng(b * 100 + t)
    e = np.array(random_entries(rng, b * nw * 2048), dtype=np.uint32).reshape(b, nw, 2, 1024)
    words = ((e[:, :, 0] << 16) | e[:, :, 1]).view(np.int32).reshape(b, nw, 8, 128)
    streams, = plan_tensors((words,), "cuda")
    # Dirty the allocator's next block of this size.
    torch.full((b, t, 64, 8, 128), -1, dtype=torch.int16, device="cuda")
    got = tpack.expand_pack_device(streams, t)
    torch.cuda.synchronize()
    assert torch.equal(got, tpack.expand_pack_reference(streams, t))
