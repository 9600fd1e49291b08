"""K2 (device Huffman decode) and the device-entropy engine in the port vs
the JAX reference, on the CPU.

On a CPU tensor ``decode_segments_device`` runs its plain PyTorch version;
it is held to the JAX package's ``decode_segments_device(interpret=True)``
on the same plan arrays, coefficients and the full flag tensor, tolerance 0.
``entropy_decode_device`` is held to the host entropy decoders.  The CUDA
kernel itself is compared with the plain version only where a card is
present.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_gpu_tpu.engine import device_entropy as jde
from jpeg_gpu_tpu.host.parser import parse as jparse
from jpeg_gpu_tpu.ops import entropy_device as jed
from jpeg_gpu_tpu_torch.engine import device_entropy as tde
from jpeg_gpu_tpu_torch.errors import JpegFormatError
from jpeg_gpu_tpu_torch.host import entropy as t_entropy
from jpeg_gpu_tpu_torch.host import entropy_native as t_native
from jpeg_gpu_tpu_torch.host import segments as tseg
from jpeg_gpu_tpu_torch.host.parser import parse as tparse
from jpeg_gpu_tpu_torch.ops import entropy_device as ted
from jpeg_gpu_tpu_torch.testing import corpus

ALL_MODES = ["mono", "4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of tiny ops; one intra-op thread
    keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _enc(mode, h, w, seed, restart=0, quality=80):
    img = corpus.synthetic_rgb(h, w, seed=seed)
    if mode == "mono":
        img, mode = img[..., 1].copy(), "4:2:0"
    return corpus.own_jpeg(img, subsampling=mode, quality=quality,
                           restart_interval=restart).data


def _ones_over_segment(data, si):
    """All-ones bits (0xFF with stuffed zeros) over restart segment si:
    beyond every codeword of the encoder's incomplete tables."""
    s, e = tparse(data).segments[si]
    out = bytearray(data)
    out[s:e] = (b"\xff\x00" * ((e - s) // 2 + 1))[: e - s]
    return bytes(out)


def _torch_k2(plan):
    out, err = ted.decode_segments_device(
        *ted.plan_tensors((plan.streams,) + plan.kernel_tables, "cpu"))
    return out, err


def _jax_k2(plan):
    out, err = jed.decode_segments_device(
        jnp.asarray(plan.streams), *(jnp.asarray(x) for x in plan.kernel_tables),
        interpret=True)
    return np.asarray(out), np.asarray(err)


@pytest.mark.parametrize("restart", [1, 3])
@pytest.mark.parametrize("mode", ["mono", "4:2:0", "4:1:1"])
def test_plain_k2_matches_jax(mode, restart):
    plan = tseg.build_plan(tparse(_enc(mode, 24, 40, seed=3, restart=restart)))
    got, gerr = _torch_k2(plan)
    ref, rerr = _jax_k2(plan)
    assert got.dtype == torch.int16 and gerr.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(gerr.numpy(), rerr)


def test_plain_k2_corrupt_plan_flags_match_jax():
    """A segment of invalid codes: the same flags, coefficients included,
    as the JAX kernel (tail suppression and the consume-nothing rule)."""
    data = _ones_over_segment(_enc("4:2:0", 24, 40, seed=4, restart=1), 2)
    plan = tseg.build_plan(tparse(data, validate=False))
    got, gerr = _torch_k2(plan)
    ref, rerr = _jax_k2(plan)
    assert gerr.numpy().reshape(-1)[2] & ted.ERR_BAD_CODE
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(gerr.numpy(), rerr)


def test_no_dri_plan_through_apply_dc_base():
    """Pseudo segments from the serial index scan decode from DC 0; the
    recorded DC bases restore the predictors, as in the reference."""
    plan = tseg.build_plan_no_dri(tparse(_enc("4:2:0", 24, 40, seed=5)))
    assert plan.dc_base is not None
    nb = plan.streams.shape[0]
    dcb = np.zeros((nb * 1024, plan.dc_base.shape[1]), np.int32)
    dcb[: plan.n_segments] = plan.dc_base
    dcb = dcb.reshape(nb, 8, 128, -1)
    got, _ = _torch_k2(plan)
    got = ted.apply_dc_base(got, torch.from_numpy(dcb), torch.from_numpy(plan.comp_of_step))
    ref, _ = _jax_k2(plan)
    ref = jed.apply_dc_base(jnp.asarray(ref), jnp.asarray(dcb), jnp.asarray(plan.comp_of_step))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("soa", [False, True])
@pytest.mark.parametrize("mode", ALL_MODES)
def test_engine_matches_host_entropy(mode, soa):
    """Restart intervals 0, 1 and 2 by mode: the device index scan path,
    one-MCU segments and longer ones."""
    restart = ALL_MODES.index(mode) % 3
    data = _enc(mode, 33, 41, seed=6, restart=restart)
    parsed = tparse(data)
    res = tde.entropy_decode_device(parsed, device="cpu", soa=soa)
    if soa:
        ref = t_native.decode_scan(parsed, soa=True).coefs
    else:
        ref = t_entropy.decode_scan(parsed).coefs
    assert len(res.coefs) == len(ref)
    for got, want in zip(res.coefs, ref):
        assert got.dtype == torch.int16 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int16))
    assert (res.specsync_stats is not None) == (restart == 0)


def _error_names(data, **kw):
    names = []
    for call in (lambda: tde.entropy_decode_device(tparse(data), device="cpu", **kw),
                 lambda: jde.entropy_decode_device(jparse(data), interpret=True, **kw)):
        with pytest.raises(Exception) as info:
            call()
        names.append(type(info.value).__name__)
    return names


def test_corrupt_segment_raises():
    data = bytearray(_enc("mono", 32, 32, seed=9, restart=1, quality=85))
    s, e = tparse(bytes(data)).segments[0]
    data[s:e] = bytes([0b10101010] * (e - s))
    assert _error_names(bytes(data)) == ["JpegFormatError"] * 2


def test_invalid_codeword_raises():
    data = _ones_over_segment(_enc("mono", 16, 16, seed=2, restart=1, quality=85), 0)
    assert _error_names(data) == ["JpegFormatError"] * 2


def test_corruption_in_last_segment_detected():
    data = _enc("mono", 40, 56, seed=6, restart=2, quality=85)
    data = _ones_over_segment(data, len(tparse(data).segments) - 1)
    assert _error_names(data) == ["JpegFormatError"] * 2


def test_salvage_zero_matches_jax():
    """on_error='zero': the corrupt segment's block is zero, every other
    block equals the clean decode, and the whole result equals JAX's."""
    clean = _enc("mono", 16, 48, seed=3, restart=1, quality=85)
    data = _ones_over_segment(clean, 1)
    got = tde.entropy_decode_device(tparse(data), device="cpu", on_error="zero").coefs[0].numpy()
    ref = jde.entropy_decode_device(jparse(data), interpret=True, on_error="zero")
    np.testing.assert_array_equal(got, np.asarray(ref.coefs[0]))
    want = tde.entropy_decode_device(tparse(clean), device="cpu").coefs[0].numpy()
    assert (got[0, 1] == 0).all()
    mask = np.ones(got.shape, bool)
    mask[0, 1] = False
    np.testing.assert_array_equal(got[mask], want[mask])
    with pytest.raises(JpegFormatError):
        tde.entropy_decode_device(tparse(data), device="cpu")


def test_salvage_keeps_valid_short_last_segment():
    """35 MCUs at restart interval 2: the short last segment's padded tail
    raises no flag, so salvage keeps it."""
    data = _enc("mono", 40, 56, seed=5, restart=2, quality=85)
    clean = tde.entropy_decode_device(tparse(data), device="cpu")
    salvaged = tde.entropy_decode_device(tparse(data), device="cpu", on_error="zero")
    ref = jde.entropy_decode_device(jparse(data), interpret=True, on_error="zero")
    np.testing.assert_array_equal(salvaged.coefs[0].numpy(), clean.coefs[0].numpy())
    np.testing.assert_array_equal(salvaged.coefs[0].numpy(), np.asarray(ref.coefs[0]))


GEOMS = [
    (((2, 2), (1, 1), (1, 1)), 5, 7, 1),    # 4:2:0
    (((1, 1), (1, 1), (1, 1)), 9, 31, 1),   # 4:4:4
    (((1, 1),), 16, 65, 2),                 # mono, 2 batches
    (((4, 1), (1, 1), (1, 1)), 3, 11, 1),   # 4:1:1
    (((1, 2), (1, 1), (1, 1)), 8, 8, 1),    # 4:4:0
]


@pytest.mark.parametrize("geom,nvmb,nhmb,b", GEOMS)
def test_assemble_r1_fast_path_equals_general(geom, nvmb, nhmb, b):
    bpm = sum(hs * vs for hs, vs in geom)
    n_mcus = nvmb * nhmb
    kout = np.random.default_rng(41).integers(
        -1024, 1024, size=(b, bpm, 64, 8, 128), dtype=np.int16)
    args = (n_mcus, 1, n_mcus, nhmb, nvmb, geom)
    fast = ted.assemble_components(torch.from_numpy(kout), *args, soa=True)
    general = ted.assemble_components(torch.from_numpy(kout), *args, soa=True,
                                      force_general=True)
    ref = jed.assemble_components(kout, *args, soa=True)
    for a, g, r in zip(fast, general, ref):
        np.testing.assert_array_equal(a.numpy(), g.numpy())
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


@pytest.mark.parametrize("soa", [False, True])
def test_assemble_general_and_frame_order_vs_jax(soa):
    """R=3 segments with a padded tail MCU, and an out-of-order scan."""
    geom = ((2, 2), (1, 1), (1, 1))
    kout = np.random.default_rng(42).integers(
        -999, 999, size=(1, 18, 64, 8, 128), dtype=np.int16)
    args = (4, 3, 10, 5, 2, geom)
    got = ted.assemble_components(torch.from_numpy(kout), *args, soa=soa,
                                  frame_order=(2, 0, 1))
    ref = jed.assemble_components(kout, *args, soa=soa, frame_order=(2, 0, 1))
    for a, r in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_io_bytes_and_host_entropy():
    import jpeg_gpu_tpu as jr
    import jpeg_gpu_tpu_torch as jt

    marked = _enc("4:2:0", 33, 41, seed=7, restart=2)
    dec = jt.get_decoder(marked, device="cpu", entropy="device")
    assert dec.io_bytes() == jr.get_decoder(marked, entropy="device").io_bytes()
    assert dec.io_bytes("quant") == jr.get_decoder(marked, entropy="device").io_bytes("quant")
    assert dec.host_entropy() is None
    assert jt.get_decoder(marked, device="cpu").io_bytes()["payload"] == "host"
    # Without restart markers the bits cut ships the index scan's windows.
    plain = _enc("4:2:0", 33, 41, seed=7)
    got = jt.get_decoder(plain, device="cpu", entropy="device").io_bytes()
    windows = tseg.build_spec_scan_input(tparse(plain)).windows
    assert got["payload"] == "bits" and got["upload"] == windows.nbytes


def test_wrapper_has_no_fallback_for_other_devices():
    plan = tseg.build_plan(tparse(_enc("mono", 16, 16, seed=1, restart=1)))
    t = ted.plan_tensors((plan.streams,) + plan.kernel_tables, "meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ted.decode_segments_device(*t)


def test_wrapper_rejects_bad_arguments():
    plan = tseg.build_plan(tparse(_enc("mono", 16, 16, seed=1, restart=1)))
    t = list(ted.plan_tensors((plan.streams,) + plan.kernel_tables, "cpu"))
    with pytest.raises(ValueError):
        ted.decode_segments_device(t[0][:, :, :4], *t[1:])
    with pytest.raises(TypeError):
        ted.decode_segments_device(t[0].to(torch.int64), *t[1:])


def _two_image_case(device):
    """Two images' plans stacked as a corpus batch, plus a third batch whose
    image index has no tables."""
    plans = [tseg.build_plan(tparse(_enc(m, 24, 40, seed=7, restart=1)))
             for m in ("4:2:0", "4:2:2")]
    corpus_plan = tseg.build_corpus_plan([plans[0], plans[0]])
    t = ted.plan_tensors((corpus_plan.streams, *corpus_plan.kernel_tables), device)
    streams = torch.cat([t[0], t[0][:1]])
    img = torch.tensor([0, 1, 7], dtype=torch.int32, device=device)
    # Image 1 decodes with the other image's tables.
    cbase, counts, symbols = (torch.cat([x[:1], y]) for x, y in zip(
        t[6:], ted.plan_tensors((plans[1].cbase[None], plans[1].counts[None],
                                 plans[1].symbols[None]), device)))
    return (streams, img, t[2], t[3], t[4], t[5], cbase, counts, symbols), plans[0]


def test_multi_image_tables_and_bad_image_index():
    args, plan = _two_image_case("cpu")
    out, err = ted.decode_segments_device_multi(*args)
    single, serr = _torch_k2(plan)
    np.testing.assert_array_equal(out[0].numpy(), single[0].numpy())
    np.testing.assert_array_equal(err[0].numpy(), serr[0].numpy())
    assert (err[2] == ted.ERR_BAD_CODE).all() and (out[2] == 0).all()
    ref, rerr = jed.decode_segments_device_multi(
        *(jnp.asarray(a.numpy()) for a in args[:1]), jnp.asarray([0, 1, 0], jnp.int32),
        *(jnp.asarray(a.numpy()) for a in args[2:]), interpret=True)
    np.testing.assert_array_equal(out[:2].numpy(), np.asarray(ref)[:2])
    np.testing.assert_array_equal(err[:2].numpy(), np.asarray(rerr)[:2])


@pytest.mark.gpu
def test_kernel_vs_plain_multi_image_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K2 kernel has no CPU mode")
    args, _ = _two_image_case("cuda")
    got, gerr = ted.decode_segments_device_multi(*args)
    ref, rerr = ted.decode_segments_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(gerr, rerr)
    assert (gerr[2] == ted.ERR_BAD_CODE).all()


@pytest.mark.gpu
@pytest.mark.parametrize("restart", [0, 1, 3])
@pytest.mark.parametrize("mode", ["mono", "4:2:0", "4:2:2"])
def test_kernel_vs_plain_on_gpu(mode, restart):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K2 kernel has no CPU mode")
    data = _enc(mode, 130, 1100, seed=12, restart=restart)
    parsed = tparse(data)
    plan = tseg.build_plan(parsed) if restart else tseg.build_plan_no_dri(parsed)
    t = ted.plan_tensors((plan.streams,) + plan.kernel_tables, "cuda")
    before = ted.launches
    got, gerr = ted.decode_segments_device(*t)
    ref, rerr = ted.decode_segments_reference(
        t[0], torch.zeros(t[0].shape[0], dtype=torch.int32, device="cuda"),
        t[1], t[2], t[3], t[4][None], t[5][None], t[6][None], t[7][None])
    torch.cuda.synchronize()
    assert ted.launches == before + 2   # the tables' kernel and the decode's
    assert torch.equal(got, ref) and torch.equal(gerr, rerr)
