"""K1 (fused SoA -> RGB) in the port vs the JAX reference.

On the CPU the port's ``decode_rgb_fused_soa`` runs its plain PyTorch
version; it is held against the JAX package's unfused
``pipeline.decode_rgb`` (bit-identical to the TPU kernel by that package's
contract) on the same random coefficients, tolerance 0.  The CUDA kernel
itself is compared with the plain version only where a card is present.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_gpu_tpu.engine import pipeline as jpipeline
from jpeg_gpu_tpu.ops import idct_islow_pallas as jpallas_idct
from jpeg_gpu_tpu.ops import pixel_fused as jfused
from jpeg_gpu_tpu_torch.engine import pipeline as tpipeline
from jpeg_gpu_tpu_torch.ops import pixel_fused as tfused

GEOMS = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2), "4:4:0": (1, 2),
         "4:1:1": (4, 1)}


def _case(sx, sy, h, w, seed, lead=()):
    """Random blocks + tables for an (h, w) image of luma sampling (sx, sy)."""
    rng = np.random.default_rng(seed)
    vbc, hbc = -(-h // (8 * sy)), -(-w // (8 * sx))
    scale = np.maximum(1, 96 >> np.add.outer(np.arange(8), np.arange(8)))

    def blocks(vb, hb):
        c = rng.integers(-1, 2, size=lead + (vb, hb, 8, 8)) * rng.integers(
            0, scale + 1, size=lead + (vb, hb, 8, 8))
        c[..., 0, 0] = rng.integers(-60, 60, size=lead + (vb, hb))
        return c.astype(np.int16)

    coefs = [blocks(vbc * sy, hbc * sx), blocks(vbc, hbc), blocks(vbc, hbc)]
    qts = [rng.integers(1, 32, size=64).astype(np.int32) for _ in range(3)]
    cw, ch = -(-w // sx), -(-h // sy)
    xd, yd = sx.bit_length() - 1, sy.bit_length() - 1
    kw = dict(width=w, height=h, comp_sizes=((w, h), (cw, ch), (cw, ch)),
              comp_decs=((0, 0), (xd, yd), (xd, yd)),
              comp_samps=((sx, sy), (1, 1), (1, 1)))
    return coefs, qts, kw


def _jax_rgb(coefs, qts, kw, upsample):
    spec = jpipeline.PipelineSpec(**kw, upsample=upsample)
    out = jpipeline.decode_rgb(
        spec, tuple(jnp.asarray(c) for c in coefs),
        tuple(jnp.asarray(q.reshape(8, 8)) for q in qts))
    return np.asarray(out)


def _torch_soa(coefs, qts, sx, sy, device="cpu"):
    t = [torch.from_numpy(c).to(device) for c in coefs]
    soa = (tfused.blocks_to_soa_split(t[0], sx, sy),
           tfused.blocks_to_soa_split(t[1], 1, 1),
           tfused.blocks_to_soa_split(t[2], 1, 1))
    return soa, tuple(torch.from_numpy(q).to(device) for q in qts)


@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
@pytest.mark.parametrize("mode,hw", [
    ("4:4:4", (17, 31)), ("4:2:2", (19, 45)), ("4:2:0", (35, 41)),
    ("4:4:0", (33, 23)), ("4:1:1", (9, 70))])
def test_plain_k1_vs_jax_decode_rgb(mode, hw, upsample):
    sx, sy = GEOMS[mode]
    coefs, qts, kw = _case(sx, sy, *hw, seed=sum(hw))
    spec = tpipeline.PipelineSpec(**kw, upsample=upsample)
    soa, tq = _torch_soa(coefs, qts, sx, sy)
    got = tpipeline.decode_rgb_soa(spec, (sx, sy), soa, tq)
    assert got.shape == hw + (3,) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), _jax_rgb(coefs, qts, kw, upsample))


def test_plain_k1_batched_per_image_tables():
    """Leading batch dims with per-image quant tables."""
    sx, sy = 2, 2
    coefs, _, kw = _case(sx, sy, 21, 27, seed=5, lead=(2,))
    rng = np.random.default_rng(6)
    qts = rng.integers(1, 32, size=(2, 3, 64)).astype(np.int32)
    soa, _ = _torch_soa(coefs, [q[0] for q in qts.transpose(1, 0, 2)], sx, sy)
    got = tfused.decode_rgb_fused_soa(
        soa[0], soa[1][:, 0, 0], soa[2][:, 0, 0],
        torch.from_numpy(qts[:, 0]), torch.from_numpy(qts[:, 1:]), sx, sy,
        fancy=True, chroma_true=kw["comp_sizes"][1], size=(21, 27))
    assert got.shape == (2, 21, 27, 3)
    for b in range(2):
        ref = _jax_rgb([c[b] for c in coefs], list(qts[b]), kw, "fancy")
        np.testing.assert_array_equal(got[b].numpy(), ref)


def test_full_grid_when_no_size():
    coefs, qts, _ = _case(2, 1, 16, 32, seed=7)
    soa, tq = _torch_soa(coefs, qts, 2, 1)
    qtc = torch.stack([tq[1], tq[2]])
    got = tfused.decode_rgb_fused_soa(
        soa[0], soa[1][0, 0], soa[2][0, 0], tq[0], qtc, 2, 1)
    assert got.shape == (16, 32, 3)


@pytest.mark.parametrize("sx,sy", [(1, 1), (2, 1), (2, 2), (1, 2), (4, 1), (4, 2)])
def test_blocks_to_soa_split_vs_jax(sx, sy):
    c = np.random.default_rng(8).integers(-99, 99, size=(2, 4, 8, 8, 8)).astype(np.int16)
    got = tfused.blocks_to_soa_split(torch.from_numpy(c), sx, sy)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfused.blocks_to_soa_split(jnp.asarray(c), sx, sy)))
    back = tfused.soa_split_to_blocks(got)
    np.testing.assert_array_equal(back.numpy(), c)


def test_blocks_to_soa_vs_jax():
    c = np.random.default_rng(9).integers(-99, 99, size=(3, 5, 8, 8)).astype(np.int16)
    np.testing.assert_array_equal(
        tfused.blocks_to_soa(torch.from_numpy(c)).numpy(),
        np.asarray(jpallas_idct.blocks_to_soa(jnp.asarray(c))))


def _args(sx=2, sy=2, dtype=torch.int16, device="cpu"):
    y = torch.zeros((sy, sx, 64, 2, 3), dtype=dtype, device=device)
    c = torch.zeros((64, 2, 3), dtype=dtype, device=device)
    q = torch.ones(64, dtype=torch.int32, device=device)
    return y, c, c.clone(), q, torch.ones((2, 64), dtype=torch.int32, device=device)


@pytest.mark.parametrize("bad", ["dtype", "fancy_no_true", "fancy_411", "shape", "size"])
def test_wrapper_rejects_bad_arguments(bad):
    if bad == "dtype":
        with pytest.raises(TypeError):
            tfused.decode_rgb_fused_soa(*_args(dtype=torch.int32), 2, 2)
    elif bad == "fancy_no_true":
        with pytest.raises(ValueError):
            tfused.decode_rgb_fused_soa(*_args(), 2, 2, fancy=True)
    elif bad == "fancy_411":
        with pytest.raises(ValueError):
            tfused.decode_rgb_fused_soa(*_args(4, 1), 4, 1, fancy=True,
                                        chroma_true=(6, 16))
    elif bad == "shape":
        y, cb, cr, qy, qc = _args()
        with pytest.raises(ValueError):
            tfused.decode_rgb_fused_soa(y, cb[:, :1], cr, qy, qc, 2, 2)
    else:
        with pytest.raises(ValueError):
            tfused.decode_rgb_fused_soa(*_args(), 2, 2, size=(33, 8))


def test_wrapper_has_no_fallback_for_other_devices():
    """Only a CPU tensor takes the plain version; any other device launches
    a kernel or raises."""
    with pytest.raises(RuntimeError):
        tfused.decode_rgb_fused_soa(*_args(device="meta"), 2, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
@pytest.mark.parametrize("mode", list(GEOMS))
def test_kernel_vs_plain_on_gpu(mode, upsample):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    sx, sy = GEOMS[mode]
    coefs, qts, kw = _case(sx, sy, 130, 1100, seed=11, lead=(2,))
    spec = tpipeline.PipelineSpec(**kw, upsample=upsample)
    soa, tq = _torch_soa(coefs, qts, sx, sy, device="cuda")
    args, kwargs = tpipeline.fused_soa_args(spec, (sx, sy), soa, tq)
    before = tfused.launches
    got = tfused.decode_rgb_fused_soa(*args, **kwargs)
    ref = tfused.decode_rgb_fused_soa_reference(*args, **kwargs)
    torch.cuda.synchronize()
    assert tfused.launches == before + 1
    assert torch.equal(got, ref)


# Widths whose pixel rows start at offsets that are not multiples of 16
# bytes (3 W bytes a row), one frame 4200 wide and 10 high, and one of
# several tiles each way.
GPU_SIZES = [(17, 31), (10, 4200), (130, 250)]


def _gpu_case(mode, upsample, hw, seed, lead=(), per_image=False):
    sx, sy = GEOMS[mode]
    coefs, qts, kw = _case(sx, sy, *hw, seed=seed, lead=lead)
    spec = tpipeline.PipelineSpec(**kw, upsample=upsample)
    soa, tq = _torch_soa(coefs, qts, sx, sy, device="cuda")
    if per_image:
        rng = np.random.default_rng(seed + 1)
        tq = tuple(torch.from_numpy(rng.integers(1, 32, size=lead + (64,)).astype(np.int32))
                   .cuda() for _ in range(3))
    return tpipeline.fused_soa_args(spec, (sx, sy), soa, tq)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", GPU_SIZES)
@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
@pytest.mark.parametrize("mode", list(GEOMS))
def test_kernel_vs_plain_unaligned_rows_on_gpu(mode, upsample, hw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    args, kwargs = _gpu_case(mode, upsample, hw, seed=sum(hw))
    before = tfused.launches
    got = tfused.decode_rgb_fused_soa(*args, **kwargs)
    ref = tfused.decode_rgb_fused_soa_reference(*args, **kwargs)
    torch.cuda.synchronize()
    assert tfused.launches == before + 1
    assert got.shape == hw + (3,) and torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
@pytest.mark.parametrize("mode", list(GEOMS))
def test_kernel_batch_of_odd_frames_per_image_tables_on_gpu(mode, upsample):
    """Three 37x53 frames in one launch, a different table set per image:
    the images after the first start at offsets that are not multiples of
    16 bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    args, kwargs = _gpu_case(mode, upsample, (37, 53), seed=12, lead=(3,), per_image=True)
    got = tfused.decode_rgb_fused_soa(*args, **kwargs)
    ref = tfused.decode_rgb_fused_soa_reference(*args, **kwargs)
    torch.cuda.synchronize()
    assert got.shape == (3, 37, 53, 3) and torch.equal(got, ref)
    one = tfused.decode_rgb_fused_soa_reference(
        args[0][1], args[1][1], args[2][1], args[3][1], args[4][1], *args[5:], **kwargs)
    assert torch.equal(got[1], one)

