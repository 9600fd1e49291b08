"""K6 (dequant + float 8x8 IDCT -> u8) and the float ops vs the JAX reference.

The same numpy inputs, drawn from a seed, go through the JAX functions
(``idct_pallas.dequant_idct_pixels_fused`` in interpret mode, and the plain
``ops/idct.py``) and the port's plain versions.  Tolerance 1 on u8, the
reference's own (its kernel against its XLA path): float sums run in
different orders, and a sample whose value lands within rounding noise of a
half rounds either way.  On the CPU the port's wrappers run the plain
version; the CUDA kernel is held to it by the ``gpu``-marked tests and by
``chip_smoke.py``.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_gpu_tpu.ops import idct as jidct
from jpeg_gpu_tpu.ops import idct_pallas as jfused
from jpeg_gpu_tpu.testing.oracle import idct8x8_float64
from jpeg_gpu_tpu_torch.ops import block_plane
from jpeg_gpu_tpu_torch.ops import idct as tidct
from jpeg_gpu_tpu_torch.ops import idct_float as tfused
from jpeg_gpu_tpu_torch.testing.encoder import _M

CSRC = pathlib.Path(tfused.__file__).parent.parent / "csrc"


def _case(seed, shape, lim=300, qhi=50):
    rng = np.random.default_rng(seed)
    coefs = rng.integers(-lim, lim, size=shape + (8, 8), dtype=np.int16)
    q = rng.integers(1, qhi, size=(8, 8)).astype(np.int32)
    return coefs, q


def _maxdiff(a, b):
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


def test_basis_equals_reference_and_kernel_literals():
    """The port's basis, the reference's, and the literals compiled into the
    CUDA kernel are the same 64 float32 values."""
    np.testing.assert_array_equal(tidct.IDCT_BASIS, jidct.IDCT_BASIS)
    np.testing.assert_array_equal(tidct.dct_basis(np.float64), jidct.dct_basis(np.float64))
    src = (CSRC / "idct_float.cu").read_text()
    body = src[src.index("kM[64] = {"):]
    body = body[: body.index("};")]
    lits = re.findall(r"-?\d\.\d+e-?\d+f", body)
    assert len(lits) == 64
    got = np.array([np.float32(x[:-1]) for x in lits], np.float32).reshape(8, 8)
    np.testing.assert_array_equal(got, tidct.IDCT_BASIS)


def test_blocks_vs_jax_kernel_and_xla_path():
    coefs, q = _case(1, (300,))
    got = tfused.dequant_idct_pixels_fused(torch.from_numpy(coefs), torch.from_numpy(q))
    assert got.dtype == torch.uint8 and got.shape == (300, 8, 8)
    kernel = jfused.dequant_idct_pixels_fused(jnp.asarray(coefs), jnp.asarray(q), interpret=True)
    xla = jidct.dequant_idct_pixels(jnp.asarray(coefs), jnp.asarray(q))
    assert _maxdiff(got.numpy(), kernel) <= 1
    assert _maxdiff(got.numpy(), xla) <= 1
    # The block form and its plain version are the same arithmetic.
    plain = tfused.dequant_idct_pixels_reference(torch.from_numpy(coefs), torch.from_numpy(q))
    assert _maxdiff(got.numpy(), plain.numpy()) <= 1


@pytest.mark.parametrize("shape", [(3, 5), (2, 4, 6), (1, 1)])
def test_float_plane_vs_jax(shape):
    coefs, q = _case(2, shape)
    c, qt = torch.from_numpy(coefs), torch.from_numpy(q)
    ref = jidct.dequant_idct_float_plane(jnp.asarray(coefs), jnp.asarray(q))
    plain = tidct.dequant_idct_float_plane(c, qt)
    assert plain.dtype == torch.uint8 and tuple(plain.shape) == np.asarray(ref).shape
    assert _maxdiff(plain.numpy(), ref) <= 1
    via_wrapper = tfused.dequant_idct_float_plane_soa(block_plane.blocks_as_soa(c), qt)
    assert torch.equal(via_wrapper, plain)


@pytest.mark.parametrize("fn", ["dequant_idct", "dequant_idct_pixels", "idct8x8"])
def test_float_ops_vs_jax(fn):
    coefs, q = _case(3, (40,), lim=1000)
    args = (coefs,) if fn == "idct8x8" else (coefs, q)
    got = getattr(tidct, fn)(*(torch.from_numpy(a) for a in args)).numpy()
    ref = np.asarray(getattr(jidct, fn)(*(jnp.asarray(a) for a in args)))
    if fn == "dequant_idct_pixels":
        assert _maxdiff(got, ref) <= 1
    else:
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)


@pytest.mark.parametrize("lo,hi", [(-256, 255), (-5, 5), (-300, 300)])
def test_float_idct_ieee1180(lo, hi):
    """The reference's IEEE 1180-1990 conformance bounds on the port's idct8x8."""
    rng = np.random.default_rng(42)
    pix = rng.integers(lo, hi + 1, size=(2000, 8, 8)).astype(np.float64)
    coefs = np.clip(np.round(np.einsum("ui,nij,vj->nuv", _M, pix, _M)), -2048, 2047)
    coefs = coefs.astype(np.int32)
    ref = np.clip(np.round(idct8x8_float64(coefs)), -256, 255)
    got = tidct.idct8x8(torch.from_numpy(coefs)).numpy()
    err = np.clip(np.round(got), -256, 255) - ref
    assert np.abs(err).max() <= 1, "peak error"
    assert (err**2).mean() <= 0.02, "overall MSE"
    assert (err**2).mean(axis=0).max() <= 0.06, "worst pixel MSE"
    assert abs(err.mean()) <= 0.0015, "overall mean error"


def test_zero_in_zero_out_and_dc_only():
    z = torch.zeros((4, 8, 8), dtype=torch.int32)
    assert (tidct.idct8x8(z) == 0).all()
    q = torch.ones((8, 8), dtype=torch.int32)
    assert (tfused.dequant_idct_pixels_fused(z.to(torch.int16), q) == 128).all()
    dc = torch.zeros((1, 8, 8), dtype=torch.int16)
    dc[0, 0, 0] = 400
    assert (tfused.dequant_idct_pixels_fused(dc, q) == 128 + 50).all()


def test_blocks_plane_round_trip_vs_jax():
    p = np.random.default_rng(5).integers(0, 256, size=(2, 24, 40)).astype(np.uint8)
    blocks = tidct.plane_to_blocks(torch.from_numpy(p))
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jidct.plane_to_blocks(jnp.asarray(p))))
    back = tidct.blocks_to_plane(blocks)
    np.testing.assert_array_equal(back.numpy(), p)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jidct.blocks_to_plane(jnp.asarray(blocks.numpy()))))


@pytest.mark.parametrize("bad", ["blocks", "qtable", "dtype"])
def test_wrapper_rejects_bad_arguments(bad):
    q = torch.ones((8, 8), dtype=torch.int32)
    if bad == "blocks":
        with pytest.raises(ValueError):
            tfused.dequant_idct_pixels_fused(torch.zeros((3, 8, 4), dtype=torch.int16), q)
    elif bad == "qtable":
        with pytest.raises(ValueError):
            tfused.dequant_idct_pixels_fused(
                torch.zeros((3, 8, 8), dtype=torch.int16), torch.ones((2, 8, 8), dtype=torch.int32))
    else:
        with pytest.raises(TypeError):
            tfused.dequant_idct_float_plane_soa(torch.zeros((64, 2, 2)), q)


def test_wrapper_has_no_fallback_for_other_devices():
    soa = torch.zeros((64, 2, 2), dtype=torch.int16, device="meta")
    with pytest.raises(RuntimeError):
        tfused.dequant_idct_float_plane_soa(soa, torch.ones(64, dtype=torch.int32, device="meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (17, 33), (3, 136, 240)])
@pytest.mark.parametrize("layout", ["soa", "view"])
def test_kernel_vs_plain_on_gpu(shape, layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K6 kernel has no CPU mode")
    assert not torch.backends.cuda.matmul.allow_tf32
    coefs, q = _case(6, shape)
    c = torch.from_numpy(coefs).cuda()
    qt = torch.from_numpy(q).cuda()
    soa = block_plane.blocks_as_soa(c)
    if layout == "soa":
        soa = soa.contiguous()
    before = tfused.launches
    got = tfused.dequant_idct_float_plane_soa(soa, qt)
    ref = tfused.dequant_idct_float_plane_soa_reference(soa, qt)
    torch.cuda.synchronize()
    assert tfused.launches == before + 1
    assert int((got.int() - ref.int()).abs().max()) <= 1
    # Against a float64 IDCT of the same blocks: peak error 1.
    deq = coefs.astype(np.float64) * q
    exact = np.clip(np.round(idct8x8_float64(deq.reshape(-1, 8, 8)) + 128.0), 0, 255)
    blocks = tidct.plane_to_blocks(got).reshape(-1, 8, 8).cpu().numpy()
    assert np.abs(blocks - exact).max() <= 1


@pytest.mark.gpu
def test_blocks_form_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K6 kernel has no CPU mode")
    coefs, q = _case(7, (777,))
    c, qt = torch.from_numpy(coefs).cuda(), torch.from_numpy(q).cuda()
    got = tfused.dequant_idct_pixels_fused(c, qt)
    ref = tfused.dequant_idct_pixels_reference(c, qt)
    assert got.shape == (777, 8, 8)
    assert int((got.int() - ref.int()).abs().max()) <= 1


def _tables_per_index(seed, lead):
    return np.random.default_rng(seed).integers(1, 50, size=lead + (1, 1, 8, 8)).astype(np.int32)


@pytest.mark.parametrize("per_index", [False, True])
def test_planes_in_one_call_vs_jax_plane_by_plane(per_index):
    """dequant_idct_float_planes_soa on the CPU: three planes of their own
    grids (views of blocks, contiguous planes), against the JAX plane
    function plane by plane, within 1; with one table per plane or one per
    leading index."""
    shapes = [(2, 6, 8), (2, 3, 4), (2, 3, 4)]
    blocks, tables = [], []
    for i, shape in enumerate(shapes):
        coefs, q = _case(20 + i, shape)
        blocks.append(coefs)
        tables.append(_tables_per_index(30 + i, shape[:1]) if per_index else q)
    planes = [block_plane.blocks_as_soa(torch.from_numpy(c)) for c in blocks]
    planes[1] = planes[1].contiguous()
    got = tfused.dequant_idct_float_planes_soa(planes, [torch.from_numpy(q) for q in tables])
    assert len(got) == 3
    for g, c, q, p in zip(got, blocks, tables, planes):
        ref = jidct.dequant_idct_float_plane(jnp.asarray(c), jnp.asarray(q))
        assert g.dtype == torch.uint8 and tuple(g.shape) == np.asarray(ref).shape
        assert _maxdiff(g.numpy(), ref) <= 1
        assert torch.equal(g, tfused.dequant_idct_float_plane_soa(p, torch.from_numpy(q)))


@pytest.mark.parametrize("bad", ["five planes", "tables", "table shape"])
def test_planes_entry_rejects_bad_descriptors(bad):
    c = block_plane.blocks_as_soa(torch.zeros((2, 3, 4, 8, 8), dtype=torch.int16))
    q = torch.ones(64, dtype=torch.int32)
    planes, tables = [c, c, c], [q, q, q]
    if bad == "five planes":
        planes, tables = planes * 2, tables * 2
    elif bad == "tables":
        tables = tables[:2]
    else:
        tables[1] = torch.ones((3, 64), dtype=torch.int32)
    with pytest.raises(ValueError):
        tfused.dequant_idct_float_planes_soa(planes, tables)


@pytest.mark.gpu
@pytest.mark.parametrize("per_index", [False, True])
@pytest.mark.parametrize("layout", ["soa", "view"])
def test_planes_in_one_launch_on_gpu(layout, per_index):
    """Several planes in one launch equal one call per plane, and their
    plain versions within 1; with a table per plane or per leading index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K6 kernel has no CPU mode")
    shapes = [(3, 136, 240), (3, 68, 120), (3, 68, 120), (1, 1)]
    planes, tables = [], []
    for i, shape in enumerate(shapes):
        coefs, q = _case(50 + i, shape)
        soa = block_plane.blocks_as_soa(torch.from_numpy(coefs).cuda())
        planes.append(soa.contiguous() if layout == "soa" else soa)
        if per_index and len(shape) == 3:
            q = _tables_per_index(60 + i, shape[:1])
        tables.append(torch.from_numpy(q).cuda())
    before = tfused.launches
    got = tfused.dequant_idct_float_planes_soa(planes, tables)
    assert tfused.launches == before + 1
    single = [tfused.dequant_idct_float_plane_soa(p, q) for p, q in zip(planes, tables)]
    ref = [tfused.dequant_idct_float_plane_soa_reference(p, q) for p, q in zip(planes, tables)]
    torch.cuda.synchronize()
    assert all(torch.equal(g, s) for g, s in zip(got, single))
    assert all(int((g.int() - r.int()).abs().max()) <= 1 for g, r in zip(got, ref))
