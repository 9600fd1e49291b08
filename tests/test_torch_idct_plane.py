"""K5 (SoA coefficient planes -> islow IDCT -> raster plane) vs the JAX reference.

The same numpy coefficients, drawn from a seed, go through the JAX Pallas
kernel ``idct_islow_pallas.dequant_idct_islow_plane_soa`` (interpret mode on
the CPU), the JAX unfused ``dequant_idct_islow_plane`` and the port's plain
version of K5; tolerance 0 (integer arithmetic).  On the CPU the port's
wrapper runs the plain version; the CUDA kernel itself is held to the plain
version by the ``gpu``-marked tests and by ``chip_smoke.py``.  The
multi-plane entry (all components of a frame in one call) is held to one
call per plane, to the unfused port and to the JAX kernel on mixed grids and
layouts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_gpu_tpu.ops import idct_islow as jislow
from jpeg_gpu_tpu.ops import idct_islow_pallas as jplane
from jpeg_gpu_tpu_torch.ops import block_plane
from jpeg_gpu_tpu_torch.ops import idct_islow as tislow
from jpeg_gpu_tpu_torch.ops import idct_islow_plane as tplane
from jpeg_gpu_tpu_torch.ops.pixel_fused import blocks_to_soa


def _case(seed, shape, lim=300):
    rng = np.random.default_rng(seed)
    coefs = rng.integers(-lim, lim + 1, size=shape + (8, 8)).astype(np.int16)
    q = rng.integers(1, 64, size=(8, 8)).astype(np.int32)
    return coefs, q


@pytest.mark.parametrize("seed,shape", [(0, (8, 6)), (1, (2, 8, 3))])
def test_plain_vs_jax_kernel_and_unfused(seed, shape):
    coefs, q = _case(seed, shape)
    soa = blocks_to_soa(torch.from_numpy(coefs))
    got = tplane.dequant_idct_islow_plane_soa(soa, torch.from_numpy(q)).numpy()
    kernel = np.asarray(jplane.dequant_idct_islow_plane_soa(
        jplane.blocks_to_soa(jnp.asarray(coefs)), jnp.asarray(q)))
    unfused = np.asarray(jislow.dequant_idct_islow_plane(jnp.asarray(coefs), jnp.asarray(q)))
    assert got.dtype == np.uint8 and got.shape == shape[:-2] + (shape[-2] * 8, shape[-1] * 8)
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(got, unfused)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (17, 33), (2, 3, 5), (2, 2, 1, 7)])
@pytest.mark.parametrize("view", [False, True])
def test_odd_grids_vs_unfused_port(shape, view):
    """Any vb, hb >= 1 and any leading axes; a strided blocks_as_soa view
    gives the same plane as contiguous planes."""
    coefs, q = _case(2, shape, lim=1500)
    c = torch.from_numpy(coefs)
    soa = block_plane.blocks_as_soa(c) if view else blocks_to_soa(c)
    assert not view or soa.data_ptr() == c.data_ptr()
    got = tplane.dequant_idct_islow_plane_soa(soa, torch.from_numpy(q.reshape(64)))
    assert torch.equal(got, tislow.dequant_idct_islow_plane(c, torch.from_numpy(q)))


def test_one_call_per_component_table():
    """A table per component is a call per component, as the engine makes
    them: slices of one block tensor go in as views."""
    coefs, _ = _case(3, (3, 4, 5))
    qs = np.random.default_rng(4).integers(1, 99, size=(3, 64)).astype(np.int32)
    c = torch.from_numpy(coefs)
    for i in range(3):
        soa = block_plane.blocks_as_soa(c[i])
        assert soa.data_ptr() == c[i].data_ptr()
        got = tplane.dequant_idct_islow_plane_soa(soa, torch.from_numpy(qs[i]))
        want = tislow.dequant_idct_islow_plane(c[i], torch.from_numpy(qs[i]))
        assert torch.equal(got, want)


def test_soa_views_round_trip():
    coefs, _ = _case(5, (2, 3, 4))
    c = torch.from_numpy(coefs)
    view = block_plane.blocks_as_soa(c)
    assert view.data_ptr() == c.data_ptr() and view.shape == (2, 64, 3, 4)
    assert torch.equal(view, blocks_to_soa(c))
    assert torch.equal(block_plane.soa_as_blocks(view), c)
    assert torch.equal(block_plane.soa_as_blocks(blocks_to_soa(c)), c)


@pytest.mark.parametrize("bad", ["dtype", "shape", "qtable", "empty"])
def test_wrapper_rejects_bad_arguments(bad):
    soa = torch.zeros((2, 64, 3, 4), dtype=torch.int16)
    q = torch.ones(64, dtype=torch.int32)
    if bad == "dtype":
        with pytest.raises(TypeError):
            tplane.dequant_idct_islow_plane_soa(soa.to(torch.int32), q)
    elif bad == "shape":
        with pytest.raises(ValueError):
            tplane.dequant_idct_islow_plane_soa(soa[:, :63], q)
    elif bad == "qtable":
        with pytest.raises(ValueError):
            tplane.dequant_idct_islow_plane_soa(soa, torch.ones(2 * 64, dtype=torch.int32))
    else:
        with pytest.raises(ValueError):
            tplane.dequant_idct_islow_plane_soa(soa[:, :, :0], q)


def test_wrapper_has_no_fallback_for_other_devices():
    """Only a CPU tensor takes the plain version; any other device launches
    a kernel or raises."""
    soa = torch.zeros((64, 2, 2), dtype=torch.int16, device="meta")
    with pytest.raises(RuntimeError):
        tplane.dequant_idct_islow_plane_soa(soa, torch.ones(64, dtype=torch.int32, device="meta"))


GRIDS = [(1, 1), (3, 5), (17, 33), (2, 4, 4)]


def _planes(nplanes, layout, seed=7):
    """``nplanes`` block tensors on mixed grids, their SoA planes in
    ``layout`` ("soa", "view", or "mixed": views and contiguous planes in
    turn) and a quant table each."""
    blocks, planes, tables = [], [], []
    for i in range(nplanes):
        coefs, q = _case(seed + i, GRIDS[i], lim=1500)
        c = torch.from_numpy(coefs)
        view = layout == "view" or (layout == "mixed" and i % 2 == 0)
        blocks.append(c)
        planes.append(block_plane.blocks_as_soa(c) if view else blocks_to_soa(c))
        tables.append(torch.from_numpy(q))
    return blocks, planes, tables


@pytest.mark.parametrize("layout", ["soa", "view", "mixed"])
@pytest.mark.parametrize("nplanes", [1, 3, 4])
def test_all_planes_in_one_call(nplanes, layout):
    """Mixed grids, mixed layouts, a table per plane: the multi-plane entry
    equals one call per plane, the unfused port and the JAX Pallas kernel."""
    blocks, planes, tables = _planes(nplanes, layout)
    got = tplane.dequant_idct_islow_planes_soa(planes, tables)
    assert isinstance(got, list) and len(got) == nplanes
    for c, p, q, g in zip(blocks, planes, tables, got):
        assert g.dtype == torch.uint8
        assert g.shape == c.shape[:-4] + (c.shape[-4] * 8, c.shape[-3] * 8)
        assert torch.equal(g, tplane.dequant_idct_islow_plane_soa(p, q))
        assert torch.equal(g, tislow.dequant_idct_islow_plane(c, q))
        kernel = np.asarray(jplane.dequant_idct_islow_plane_soa(
            jplane.blocks_to_soa(jnp.asarray(c.numpy())), jnp.asarray(q.numpy()), band=1))
        np.testing.assert_array_equal(g.numpy(), kernel)


@pytest.mark.parametrize("bad", ["dtype", "five planes", "no planes", "tables", "devices", "shape"])
def test_multi_plane_entry_rejects_bad_descriptors(bad):
    _, planes, tables = _planes(3, "soa")
    want = ValueError
    if bad == "dtype":
        planes[1], want = planes[1].to(torch.int32), TypeError
    elif bad == "five planes":
        planes, tables = planes + planes[:2], tables + tables[:2]
    elif bad == "no planes":
        planes, tables = [], []
    elif bad == "tables":
        tables = tables[:2]
    elif bad == "devices":
        planes[2] = planes[2].to("meta")
    else:
        planes[0] = planes[0][:63]
    with pytest.raises(want):
        tplane.dequant_idct_islow_planes_soa(planes, tables)


def test_multi_plane_entry_has_no_fallback_for_other_devices():
    soa = torch.zeros((64, 2, 2), dtype=torch.int16, device="meta")
    q = torch.ones(64, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tplane.dequant_idct_islow_planes_soa([soa, soa], [q, q])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["soa", "view", "mixed"])
@pytest.mark.parametrize("nplanes", [1, 3, 4])
def test_multi_plane_kernel_vs_plain_on_gpu(nplanes, layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K5 kernel has no CPU mode")
    _, planes, tables = _planes(nplanes, layout)
    planes = [p.cuda() if p.is_contiguous() else block_plane.blocks_as_soa(
        block_plane.soa_as_blocks(p).cuda()) for p in planes]
    tables = [q.cuda() for q in tables]
    before = tplane.launches
    got = tplane.dequant_idct_islow_planes_soa(planes, tables)
    assert tplane.launches == before + 1
    ref = [tplane.dequant_idct_islow_plane_soa_reference(p, q) for p, q in zip(planes, tables)]
    torch.cuda.synchronize()
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (17, 33), (3, 136, 240)])
@pytest.mark.parametrize("layout", ["soa", "view"])
def test_kernel_vs_plain_on_gpu(shape, layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K5 kernel has no CPU mode")
    coefs, q = _case(6, shape, lim=1500)
    c = torch.from_numpy(coefs).cuda()
    qt = torch.from_numpy(q).cuda()
    soa = blocks_to_soa(c) if layout == "soa" else block_plane.blocks_as_soa(c)
    before = tplane.launches
    got = tplane.dequant_idct_islow_plane_soa(soa, qt)
    ref = tplane.dequant_idct_islow_plane_soa_reference(soa, qt)
    torch.cuda.synchronize()
    assert tplane.launches == before + 1
    assert torch.equal(got, ref)


# -- a quant table per leading index -----------------------------------------
# (leading axes, table shape): every shape check_plane_args takes for a table
# per leading index, the broadcast ones included.
PER_INDEX_TABLES = [
    ((3,), (3, 64)),
    ((3,), (3, 8, 8)),
    ((3,), (3, 1, 1, 8, 8)),
    ((2, 3), (2, 3, 64)),
    ((2, 3), (2, 3, 8, 8)),
    ((2, 3), (2, 1, 64)),
    ((2, 3), (3, 64)),
    ((2, 3), (2, 3, 1, 1, 8, 8)),
]


def _per_index_case(lead, tshape, seed=40):
    coefs, _ = _case(seed, lead + (5, 7), lim=1500)
    q = np.random.default_rng(seed + 1).integers(1, 90, size=tshape).astype(np.int32)
    # The table of each leading index, as (8, 8), by numpy broadcasting.
    rest = tshape[:-1] if tshape[-1] == 64 else tshape[:-2]
    if len(rest) == len(lead) + 2:
        rest = rest[:-2]
    full = np.broadcast_to(q.reshape(rest + (8, 8)), lead + (8, 8))
    return coefs, q, full


@pytest.mark.parametrize("lead,tshape", PER_INDEX_TABLES)
def test_table_per_leading_index(lead, tshape):
    """Each leading index takes its own table: equal to one call per index,
    and to the JAX unfused function with the table broadcast as the batch
    code broadcasts it."""
    coefs, q, full = _per_index_case(lead, tshape)
    c = torch.from_numpy(coefs)
    got = tplane.dequant_idct_islow_plane_soa(block_plane.blocks_as_soa(c), torch.from_numpy(q))
    assert got.shape == lead + (40, 56)
    for idx in np.ndindex(*lead):
        one = tplane.dequant_idct_islow_plane_soa(
            block_plane.blocks_as_soa(c[idx]), torch.from_numpy(full[idx].copy()))
        assert torch.equal(got[idx], one)
    ref = jislow.dequant_idct_islow_plane(
        jnp.asarray(coefs), jnp.asarray(full.reshape(lead + (1, 1, 8, 8))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("tshape", [
    (2, 64), (128,), (3, 32), (3, 8, 4), (3, 2, 1, 8, 8), (3, 1, 1, 64), (3, 64, 1),
    (1, 3, 64)])
def test_rejected_table_shapes(tshape):
    """Tables that are neither one table nor one per leading index of (3,)."""
    soa = torch.zeros((3, 64, 2, 2), dtype=torch.int16)
    q = torch.ones(tshape, dtype=torch.int32)
    with pytest.raises(ValueError, match="quant table"):
        tplane.dequant_idct_islow_plane_soa(soa, q)
    with pytest.raises(ValueError, match="quant table"):
        block_plane.check_plane_args(soa, q)


def test_check_plane_args_table_forms():
    """One table comes back as (64,) int32, tables per index as (n, 64)."""
    soa = torch.zeros((2, 3, 64, 1, 1), dtype=torch.int16)
    for shape in [(64,), (8, 8), (1, 64), (1, 1, 1, 8, 8)]:
        *_, q = block_plane.check_plane_args(soa, torch.ones(shape, dtype=torch.int64))
        assert q.shape == (64,) and q.dtype == torch.int32
    qs = torch.arange(6 * 64, dtype=torch.int32).reshape(2, 3, 1, 1, 8, 8)
    *_, q = block_plane.check_plane_args(soa, qs)
    assert q.shape == (6, 64) and torch.equal(q, qs.reshape(6, 64))


def test_all_planes_in_one_call_with_tables_per_index():
    """The multi-plane entry with a table per leading index on some planes
    and one table on others: each plane equals its single call."""
    coefs_a, qa, _ = _per_index_case((3,), (3, 1, 1, 8, 8), seed=41)
    coefs_b, qb = _case(42, (4, 6), lim=1500)
    planes = [block_plane.blocks_as_soa(torch.from_numpy(coefs_a)),
              blocks_to_soa(torch.from_numpy(coefs_b))]
    tables = [torch.from_numpy(qa), torch.from_numpy(qb)]
    got = tplane.dequant_idct_islow_planes_soa(planes, tables)
    for g, p, q in zip(got, planes, tables):
        assert torch.equal(g, tplane.dequant_idct_islow_plane_soa(p, q))


@pytest.mark.gpu
@pytest.mark.parametrize("lead,tshape", PER_INDEX_TABLES[:4])
def test_table_per_leading_index_on_gpu(lead, tshape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K5 kernel has no CPU mode")
    coefs, q, _ = _per_index_case(lead, tshape)
    soa = block_plane.blocks_as_soa(torch.from_numpy(coefs).cuda())
    qt = torch.from_numpy(q).cuda()
    other = blocks_to_soa(torch.from_numpy(_case(43, (17, 33), lim=1500)[0]).cuda())
    q1 = torch.from_numpy(_case(43, (1,))[1]).cuda()
    before = tplane.launches
    got = tplane.dequant_idct_islow_planes_soa([soa, other], [qt, q1])
    assert tplane.launches == before + 1
    ref = [tplane.dequant_idct_islow_plane_soa_reference(soa, qt),
           tplane.dequant_idct_islow_plane_soa_reference(other, q1)]
    torch.cuda.synchronize()
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
