"""The port's (data, space) mesh and its sharded pixel decode, on the CPU.

``jpeg_gpu_tpu_torch.parallel`` on an 8-entry CPU mesh
(``make_mesh(devices=["cpu"] * 8)``, every kernel's plain version) is held
to the JAX reference's ``parallel/shard.py`` on its own 8-device CPU mesh
(``tests/conftest.py``): the same coefficients give the same RGB and the
same uint32 checksum, bit for bit on the exact paths and within 2 on
``exact=False`` RGB; and to the port's own unsharded decode, bit for bit.
The JAX side compiles a program per mesh (seconds each on the CPU), so it is
held to the reference at one space size per mode and the whole grid of
space sizes to the port's unsharded decode.  ``gpu`` cases run a 4-entry
``cuda:0`` mesh against the unsharded decode on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_gpu_tpu.engine import batch as jbatch
from jpeg_gpu_tpu.engine.pipeline import PipelineSpec as JSpec
from jpeg_gpu_tpu.parallel import mesh as jmesh
from jpeg_gpu_tpu.parallel import shard as jshard
from jpeg_gpu_tpu.testing import corpus
from jpeg_gpu_tpu_torch import decode
from jpeg_gpu_tpu_torch.engine import batch as tbatch
from jpeg_gpu_tpu_torch.engine import pipeline
from jpeg_gpu_tpu_torch.engine.pipeline import PipelineSpec
from jpeg_gpu_tpu_torch.host.entropy import decode_scan
from jpeg_gpu_tpu_torch.host.parser import parse
from jpeg_gpu_tpu_torch.ops import entropy_device, idct_islow_plane
from jpeg_gpu_tpu_torch.parallel import mesh as tmesh
from jpeg_gpu_tpu_torch.parallel import shard as tshard
from jpeg_gpu_tpu_torch.testing import corpus as tcorpus

MODES = ["4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1", "mono"]
CPU8 = ["cpu"] * 8


def _frame(mode, h=64, w=64, seed=0, quality=85):
    if mode == "mono":
        return tcorpus.own_jpeg(tcorpus.synthetic_gray(h, w, seed=seed), quality=quality).data
    return tcorpus.own_jpeg(tcorpus.synthetic_rgb(h, w, seed=seed), mode, quality=quality).data


def _batch(datas, exact=True, upsample="nearest", per_image=False):
    """Host-entropy blocks of same-geometry frames as an (N, vb, hb, 8, 8)
    batch per component, and their tables: shared (8, 8) from the first
    frame, or (N, 1, 1, 8, 8) per image.  Returns the numpy arrays and the
    port's spec."""
    parsed = [parse(d) for d in datas]
    hdr = parsed[0].header
    coefs = [np.stack([decode_scan(p).coefs[ci] for p in parsed]) for ci in range(len(hdr.components))]
    if per_image:
        qts = [np.stack([p.header.quant_for(c).values.astype(np.int32) for p in parsed])
               [:, None, None] for c in hdr.components]
    else:
        qts = [hdr.quant_for(c).values.astype(np.int32) for c in hdr.components]
    spec = PipelineSpec.from_header(hdr, exact=exact, upsample=upsample)
    return spec, coefs, qts


def _torch_sharded(spec, coefs, qts, space):
    mesh = tmesh.make_mesh(devices=CPU8, space=space)
    return tshard.decode_batch_sharded(
        spec, mesh, tuple(torch.from_numpy(c) for c in coefs),
        tuple(torch.from_numpy(q) for q in qts))


def _jax_sharded(spec, coefs, qts, space):
    jspec = JSpec(**{f: getattr(spec, f) for f in
                     ("width", "height", "comp_sizes", "comp_decs", "comp_samps", "exact",
                      "upsample")})
    rgb, checksum = jshard.decode_batch_sharded(
        jspec, jmesh.make_mesh(8, space=space), tuple(jnp.asarray(c) for c in coefs),
        tuple(jnp.asarray(q) for q in qts))
    return np.asarray(rgb), int(checksum)


def _unsharded(spec, coefs, qts):
    return pipeline.decode_rgb(spec, tuple(torch.from_numpy(c) for c in coefs),
                               tuple(torch.from_numpy(q) for q in qts)).numpy()


def _u32_sum(rgb) -> int:
    return int(np.asarray(rgb).astype(np.uint64).sum()) & 0xFFFFFFFF


# -- the mesh ------------------------------------------------------------------

def test_make_mesh_grid():
    mesh = tmesh.make_mesh(devices=CPU8, space=2)
    assert mesh.shape == {"data": 4, "space": 2} and mesh.size == 8
    assert mesh.first_device == torch.device("cpu") and len(mesh.flat()) == 8
    assert tmesh.make_mesh(4, devices=CPU8).shape == {"data": 4, "space": 1}
    with pytest.raises(ValueError):
        tmesh.make_mesh(devices=CPU8, space=3)
    with pytest.raises(ValueError):
        tmesh.make_mesh(9, devices=CPU8)


def test_make_mesh_takes_the_cards_or_raises():
    if torch.cuda.is_available():
        mesh = tmesh.make_mesh()
        assert mesh.size == torch.cuda.device_count()
        assert all(d.type == "cuda" for d in mesh.flat())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()


def test_split_and_gather_are_views_on_one_device():
    x = torch.arange(24).reshape(4, 6)
    parts = tmesh.split(x, 2, dim=0)
    assert all(p.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
               for p in parts) and parts[1][0, 0] == 12
    assert tmesh.to(parts[0], torch.device("cpu")) is parts[0]
    assert torch.equal(tmesh.all_gather(parts, torch.device("cpu")), x)
    with pytest.raises(ValueError):
        tmesh.split(x, 4, dim=1)


# -- decode_batch_sharded ------------------------------------------------------

@pytest.mark.parametrize("space", [1, 2, 4])
@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
@pytest.mark.parametrize("mode", MODES)
def test_sharded_batch_matches_unsharded(mode, upsample, space):
    """Every mode x upsampling x space size against the port's unsharded
    pipeline (K5 on the whole frame), with the checksum."""
    datas = [_frame(mode, seed=s) for s in range(8 // space)]
    spec, coefs, qts = _batch(datas, upsample=upsample, per_image=True)
    rgb, checksum = _torch_sharded(spec, coefs, qts, space)
    assert rgb.dtype == torch.uint8 and rgb.shape[0] == len(datas)
    want = _unsharded(spec, coefs, qts)
    np.testing.assert_array_equal(rgb[:, :64, :64].numpy(), want)
    assert int(checksum) == _u32_sum(rgb)


@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
@pytest.mark.parametrize("mode", MODES)
def test_sharded_batch_matches_reference(mode, upsample):
    """RGB (MCU-padded, padding included) and checksum against the JAX
    sharded decode on the same coefficients, space 2."""
    datas = [_frame(mode, seed=s) for s in range(4)]
    spec, coefs, qts = _batch(datas, upsample=upsample)
    rgb, checksum = _torch_sharded(spec, coefs, qts, 2)
    jrgb, jchecksum = _jax_sharded(spec, coefs, qts, 2)
    np.testing.assert_array_equal(rgb.numpy(), jrgb)
    assert int(checksum) == jchecksum


@pytest.mark.parametrize("space,mode", [(1, "4:2:0"), (4, "4:2:2")])
def test_sharded_batch_other_space_matches_reference(space, mode):
    """Space 1 and 4 against the reference, per-image tables."""
    datas = [_frame(mode, seed=s, quality=70 + 3 * s) for s in range(8 // space)]
    spec, coefs, qts = _batch(datas, upsample="fancy", per_image=True)
    rgb, checksum = _torch_sharded(spec, coefs, qts, space)
    jrgb, jchecksum = _jax_sharded(spec, coefs, qts, space)
    np.testing.assert_array_equal(rgb.numpy(), jrgb)
    assert int(checksum) == jchecksum


def test_sharded_batch_float_idct():
    """exact=False (K6): within 2 of the reference's sharded decode on RGB
    and bit for bit the port's unsharded float decode."""
    datas = [_frame("4:2:0", seed=s) for s in range(4)]
    spec, coefs, qts = _batch(datas, exact=False, upsample="fancy")
    rgb, _ = _torch_sharded(spec, coefs, qts, 2)
    np.testing.assert_array_equal(rgb[:, :64, :64].numpy(), _unsharded(spec, coefs, qts))
    jrgb, _ = _jax_sharded(spec, coefs, qts, 2)
    diff = np.abs(rgb.numpy().astype(np.int32) - jrgb.astype(np.int32))
    assert int(diff.max()) <= 2


@pytest.mark.parametrize("space", [2, 4])
@pytest.mark.parametrize("mode", ["4:2:0", "4:2:2", "4:4:0"])
def test_sharded_fancy_halo_odd_size(space, mode):
    """Fancy upsampling across shards at odd sizes, where the true-size
    clamps fall inside the MCU padding: the one-row halo exchange gives the
    unsharded filter's output bit for bit (the reference's
    test_sharded_fancy_halo_matches_single_device)."""
    h, w = 125, 67
    data = tcorpus.own_jpeg(tcorpus.synthetic_rgb(h, w, seed=21), mode, quality=85).data
    spec, coefs, qts = _batch([data] * (8 // space), upsample="fancy")
    rgb, _ = _torch_sharded(spec, coefs, qts, space)
    want = decode(data, device="cpu", upsample="fancy")
    for img in rgb.numpy():
        np.testing.assert_array_equal(img[:h, :w], want)


def test_sharded_batch_launches_one_idct_per_shard(monkeypatch):
    """The IDCT runs once per shard, all components in one call (K5 on
    the card)."""
    calls = []
    real = idct_islow_plane.dequant_idct_islow_planes_soa

    def counting(coefs, qtables):
        calls.append(len(coefs))
        return real(coefs, qtables)

    monkeypatch.setattr(idct_islow_plane, "dequant_idct_islow_planes_soa", counting)
    spec, coefs, qts = _batch([_frame("4:2:0", seed=s) for s in range(4)])
    _torch_sharded(spec, coefs, qts, 2)
    assert calls == [3] * 8


def test_halo_rows_come_from_the_neighbours():
    planes = [torch.full((2, 3), float(i)) for i in range(3)]
    halos = tshard._halo_rows(planes)
    assert [(float(t[0, 0]), float(b[0, 0])) for t, b in halos] == [(0, 1), (0, 2), (1, 2)]


def test_clamp_true_rows_per_shard():
    plane = torch.arange(8).reshape(8, 1)
    top = plane[:4]
    # True height 5 over two shards of 4 rows: shard 0 lies above the edge,
    # shard 1 holds only row 4 of the true rows and replicates it.
    assert tshard._clamp_true_rows(top, 5, 0) is top
    assert tshard._clamp_true_rows(plane[4:], 5, 1).flatten().tolist() == [4, 4, 4, 4]
    assert tshard._clamp_true_rows(plane, 6, 0).flatten().tolist() == [0, 1, 2, 3, 4, 5, 5, 5]


# -- decode_batch(mesh=) -------------------------------------------------------

def _mixed_corpus():
    """Two buckets, five 64x64 4:2:0 frames (a count no data axis of 8
    divides) and three gray frames, tables differing per image."""
    datas = [corpus.pil_jpeg(corpus.synthetic_rgb(64, 64, seed=q), quality=q,
                             subsampling="4:2:0") for q in (60, 70, 80, 90, 95)]
    datas += [corpus.pil_jpeg(corpus.synthetic_gray(48, 32, seed=q), quality=q)
              for q in (60, 75, 90)]
    return datas


def test_decode_batch_mesh_matches_reference():
    datas = _mixed_corpus()
    got = tbatch.decode_batch(datas, mesh=tmesh.make_mesh(devices=CPU8, space=2))
    want = jbatch.decode_batch(datas, mesh=jmesh.make_mesh(8, space=2))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("space", [1, 2])
@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
def test_decode_batch_mesh_matches_unsharded(upsample, space):
    datas = _mixed_corpus()
    got = tbatch.decode_batch(datas, upsample=upsample,
                              mesh=tmesh.make_mesh(devices=CPU8, space=space))
    want = tbatch.decode_batch(datas, upsample=upsample, device="cpu")
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_space_axis_must_divide_block_rows():
    data = _frame("4:2:0", h=48, w=32)    # 6 luma, 3 chroma block rows
    mesh = tmesh.make_mesh(devices=CPU8, space=2)
    with pytest.raises(ValueError, match="space axis"):
        tbatch.decode_batch([data], mesh=mesh)
    spec, coefs, qts = _batch([data] * 4)
    with pytest.raises(ValueError, match="space axis"):
        _torch_sharded(spec, coefs, qts, 2)
    with pytest.raises(ValueError, match="space axis"):
        tshard.check_space_rows(3, ((2, 2), (1, 1), (1, 1)), 2)


def test_mesh_and_device_must_agree():
    mesh = tmesh.make_mesh(devices=CPU8)
    with pytest.raises(ValueError, match="first device"):
        tbatch.decode_batch([_frame("4:2:0")], mesh=mesh, device="meta")


def test_local_seg_meta_remap():
    """The last segment's batch index becomes shard-local on the shard that
    holds it and -1 elsewhere."""
    meta = torch.tensor([5, 17, 3], dtype=torch.int32)
    got = [tshard._local_seg_meta(meta, d * 2, 2).tolist() for d in range(4)]
    assert got == [[-1, 17, 3], [-1, 17, 3], [1, 17, 3], [-1, 17, 3]]
    assert entropy_device.SLOTS == 1024


# -- on the card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
def test_sharded_batch_on_gpu_mesh(upsample):
    """A (data=2, space=2) mesh of one card against the unsharded decode
    on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    datas = [_frame("4:2:0", seed=s) for s in range(4)]
    spec, coefs, qts = _batch(datas, upsample=upsample, per_image=True)
    mesh = tmesh.make_mesh(devices=["cuda:0"] * 4, space=2)
    rgb, checksum = tshard.decode_batch_sharded(
        spec, mesh, tuple(torch.from_numpy(c).cuda() for c in coefs),
        tuple(torch.from_numpy(q).cuda() for q in qts))
    want = pipeline.decode_rgb(spec, tuple(torch.from_numpy(c).cuda() for c in coefs),
                               tuple(torch.from_numpy(q).cuda() for q in qts))
    assert rgb.is_cuda and torch.equal(rgb[:, :64, :64], want)
    assert int(checksum) == _u32_sum(rgb.cpu())


@pytest.mark.gpu
def test_decode_batch_mesh_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    datas = _mixed_corpus()
    got = tbatch.decode_batch(datas, mesh=tmesh.make_mesh(devices=["cuda:0"] * 4, space=2))
    want = tbatch.decode_batch(datas, device="cuda")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
