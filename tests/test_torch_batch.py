"""Batched corpus decode in the port vs the JAX reference, on the CPU.

The port's ``decode_batch``, ``decode_batch_device`` and
``decode_batch_device_resident`` (``device="cpu"``: every kernel runs its
plain version) are held to the JAX package's functions on the same bytes:
tolerance 0 on the exact buckets, 2 on RGB for ``exact=False`` (the two
packages sum the float IDCT in different orders).  The sharded forms
(``mesh=``) are held to the reference in ``test_torch_parallel.py`` and
``test_torch_sharded_device_entropy.py``.
"""

import numpy as np
import pytest
import torch

from jpeg_gpu_tpu.engine import batch as jbatch
from jpeg_gpu_tpu.testing import corpus
from jpeg_gpu_tpu_torch import decode
from jpeg_gpu_tpu_torch.engine import batch as tbatch
from jpeg_gpu_tpu_torch.engine import pipeline
from jpeg_gpu_tpu_torch.errors import JpegFormatError, JpegUnsupportedError
from jpeg_gpu_tpu_torch.host import segments as tseg
from jpeg_gpu_tpu_torch.host.parser import parse as tparse
from jpeg_gpu_tpu_torch.ops import entropy_device as ted
from jpeg_gpu_tpu_torch.testing import corpus as tcorpus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain K2 runs thousands of tiny ops; one intra-op thread keeps
    them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _corpus():
    datas = []
    # Two geometry buckets x different quality (= different quant tables).
    for q in (70, 85, 95):
        img = corpus.synthetic_rgb(64, 64, seed=q)
        datas.append(corpus.pil_jpeg(img, quality=q, subsampling="4:2:0"))
    for q in (60, 90):
        img = corpus.synthetic_gray(48, 32, seed=q)
        datas.append(corpus.pil_jpeg(img, quality=q))
    return datas


def _restart_corpus(n=3, **kw):
    """Same geometry, different Huffman and quant tables, restart markers."""
    return [
        corpus.pil_jpeg(
            corpus.synthetic_rgb(48, 64, seed=s), quality=q, subsampling="4:2:0",
            optimize=True, **kw,
        )
        for s, q in [(0, 70), (1, 92), (2, 85)][:n]
    ]


def _assert_equal(got, ref, tol=0):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert isinstance(a, np.ndarray) and a.shape == b.shape and a.dtype == b.dtype
        if tol == 0:
            np.testing.assert_array_equal(a, b)
        else:
            assert int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) <= tol


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
def test_batch_matches_reference(exact, upsample):
    datas = _corpus()
    got = tbatch.decode_batch(datas, exact=exact, upsample=upsample, device="cpu")
    ref = jbatch.decode_batch(datas, exact=exact, upsample=upsample)
    _assert_equal(got, ref, tol=0 if exact else 2)


def test_batch_matches_single_decode():
    datas = _corpus()
    outs = tbatch.decode_batch(datas, device="cpu")
    for data, got in zip(datas, outs):
        np.testing.assert_array_equal(got, decode(data, device="cpu"))


def test_batch_python_entropy_blocks_to_fused(monkeypatch):
    """Without the native decoder the fused bucket gets blocks, which
    become K1's SoA planes on the device: the same pixels."""
    from jpeg_gpu_tpu_torch.host import entropy_native

    datas = _corpus()
    want = tbatch.decode_batch(datas, device="cpu")
    monkeypatch.setattr(entropy_native, "available", lambda: False)
    _assert_equal(tbatch.decode_batch(datas, device="cpu"), want)


def test_decode_batch_device_mixed_tables():
    """Corpus device decode: same geometry, different Huffman tables; a
    gray image in its own bucket, which has no restart markers and fits one
    mega-segment."""
    datas = _restart_corpus(restart_marker_blocks=2)
    datas.append(corpus.pil_jpeg(corpus.synthetic_gray(32, 32, seed=3), quality=80))
    buckets, fallback = tbatch._device_buckets(datas, True, "nearest")
    assert [b.indices for b in buckets] == [[0, 1, 2], [3]] and fallback == []
    got = tbatch.decode_batch_device(datas, device="cpu")
    _assert_equal(got, jbatch.decode_batch_device(datas))
    _assert_equal(got, tbatch.decode_batch(datas, device="cpu"))
    _assert_equal(tbatch.decode_batch(datas, entropy="device", device="cpu"), got)


@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
def test_decode_batch_device_unfused_buckets(upsample):
    """4:2:2 and 4:4:0 buckets beside the 4:2:0 one (K1, or K6 through
    pipeline.decode_rgb with exact=False) against the reference's
    host-entropy batch decode, which its device-entropy one equals by
    contract (the interpret-mode K2 of the reference takes seconds per
    bucket)."""
    datas = _restart_corpus(2, restart_marker_blocks=1)
    for mode in ("4:2:2", "4:4:0"):
        enc = tcorpus.own_jpeg(tcorpus.synthetic_rgb(24, 40, seed=5), subsampling=mode,
                               restart_interval=1)
        datas.append(enc.data)
    for exact in (True, False):
        got = tbatch.decode_batch_device(datas, exact=exact, upsample=upsample, device="cpu")
        ref = jbatch.decode_batch(datas, exact=exact, upsample=upsample)
        _assert_equal(got, ref, tol=0 if exact else 2)


@pytest.mark.parametrize("exact", [True, False])
def test_decode_batch_device_unfused_and_fallback_vs_reference_device(exact):
    """A bucket no fused geometry takes (h2v4: K5, or K6 with exact=False)
    and a stream the device planner rejects, held to the reference's own
    device-entropy batch decode."""
    small = tcorpus.own_jpeg(tcorpus.synthetic_rgb(24, 40, seed=5), subsampling="h2v4",
                             restart_interval=1).data
    big = corpus.pil_jpeg(corpus.synthetic_rgb(160, 192, seed=11), quality=95,
                          subsampling="4:2:0")
    datas = [small, big]
    buckets, fallback = tbatch._device_buckets(datas, exact, "fancy")
    assert fallback == [1] and pipeline.fused_rgb_geometry(buckets[0].spec) is None
    got = tbatch.decode_batch_device(datas, exact=exact, upsample="fancy", device="cpu")
    ref = jbatch.decode_batch_device(datas, exact=exact, upsample="fancy")
    _assert_equal(got, ref, tol=0 if exact else 2)


def test_bucket_key_separates_sampling_factors():
    """Same size + decimations but different sampling factors must not
    share a bucket: 4:4:4 and the all-2x2 fixture have identical
    comp_sizes/comp_decs yet different MCU-aligned block grids."""
    img = corpus.synthetic_rgb(24, 24, seed=7)
    a = corpus.own_jpeg(img, subsampling="4:4:4", quality=85).data
    b = corpus.own_jpeg(img, subsampling="4:4:4-2x2", quality=85).data
    outs = tbatch.decode_batch([a, b], device="cpu")
    for data, got in zip((a, b), outs):
        np.testing.assert_array_equal(got, decode(data, device="cpu"))
    _assert_equal(outs, jbatch.decode_batch([a, b]))
    buckets, _ = tbatch._device_buckets([a, b], True, "nearest")
    assert len(buckets) == 2


def test_decode_batch_device_resident():
    """Device-resident corpus decode: tensors on the device, values equal
    the with-download path and the reference; per-image flags clean."""
    datas = _restart_corpus(restart_marker_blocks=1)
    rgb, err = tbatch.decode_batch_device_resident(datas, device="cpu")
    assert isinstance(rgb, torch.Tensor) and isinstance(err, torch.Tensor)
    assert rgb.shape == (3, 48, 64, 3) and rgb.dtype == torch.uint8
    assert err.shape == (3,) and err.dtype == torch.int32
    got = tbatch.decode_batch_device(datas, device="cpu")
    for j in range(3):
        np.testing.assert_array_equal(rgb[j].numpy(), got[j])
    assert not err.any()
    jrgb, _ = jbatch.decode_batch_device_resident(datas)
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))


def test_decode_batch_device_resident_rejects_mixed_buckets():
    datas = [
        corpus.pil_jpeg(
            corpus.synthetic_rgb(48, 64, seed=0), quality=85,
            subsampling="4:2:0", restart_marker_blocks=1,
        ),
        corpus.pil_jpeg(
            corpus.synthetic_rgb(32, 32, seed=1), quality=85,
            subsampling="4:2:0", restart_marker_blocks=1,
        ),
    ]
    with pytest.raises(ValueError):
        tbatch.decode_batch_device_resident(datas, device="cpu")


def _ones_over_segment(data, si):
    """All-ones bits (0xFF with stuffed zeros) over restart segment si:
    beyond every codeword of libjpeg's tables, whose all-ones code is
    reserved, so K2 flags the segment whatever the tables."""
    s, e = tparse(data).segments[si]
    out = bytearray(data)
    out[s:e] = (b"\xff\x00" * ((e - s) // 2 + 1))[: e - s]
    return bytes(out)


def test_decode_batch_device_flags_corrupt_image():
    """The per-image flags, reduced on the device, name the corrupt image
    by its input index; on_error="zero" salvages it as the reference does."""
    datas = [
        corpus.pil_jpeg(
            corpus.synthetic_rgb(48, 64, seed=s), quality=85,
            subsampling="4:2:0", restart_marker_blocks=1,
        )
        for s in range(2)
    ]
    datas.append(corpus.pil_jpeg(corpus.synthetic_gray(32, 32, seed=3), quality=80))
    datas[1] = _ones_over_segment(datas[1], 2)
    # The gray image is a bucket of its own, decoded first: the index is
    # the input's, not the bucket's.
    datas = [datas[2], datas[0], datas[1]]
    with pytest.raises(JpegFormatError, match="image 2"):
        tbatch.decode_batch_device(datas, device="cpu")
    with pytest.raises(JpegFormatError, match="image 1"):
        tbatch.decode_batch_device_resident(datas[1:], device="cpu")
    got = tbatch.decode_batch_device(datas, on_error="zero", device="cpu")
    _assert_equal(got, jbatch.decode_batch_device(datas, on_error="zero"))
    rgb, err = tbatch.decode_batch_device_resident(datas[1:], on_error="zero", device="cpu")
    assert err[0] == 0 and err[1] == ted.ERR_BAD_CODE
    np.testing.assert_array_equal(rgb[1].numpy(), got[2])
    # check_errors=False returns the decode and leaves the flags to the caller.
    unchecked = tbatch.decode_batch_device(datas, check_errors=False, device="cpu")
    _assert_equal(unchecked[:2], got[:2])


def test_mesh_raises_not_implemented():
    """The sharded forms exist now: a port Mesh decodes as the unsharded
    call does, and anything else (a JAX mesh, say) is refused by type."""
    from jpeg_gpu_tpu_torch.parallel.mesh import make_mesh

    datas = _corpus()[:1]
    for fn in (tbatch.decode_batch, tbatch.decode_batch_device):
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            fn(datas, mesh=object())
        got = fn(datas, mesh=make_mesh(devices=["cpu"] * 2))
        _assert_equal(got, fn(datas, device="cpu"))


def test_on_error_is_checked():
    with pytest.raises(ValueError):
        tbatch.decode_batch_device(_corpus()[:1], on_error="ignore", device="cpu")


def test_no_restart_host_fallback():
    """A stream without restart markers too large for one 1024-word segment
    is rejected by the device planner and decodes through the host path;
    a small one is one mega-segment on the device.  Both equal the
    reference and the single-image decode."""
    big = corpus.pil_jpeg(corpus.synthetic_rgb(160, 192, seed=11), quality=95,
                          subsampling="4:2:0")
    small = corpus.pil_jpeg(corpus.synthetic_rgb(48, 64, seed=12), quality=75,
                            subsampling="4:2:0")
    with pytest.raises(JpegUnsupportedError):
        tseg.build_plan(tparse(big))
    plan = tseg.build_plan(tparse(small))
    assert plan.n_segments == 1 and plan.mcus_per_segment == plan.n_mcus
    datas = [big, small] + _restart_corpus(1, restart_marker_blocks=1)
    buckets, fallback = tbatch._device_buckets(datas, True, "nearest")
    assert fallback == [0] and sorted(i for b in buckets for i in b.indices) == [1, 2]
    got = tbatch.decode_batch_device(datas, device="cpu")
    _assert_equal(got, jbatch.decode_batch(datas))
    for data, a in zip(datas, got):
        np.testing.assert_array_equal(a, decode(data, device="cpu"))
    with pytest.raises(JpegUnsupportedError, match="image 0"):
        tbatch.decode_batch_device_resident(datas[:2], device="cpu")


def _kernel_out(mode, restart, seed, n):
    """K2's plain output for n images of one geometry, stacked per image."""
    plans = []
    for i in range(n):
        img = tcorpus.synthetic_rgb(40, 56, seed=seed + i)
        if mode == "mono":
            img, sub = img[..., 1].copy(), "4:2:0"
        else:
            sub = mode
        data = tcorpus.own_jpeg(img, subsampling=sub, restart_interval=restart).data
        plans.append(tseg.build_plan(tparse(data)))
    cp = tseg.build_corpus_plan(plans)
    t = ted.plan_tensors((cp.streams,) + cp.kernel_tables, "cpu")
    out, _ = ted.decode_segments_device_multi(*t)
    hdr = tparse(data).header
    geom = tuple((hdr.components[c].hsamp, hdr.components[c].vsamp) for c in hdr.scan.comp_idx)
    meta = (cp.n_segments, cp.mcus_per_segment, cp.n_mcus, hdr.nhmb, hdr.nvmb, geom)
    return out.reshape(n, cp.batches_per_image, *out.shape[1:]), meta, hdr.scan.comp_idx


@pytest.mark.parametrize("soa,force_general", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("mode,restart", [("4:2:0", 1), ("4:2:2", 3), ("mono", 2),
                                          ("4:1:1", 1)])
def test_assemble_components_batched_equals_loop(mode, restart, soa, force_general):
    """assemble_components with a leading image axis: one call for the
    bucket, equal image by image to one call per image."""
    out, meta, order = _kernel_out(mode, restart, seed=20, n=3)
    kw = dict(soa=soa, force_general=force_general, frame_order=order)
    batched = ted.assemble_components(out, *meta, **kw)
    for i in range(out.shape[0]):
        single = ted.assemble_components(out[i], *meta, **kw)
        assert len(single) == len(batched)
        for a, b in zip(batched, single):
            assert a.is_contiguous() and a.shape == (3, *b.shape)
            assert torch.equal(a[i], b)


@pytest.mark.gpu
def test_multi_table_k2_three_sets_on_gpu():
    """K2's row form over a corpus bucket with three distinct Huffman table
    sets (one launch) against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K2 kernel has no CPU mode")
    plans = [tseg.build_plan(tparse(d)) for d in _restart_corpus(restart_marker_blocks=1)]
    cp = tseg.build_corpus_plan(plans)
    assert len({p.cbase.tobytes() + p.symbols.tobytes() for p in plans}) == 3
    t = ted.plan_tensors((cp.streams,) + cp.kernel_tables, "cuda")
    before = ted.launches
    got, gerr = ted.decode_segments_device_multi(*t)
    assert ted.launches == before + 2   # the tables' kernel and the decode's
    ref, rerr = ted.decode_segments_reference(*t)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(gerr, rerr)
    # Slots past an image's segments hold no data; its real ones are clean.
    assert not gerr.reshape(3, -1)[:, : cp.n_segments].any()


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
def test_decode_batch_device_on_gpu_vs_cpu(exact):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    datas = _restart_corpus(restart_marker_blocks=1)
    datas.append(corpus.pil_jpeg(corpus.synthetic_gray(32, 32, seed=3), quality=80))
    gpu = tbatch.decode_batch_device(datas, exact=exact, upsample="fancy")
    cpu = tbatch.decode_batch_device(datas, exact=exact, upsample="fancy", device="cpu")
    _assert_equal(gpu, cpu, tol=0 if exact else 2)
    rgb, err = tbatch.decode_batch_device_resident(datas[:3], exact=exact, upsample="fancy")
    assert rgb.is_cuda and err.is_cuda and not err.any()
    _assert_equal(list(rgb.cpu().numpy()), cpu[:3], tol=0 if exact else 2)
