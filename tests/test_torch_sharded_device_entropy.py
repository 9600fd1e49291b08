"""Sharded decode with the Huffman decode on the device, on the CPU.

The port's ``engine/device_entropy.decode_image_device_sharded`` (restart
segments over the data axis, the device index scan for streams without
restart markers) and ``engine/batch.decode_batch_device(mesh=)`` (a corpus
over the whole grid) on an 8-entry CPU mesh, every kernel's plain version.
Each path is held to the JAX reference's sharded function in one case (its
interpret-mode Huffman kernel takes seconds a call) and otherwise to the
port's unsharded decode, which the tier-1 tests hold to the reference, bit
for bit.  The cases port ``tests/test_sharded_device_entropy.py``.
``gpu`` cases run a 4-entry ``cuda:0`` mesh against the unsharded decode on
the card.
"""

import numpy as np
import pytest
import torch

from jpeg_gpu_tpu.engine import batch as jbatch
from jpeg_gpu_tpu.engine import device_entropy as jde
from jpeg_gpu_tpu.host.parser import parse as jparse
from jpeg_gpu_tpu.parallel import mesh as jmesh
from jpeg_gpu_tpu.testing import corpus
from jpeg_gpu_tpu_torch import decode
from jpeg_gpu_tpu_torch.engine import batch as tbatch
from jpeg_gpu_tpu_torch.engine import device_entropy as tde
from jpeg_gpu_tpu_torch.errors import JpegFormatError
from jpeg_gpu_tpu_torch.host.parser import parse
from jpeg_gpu_tpu_torch.ops import specsync_device
from jpeg_gpu_tpu_torch.parallel import mesh as tmesh
from jpeg_gpu_tpu_torch.parallel import shard as tshard


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain K2 and K3 run thousands of tiny ops; one intra-op thread
    keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(n=8, space=1):
    return tmesh.make_mesh(n, space=space, devices=["cpu"] * 8)


def _host(data, upsample="nearest"):
    """The port's unsharded decode with host entropy."""
    return decode(data, device="cpu", upsample=upsample)


def _restart_frame(h=64, w=64, seed=11, interval=1, mode="4:2:0"):
    return corpus.own_jpeg(corpus.synthetic_rgb(h, w, seed=seed), subsampling=mode,
                           quality=85, restart_interval=interval).data


def _corrupt(data: bytes, si: int) -> bytes:
    """All-ones bits (stuffed) over restart segment ``si``: invalid codes."""
    s, e = parse(data).segments[si]
    out = bytearray(data)
    out[s:e] = (b"\xff\x00" * ((e - s) // 2 + 1))[: e - s]
    return bytes(out)


def test_sharded_image_matches_reference():
    data = _restart_frame()
    got = tde.decode_image_device_sharded(parse(data), _mesh(space=2), upsample="fancy")
    want = jde.decode_image_device_sharded(jparse(data), jmesh.make_mesh(8, space=2),
                                           upsample="fancy")
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("space", [1, 2])
@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
def test_sharded_image_matches_unsharded(upsample, space):
    data = _restart_frame(128, 128)
    got = tde.decode_image_device_sharded(parse(data), _mesh(space=space), upsample=upsample)
    np.testing.assert_array_equal(got, _host(data, upsample))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("mode", ["4:2:2", "4:4:0", "4:1:1", "4:4:4"])
def test_sharded_image_other_modes(mode, exact):
    """The geometries of K5 / K6 per space shard and of K1 on row slices,
    against the unsharded device decode."""
    data = _restart_frame(64, 96, seed=3, interval=2, mode=mode)
    got = tde.decode_image_device_sharded(parse(data), _mesh(4, space=2), exact=exact,
                                          upsample="fancy")
    want = tde.decode_image_device(parse(data), exact=exact, upsample="fancy", device="cpu")
    np.testing.assert_array_equal(got, want.numpy())


def test_sharded_image_gray():
    data = corpus.own_jpeg(corpus.synthetic_gray(64, 96, seed=12), quality=80,
                           restart_interval=2).data
    got = tde.decode_image_device_sharded(parse(data), _mesh(space=2))
    np.testing.assert_array_equal(got, _host(data))


def test_sharded_multibatch_short_last_segment():
    """The short last segment's flag suppression when its batch lands on
    data shard 1: 2049 MCUs at restart interval 2 are 1025 segments in two
    batches, the last of one MCU.  Without the shard-local seg_meta this
    raises on a valid image."""
    data = corpus.pil_jpeg(corpus.synthetic_gray(24, 5464, seed=13), quality=85,
                           restart_marker_blocks=2)
    parsed = parse(data)
    assert parsed.header.n_mcus == 2049
    got = tde.decode_image_device_sharded(parsed, _mesh(2))
    np.testing.assert_array_equal(got, _host(data))


def test_sharded_image_no_restart_serial_scan():
    """specsync=False: the serial scan's pseudo segments shard over data
    with their DC bases added on each shard."""
    data = corpus.pil_jpeg(corpus.synthetic_rgb(96, 128, seed=14), quality=88,
                           subsampling="4:2:0")
    parsed = parse(data)
    assert parsed.header.restart_interval == 0
    got = tde.decode_image_device_sharded(parsed, _mesh(space=2), specsync=False)
    np.testing.assert_array_equal(got, _host(data))


def test_sharded_spec_matches_reference():
    """Without restart markers through the device index scan, against the
    reference's decode_image_device_sharded_spec path."""
    data = corpus.pil_jpeg(corpus.synthetic_rgb(64, 64, seed=14), quality=85,
                           subsampling="4:2:0")
    got = tde.decode_image_device_sharded(parse(data), _mesh(space=2))
    want = jde.decode_image_device_sharded(jparse(data), jmesh.make_mesh(8, space=2))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
def test_sharded_spec_matches_unsharded(upsample, monkeypatch):
    """No serial host scan: the spec path runs (and K3 once, the mesh naming
    one device eight times), pixels equal to the unsharded decode."""
    data = corpus.pil_jpeg(corpus.synthetic_rgb(128, 128, seed=14), quality=85,
                           subsampling="4:2:0")
    scans = []
    real = specsync_device.device_index_scan
    monkeypatch.setattr(specsync_device, "device_index_scan",
                        lambda *a, **k: scans.append(1) or real(*a, **k))
    got = tde.decode_image_device_sharded(parse(data), _mesh(space=2), upsample=upsample)
    assert scans == [1]
    np.testing.assert_array_equal(got, _host(data, upsample))


def test_sharded_spec_falls_back_when_ineligible(monkeypatch):
    from jpeg_gpu_tpu_torch.errors import JpegUnsupportedError

    data = corpus.pil_jpeg(corpus.synthetic_rgb(64, 96, seed=15), quality=85,
                           subsampling="4:2:0")

    def raise_unsupported(parsed, **kw):
        raise JpegUnsupportedError("forced")

    monkeypatch.setattr(tde, "build_spec_scan_input", raise_unsupported)
    got = tde.decode_image_device_sharded(parse(data), _mesh(4))
    np.testing.assert_array_equal(got, _host(data))


def test_sharded_spec_falls_back_when_the_scan_does_not_converge(monkeypatch):
    """A scan cut to one round does not converge: ok is False and the
    serial scan's plan decodes the image, with the same pixels."""
    data = corpus.pil_jpeg(corpus.synthetic_rgb(64, 96, seed=16), quality=85,
                           subsampling="4:2:0")
    parsed = parse(data)
    real = specsync_device.device_index_scan
    seen = []

    def one_round(*a, **k):
        bitpos, ok, stats = real(*a, max_rounds=1, **k)
        seen.append(bool(ok))
        return bitpos, ok, stats

    monkeypatch.setattr(specsync_device, "device_index_scan", one_round)
    assert tde._spec_decode_sharded_try(parsed, _mesh(4), True, "nearest", True) is None
    got = tde.decode_image_device_sharded(parsed, _mesh(4))
    assert seen == [False, False]
    np.testing.assert_array_equal(got, _host(data))


def test_sharded_image_names_the_corrupt_segment():
    data = _corrupt(_restart_frame(64, 64, interval=1), 9)
    with pytest.raises(JpegFormatError, match="restart segment 9 "):
        tde.decode_image_device_sharded(parse(data), _mesh(space=2))


def test_sharded_image_space_must_divide():
    data = _restart_frame(48, 32)    # 3 MCU rows
    with pytest.raises(ValueError, match="space axis"):
        tde.decode_image_device_sharded(parse(data), _mesh(space=2))


# -- a corpus over the grid ----------------------------------------------------

def _restart_corpus(n=6, seed=200):
    return [corpus.pil_jpeg(corpus.synthetic_rgb(64, 64, seed=seed + i), quality=85,
                            subsampling="4:2:0", optimize=True, restart_marker_blocks=1)
            for i in range(n)]


def test_sharded_corpus_matches_reference():
    datas = _restart_corpus()      # 6 images: not a multiple of 8, padded
    got = tbatch.decode_batch(datas, mesh=_mesh(space=2), entropy="device")
    want = jbatch.decode_batch(datas, mesh=jmesh.make_mesh(8, space=2), entropy="device")
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("space", [1, 2])
@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
def test_sharded_corpus_matches_unsharded(upsample, space):
    datas = _restart_corpus()
    got = tbatch.decode_batch_device(datas, upsample=upsample, mesh=_mesh(space=space))
    want = tbatch.decode_batch(datas, upsample=upsample, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("exact", [True, False])
def test_sharded_corpus_gray_and_unfused(exact):
    """A gray bucket and a 4:2:2 bucket (K5, or K6 with exact=False, per
    space shard) beside the fused one, against the unsharded device decode."""
    datas = [corpus.pil_jpeg(corpus.synthetic_gray(48, 64, seed=300 + i), quality=80,
                             restart_marker_blocks=1) for i in range(4)]
    datas += [corpus.own_jpeg(corpus.synthetic_rgb(32, 48, seed=s), subsampling="4:2:2",
                              restart_interval=1).data for s in (1, 2, 3)]
    got = tbatch.decode_batch_device(datas, exact=exact, upsample="fancy", mesh=_mesh(4, space=2))
    want = tbatch.decode_batch_device(datas, exact=exact, upsample="fancy", device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sharded_corpus_names_the_corrupt_image_and_salvages():
    datas = _restart_corpus(5)
    datas[3] = _corrupt(datas[3], 5)
    with pytest.raises(JpegFormatError, match="image 3 restart segment 5 "):
        tbatch.decode_batch_device(datas, mesh=_mesh(space=2))
    got = tbatch.decode_batch_device(datas, mesh=_mesh(space=2), on_error="zero")
    want = tbatch.decode_batch_device(datas, on_error="zero", device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sharded_corpus_warns_when_padding_exceeds_the_bucket(monkeypatch):
    warned = []
    monkeypatch.setattr(tbatch.log, "warning", lambda msg, *a: warned.append(msg % a))
    tbatch.decode_batch_device(_restart_corpus(3), mesh=_mesh(8))
    assert len(warned) == 1 and "pads 3 image(s) to 8 shards" in warned[0]
    tbatch.decode_batch_device(_restart_corpus(6), mesh=_mesh(8))   # pads 2: no warning
    assert len(warned) == 1


def test_sharded_corpus_space_must_divide():
    datas = [_restart_frame(48, 32, seed=s) for s in range(2)]
    with pytest.raises(ValueError, match="space axis"):
        tbatch.decode_batch_device(datas, mesh=_mesh(space=2))


def test_shard_shares_of_a_corpus(monkeypatch):
    """K2 runs once per shard of the grid, each over its own images' table
    sets."""
    from jpeg_gpu_tpu_torch.ops import entropy_device

    calls = []
    real = entropy_device.decode_segments_device_multi

    def spy(streams, img_of_batch, *rest, **kw):
        calls.append((streams.shape[0], rest[-1].shape[0]))
        return real(streams, img_of_batch, *rest, **kw)

    monkeypatch.setattr(entropy_device, "decode_segments_device_multi", spy)
    tbatch.decode_batch_device(_restart_corpus(8), mesh=_mesh(8, space=2))
    assert calls == [(1, 1)] * 8
    assert tshard.check_space_rows(4, ((2, 2),), 2) is None


# -- on the card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("interval", [1, 0])
@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
def test_sharded_image_on_gpu_mesh(upsample, interval):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    data = _restart_frame(128, 128, interval=interval)
    got = tde.decode_image_device_sharded(
        parse(data), tmesh.make_mesh(devices=["cuda:0"] * 4, space=2), upsample=upsample)
    want = tde.decode_image_device(parse(data), upsample=upsample, device="cuda")
    np.testing.assert_array_equal(got, want.cpu().numpy())


@pytest.mark.gpu
def test_sharded_corpus_on_gpu_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    datas = _restart_corpus()
    got = tbatch.decode_batch_device(datas, mesh=tmesh.make_mesh(devices=["cuda:0"] * 4, space=2))
    want = tbatch.decode_batch_device(datas, device="cuda")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
