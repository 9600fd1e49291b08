"""The port's multi-process glue (``parallel/distributed.py``), on the CPU.

Single-process cases mirror ``tests/test_distributed.py``: without a
process group one rank owns the whole corpus and decodes it on a mesh of
its device.  One case runs two ranks on the CPU with gloo, joined through a
file rendezvous (no TCP port to collide between test workers), and holds
every rank's output and the summed checksum to the single-process decode.
The NCCL path needs a card per rank: a ``gpu`` case runs it at world size 1.
"""

import os

import numpy as np
import pytest
import torch

from jpeg_gpu_tpu.parallel import distributed as jdistributed
from jpeg_gpu_tpu.testing import corpus
from jpeg_gpu_tpu_torch.engine.batch import decode_batch
from jpeg_gpu_tpu_torch.parallel import distributed
from jpeg_gpu_tpu_torch.testing import multichip


def _corpus(n=8):
    return [corpus.pil_jpeg(corpus.synthetic_rgb(32, 48, seed=i), quality=80 + i % 3,
                            subsampling="4:2:0") for i in range(n)]


def _checksum(rgbs) -> int:
    """The decode signature over the MCU-padded frames: here 32x48 is whole
    MCUs, so the cropped frames' sum."""
    return int(sum(int(r.astype(np.uint64).sum()) for r in rgbs)) & 0xFFFFFFFF


def test_initialize_from_env_single_process(monkeypatch):
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(v, raising=False)
    assert distributed.initialize_from_env() is False
    assert not torch.distributed.is_initialized()


def test_no_card_raises_without_device(monkeypatch):
    """Without a card, omitting ``device`` raises instead of running on the
    CPU (and so picking gloo): the CPU runs only for ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.decode_batch_distributed(_corpus(2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize_from_env(init_method="file:///nonexistent/rdzv", world_size=1,
                                        rank=0)
    assert not torch.distributed.is_initialized()


def test_local_shard_covers_all():
    sl = distributed.local_shard(10)
    assert (sl.start, sl.stop) == (0, 10)


@pytest.mark.parametrize("space", [1, 2])
def test_decode_batch_distributed_matches_plain(space):
    datas = _corpus(8 if space == 1 else 4)
    want = decode_batch(datas, device="cpu")
    got, checksum = distributed.decode_batch_distributed(
        datas, space=space, device="cpu", return_checksum=True)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert checksum == _checksum(want)


def test_decode_batch_distributed_matches_reference():
    datas = _corpus(8)
    got = distributed.decode_batch_distributed(datas, upsample="fancy", device="cpu")
    want = jdistributed.decode_batch_distributed(datas, upsample="fancy")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_decode_batch_distributed_rejects_mixed_geometry():
    datas = _corpus(2)
    datas.append(corpus.pil_jpeg(corpus.synthetic_rgb(64, 64, seed=9), quality=85,
                                 subsampling="4:2:0"))
    with pytest.raises(ValueError, match="one geometry bucket"):
        distributed.decode_batch_distributed(datas, device="cpu")
    assert distributed.decode_batch_distributed([], device="cpu") == []


def test_two_process_gloo(tmp_path):
    """Two ranks, four images each, gloo on the CPU."""
    import torch.multiprocessing as mp

    datas = _corpus(8)
    mp.spawn(multichip.distributed_worker,
             args=(2, f"file://{tmp_path}/rdzv", datas, 2, "cpu", str(tmp_path)),
             nprocs=2, join=True)
    want = decode_batch(datas, device="cpu")
    got = []
    for rank in range(2):
        with np.load(tmp_path / f"rank{rank}.npz") as f:
            rgbs = [f[f"arr_{i}"] for i in range(4)]
            assert int(f["checksum"]) == _checksum(want)
        got += rgbs
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # Each rank's share sums to its part of the global checksum.
    assert (_checksum(got[:4]) + _checksum(got[4:])) & 0xFFFFFFFF == _checksum(want)


def test_two_process_mixed_bucket_raises_on_every_rank(tmp_path):
    """Rank 1 holds an image of another geometry: both ranks raise."""
    import torch.multiprocessing as mp

    datas = _corpus(3)
    datas.append(corpus.pil_jpeg(corpus.synthetic_rgb(64, 64, seed=9), quality=85,
                                 subsampling="4:2:0"))
    with pytest.raises(Exception) as info:
        mp.spawn(multichip.distributed_worker,
                 args=(2, f"file://{tmp_path}/rdzv", datas, 1, "cpu", str(tmp_path)),
                 nprocs=2, join=True)
    assert "one geometry bucket" in str(info.value)
    assert not any(os.path.exists(tmp_path / f"rank{r}.npz") for r in range(2))


@pytest.mark.gpu
def test_nccl_world_size_one(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs on cards")
    import torch.multiprocessing as mp

    datas = _corpus(4)
    mp.spawn(multichip.distributed_worker,
             args=(1, f"file://{tmp_path}/rdzv", datas, 2, "cuda:0", str(tmp_path)),
             nprocs=1, join=True)
    want = decode_batch(datas, device="cuda")
    with np.load(tmp_path / "rank0.npz") as f:
        for i, b in enumerate(want):
            np.testing.assert_array_equal(f[f"arr_{i}"], b)
        assert int(f["checksum"]) == _checksum(want)
