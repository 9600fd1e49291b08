"""The port's dry run of every sharded path (``testing/multichip.py``),
on an 8-entry CPU mesh as the reference's ``test_graft_dryrun_multichip``
runs its own on 8 CPU devices, and on a (data=2, space=2) mesh of one card.
Each of its checks holds a sharded output to the unsharded decode on the
mesh's first device, bit for bit; the 8K 4:2:0 frame of BASELINE config 5
makes it the slowest test of the sharded files on the CPU."""

import pytest
import torch

from jpeg_gpu_tpu_torch.testing import multichip


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_dryrun_multichip_cpu_mesh():
    summary = multichip.dryrun_multichip(8, devices=["cpu"] * 8)
    assert summary["mesh"] == (4, 2)
    assert summary["corpus_images"] == 9
    assert summary["frame_8k"] == (4, 4320, 7680, 3)
    assert summary["image_restart"] == summary["image_no_restart"] == (64, 64, 3)


@pytest.mark.gpu
def test_dryrun_multichip_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    summary = multichip.dryrun_multichip(4, devices=["cuda:0"] * 4)
    assert summary["mesh"] == (2, 2)
