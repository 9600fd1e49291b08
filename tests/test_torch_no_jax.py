"""The port never imports jax.

Checked in a fresh interpreter: this test process has jax loaded already
(tests/conftest.py imports it).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
import numpy as np
import jpeg_gpu_tpu_torch as jt
from jpeg_gpu_tpu_torch import cuda_build
from jpeg_gpu_tpu_torch.engine import pipeline
from jpeg_gpu_tpu_torch.ops import pixel_fused
from jpeg_gpu_tpu_torch.testing import corpus
enc = corpus.own_jpeg(corpus.synthetic_rgb(20, 30, seed=1), "4:2:0")
rgb = jt.decode(enc.data, device="cpu", upsample="{upsample}", entropy="{entropy}")
assert rgb.shape == (20, 30, 3), rgb.shape
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jpeg_gpu_tpu.")))
print("LEAKED", leaked)
assert not leaked, leaked
"""


@pytest.mark.parametrize("upsample,entropy", [("nearest", "auto"), ("fancy", "python"),
                                              ("fancy", "device")])
def test_port_imports_no_jax(upsample, entropy):
    # One intra-op thread: the plain kernel versions run many tiny ops, and
    # this process shares the cores with the other test workers.
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(upsample=upsample, entropy=entropy)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout
