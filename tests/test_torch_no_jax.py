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
rgb = jt.decode(enc.data, device="cpu", upsample="{upsample}", entropy="{entropy}", **{extra})
assert rgb.shape == (20, 30, 3), rgb.shape
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jpeg_gpu_tpu.")))
print("LEAKED", leaked)
assert not leaked, leaked
"""


BATCH_AND_CLI = """
import sys
import numpy as np
from jpeg_gpu_tpu_torch.cli import main
from jpeg_gpu_tpu_torch.engine.batch import decode_batch_device
from jpeg_gpu_tpu_torch.testing import corpus
datas = [corpus.own_jpeg(corpus.synthetic_rgb(16, 24, seed=s), "4:2:0", restart_interval=1).data
         for s in (1, 2)]
rgb = decode_batch_device(datas, device="cpu")
assert [r.shape for r in rgb] == [(16, 24, 3)] * 2
path = sys.argv[1]
open(path, "wb").write(datas[0])
assert main(["-b", "1", "--device", "cpu", path]) == 0
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jpeg_gpu_tpu.")))
print("LEAKED", leaked)
assert not leaked, leaked
"""


def test_batch_and_cli_import_no_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", BATCH_AND_CLI, str(tmp_path / "t.jpg")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


SHARDED = """
import sys
import numpy as np
from jpeg_gpu_tpu_torch.engine.batch import decode_batch
from jpeg_gpu_tpu_torch.engine.device_entropy import decode_image_device_sharded
from jpeg_gpu_tpu_torch.host.parser import parse
from jpeg_gpu_tpu_torch.parallel import distributed, mesh, shard
from jpeg_gpu_tpu_torch.testing import corpus, multichip
m = mesh.make_mesh(devices=["cpu"] * 4, space=2)
datas = [corpus.own_jpeg(corpus.synthetic_rgb(32, 32, seed=s), "4:2:0", restart_interval=1).data
         for s in (1, 2, 3)]
assert [r.shape for r in decode_batch(datas, mesh=m)] == [(32, 32, 3)] * 3
assert [r.shape for r in decode_batch(datas, mesh=m, entropy="device")] == [(32, 32, 3)] * 3
assert decode_image_device_sharded(parse(datas[0]), m).shape == (32, 32, 3)
assert len(distributed.decode_batch_distributed(datas, device="cpu")) == 3
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jpeg_gpu_tpu.")))
print("LEAKED", leaked)
assert not leaked, leaked
"""


def test_parallel_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", SHARDED], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


SWEEP = """
import sys
import torch
from jpeg_gpu_tpu_torch.testing import specsync_artifact, sweep
entry = sweep.load_manifest()["sweep"][17]
checks = sweep.check_config(sweep.read_fixture(sweep.FIXTURES, entry), entry, torch.device("cpu"))
assert checks["cuda_eq_host"] and checks["device_entropy_eq"] and checks["rgb_sha_eq_r05"], checks
assert specsync_artifact.check_fallback(torch.device("cpu"))
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jpeg_gpu_tpu.")))
print("LEAKED", leaked)
assert not leaked, leaked
"""


def test_sweep_and_scan_artifact_import_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", SWEEP], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


FUZZ = """
import sys
from jpeg_gpu_tpu_torch.testing import fuzz
res = fuzz.run("cpu", seed=0, n=4, paths=("auto", "device", "batch_device"))
assert res["ok"] and res["pairs"] == 12, res
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jpeg_gpu_tpu.")))
print("LEAKED", leaked)
assert not leaked, leaked
"""


def test_fuzz_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", FUZZ], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


@pytest.mark.parametrize("upsample,entropy,extra", [
    ("nearest", "auto", {}), ("fancy", "python", {}), ("fancy", "device", {}),
    ("nearest", "auto", {"upload": "pack"}), ("fancy", "auto", {"exact": False}),
])
def test_port_imports_no_jax(upsample, entropy, extra):
    # One intra-op thread: the plain kernel versions run many tiny ops, and
    # this process shares the cores with the other test workers.
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(upsample=upsample, entropy=entropy, extra=extra)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


FULLSIZE = """
import sys
from jpeg_gpu_tpu_torch.testing import fullsize
f = fullsize.BY_NAME["4k-444-r1"]
data = fullsize.build(f.name, f.reduced)
ref = fullsize.cpu_reference(data)
assert set(ref) == {*fullsize.KINDS, "float"}, ref
assert fullsize.load_manifest()["frames"][f.name]["mcus"] == 129600
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jpeg_gpu_tpu.")))
print("LEAKED", leaked)
assert not leaked, leaked
"""


def test_fullsize_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", FULLSIZE], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout
