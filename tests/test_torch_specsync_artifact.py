"""The device-scan artifact (``jpeg_gpu_tpu_torch/testing/specsync_artifact.py``) on the CPU.

The six committed scan inputs of ``scripts/specsync_device_artifact.py``
go through the plain version of K3 (``device_index_scan`` on CPU tensors):
the per-MCU bit offsets equal the native serial scan's, and the engine's
``entropy="device"`` decode, which takes the scan, equals the host
pipeline.  A scan forced to overflow falls back to the serial scan with the
same coefficients.
"""

import json

import pytest
import torch

from jpeg_gpu_tpu_torch.testing import specsync_artifact, sweep


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of tiny ops; one intra-op thread
    keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", [c[0] for c in sweep.SPECSYNC_CONFIGS])
def test_scan_bit_identical_and_decode_equal(name):
    (entry,) = [e for e in sweep.load_manifest()["specsync"] if e["config"] == name]
    rec = specsync_artifact.check_config(sweep.read_fixture(sweep.FIXTURES, entry), entry,
                                         torch.device("cpu"))
    assert rec["converged"] and rec["plan_bit_identical"], rec
    assert rec["decode_equal_host"] and rec["decode_via_scan"], rec
    assert rec["n_mcus"] > 0 and rec["rounds"] >= 1


def test_forced_overflow_falls_back_to_the_serial_scan():
    assert specsync_artifact.check_fallback(torch.device("cpu"))


def test_fallback_check_sees_a_wrong_decode(monkeypatch):
    """The fallback check compares coefficients: a forced run that decodes
    differently is caught."""
    from jpeg_gpu_tpu_torch.engine import device_entropy as de

    real = de.entropy_decode_device

    def skewed(parsed, specsync=True, **kw):
        res = real(parsed, specsync=specsync, **kw)
        if specsync:
            res.coefs = (res.coefs[0] + 1,) + tuple(res.coefs[1:])
        return res

    monkeypatch.setattr(de, "entropy_decode_device", skewed)
    assert not specsync_artifact.check_fallback(torch.device("cpu"))


def test_run_on_the_cpu(tmp_path):
    assert specsync_artifact.main(["--device", "cpu", "--out", str(tmp_path / "a.json")]) == 0
    art = json.loads((tmp_path / "a.json").read_text())
    assert art["n_configs"] == 6 and art["all_ok"] and art["fallback_serial_scan_ok"]
    assert art["backend"] == "cpu" and art["gpu"] is None
    assert art["serving_1080p"].startswith("not measured")
    assert [c["config"] for c in art["configs"]] == [c[0] for c in sweep.SPECSYNC_CONFIGS]
    assert art["launches"] == {f"K{k}": 0 for k in range(1, 7)}


def test_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        specsync_artifact.run()


@pytest.mark.gpu
def test_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 runs on the card")
    art = specsync_artifact.run("cuda")
    assert art["all_ok"] and art["fallback_serial_scan_ok"] and art["backend"] == "cuda"
    assert art["serving_1080p"]["device_scan_ms_per_frame"] > 0
