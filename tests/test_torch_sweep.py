"""The port's differential sweep (``jpeg_gpu_tpu_torch/testing/sweep.py``) on the CPU.

The 20 committed JPEGs of ``testing/sweep_r05/`` are the inputs of
``scripts/sweep_differential.py`` (seed 2026).  Each decodes on the CPU,
with the default entropy path and with ``entropy="device"``, to the RGB
checksum the compiled TPU kernels gave (``SWEEP_r05.json``), equal to the
host pipeline and, where the reference compares with libjpeg, to libjpeg's
checksum.  The JAX reference (interpret mode on the CPU) takes 2-9 s a
frame, so four configs hold the port to it in tier-1 and all 20 under
``slow``.
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

import jpeg_gpu_tpu as jr
import jpeg_gpu_tpu_torch as jt
from jpeg_gpu_tpu_torch.testing import sweep

REPO = pathlib.Path(__file__).resolve().parents[1]
KEYS = ("i", "h", "w", "q", "mode", "restart", "upsample")
# Gray without restart markers, 4:1:1 fancy, h2v4, and 48x4200 fancy.
TIER1_REFERENCE = (5, 1, 17, 18)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of tiny ops; one intra-op thread
    keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _entry(i):
    return sweep.load_manifest()["sweep"][i]


def _data(entry):
    return sweep.read_fixture(sweep.FIXTURES, entry)


def test_draw_configs_equal_the_reference_artifact():
    ref = json.loads((REPO / "SWEEP_r05.json").read_text())
    assert sweep.draw_configs() == [{k: c[k] for k in KEYS} for c in ref["configs"]]
    manifest = sweep.load_manifest()
    assert [{k: e[k] for k in KEYS} for e in manifest["sweep"]] == sweep.draw_configs()
    assert [e["rgb_sha_r05"] for e in manifest["sweep"]] == [c["rgb_sha"] for c in ref["configs"]]
    # libjpeg's checksum exactly where the reference compares with libjpeg.
    assert [("libjpeg_rgb_sha" in e) for e in manifest["sweep"]] == [
        "tpu_eq_libjpeg" in c for c in ref["configs"]]


@pytest.mark.parametrize("name", [f"{i:02d}.jpg" for i in range(20)]
                         + [f"{c[0]}.jpg" for c in sweep.SPECSYNC_CONFIGS])
def test_committed_file_matches_its_manifest_sha256(name):
    manifest = sweep.load_manifest()
    (entry,) = [e for e in manifest["sweep"] + manifest["specsync"] if e["file"] == name]
    data = (sweep.FIXTURES / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == entry["sha256"]


@pytest.mark.parametrize("i", range(20))
def test_cpu_decode_equals_the_tpu_checksum_host_and_libjpeg(i):
    entry = _entry(i)
    data, ups = _data(entry), entry["upsample"]
    out = jt.decode(data, device="cpu", upsample=ups)
    dev = jt.decode(data, device="cpu", entropy="device", upsample=ups)
    assert sweep._checksum(out) == entry["rgb_sha_r05"]
    np.testing.assert_array_equal(dev, out)
    np.testing.assert_array_equal(out, jt.decode(data, impl="host", upsample=ups))
    if sweep.libjpeg_checked(entry):
        assert sweep._checksum(out) == entry["libjpeg_rgb_sha"]
    else:
        assert "libjpeg_rgb_sha" not in entry


@pytest.mark.parametrize("i", [i for i in range(20) if sweep.libjpeg_checked(_entry(i))])
def test_cpu_decode_equals_libjpeg_live(i):
    entry = _entry(i)
    data = _data(entry)
    try:
        want = jt.decode(data, impl="libjpeg")
    except jt.JpegUnsupportedError as e:
        pytest.skip(f"this machine's libjpeg oracle does not serve RGB: {e}")
    np.testing.assert_array_equal(
        jt.decode(data, device="cpu", upsample=entry["upsample"]), want)


def test_build_fixtures_reproduces_the_committed_checksums(tmp_path):
    pytest.importorskip("PIL")
    manifest = sweep.build_fixtures(tmp_path)
    committed = sweep.load_manifest()
    for built, entry in zip(manifest["sweep"], committed["sweep"]):
        data = sweep.read_fixture(tmp_path, built)
        out = jt.decode(data, device="cpu", upsample=built["upsample"])
        assert sweep._checksum(out) == entry["rgb_sha_r05"] == built["rgb_sha_r05"]
        assert built.get("libjpeg_rgb_sha") == entry.get("libjpeg_rgb_sha")
    for built, entry in zip(manifest["specsync"], committed["specsync"]):
        assert {k: v for k, v in built.items() if k != "sha256"} == {
            k: v for k, v in entry.items() if k != "sha256"}
        data = sweep.read_fixture(tmp_path, built)
        np.testing.assert_array_equal(jt.decode(data, device="cpu"),
                                      jt.decode(_data(entry), device="cpu"))


@pytest.mark.parametrize("i", [
    pytest.param(i, marks=() if i in TIER1_REFERENCE else pytest.mark.slow) for i in range(20)])
def test_port_equals_the_jax_reference(i):
    entry = _entry(i)
    data, ups = _data(entry), entry["upsample"]
    got = jt.decode(data, device="cpu", upsample=ups)
    np.testing.assert_array_equal(got, np.asarray(jr.decode(data, impl="tpu", upsample=ups)))
    np.testing.assert_array_equal(
        jt.decode(data, device="cpu", entropy="device", upsample=ups),
        np.asarray(jr.decode(data, impl="tpu", entropy="device", upsample=ups)))


def test_run_on_the_cpu(tmp_path):
    assert sweep.main(["--device", "cpu", "--out", str(tmp_path / "s.json")]) == 0
    art = json.loads((tmp_path / "s.json").read_text())
    assert (art["n"], art["passed"], art["failed"]) == (20, 20, 0), [
        c for c in art["configs"] if not c["ok"]]
    assert (art["n_random"], art["n_pinned"], art["seed"], art["backend"]) == (14, 6, 2026, "cpu")
    assert art["gpu"] is None and art["launches"] == {f"K{k}": 0 for k in range(1, 7)}
    for c in art["configs"]:
        assert c["cuda_eq_host"] and c["device_entropy_eq"] and c["rgb_sha_eq_r05"], c
        assert c.get("eq_libjpeg", True), c
    # The reference's store cross-check has no counterpart: null, not faked.
    xcheck = [c["i"] for c in art["configs"] if "raster_eq_xla_store" in c]
    assert xcheck == [14, 15, 16, 18]
    assert all(art["configs"][i]["raster_eq_xla_store"] is None for i in xcheck)


def test_a_failed_config_is_counted(tmp_path):
    """A file whose bytes differ from its manifest fails its config, which
    is recorded and counted; the other configs still run."""
    manifest = sweep.load_manifest()
    manifest["sweep"] = manifest["sweep"][6:8]
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    for entry in manifest["sweep"]:
        (tmp_path / entry["file"]).write_bytes(_data(entry))
    broken = bytearray((tmp_path / "07.jpg").read_bytes())
    broken[-10] ^= 0xFF
    (tmp_path / "07.jpg").write_bytes(bytes(broken))
    art = sweep.run("cpu", fixture_dir=tmp_path)
    assert (art["n"], art["passed"], art["failed"]) == (2, 1, 1)
    (bad,) = [c for c in art["configs"] if not c["ok"]]
    assert bad["i"] == 7 and "sha256" in bad["error"]


def test_cli_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.main(["--out", str(tmp_path / "s.json")])
    assert not (tmp_path / "s.json").exists()


@pytest.mark.gpu
def test_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep's kernels run on the card")
    art = sweep.run("cuda")
    assert (art["passed"], art["failed"], art["backend"]) == (20, 0, "cuda"), [
        c for c in art["configs"] if not c["ok"]]
    assert art["launches"]["K1"] == 30 and art["launches"]["K5"] == 10
