"""The port's CLI: the reference's app-layer switches plus ``--device``.

The port of ``tests/test_cli.py``.  The torch backend's default device is
the card, so every run of it here passes ``--device cpu``.
"""

import json
import sys

import numpy as np
import pytest

from jpeg_gpu_tpu_torch import decode
from jpeg_gpu_tpu_torch.cli import main
from jpeg_gpu_tpu_torch.testing import corpus


@pytest.fixture()
def jpg(tmp_path):
    img = corpus.synthetic_rgb(32, 48, seed=1)
    p = tmp_path / "t.jpg"
    p.write_bytes(corpus.pil_jpeg(img, quality=85, subsampling="4:2:0"))
    return str(p)


def test_cli_no_gpu_alias(jpg, capsys):
    assert main(["--no-gpu", jpg]) == 0
    assert "(host," in capsys.readouterr().out


def test_cli_no_cpu_alias(jpg, capsys):
    assert main(["--no-cpu", "--device", "cpu", jpg]) == 0
    assert "(torch," in capsys.readouterr().out


def test_cli_no_gpu_no_cpu_conflict(jpg):
    assert main(["--no-gpu", "--no-cpu", jpg]) == 2


def test_cli_header(jpg, capsys):
    assert main(["-H", "--device", "cpu", jpg]) == 0
    out = capsys.readouterr().out
    assert "48" in out and "32" in out


def test_cli_dump_quant(jpg, capsys):
    """-d -o quant prints every plane's coefficients, the reference's
    differential dump format."""
    assert main(["-d", "-o", "quant", "--device", "cpu", jpg]) == 0
    lines = capsys.readouterr().out.splitlines()
    want = decode(open(jpg, "rb").read(), out="quant", device="cpu").coefs
    at = 0
    for ci, c in enumerate(want):
        vb, hb = c.shape[:2]
        assert lines[at] == f"plane {ci}: {hb}x{vb} blocks"
        rows = [[int(v) for v in line.split()] for line in lines[at + 1: at + 1 + vb * 8]]
        np.testing.assert_array_equal(np.array(rows), c.transpose(0, 2, 1, 3).reshape(vb * 8, -1))
        at += 1 + vb * 8
    assert at == len(lines)


@pytest.mark.parametrize("extra", [[], ["--no-cpu"]])
def test_cli_bench(jpg, capsys, extra):
    assert main(["-b", "2", "--device", "cpu", *extra, jpg]) == 0
    out = capsys.readouterr().out
    assert "FPS" in out and "impl=torch" in out and "upload=" in out
    assert ("entropy=device" in out) == bool(extra)


def test_cli_impl_libjpeg(jpg, capsys):
    from jpeg_gpu_tpu_torch.host import oracle_native

    if not oracle_native.available():
        pytest.skip("system libjpeg shim unavailable")
    assert main(["--impl", "libjpeg", "-o", "yuv", jpg]) == 0
    assert "decoded stage yuv (libjpeg)" in capsys.readouterr().out
    assert main(["--impl", "libjpeg", jpg]) == 0
    assert "(libjpeg," in capsys.readouterr().out


def test_cli_save_png(jpg, tmp_path, capsys):
    from PIL import Image

    out = tmp_path / "o.png"
    assert main(["--device", "cpu", "--save", str(out), jpg]) == 0
    np.testing.assert_array_equal(np.asarray(Image.open(out)),
                                  decode(open(jpg, "rb").read(), device="cpu"))


def test_cli_save_without_pillow(jpg, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "PIL", None)   # import PIL raises ImportError
    assert main(["--device", "cpu", "--save", str(tmp_path / "o.png"), jpg]) == 1
    assert "Pillow" in capsys.readouterr().err


def _program_spans(path, ph="X"):
    doc = json.loads(path.read_text())
    return [e for e in doc["traceEvents"] if e.get("cat") == "program" and e["ph"] == ph]


def test_cli_profile(jpg, tmp_path, capsys):
    """The trace holds the program's spans of the profiled decode (host
    entropy: the parse and K1's call), as complete events beside the
    profiler's operations."""
    assert main(["--device", "cpu", "--profile", str(tmp_path / "prof"), jpg]) == 0
    path = tmp_path / "prof" / "trace.json"
    assert path.stat().st_size > 0
    spans = _program_spans(path)
    assert sorted(e["name"] for e in spans) == ["host.parse", "pipeline.decode_rgb_soa"]
    ops = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") != "program"]
    # On the profiler's clock: the spans lie among the profiled operations.
    assert min(e["ts"] for e in ops) - 1e5 < min(e["ts"] for e in spans)
    assert max(e["ts"] for e in spans) < max(e["ts"] + e["dur"] for e in ops) + 1e5
    assert all(e["ph"] == "X" and e["dur"] >= 0 and "frame" in e["args"] for e in spans)


def test_cli_profile_device_entropy(jpg, tmp_path, capsys):
    """With the Huffman decode on the device every span of the engine's
    halves is in the trace, all of one frame, and the counters of the native
    byte walks."""
    assert main(["--device", "cpu", "-e", "device", "--profile", str(tmp_path / "p"),
                 jpg]) == 0
    spans = _program_spans(tmp_path / "p" / "trace.json")
    assert {e["name"] for e in spans} == {
        "host.parse", "engine.plan_frame", "host.destuff", "host.scan_windows",
        "engine.upload_frame", "engine.decode_frame", "engine.scan", "engine.scan_verdict",
        "engine.k2", "engine.assemble", "pipeline.decode_rgb_soa"}
    assert len({e["args"]["frame"] for e in spans}) == 1
    counters = {e["name"]: e["args"][e["name"]]
                for e in _program_spans(tmp_path / "p" / "trace.json", "C")}
    assert counters["engine.scan_frames"] == 1 and counters["engine.scan_rounds"] >= 1
    assert counters["host.native_markers"] == counters["host.native_windows"] == 1


def test_cli_device_errors(jpg, capsys):
    """Without a card the default device fails cleanly, as does a bad name."""
    import torch

    if not torch.cuda.is_available():
        assert main([jpg]) == 1
        assert "no CUDA device" in capsys.readouterr().err
    assert main(["--device", "nonsense", jpg]) == 1
    assert main([jpg + ".missing"]) == 1


def test_cli_corrupt_input(tmp_path, capsys):
    p = tmp_path / "bad.jpg"
    p.write_bytes(b"\xff\xd8\xff\xdb garbage")
    assert main(["--device", "cpu", str(p)]) == 1
    assert capsys.readouterr().err.startswith("error:")
