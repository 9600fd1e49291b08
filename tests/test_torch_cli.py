"""The port's CLI: the reference's app-layer switches plus ``--device``.

The port of ``tests/test_cli.py``.  The torch backend's default device is
the card, so every run of it here passes ``--device cpu``.
"""

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


def test_cli_profile(jpg, tmp_path, capsys):
    assert main(["--device", "cpu", "--profile", str(tmp_path / "prof"), jpg]) == 0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


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
