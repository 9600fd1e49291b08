"""The port's bench (``jpeg_gpu_tpu_torch/bench.py``) on the CPU, small.

Each row function runs at 64x96 (batch 2, three frames a serving loop) and
its output gate holds; every frame of both serving loops (with a restart
marker every MCU, and without restart markers through the device index
scan) equals the JAX package's host decode of the same bytes, byte for
byte; the JSON line carries every detail key of ``bench.py`` and of
``scripts/bench_corpus_resident.py``; a corrupt frame among a loop's
frames raises a JpegError after the producer stopped and reports no
number; the engine's device half after its host half, as the serving loop
calls them (shapes pinned from a first frame, flags left on the device),
equals ``entropy_decode_device`` on sweep frames; and without a card
``device=None`` raises.
"""

import json
import threading

import numpy as np
import pytest
import torch

import jpeg_gpu_tpu as jr
from jpeg_gpu_tpu_torch import bench
from jpeg_gpu_tpu_torch.engine import device_entropy as de
from jpeg_gpu_tpu_torch.errors import JpegError
from jpeg_gpu_tpu_torch.host.parser import parse
from jpeg_gpu_tpu_torch.testing import sweep

H, W = 64, 96

# bench.py's detail keys (bench.py:629-657 and :571-610) and
# scripts/bench_corpus_resident.py's, less vs_baseline (dropped with the
# TPU's per-chip share), plus what the port records beside them.
DETAIL_KEYS = {
    "batch", "device_ms_per_batch", "fancy_parity_mpix_per_s",
    "full_on_device_decode_mpix_per_s", "full_4k422_device_decode_mpix_per_s",
    "e2e_bytes_to_pixels_mpix_per_s", "e2e_no_dri_mpix_per_s", "e2e_host_ms_per_frame",
    "e2e_host_upload_ms_per_frame", "e2e_no_dri_host_ms_per_frame",
    "e2e_no_dri_host_upload_ms_per_frame", "e2e_no_dri_impl", "upload_bytes_coefs_frame",
    "upload_bytes_bits_frame", "host_entropy_mpix_per_s", "host_entropy_impl", "backend",
    "corpus_device_resident_mpix_per_s", "corpus_e2e_1core_host_bound_mpix_per_s",
    "full_512gray_device_decode_mpix_per_s", "full_8k420_device_decode_mpix_per_s",
    "full_8k420_fancy_device_decode_mpix_per_s",
    "host_entropy_threads", "card", "toolchain", "bandwidth", "device_rows", "host_rows",
    "launches",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of tiny ops; one intra-op thread
    keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frame(mode="4:2:0", seed=1, restart=0, ups=("nearest",), h=H, w=W):
    return bench.Frame.of(bench.encode(h, w, mode, seed, restart), ups)


@pytest.fixture(scope="module")
def inputs():
    return bench.Inputs(
        pixels=_frame(seed=0, ups=("nearest", "fancy")), r1=_frame(restart=1), r0=_frame(),
        k4_422=_frame("4:2:2", restart=1), gray=_frame("gray", restart=1),
        k8=_frame(seed=2, restart=1, ups=("nearest", "fancy")),
        corpus=[_frame(seed=100 + k, restart=1, h=32, w=32) for k in range(3)])


def _spoil(data: bytes, at: int) -> bytes:
    """Three stuffed 0xFF bytes ``at`` bytes into the scan: invalid codes
    the device index scan synchronizes past and K2 flags."""
    s, _ = parse(data).segments[0]
    out = bytearray(data)
    out[s + at: s + at + 6] = b"\xff\x00" * 3
    return bytes(out)


def _corrupt(data: bytes, si: int) -> bytes:
    """All-ones bits over restart segment ``si``: invalid codes."""
    s, e = parse(data).segments[si]
    out = bytearray(data)
    out[s:e] = (b"\xff\x00" * ((e - s) // 2 + 1))[: e - s]
    return bytes(out)


@pytest.mark.parametrize("row", ["pixels nearest", "pixels fancy", "full r1", "full gray",
                                 "full k8 fancy", "host entropy", "corpus resident",
                                 "corpus download"])
def test_row_runs_and_its_gate_holds(inputs, row):
    """Each row at 64x96 on the CPU: it runs, holds its output to the CPU
    port's decode, and reports a rate."""
    if row.startswith("pixels"):
        out = bench.pixel_row(inputs.pixels, 2, row.split()[1], "cpu", iters=1)
    elif row.startswith("full"):
        frame = getattr(inputs, row.split()[1])
        out = bench.full_row(frame, 2, "fancy" if row.endswith("fancy") else "nearest", "cpu",
                             iters=1)
        assert out["launches"] == [0] * 6   # the plain versions count no launch
    elif row == "host entropy":
        out = bench.host_entropy_row(inputs.pixels, reps=2)
        assert len(out["runs_mpix_per_s"]) == 2 and out["impl"] == "native"
        assert out["upload_bytes_coefs_frame"] == H * W * 3 // 2 * 2   # int16 4:2:0 planes
    elif row == "corpus resident":
        out = bench.corpus_resident_row(inputs.corpus, "cpu", calls=2, reps=2)
        assert len(out["runs_mpix_per_s"]) == 2
    else:
        out = bench.corpus_download_row(inputs.corpus, "cpu", reps=2)
    assert out["mpix_per_s"] > 0


def test_a_gate_that_fails_raises(inputs):
    """A row whose output differs from the CPU port's decode raises and
    reports no number."""
    wrong = bench.Frame(inputs.r1.data, {"nearest": "0" * 64})
    with pytest.raises(bench.RowFailed):
        bench.full_row(wrong, 2, "nearest", "cpu", iters=1)


@pytest.mark.parametrize("restart", [1, 0])
def test_serving_loop_frames_equal_the_jax_host_decode(inputs, restart):
    """Every frame out of the serving loop equals jpeg_gpu_tpu.decode(data,
    impl="host") byte for byte; the stream without restart markers went
    through the device index scan on every frame."""
    frame = inputs.r1 if restart else inputs.r0
    out = bench.serve([frame], 3, "cpu", loop_reps=1, host_reps=2)
    assert out["impl"] == ("rows" if restart else "device_specsync")
    assert len(out["frames"]) == 3 and len(out["host_runs_ms"]) == 2
    ref = jr.decode(frame.data, impl="host")
    for rgb in out["frames"]:
        np.testing.assert_array_equal(rgb.numpy(), ref)
    assert out["upload_bytes_frame"] > 0 and out["device_ms_per_frame"] is None


@pytest.mark.parametrize("restart", [1, 0])
def test_corrupt_frame_raises_after_the_drain(inputs, restart):
    """A corrupt frame among the loop's frames raises a JpegError once the
    producer has stopped, and the loop reports no number."""
    good = inputs.r1 if restart else inputs.r0
    bad = bench.Frame(_corrupt(good.data, 3) if restart else _spoil(good.data, 50), good.cpu)
    with pytest.raises(JpegError, match="frame 1 flagged"):
        bench.serve([good, bad, good], 3, "cpu", loop_reps=1, host_reps=1)
    assert not [t for t in threading.enumerate() if t.name == "bench-producer"]


def test_json_line_carries_every_detail_key(inputs):
    line = bench.run("cpu", inputs, batches={k: 2 for k in bench.BATCHES}, iters=1,
                     e2e_frames=(3, 3), loop_reps=1, host_reps=1, corpus_calls=2,
                     corpus_reps=1)
    text = json.dumps(line)
    assert "\n" not in text
    assert line["metric"] == "device_decode_1080p_420_mpix_per_s" and line["unit"] == "Mpix/s"
    detail = line["detail"]
    assert DETAIL_KEYS <= set(detail), DETAIL_KEYS - set(detail)
    assert line["value"] > 0 and detail["e2e_no_dri_impl"] == "device_specsync"
    assert detail["backend"] == "cpu" and detail["bandwidth"] is None
    for key in ("e2e_bytes_to_pixels_mpix_per_s", "corpus_device_resident_mpix_per_s"):
        assert detail["host_rows"][key]["runs_mpix_per_s"], key


def _sweep_frame(index):
    entry = sweep.load_manifest()["sweep"][index]
    return sweep.read_fixture(sweep.FIXTURES, entry)


# 13: 4:2:0 with a restart marker every MCU; 8: 4:1:1 every two MCUs;
# 2: 4:4:4 and 5: gray without restart markers (the device index scan).
@pytest.mark.parametrize("index", [13, 8, 2, 5])
def test_device_half_after_host_half_equals_entropy_decode_device(index):
    data = _sweep_frame(index)
    first = de.plan_frame(parse(data))
    pins = ({"nw": first.scan.nw, "subseq_bytes": first.scan.subseq_bytes}
            if first.scan is not None else {"nw": first.rows.nw})
    assert (first.scan is None) == bool(parse(data).header.restart_interval)
    plan = de.plan_frame(parse(data), **pins)
    got = de.decode_frame(de.upload_frame(plan, "cpu"), check_errors=False)
    ref = de.entropy_decode_device(parse(data), device="cpu")
    assert got.n_segments == ref.n_segments
    assert (got.specsync_stats is None) == (ref.specsync_stats is None)
    for a, b in zip(got.coefs, ref.coefs):
        assert torch.equal(a, b)
    assert torch.equal(got.err, ref.err) and not got.err.reshape(-1)[: got.n_segments].any()


@pytest.mark.parametrize("entry", ["run", "serve", "pixel_row", "full_row",
                                   "corpus_resident_row", "corpus_download_row", "bandwidth",
                                   "main"])
def test_no_card_raises(monkeypatch, inputs, entry):
    """device=None means the card: without one every entry point raises
    before it decodes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "run": lambda: bench.run(None, inputs),
        "serve": lambda: bench.serve([inputs.r1], 3, None),
        "pixel_row": lambda: bench.pixel_row(inputs.pixels, 2, "nearest", None, 1),
        "full_row": lambda: bench.full_row(inputs.r1, 2, "nearest", None, 1),
        "corpus_resident_row": lambda: bench.corpus_resident_row(inputs.corpus, None, 1, 1),
        "corpus_download_row": lambda: bench.corpus_download_row(inputs.corpus, None, 1),
        "bandwidth": lambda: bench.bandwidth(None),
        "main": lambda: bench.main([]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
