"""The harness on the CPU: each cell's path at a tiny size, the control and
the faults that ``correct`` has to catch, the modules a run loads, the
metric arithmetic and ``BENCHMARK.json``'s references to its files.

    python -m pytest jpegbench/ -q      (the ``gpu`` case runs on a card)
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from jpegbench import cells, drivers, profile, run
from jpegbench.test_jpegbench_traffic import LOADER_CONFIG, LOADER_TRAFFIC, small
from jpegbench.traffic_gen import Facts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ["mjpeg-1080p.scan", "mjpeg-1080p.rst", "loader"]
SEED = 2**31 + 991
CPU = torch.device("cpu")


def _run(name, device=CPU, **kw):
    return run.run_cell(small(name), SEED, 0.05, False, device, time.perf_counter(), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name):
    r = _run(name)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks" and r["checks"]["compared"]["value"] >= 1
    # The CPU has no device trace: the metrics that read one are left out.
    assert set(r["metrics"]) == {m["name"] for m in small(name).end_to_end
                                 if m.get("source") != "device_trace"}
    assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The program's float path in place of the exact one (the control of
    ``check.py``) reads a difference of 1 or more: not correct."""
    r = _run(name, exact=False)
    assert r["correct"] is False and r["checks"]["rgb_max_diff"]["value"] >= 1


def _stale_output(monkeypatch):
    """A step that returns its state unchanged: each frame gets the RGB the
    pixel stage left for the frame before it."""
    from jpeg_gpu_tpu_torch.engine import pipeline

    real, last = pipeline.decode_rgb_soa, []

    def stale(*a, **k):
        out = real(*a, **k)
        last.append(out)
        return last[-2] if len(last) > 1 else out

    monkeypatch.setattr(pipeline, "decode_rgb_soa", stale)


def _altered_sample(monkeypatch):
    """An answer altered where it is produced: one sample of the pixel
    stage's output (K1's, per frame or per bucket of a batch) off by one."""
    from jpeg_gpu_tpu_torch.engine import pipeline

    real = pipeline.decode_rgb_soa

    def nudged(*a, **k):
        out = real(*a, **k).clone()
        out.reshape(-1)[7] ^= 1
        return out

    monkeypatch.setattr(pipeline, "decode_rgb_soa", nudged)


def _half_batch(monkeypatch):
    """Half of the batch left out: the pixel stage's second half of images
    zero."""
    from jpeg_gpu_tpu_torch.engine import batch

    real = batch._pixels

    def half(*a, **k):
        out = real(*a, **k).clone()
        out[out.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(batch, "_pixels", half)


@pytest.mark.parametrize("name,fault", [
    ("mjpeg-1080p.scan", _stale_output), ("mjpeg-1080p.rst", _stale_output),
    ("mjpeg-1080p.scan", _altered_sample), ("mjpeg-1080p.rst", _altered_sample),
    ("loader", _altered_sample), ("loader", _half_batch),
])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(name)
    assert r["correct"] is False and r["checks"]["rgb_max_diff"]["value"] >= 1


def test_flagged_frames_are_not_correct(monkeypatch):
    """A frame whose device entropy decode raised an error flag fails."""
    from jpeg_gpu_tpu_torch.engine import device_entropy

    real = device_entropy.decode_frame

    def flagged(*a, **k):
        res = real(*a, **k)
        res.err = res.err + 1
        return res

    monkeypatch.setattr(device_entropy, "decode_frame", flagged)
    r = _run("mjpeg-1080p.rst")
    assert r["correct"] is False and r["checks"]["flagged"]["value"] >= 1


def test_stream_compares_a_sample_of_the_whole_window():
    """The compared frames are ``compare_frames`` of the window's, drawn
    from the seed over all of it (reservoir sampling), not its first ones."""
    stream = drivers.load("stream")
    picks = []
    for seed in (SEED, SEED, SEED + 1):
        r = stream.Reservoir(8, seed)
        for n in range(4000):
            slot = r.offer(n)
            assert slot is None or 0 <= slot < 8
        picks.append(sorted(r.frame_of_slot))
    assert picks[0] == picks[1] != picks[2]
    assert all(len(set(p)) == 8 for p in picks)
    assert max(max(p) for p in picks) > 2000 and min(max(p) for p in picks) > 8


def test_loader_batches_share_no_image_with_their_neighbours(monkeypatch):
    from jpeg_gpu_tpu_torch.engine import batch as batch_mod

    def fake(datas, **kw):
        return [np.zeros((1, 1, 3), np.uint8) for _ in datas]

    monkeypatch.setattr(batch_mod, "decode_batch_device", fake)
    c = small("loader")
    pool = c.driver.make_pool(c.config, c.traffic, SEED)
    assert len(pool) == 2 * c.traffic["batch"]
    ctx = drivers.Context(c.config, c.traffic, pool, SEED, CPU, True, drivers.Spans())
    got = c.driver.window(ctx, 0.05)
    b = c.traffic["batch"]
    batches = [got.order[i:i + b] for i in range(0, len(got.order), b)]
    assert len(batches) >= 3 and all(len(set(x)) == b for x in batches)
    assert all(not set(x) & set(y) for x, y in zip(batches, batches[1:]))


@pytest.mark.parametrize("where,key,value", [
    ("traffic", "clients", 4),                  # a key no driver reads
    ("traffic", "compare_frames", None),        # a key the driver needs, missing
    ("config", "exact", False),                 # the comparison's limit is for the exact decode
    ("config", "guarantees", ["islow_exact", "durable"]),
    ("config", "entry", "decode"),
    ("config", "upsample", "bilinear"),
    ("traffic", "kind", "open_loop"),           # no drivers/open_loop.py
])
def test_a_file_that_states_what_the_run_does_not_do_is_refused(where, key, value):
    c = cells.load("mjpeg-1080p.scan")
    target = c.config if where == "config" else c.traffic
    if value is None:
        del target[key]
    else:
        target[key] = value
    with pytest.raises(ValueError):
        drivers.validate(drivers.load(c.traffic["kind"]), c.config, c.traffic)


def test_the_loader_refuses_a_pool_of_one_batch():
    with pytest.raises(ValueError):
        drivers.validate(drivers.load("loader"), LOADER_CONFIG, {**LOADER_TRAFFIC, "pool_batches": 1})


def test_the_configurations_exact_option_reaches_the_program(monkeypatch):
    """The run takes ``exact`` from the configuration; ``--control`` (here
    ``exact=False``) overrides it."""
    from jpeg_gpu_tpu_torch.engine import pipeline

    seen = []
    real = pipeline.PipelineSpec.from_header

    def spy(*a, **k):
        seen.append(k.get("exact"))
        return real(*a, **k)

    monkeypatch.setattr(pipeline.PipelineSpec, "from_header", spy)
    _run("mjpeg-1080p.scan")
    _run("mjpeg-1080p.scan", exact=False)
    assert True in seen and seen[-1] is False


_LOADED = """
import json, sys, time
import torch
{imports}
{body}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_level_modules(imports, body=""):
    out = subprocess.run([sys.executable, "-c", _LOADED.format(imports=imports, body=body)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_and_generator_load_nothing_of_the_program_or_jax():
    loaded = _top_level_modules("import jpegbench.reference, jpegbench.traffic_gen, "
                                "jpegbench.check, jpegbench.profile")
    assert not loaded & {"jax", "jaxlib", "flax", "jpeg_gpu_tpu", "jpeg_gpu_tpu_torch"}


@pytest.mark.parametrize("name", ["mjpeg-1080p.rst", "loader"])
def test_a_run_loads_no_jax(name):
    """A whole run in a fresh interpreter, then ``sys.modules`` by whole
    top-level names: the program is there, JAX and the JAX package are not."""
    body = (f"from jpegbench import run\n"
            f"from jpegbench.test_jpegbench_traffic import small\n"
            f"r = run.run_cell(small({name!r}), 5, 0.05, False, torch.device('cpu'), "
            f"time.perf_counter())\n"
            f"assert r['correct'], r\n"
            f"assert run.forbidden_modules() == [], run.forbidden_modules()")
    loaded = _top_level_modules("", body)
    assert "jpeg_gpu_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jpeg_gpu_tpu_torch_like", sys)
    assert "jpeg_gpu_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jpeg_gpu_tpu.engine", sys)
    assert "jpeg_gpu_tpu" in run.forbidden_modules()


def test_the_command_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "jpegbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _facts(**kw):
    base = dict(bytes=0, scan_bytes=0, pixels=0, mcus=0, blocks=0, symbols=0, segments=1,
                quant_bytes=256)
    return Facts(**{**base, **kw})


def test_profile_busy_gaps_and_roofline(capsys):
    spans = [("window", 0.0, 10.0), ("consumer.decode_frame", 1.0, 4.0),
             ("producer.plan", 0.0, 6.0), ("consumer.queue_wait", 4.0, 10.0)]
    device = [("void (anonymous namespace)::decode_kernel<1>(int const*)", 2.0, 3.0),
              ("decode_kernel(int)", 2.5, 3.5), ("Memcpy HtoD (Pinned -> Device)", 8.0, 9.0),
              ("fused_rgb_kernel", 11.0, 12.0)]
    p = profile.Profile(device, spans)
    assert profile.busy(p) == (2.5, 10.0)
    gaps = dict(profile.idle_gaps(p))
    # Gaps [0, 2], [3.5, 8] and [9, 10], labelled at their middles.
    assert gaps == pytest.approx({"consumer.decode_frame|producer.plan": 2.0,
                                  "consumer.queue_wait|producer.plan": 4.5,
                                  "consumer.queue_wait": 1.0})
    assert dict(profile.device_ops(p)) == {"decode_kernel": 2.0, "Memcpy HtoD": 1.0}
    assert profile.kernel_records(p, "k2") == (2.0, 2)
    f = _facts(scan_bytes=3_350_000, blocks=0, symbols=1)
    # 3.35 MB at 3.35 TB/s is 1 us of the 2 s recorded, over two launches.
    assert profile.roofline_pct(p, "k2", [f, f], 2) == pytest.approx(100 * 2e-6 / 2.0)
    # Records missing: the time is scaled by launched / recorded, and said.
    assert profile.roofline_pct(p, "k2", [f, f], 4) == pytest.approx(100 * 2e-6 / 4.0)
    assert "kept 2 of 4" in capsys.readouterr().err
    assert profile.roofline_pct(p, "k3", [f], 1) is None       # nothing recorded
    assert profile.ISLOW_OPS_PER_BLOCK == 960


def test_device_ms_per_frame_is_busy_time_per_completed_frame():
    from jpegbench.observed import Observed

    read = cells.load("mjpeg-1080p.scan").reader("device_ms_per_frame")
    p = profile.Profile([("decode_kernel", 2.0, 3.0), ("Memcpy HtoD", 2.5, 3.5),
                         ("fused_rgb_kernel", 11.0, 12.0)], [("window", 0.0, 10.0)])
    f = _facts(pixels=1)
    # 1.5 s busy inside the window (the kernel after it left out), 4 frames.
    assert read(Observed("stream", 1.0, [f] * 4, {}, None, profile=p)) == pytest.approx(375.0)
    assert read(Observed("stream", 1.0, [f] * 4, {}, None, profile=None)) is None
    assert read(Observed("stream", 1.0, [], {}, None, profile=p)) is None


def test_untraced_spans_keep_only_an_annotated_window():
    """An untraced run records no span, but keeps the window where it is
    profiled (an end-to-end metric that reads the card's trace needs it)."""
    for annotate, kept in ((False, []), (True, ["window"])):
        spans = drivers.Spans(enabled=False, annotate=annotate)
        for name in ("window", "consumer.decode_frame"):
            with spans(name):
                pass
        assert [n for n, _, _ in spans.intervals] == kept


def test_benchmark_json_names_files_that_exist():
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    assert bench["paths"] == ["jpegbench"]
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for c in bench["configs"]:
        cfg = json.loads(open(os.path.join(ROOT, c["file"])).read())
        assert cfg["name"] == c["name"] and set(c["reduced"]) <= set(cfg)
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names) and all(name.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "jpegbench", "metrics", m["name"] + ".py"))
    for w in bench["workloads"]:
        assert name.match(w["name"]) and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "jpegbench", "traffic", w["traffic"] + ".json"))
        assert w["chips"] == 1
        c = cells.load(w["name"], bench)
        assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
        assert c.per_layer


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cells_and_control_on_the_card(name):
    """Each cell at a tiny size on the card: the exact path correct with
    every end-to-end metric there, the control not; and the traced run's
    per-layer metrics all there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    r = _run(name, dev)
    assert r["correct"] is True
    assert set(r["metrics"]) == {m["name"] for m in small(name).end_to_end}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert _run(name, dev, exact=False)["correct"] is False
    r = run.run_cell(small(name), SEED, 0.5, True, dev, time.perf_counter())
    assert r["correct"] is True and r["device"]["busy_s"] > 0
    assert set(r["metrics"]) == {m["name"] for m in small(name).per_layer}
