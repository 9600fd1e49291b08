"""The cell ``places365-256.b256`` on the CPU: its files, its pool, its
window at a batch of 4 (the path it drives, ``correct``, the control and
the faults ``correct`` has to catch) and the readers of its per-layer
metrics.

    python -m pytest jpegbench/ -q      (the ``gpu`` case runs on a card)
"""

import time

import numpy as np
import pytest
import torch

from jpegbench import cells, drivers, reference, run, traffic_gen
from jpegbench.observed import Observed
from jpegbench.profile import Profile
from jpegbench.test_jpegbench_harness import _altered_sample, _half_batch, _facts
from jpegbench.traffic_gen import huffman

CELL = "places365-256.b256"
SEED = 2**32 + 365
CPU = torch.device("cpu")
NEW_READERS = ("device_idle_pct.loader", "k1_roofline.loader", "loader_d2h_ms")


def test_the_cell_validates_under_the_loader_driver():
    c = cells.load(CELL)
    assert c.traffic == {"kind": "loader", "batch": 256, "pool_batches": 2,
                         "compare_per_batch": 16}
    assert c.driver is drivers.load("loader") and c.chips == 1
    assert c.config["sizes"] == [[256, 256, 1.0]] and c.config["upsample"] == "fancy"
    assert {m["name"] for m in c.end_to_end} == {"loader_img_per_s", "setup_s"}
    assert {m["name"] for m in c.per_layer} == set(NEW_READERS)
    assert all(m["moves"] == "loader_img_per_s" for m in c.per_layer)


@pytest.fixture(scope="module")
def pool():
    c = cells.load(CELL)
    return c.driver.make_pool(c.config, c.traffic, SEED)


def test_the_pool_is_512_jfif_images_of_256x256_without_restart_markers(pool):
    assert len(pool) == 512
    # A 256x256 image is one tile of the committed 384x256 source: 16 x 24
    # cyclic shifts x 4 mirrors, 1,536 images for any seed, so 512 draws
    # hold about 435 distinct ones (PERF.md, Open questions).
    assert len({f.data for f in pool}) > 400
    for f in pool[:: 37]:
        assert f.data[2:4] == b"\xff\xe0" and f.data[6:11] == b"JFIF\x00"
        hdr = reference.parse(f.data)
        assert (hdr.height, hdr.width) == (256, 256)
        assert hdr.sampling == ((2, 2), (1, 1), (1, 1))
        assert [c[0] for c in hdr.components] == [1, 2, 3]
        assert hdr.restart_interval == 0 and b"\xff\xdd" not in f.data[: f.data.index(b"\xff\xda")]
        assert f.facts.segments == 1
        for sel, (counts, symbols) in enumerate(huffman.ANNEX_K):
            got = hdr.huffman[(sel // 2, sel % 2)]
            assert np.array_equal(got[0], counts) and np.array_equal(got[1], symbols)


def test_the_same_seed_gives_the_same_bytes(pool):
    c = cells.load(CELL)
    again = c.driver.make_pool(c.config, c.traffic, SEED)
    assert [f.data for f in again] == [f.data for f in pool]
    cfg = c.config
    args = (256, 256, cfg["sampling"], cfg["quality"], 0, cfg["huffman_tables"], False)
    assert traffic_gen.make_frame(SEED, 0, *args).data == pool[0].data
    assert traffic_gen.make_frame(SEED + 1, 0, *args).data != pool[0].data


def small():
    """The committed cell at a batch of 4: two batches of 256x256 images."""
    c = cells.load(CELL)
    c.traffic.update(batch=4, compare_per_batch=4)
    drivers.validate(c.driver, c.config, c.traffic)
    return c


def _run(**kw):
    return run.run_cell(small(), SEED, 0.05, False, CPU, time.perf_counter(), **kw)


def test_the_window_takes_the_host_entropy_fallback_and_is_correct(monkeypatch):
    """Every image is rejected by the device planner and decoded by the
    host-entropy ``decode_batch``, a batch at a time; the sampled outputs
    equal the reference with fancy upsampling."""
    from jpeg_gpu_tpu_torch.engine import batch

    calls, real = [], batch.decode_batch

    def spy(datas, **kw):
        calls.append((len(datas), kw.get("entropy", "host"), kw.get("upsample")))
        return real(datas, **kw)

    monkeypatch.setattr(batch, "decode_batch", spy)
    r = _run()
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 4
    assert r["checks"]["compared"]["value"] >= 4 and r["checks"]["rgb_max_diff"]["value"] == 0
    assert set(r["metrics"]) == {"loader_img_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert calls and set(calls) == {(4, "host", "fancy")}


def test_the_control_is_not_correct():
    """The program's float path (``exact=False``, K6) in place of the exact
    one reads a difference of 1 or more."""
    r = _run(exact=False)
    assert r["correct"] is False and r["checks"]["rgb_max_diff"]["value"] >= 1


@pytest.mark.parametrize("fault", [_altered_sample, _half_batch])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = _run()
    assert r["correct"] is False and r["checks"]["rgb_max_diff"]["value"] >= 1


class _Run:
    def __init__(self, batches):
        self.batches, self.wall_s = batches, 1.0


def _observed(kind, profile=None, batches=2, launches=2):
    f = _facts(pixels=65536, blocks=1536, quant_bytes=256)
    return Observed(kind, 1.0, [f] * (4 * batches), {}, _Run(batches), profile,
                    launches={"k1": launches})


def _profile():
    spans = [("window", 0.0, 10.0), ("loader.call", 0.0, 10.0)]
    device = [("void (anonymous namespace)::fused_rgb_kernel<2, 2, true>(short const*)", 1.0, 1.5),
              ("fused_rgb_kernel", 6.0, 6.5), ("Memcpy HtoD (Pageable -> Device)", 0.5, 1.0),
              ("Memcpy DtoH (Device -> Pageable)", 2.0, 2.25),
              ("Memcpy DtoH (Device -> Pageable)", 7.0, 7.25),
              ("Memcpy DtoH (Device -> Pageable)", 9.75, 10.5)]     # half in the window
    return Profile(device, spans)


@pytest.mark.parametrize("metric", NEW_READERS)
def test_the_new_readers_read_nothing_outside_the_loader(metric):
    read = cells.Cell(CELL, 1, {}, {}, [], []).reader(metric)
    assert read(_observed("stream", _profile())) is None
    assert read(_observed("loader", None)) is None


def test_the_new_readers_on_a_hand_made_window():
    c = cells.Cell(CELL, 1, {}, {}, [], [])
    o = _observed("loader", _profile())
    # DtoH: 0.25 + 0.25 + 0.25 (clipped) s over 2 batches.
    assert c.reader("loader_d2h_ms")(o) == pytest.approx(0.75 / 2 * 1e3)
    # K1: 8 images of 1536 blocks x 128 B + 256 B + 65536 x 3 B at 3.35 TB/s
    # (over 960 x 1536 operations at 67 Top/s), over the 1 s recorded.
    least = 8 * max((1536 * 128 + 256 + 3 * 65536) / 3.35e12, 960 * 1536 / 67e12)
    assert c.reader("k1_roofline.loader")(o) == pytest.approx(100 * least / 1.0)
    assert c.reader("device_idle_pct.loader")(o) == pytest.approx(100 * (1 - 2.25 / 10))
    assert c.reader("loader_d2h_ms")(_observed("loader", Profile([], _profile().spans))) is None


@pytest.mark.gpu
def test_the_cell_on_the_card_takes_the_described_path(monkeypatch):
    """On a card, at a batch of 4: correct, the control not, and the traced
    window holds one K1 launch a batch, no K2 or K3, and a copy down."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from jpeg_gpu_tpu_torch.ops import pixel_fused

    dev = torch.device("cuda", 0)
    loader, windows = drivers.load("loader"), []
    real = loader.window

    def counted(ctx, seconds, warm=False):
        before = pixel_fused.launches
        got = real(ctx, seconds, warm)
        windows.append((got.batches, pixel_fused.launches - before))
        return got

    monkeypatch.setattr(loader, "window", counted)
    assert run.run_cell(small(), SEED, 0.2, False, dev, time.perf_counter())["correct"] is True
    assert run.run_cell(small(), SEED, 0.2, False, dev, time.perf_counter(),
                        exact=False)["correct"] is False
    windows.clear()
    r = run.run_cell(small(), SEED, 0.5, True, dev, time.perf_counter())
    assert r["correct"] is True and r["device"]["busy_s"] > 0
    assert set(r["metrics"]) == set(NEW_READERS)
    ops = {name for name, _ in r["breakdown"]["device_ops"]}
    assert "fused_rgb_kernel" in ops and "Memcpy DtoH" in ops
    assert not ops & {"decode_kernel", "dc_base_kernel", "index_scan_kernel", "scan_lut_kernel"}
    assert windows and all(batches == k1 for batches, k1 in windows)
