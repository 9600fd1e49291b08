"""The traffic generator and the plain reference, on the CPU.

    python -m pytest jpegbench/ -q
"""

import io
import json

import numpy as np
import pytest

from jpegbench import cells, drivers, reference, traffic_gen
from jpegbench.traffic_gen import frames, huffman

SEED = 2**31 + 77


# A loader configuration and mix at a size the CPU decodes quickly (one
# geometry with partial MCUs: each new one costs the CPU path seconds).  No
# cell of BENCHMARK.json drives the loader yet: its configuration waits for
# a cited source of its sizes, quality and tables (PERF.md, Open questions).
LOADER_CONFIG = {
    "name": "loader-test", "sizes": [[50, 37, 1.0]],
    "sampling": "4:2:0", "quality": 85, "huffman_tables": "optimal", "header": "jfif",
    "restart_interval": 0, "scan_script": "sequential", "upsample": "fancy", "exact": True,
    "guarantees": ["islow_exact", "batch_order"]}
LOADER_TRAFFIC = {"kind": "loader", "batch": 4, "pool_batches": 2, "compare_per_batch": 4}
LOADER_METRICS = {"end_to_end": [{"name": "loader_img_per_s", "unit": "img/s"},
                                 {"name": "setup_s", "unit": "s"}],
                  "per_layer": [{"name": "device_idle_pct.loader", "unit": "%"},
                                {"name": "k1_roofline", "unit": "%"}]}


def small(name):
    """The cell ``name`` of BENCHMARK.json, ``mjpeg-1080p.rst`` or ``loader``
    (the loader configuration above), at a size the CPU decodes quickly; the
    stream frames keep a partial MCU row and column."""
    if name == "loader":
        c = cells.Cell(name=name, chips=1, config=json.loads(json.dumps(LOADER_CONFIG)),
                       traffic=dict(LOADER_TRAFFIC), **LOADER_METRICS)
    elif name == "mjpeg-1080p.rst":
        # A mix whose cell BENCHMARK.json does not name yet (PERF.md, Open
        # questions): the stream configuration with it, less the metrics of the
        # index scan, which restart markers bypass.
        c = cells.load("mjpeg-1080p.scan")
        c.name = name
        c.traffic = json.loads((cells.HERE / "traffic" / f"{name}.json").read_text())
        c.per_layer = [m for m in c.per_layer
                       if m["name"] not in ("scan_fallback_pct", "k3_roofline")]
    else:
        c = cells.load(name)
    if c.traffic["kind"] == "stream":
        c.config.update(width=56, height=40, distinct_frames=3)
        c.traffic.update(compare_frames=4)
    drivers.validate(c.driver, c.config, c.traffic)
    return c


def pool_of(c, seed):
    return c.driver.make_pool(c.config, c.traffic, seed)


@pytest.mark.parametrize("name", ["mjpeg-1080p.scan", "mjpeg-1080p.rst", "loader"])
def test_pool_is_a_function_of_the_seed(name):
    c = small(name)
    a, b, other = pool_of(c, SEED), pool_of(c, SEED), pool_of(c, SEED + 1)
    assert [f.data for f in a] == [f.data for f in b]
    assert [f.data for f in a] != [f.data for f in other]
    assert len({f.data for f in a}) == len(a)          # every frame of a pool differs


@pytest.mark.parametrize("name,restart,tables,ids", [
    ("mjpeg-1080p.scan", 0, "annex_k", (0, 1, 2)),
    ("mjpeg-1080p.rst", 1, "annex_k", (0, 1, 2)),
    ("loader", 0, "optimal", (1, 2, 3)),
])
def test_bytes_state_sampling_tables_and_restart(name, restart, tables, ids):
    c = small(name)
    pool = pool_of(c, SEED)
    sets = set()
    for f in pool:
        hdr = reference.parse(f.data)
        assert hdr.sampling == ((2, 2), (1, 1), (1, 1))
        assert tuple(cid for cid, *_ in hdr.components) == ids
        assert hdr.restart_interval == restart
        q = frames.quant_tables(85)
        assert np.array_equal(hdr.qtables[0], q[0]) and np.array_equal(hdr.qtables[1], q[1])
        got = tuple(hdr.huffman[k] for k in ((0, 0), (0, 1), (1, 0), (1, 1)))
        if tables == "annex_k":
            for (gc, gs), (wc, ws) in zip(got, huffman.ANNEX_K):
                assert np.array_equal(gc, wc) and np.array_equal(gs, ws)
        sets.add(b"".join(c.tobytes() + s.tobytes() for c, s in got))
        nvmb, nhmb = hdr.mcu_grid()
        assert f.facts.mcus == nvmb * nhmb and f.facts.blocks == 6 * f.facts.mcus
        assert f.facts.segments == (f.facts.mcus if restart else 1)
        assert f.facts.scan_bytes == len(hdr.entropy)
        assert f.facts.pixels == f.height * f.width and f.facts.bytes == len(f.data)
        # The bytes hold exactly the coefficients the reference is given.
        _, coefs = reference.decode_coefficients(f.data)
        assert all(np.array_equal(a, b) for a, b in zip(coefs, f.coefs))
    assert len(sets) == (1 if tables == "annex_k" else len(pool))


def test_loader_sizes_are_the_same_for_every_seed():
    c = small("loader")
    c.config["sizes"] = [[50, 37, 0.5], [37, 50, 0.25], [48, 48, 0.25]]
    assert traffic_gen.size_counts(c.config["sizes"], 8) == [4, 2, 2]
    assert traffic_gen.size_counts([[1, 1, 0.5], [2, 2, 0.2], [3, 3, 0.15], [4, 4, 0.08],
                                    [5, 5, 0.07]], 256) == [128, 51, 38, 21, 18]
    sizes = [sorted((f.width, f.height) for f in pool_of(c, seed)) for seed in (SEED, SEED + 9)]
    assert sizes[0] == sizes[1] and len(sizes[0]) == 8


def test_annex_k_tables_are_libjpegs():
    """Pillow's encoder without optimize writes T.81 Annex K.3's tables."""
    Image = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(buf, "JPEG", quality=85)
    hdr = reference.parse(buf.getvalue())
    for key, (wc, ws) in zip(((0, 0), (0, 1), (1, 0), (1, 1)), huffman.ANNEX_K):
        gc, gs = hdr.huffman[key]
        assert np.array_equal(gc, wc) and np.array_equal(gs, ws)


@pytest.mark.parametrize("height,width,restart,tables", [
    (40, 56, 0, "annex_k"), (37, 50, 0, "optimal"), (33, 50, 1, "annex_k"), (48, 48, 2, "optimal"),
])
def test_reference_is_libjpegs_fancy_decode(height, width, restart, tables):
    Image = pytest.importorskip("PIL.Image")
    f = frames.make_frame(SEED, 5, height, width, "4:2:0", 85, restart, tables, tables == "annex_k")
    want = np.asarray(Image.open(io.BytesIO(f.data)).convert("RGB"))
    got = reference.rgb(f.coefs, f.qtables, f.sampling, height, width, "fancy")
    assert np.array_equal(got, want)
    assert np.array_equal(reference.decode(f.data, "fancy"), want)


@pytest.mark.parametrize("height,width,restart", [(40, 56, 0), (37, 50, 1), (8, 200, 0)])
def test_reference_is_the_programs_cpu_decode(height, width, restart):
    """The test, not the reference, imports the program."""
    import jpeg_gpu_tpu_torch as jt

    f = frames.make_frame(SEED, 6, height, width, "4:2:0", 85, restart, "annex_k", True)
    for ups in ("nearest", "fancy"):
        want = jt.decode(f.data, device="cpu", upsample=ups)
        assert np.array_equal(reference.rgb(f.coefs, f.qtables, f.sampling, height, width, ups),
                              want)


def test_idct_range_limit_wraps_as_libjpeg():
    """A DC far out of range wraps through libjpeg's 10-bit range limit."""
    q = np.ones((8, 8), np.int64)
    blk = np.zeros((1, 8, 8), np.int64)
    for dc, want in ((0, 128), (8 * 100, 228), (8 * 200, 255), (-8 * 200, 0), (8 * 600, 0)):
        blk[0, 0, 0] = dc
        assert int(reference.idct_islow(blk, q)[0, 0, 0]) == want
