"""The port's copies of the framework-free host modules vs the originals.

The port cannot import ``jpeg_gpu_tpu.host`` (importing that package loads
jax), so it carries copies.  They must parse and entropy-decode to the same
headers and coefficients, build the same device plans and index-scan
inputs, and the copied encoder must write the same bytes
wherever the original terminates.  The copies of the native build script,
the libjpeg oracle (shim, ctypes layer) and the test oracles are the
originals' code with the package's name in the imports.  The copy also fixes the original
encoder's Huffman length-limit loop (Figure K.3 starts the search at
i - 2), which never returns on images whose optimal code exceeds 16 bits.
"""

import pathlib

import numpy as np
import pytest

from jpeg_gpu_tpu.host import entropy as r_entropy
from jpeg_gpu_tpu.host import entropy_native as r_native
from jpeg_gpu_tpu.host import oracle_native as r_oracle
from jpeg_gpu_tpu.host import pack_plan as r_pack_plan
from jpeg_gpu_tpu.host import segments as r_segments
from jpeg_gpu_tpu.host import specsync as r_specsync
from jpeg_gpu_tpu.host.parser import parse as r_parse
from jpeg_gpu_tpu.testing import corpus as r_corpus
from jpeg_gpu_tpu.testing import oracle as r_test_oracle
from jpeg_gpu_tpu_torch.host import entropy as t_entropy
from jpeg_gpu_tpu_torch.host import entropy_native as t_native
from jpeg_gpu_tpu_torch.host import oracle_native as t_oracle
from jpeg_gpu_tpu_torch.host import pack_plan as t_pack_plan
from jpeg_gpu_tpu_torch.host import segments as t_segments
from jpeg_gpu_tpu_torch.host import specsync as t_specsync
from jpeg_gpu_tpu_torch.host.parser import parse as t_parse
from jpeg_gpu_tpu_torch.testing import corpus as t_corpus
from jpeg_gpu_tpu_torch.testing import encoder as t_encoder
from jpeg_gpu_tpu_torch.testing import oracle as t_test_oracle

REPO = pathlib.Path(__file__).resolve().parent.parent

MODES = ["4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1"]


def _image(mode, h, w, seed):
    img = t_corpus.synthetic_rgb(h, w, seed=seed)
    return img[..., 1].copy() if mode == "mono" else img


@pytest.mark.parametrize("mode", MODES + ["mono"])
@pytest.mark.parametrize("restart", [0, 3])
def test_encoder_bytes_identical(mode, restart):
    img = _image(mode, 33, 41, seed=4)
    sub = "4:2:0" if mode == "mono" else mode
    a = t_corpus.own_jpeg(img, subsampling=sub, quality=75, restart_interval=restart)
    b = r_corpus.own_jpeg(img, subsampling=sub, quality=75, restart_interval=restart)
    assert a.data == b.data
    for x, y in zip(a.coefs, b.coefs):
        np.testing.assert_array_equal(x, y)


def test_encoder_bytes_identical_16bit_qt_and_larger():
    img = t_corpus.synthetic_rgb(130, 250, seed=3)
    a = t_corpus.own_jpeg(img, subsampling="4:2:2", force_16bit_qt=True)
    b = r_corpus.own_jpeg(img, subsampling="4:2:2", force_16bit_qt=True)
    assert a.data == b.data


@pytest.mark.parametrize("mode", MODES + ["mono"])
def test_parser_headers_equal(mode):
    img = _image(mode, 40, 50, seed=5)
    sub = "4:2:0" if mode == "mono" else mode
    data = t_corpus.own_jpeg(img, subsampling=sub, restart_interval=2).data
    a, b = t_parse(data), r_parse(data)
    assert a.header.describe() == b.header.describe()
    np.testing.assert_array_equal(a.segments, b.segments)
    for ta, tb in zip(a.header.dc_tables + a.header.ac_tables,
                      b.header.dc_tables + b.header.ac_tables):
        assert (ta is None) == (tb is None)
        if ta is not None:
            np.testing.assert_array_equal(ta.counts, tb.counts)
            np.testing.assert_array_equal(ta.symbols, tb.symbols)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("restart", [0, 2])
def test_entropy_decoders_equal(mode, restart):
    img = _image(mode, 37, 45, seed=6)
    enc = t_corpus.own_jpeg(img, subsampling=mode, restart_interval=restart)
    tp, rp = t_parse(enc.data), r_parse(enc.data)
    t_py = t_entropy.decode_scan(tp, validate=True).coefs
    r_py = r_entropy.decode_scan(rp, validate=True).coefs
    t_nat = t_native.decode_scan(tp).coefs
    r_nat = r_native.decode_scan(rp).coefs
    for truth, a, b, c, d in zip(enc.coefs, t_py, r_py, t_nat, r_nat):
        for got in (a, b, c, d):
            np.testing.assert_array_equal(got, truth)
    t_soa = t_native.decode_scan(tp, soa=True).coefs
    r_soa = r_native.decode_scan(rp, soa=True).coefs
    for a, b in zip(t_soa, r_soa):
        assert a.dtype == np.int16
        np.testing.assert_array_equal(a, b)


def test_pack_streams_equal():
    enc = t_corpus.own_jpeg(_image("4:2:0", 24, 40, 7), restart_interval=1)
    a = t_native.decode_scan(t_parse(enc.data), want_pack=True)
    b = r_entropy.decode_scan(r_parse(enc.data), want_pack=True)
    np.testing.assert_array_equal(a.pack, b.pack)


@pytest.mark.parametrize("mode", ["mono", "4:2:0", "4:4:4", "4:1:1"])
@pytest.mark.parametrize("k", [0, 3])
def test_build_pack_plan_equal(mode, k):
    """The copied pack planner lays out the same lanes as the original, from
    the default split and from a forced number of MCUs per lane."""
    img = _image(mode, 40, 56, seed=12)
    sub = "4:2:0" if mode == "mono" else mode
    data = t_corpus.own_jpeg(img, subsampling=sub, restart_interval=2).data
    tp, rp = t_parse(data), r_parse(data)
    a = t_pack_plan.build_pack_plan(tp, t_native.decode_scan(tp, want_pack=True), k)
    b = r_pack_plan.build_pack_plan(rp, r_entropy.decode_scan(rp, want_pack=True), k)
    np.testing.assert_array_equal(a.streams, b.streams)
    assert a.streams.dtype == np.int32 and a.streams.shape[2:] == (8, 128)
    assert (a.n_segments, a.mcus_per_segment, a.blocks_per_segment, a.packed_entries) == (
        b.n_segments, b.mcus_per_segment, b.blocks_per_segment, b.packed_entries)


def test_length_limit_case_that_hangs_the_reference():
    """synthetic_rgb(512, 512, seed=1) at 4:2:0 needs codes past 16 bits;
    the copied encoder limits them and the stream decodes exactly."""
    enc = t_corpus.own_jpeg(t_corpus.synthetic_rgb(512, 512, seed=1), "4:2:0")
    parsed = t_parse(enc.data)
    for spec in parsed.header.dc_tables + parsed.header.ac_tables:
        if spec is not None:
            assert int(spec.counts.sum()) == len(spec.symbols)
    for truth, got in zip(enc.coefs, t_native.decode_scan(parsed).coefs):
        np.testing.assert_array_equal(got, truth)


def test_length_limit_keeps_kraft_and_16_bits():
    """Fibonacci frequencies give one code per length up to ~25 bits (the
    original loop's hang: bits[i - 1] > 0 at every step); the result is a
    valid prefix code of at most 16 bits covering every used symbol."""
    fib = [1, 1]
    while len(fib) < 25:
        fib.append(fib[-1] + fib[-2])
    freq = np.zeros(256, dtype=np.int64)
    freq[:25] = fib
    counts, symbols = t_encoder.gen_huffman_table(freq)
    assert counts.shape == (16,) and len(symbols) == 25
    # The reserved all-ones code is dropped, so the sum stays below 1.
    kraft = sum(int(c) * 2.0 ** -(i + 1) for i, c in enumerate(counts))
    assert kraft < 1.0


def _plan_arrays(plan):
    return [plan.streams, *plan.kernel_tables] + (
        [] if plan.dc_base is None else [plan.dc_base])


@pytest.mark.parametrize("mode", ["mono", "4:2:0", "4:1:1"])
@pytest.mark.parametrize("restart", [1, 3])
def test_build_plan_equal(mode, restart):
    img = _image(mode, 37, 45, seed=8)
    sub = "4:2:0" if mode == "mono" else mode
    data = t_corpus.own_jpeg(img, subsampling=sub, restart_interval=restart).data
    a, b = t_segments.build_plan(t_parse(data)), r_segments.build_plan(r_parse(data))
    assert (a.n_segments, a.nw, a.mcus_per_segment, a.n_mcus) == (
        b.n_segments, b.nw, b.mcus_per_segment, b.n_mcus)
    for x, y in zip(_plan_arrays(a), _plan_arrays(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", ["4:2:0", "4:4:4"])
def test_build_plan_no_dri_and_auto_equal(mode):
    data = t_corpus.own_jpeg(_image(mode, 40, 56, seed=9), subsampling=mode).data
    for build in ("build_plan_no_dri", "build_plan_auto"):
        a = getattr(t_segments, build)(t_parse(data))
        b = getattr(r_segments, build)(r_parse(data))
        assert (a.n_segments, a.nw) == (b.n_segments, b.nw)
        for x, y in zip(_plan_arrays(a), _plan_arrays(b)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("subseq_bytes", [None, 32])
@pytest.mark.parametrize("mode", ["mono", "4:2:2"])
def test_build_spec_scan_input_equal(mode, subseq_bytes):
    sub = "4:2:0" if mode == "mono" else mode
    data = t_corpus.own_jpeg(_image(mode, 48, 72, seed=10), subsampling=sub).data
    a = t_segments.build_spec_scan_input(t_parse(data), subseq_bytes=subseq_bytes)
    b = r_segments.build_spec_scan_input(r_parse(data), subseq_bytes=subseq_bytes)
    for field in a.__dataclass_fields__:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, field


@pytest.mark.parametrize("mode", ["4:2:0", "4:4:4"])
def test_spec_index_scan_equal(mode):
    """The numpy oracle of the index scan: the same result as the
    original's, and the serial native scan's offsets and DC bases."""
    data = t_corpus.own_jpeg(_image(mode, 32, 48, seed=11), subsampling=mode).data
    a = t_specsync.spec_index_scan(t_parse(data), subseq_bytes=64)
    b = r_specsync.spec_index_scan(r_parse(data), subseq_bytes=64)
    assert a is not None and b is not None
    for field in ("bitpos", "dc_base", "end_bit", "rounds", "n_subseq"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    bitpos, dc_base, end_bit = t_native.index_scan(t_parse(data), 1)
    np.testing.assert_array_equal(a.bitpos, bitpos)
    np.testing.assert_array_equal(a.dc_base, dc_base)
    assert a.end_bit == end_bit
    np.testing.assert_array_equal(t_specsync.destuff(t_parse(data)),
                                  r_specsync.destuff(r_parse(data)))


def _code(path: pathlib.Path) -> str:
    """A source file without its leading comment or docstring, which may
    say where the original's notes live."""
    text = path.read_text()
    if text.startswith('"""'):
        return text.split('"""', 2)[2]
    return text[text.index("#include"):]


@pytest.mark.parametrize("rel", [
    "host/native/build.py",
    "host/native/jpeg_oracle.cpp",
    "host/oracle_native.py",
    "testing/oracle.py",
])
def test_copied_code_equals_original(rel):
    """The code of these copies is the original's with the imports renamed,
    but for the oracle's loader, which also treats a shim that does not load
    as unavailable (test_oracle_shim_that_does_not_load_is_unavailable)."""
    orig = _code(REPO / "jpeg_gpu_tpu" / rel)
    copy = _code(REPO / "jpeg_gpu_tpu_torch" / rel)
    if rel == "host/oracle_native.py":
        orig, copy = (_without(x, "def _load", "def available") for x in (orig, copy))
    assert copy == orig.replace("jpeg_gpu_tpu.", "jpeg_gpu_tpu_torch.")


def _without(text: str, start: str, stop: str) -> str:
    return text[: text.index(start)] + text[text.index(stop):]


def test_oracle_shim_that_does_not_load_is_unavailable(monkeypatch):
    """A shim that builds but whose libjpeg the loader cannot find (the
    headers and a link-time library outside the loader's path) makes the
    oracle unavailable instead of raising OSError; the original raises."""
    import ctypes

    def cannot_load(*args, **kwargs):
        raise OSError("libjpeg.so.62: cannot open shared object file")

    monkeypatch.setattr(t_oracle, "_lib", None)
    monkeypatch.setattr(t_oracle, "_lib_failed", False)
    monkeypatch.setattr(t_oracle.build, "oracle_object_path", lambda: pathlib.Path("shim.so"))
    monkeypatch.setattr(ctypes, "CDLL", cannot_load)
    assert not t_oracle.available()
    assert t_oracle.libjpeg_probe(b"") == "oracle unavailable"


@pytest.mark.parametrize("mode", ["mono", "4:2:0", "4:4:4"])
def test_oracle_shims_equal(mode):
    """Both packages' libjpeg shims give the same coefficients, tables,
    planes and pixels."""
    if not (t_oracle.available() and r_oracle.available()):
        pytest.skip("system libjpeg shim unavailable")
    img = _image(mode, 37, 45, seed=13)
    data = r_corpus.pil_jpeg(img, quality=85) if mode == "mono" else r_corpus.pil_jpeg(
        img, quality=85, subsampling=mode)
    (tc, tq), (rc, rq) = t_oracle.libjpeg_coefficients(data), r_oracle.libjpeg_coefficients(data)
    for a, b in zip(tc + tq + t_oracle.libjpeg_raw_yuv(data),
                    rc + rq + r_oracle.libjpeg_raw_yuv(data)):
        np.testing.assert_array_equal(a, b)
    for fancy in (False, True):
        np.testing.assert_array_equal(t_oracle.libjpeg_rgb(data, fancy),
                                      r_oracle.libjpeg_rgb(data, fancy))
    rgb = r_test_oracle.pil_decode_rgb(data)
    np.testing.assert_array_equal(t_test_oracle.pil_decode_rgb(data), rgb)
    assert t_test_oracle.psnr(rgb, rgb[::-1]) == r_test_oracle.psnr(rgb, rgb[::-1])
