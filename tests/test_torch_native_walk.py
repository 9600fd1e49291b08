"""The producer's byte walks in native code against their numpy forms.

Where the host library is available, the parser's marker walk
(``host/parser._scan_entropy_segments`` -> ``entropy_native.scan_markers``,
which also counts the stuffed zeros) and the scan input's destuff and window
rows (``host/segments.build_spec_scan_input`` -> ``entropy_native.scan_windows``)
run natively; where it is not, numpy passes do the same work.  Both must give
the same segments, stuffed counts and errors, and the same
``SpecScanInput`` bit for bit, on real frames (the benchmark generator's
1080p stream, the sweep's and the fuzz's frames), on seeded garbage and on
hand-made edges of the walks.  The numpy fallback also decodes equal to the
JAX package.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest

import jpeg_gpu_tpu as jr
import jpeg_gpu_tpu_torch as jt
from jpeg_gpu_tpu_torch.engine import device_entropy
from jpeg_gpu_tpu_torch.errors import JpegError
from jpeg_gpu_tpu_torch.host import entropy_native, parser
from jpeg_gpu_tpu_torch.host.parser import ParsedJpeg, parse
from jpeg_gpu_tpu_torch.host.segments import build_spec_scan_input
from jpeg_gpu_tpu_torch.testing import corpus, fuzz
from jpeg_gpu_tpu_torch.utils import trace
from jpegbench import traffic_gen

SEED = 3999999937
FRAMES_R0 = 16
FRAMES_R1 = 2
FUZZ_CASES = 68
SCAN_KW = {"sb_target": device_entropy.SCAN_SB_TARGET}


@contextlib.contextmanager
def _numpy_only():
    """The host library marked unavailable: the parser's and the planner's
    numpy passes."""
    with mock.patch.object(entropy_native, "available", return_value=False):
        yield


def _counted(fn):
    """(fn's outcome, the tracer's counters over it): a value, or the
    exception's class and text."""
    with trace.enable():
        try:
            out = ("value", fn())
        except (JpegError, ValueError) as e:
            out = ("error", type(e), str(e))
    return out, trace.snapshot().counters


def _both(fn, counter):
    """fn's outcome natively and in numpy; the native run must have counted
    ``counter`` and the numpy run nothing native."""
    assert entropy_native.available()
    native, counts = _counted(fn)
    if native[0] == "value" and counter:
        assert counts.get(counter, 0) >= 1, counts
    with _numpy_only():
        numpy_, counts = _counted(fn)
    assert not {"host.native_markers", "host.native_windows"} & set(counts), counts
    return native, numpy_


def _same(a, b):
    assert a[0] == b[0], (a, b)
    if a[0] == "error":
        assert a[1:] == b[1:]
        return
    x, y = a[1], b[1]
    if isinstance(x, tuple):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            _same(("value", u), ("value", v))
    elif isinstance(x, np.ndarray):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    elif hasattr(x, "__dataclass_fields__"):
        for field in x.__dataclass_fields__:
            _same(("value", getattr(x, field)), ("value", getattr(y, field)))
    else:
        assert x == y


def _walk(data: bytes, start: int, expected, validate=True):
    return parser._scan_entropy_segments(data, start, expected, validate)


def _check_frame(data: bytes, **pins):
    """parse's segments and errors, then, for a stream without restart
    markers, its scan input: native == numpy."""
    a, b = _both(lambda: parse(data).segments, "host.native_markers")
    _same(a, b)
    if a[0] == "error" or len(a[1]) != 1 or parse(data).header.restart_interval:
        return a
    parsed = parse(data)
    _same(*_both(lambda: build_spec_scan_input(parsed, **pins), "host.native_windows"))
    return a


def _traffic_frame(index: int, restart: int) -> bytes:
    return traffic_gen.make_frame(SEED, index, 1080, 1920, "4:2:0", 85, restart,
                                  "annex_k", True).data


@pytest.fixture(scope="module")
def serving_pins():
    """The pins a serving loop takes from its first frame (``bench.serve``):
    the scan's row width and window stride."""
    first = build_spec_scan_input(parse(_traffic_frame(0, 0)), **SCAN_KW)
    return {"nw": first.nw, "subseq_bytes": first.subseq_bytes}


@pytest.mark.parametrize("index,restart", [(i, 0) for i in range(FRAMES_R0)]
                         + [(i, 1) for i in range(FRAMES_R1)])
def test_traffic_frames(index, restart, serving_pins):
    """The benchmark's 1080p 4:2:0 RTP/JPEG frames: segments, and the scan
    input at the engine's stride target and at the serving loop's pins."""
    data = _traffic_frame(index, restart)
    _check_frame(data, **SCAN_KW)
    if not restart:
        _check_frame(data, **serving_pins)


@pytest.fixture(scope="module")
def sources():
    return fuzz.sources()


@pytest.mark.parametrize("i", range(27))
def test_sweep_and_fuzz_sources(i, sources):
    """The sweep's 20 frames and the fuzz's own, at the default stride and
    at the smallest."""
    src = sources[i]
    assert _check_frame(src.data)[0] == "value"
    _check_frame(src.data, subseq_bytes=8)


@pytest.fixture(scope="module")
def fuzz_cases(sources):
    return list(fuzz.cases(20, FUZZ_CASES, sources))


@pytest.mark.parametrize("i", range(FUZZ_CASES))
def test_fuzz_cases(i, fuzz_cases):
    """Seeded garbage (four cases of each of the fuzz's mutation kinds): the
    same segments or the same exception, with the same text."""
    _check_frame(fuzz_cases[i][1])


def _base(mode="4:2:0", h=40, w=48, restart=0, seed=1) -> bytes:
    img = corpus.synthetic_gray(h, w, seed=seed) if mode == "gray" else corpus.synthetic_rgb(
        h, w, seed=seed)
    return corpus.own_jpeg(img, subsampling="4:2:0" if mode == "gray" else mode, quality=85,
                           restart_interval=restart).data


def _edge(kind: str):
    """(data, scan start, a subseq_bytes pin or None) of a hand-made edge of
    the walks, built on a small frame without restart markers whose scan
    ends with FF D9 at ``e``."""
    data = _base()
    (s, e), = parse(data).segments
    scan = data[s:e]
    sb = None
    if kind == "ff_last_byte":           # no EOI, the last byte a lone 0xFF
        out = data[:e] + b"\xff"
    elif kind == "fill_before_eoi":
        out = data[:e] + b"\xff\xff\xff" + data[e + 1:]
    elif kind == "no_eoi":
        out = data[:e]
    elif kind == "fill_at_eof":
        out = data[:e] + b"\xff\xff"
    elif kind == "stuffed_before_eoi":
        out = data[:e] + b"\xff\x00" + data[e:]
    elif kind == "stride_multiple":      # destuffed length a multiple of 64
        n = len(scan) - scan.count(b"\xff\x00")
        out = data[:e] + b"\x01" * (-n % 64 or 64) + data[e:]
        sb = 64
    elif kind == "dense_ff":             # a third of the bytes 0xFF, a third 0x00
        rng = np.random.default_rng(5)
        body = rng.choice([0xFF, 0x00, 0x5A], size=4099).astype(np.uint8).tobytes()
        body = body.replace(b"\xff\x5a", b"\xff\x00")
        out = data[:s] + body + b"\xff\xd9"
    elif kind == "empty_scan":
        out = data[:s] + b"\xff\xd9"
    else:
        raise ValueError(kind)
    return out, s, sb


EDGES = ("ff_last_byte", "fill_before_eoi", "no_eoi", "fill_at_eof", "stuffed_before_eoi",
         "stride_multiple", "dense_ff", "empty_scan")


@pytest.mark.parametrize("kind", EDGES)
def test_edges(kind):
    """The walks at the ends of a scan, each segment then planned as the
    scan input at the default stride, at the smallest and at ``sb``."""
    data, start, sb = _edge(kind)
    a, b = _both(lambda: _walk(data, start, 1), "host.native_markers")
    _same(a, b)
    if kind == "stride_multiple":
        (s0, e0), = a[1][0]
        assert (e0 - s0 - data[s0:e0].count(b"\xff\x00")) % sb == 0
    segments, _, stuffed = a[1]
    parsed = ParsedJpeg(parse(_base()).header, data, segments, stuffed)
    for pins in ({}, {"subseq_bytes": 8}, {"subseq_bytes": sb} if sb else SCAN_KW):
        _same(*_both(lambda: build_spec_scan_input(parsed, **pins), "host.native_windows"))


@pytest.mark.parametrize("mode,h,w", [("gray", 8, 8), ("4:2:0", 16, 16), ("4:4:4", 1, 1)])
def test_one_mcu_image(mode, h, w):
    data = _base(mode, h, w)
    assert parse(data).header.n_mcus == 1
    _check_frame(data)
    _check_frame(data, subseq_bytes=8)


def _rst_frame():
    data = _base("4:2:2", 32, 48, restart=1, seed=2)
    return data, parse(data).segments


@pytest.mark.parametrize("which", [0, 1, 8, "last"])
def test_restart_markers_out_of_sequence(which):
    """A restart marker's n changed: the same exception and text with
    validation, the same segments without."""
    data, segs = _rst_frame()
    k = len(segs) - 2 if which == "last" else which
    rst = int(segs[k + 1, 0]) - 2          # the 0xFF of RST k
    buf = bytearray(data)
    buf[rst + 1] = 0xD0 + (buf[rst + 1] - 0xD0 + 3) % 8
    bad = bytes(buf)
    a, b = _both(lambda: parse(bad), None)
    assert a[0] == "error" and "out of sequence" in a[2]
    _same(a, b)
    _same(*_both(lambda: _walk(bad, int(segs[0, 0]), len(segs), validate=False),
                 "host.native_markers"))


@pytest.mark.parametrize("expected", [None, 1, 2, "all"])
def test_more_restart_markers_than_expected(expected):
    """The native walk's first guess at the count of markers is the
    expected count; more take its second call.  The same segments, and
    with validation the same error."""
    data, segs = _rst_frame()
    expected = len(segs) if expected == "all" else expected
    for validate in (False, True):
        a, b = _both(lambda: _walk(data, int(segs[0, 0]), expected, validate),
                     "host.native_markers")
        _same(a, b)
        if not validate or expected in (None, len(segs)):
            np.testing.assert_array_equal(a[1][0], segs)


@pytest.mark.parametrize("restart", [0, 1])
def test_numpy_fallback_decodes_equal_to_the_jax_package(restart):
    """With the host library marked unavailable, the device entropy path's
    decode (parse and plan in numpy) equals the JAX package's."""
    data = _base("4:2:0", 24, 40, restart=restart, seed=3)
    with _numpy_only(), trace.enable():
        got = jt.decode(data, device="cpu", entropy="device")
    counters = trace.snapshot().counters
    assert "host.native_markers" not in counters and "host.native_windows" not in counters
    if not restart:
        assert counters["engine.scan_frames"] == 1
    np.testing.assert_array_equal(got, jr.decode(data, impl="tpu", entropy="device"))
