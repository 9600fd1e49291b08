"""The port's copies of the framework-free host modules vs the originals.

The port cannot import ``jpeg_gpu_tpu.host`` (importing that package loads
jax), so it carries copies.  They must parse and entropy-decode to the same
headers and coefficients, and the copied encoder must write the same bytes
wherever the original terminates.  The copy also fixes the original
encoder's Huffman length-limit loop (Figure K.3 starts the search at
i - 2), which never returns on images whose optimal code exceeds 16 bits.
"""

import numpy as np
import pytest

from jpeg_gpu_tpu.host import entropy as r_entropy
from jpeg_gpu_tpu.host import entropy_native as r_native
from jpeg_gpu_tpu.host.parser import parse as r_parse
from jpeg_gpu_tpu.testing import corpus as r_corpus
from jpeg_gpu_tpu_torch.host import entropy as t_entropy
from jpeg_gpu_tpu_torch.host import entropy_native as t_native
from jpeg_gpu_tpu_torch.host.parser import parse as t_parse
from jpeg_gpu_tpu_torch.testing import corpus as t_corpus
from jpeg_gpu_tpu_torch.testing import encoder as t_encoder

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
