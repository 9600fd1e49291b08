"""K3 (the device index scan) and its glue in the port vs the JAX reference.

On CPU tensors ``device_index_scan`` runs every round through the plain
PyTorch version of K3; it is held to the JAX package's
``device_index_scan(interpret=True)`` (bitpos, ok and stats) and to the
serial native index scan, tolerance 0.  The two things the CUDA kernel
does differently are held to the plain version here in plain PyTorch: the
first-level symbol table (equal to ``decode_symbol`` for every 16-bit
prefix) and the lazy scheme (a lane decodes only when its entry changed and
records while it decodes; equal to the rounds plus a record pass).  The
engine's index-scan path is held to the serial-scan path and must fall back
to it whenever the scan cannot be used.  The CUDA kernel itself is compared
with the plain version only where a card is present.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_gpu_tpu.host import segments as jseg
from jpeg_gpu_tpu.host.parser import parse as jparse
from jpeg_gpu_tpu.ops import specsync_device as jsd
from jpeg_gpu_tpu_torch.engine import device_entropy as tde
from jpeg_gpu_tpu_torch.errors import JpegUnsupportedError
from jpeg_gpu_tpu_torch.host import entropy_native as t_native
from jpeg_gpu_tpu_torch.host import segments as tseg
from jpeg_gpu_tpu_torch.host.parser import parse as tparse
from jpeg_gpu_tpu_torch.ops import specsync_device as tsd
from jpeg_gpu_tpu_torch.ops.entropy_device import _Tables, decode_symbol, plan_tensors
from jpeg_gpu_tpu_torch.testing import corpus, scan_cases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of tiny ops; one intra-op thread
    keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _enc(mode, h, w, seed, quality=85, restart=0):
    img = corpus.synthetic_rgb(h, w, seed=seed)
    if mode == "mono":
        img, mode = img[..., 1].copy(), "4:2:0"
    return corpus.own_jpeg(img, subsampling=mode, quality=quality,
                           restart_interval=restart).data


def _torch_scan(inp, device="cpu", **kw):
    w, = plan_tensors((inp.windows,), device)
    tabs = plan_tensors(
        (inp.dcslot_of_c, inp.acslot_of_c, inp.cbase, inp.counts, inp.symbols), device)
    return tsd.device_index_scan(w, inp.n_bits, *tabs, sb=inp.subseq_bytes,
                                 maxrec=inp.maxrec, n_mcus=inp.n_mcus, **kw)


@pytest.mark.parametrize("mode,q", [("4:2:0", 85), ("4:4:4", 92), ("mono", 75)])
def test_plain_k3_matches_jax(mode, q):
    """32-byte subsequences, so several rounds run (4:2:0 here does not
    converge within 16 rounds: ok is False on both sides)."""
    data = _enc(mode, 56, 72, seed=9, quality=q)
    inp = tseg.build_spec_scan_input(tparse(data), subseq_bytes=32)
    bitpos, ok, stats = _torch_scan(inp)
    ji = jseg.build_spec_scan_input(jparse(data), subseq_bytes=32)
    jb, jok, jst = jsd.device_index_scan(
        jnp.asarray(ji.windows), jnp.asarray(np.array([ji.n_bits], np.int32)),
        *(jnp.asarray(x) for x in (ji.dcslot_of_c, ji.acslot_of_c, ji.cbase,
                                   ji.counts, ji.symbols)),
        used_slots=ji.used_slots, bpm=ji.bpm, sb=ji.subseq_bytes,
        maxrec=ji.maxrec, n_mcus=ji.n_mcus, interpret=True)
    assert bitpos.dtype == torch.int32 and stats.dtype == torch.int32
    np.testing.assert_array_equal(bitpos.numpy(), np.asarray(jb))
    assert bool(ok) == bool(jok)
    np.testing.assert_array_equal(stats.numpy(), np.asarray(jst))


@pytest.mark.parametrize("mode", ["4:2:0", "4:2:2", "4:4:4", "mono"])
def test_bitpos_matches_native_index_scan(mode):
    data = _enc(mode, 40, 64, seed=10)
    inp = tseg.build_spec_scan_input(tparse(data), subseq_bytes=64)
    bitpos, ok, stats = _torch_scan(inp)
    assert bool(ok), stats
    ref, _, _ = t_native.index_scan(tparse(data), 1)
    np.testing.assert_array_equal(bitpos.numpy(), ref.astype(np.int32))


def test_round_records_count_past_maxrec():
    """The record count keeps counting past maxrec; records beyond it are
    dropped and the scan reports the overflow."""
    data = _enc("mono", 32, 64, seed=11)
    inp = tseg.build_spec_scan_input(tparse(data), subseq_bytes=64)
    full = _torch_scan(inp)
    inp.maxrec = 1
    bitpos, ok, stats = _torch_scan(inp)
    assert bool(full[1]) and not bool(ok)
    assert int(stats[2]) == 1 and int(stats[1]) == int(full[2][1])


@pytest.mark.parametrize("mode", ["4:2:0", "4:2:2"])
def test_spec_path_equals_serial_scan_path(mode):
    parsed = tparse(_enc(mode, 48, 64, seed=3))
    a = tde.entropy_decode_device(parsed, device="cpu")
    b = tde.entropy_decode_device(parsed, device="cpu", specsync=False)
    assert a.specsync_stats is not None  # the index scan ran
    assert b.specsync_stats is None
    for x, y in zip(a.coefs, b.coefs):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_overflow_falls_back_to_serial(monkeypatch):
    parsed = tparse(_enc("4:2:0", 48, 64, seed=3))
    real_build = tseg.build_spec_scan_input

    def tiny_maxrec(parsed, **kw):
        inp = real_build(parsed, **kw)
        inp.maxrec = 1  # every lane with more than one MCU start overflows
        return inp

    monkeypatch.setattr(tde, "build_spec_scan_input", tiny_maxrec)
    a = tde.entropy_decode_device(parsed, device="cpu")
    assert a.specsync_stats is None  # fell back
    b = tde.entropy_decode_device(parsed, device="cpu", specsync=False)
    for x, y in zip(a.coefs, b.coefs):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_unsupported_size_falls_back(monkeypatch):
    parsed = tparse(_enc("4:2:0", 48, 64, seed=3))

    def raise_unsupported(parsed, **kw):
        raise JpegUnsupportedError("forced")

    monkeypatch.setattr(tde, "build_spec_scan_input", raise_unsupported)
    a = tde.entropy_decode_device(parsed, device="cpu")
    assert a.specsync_stats is None
    b = tde.entropy_decode_device(parsed, device="cpu", specsync=False)
    for x, y in zip(a.coefs, b.coefs):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("mode,bpm", [("h4v4", 18), ("4:4:4-2x2", 12)])
def test_wide_mcus_go_through_the_scan(mode, bpm):
    """Sampling factors the parser accepts give MCUs of more than 10 blocks:
    the index scan takes them like any other and equals the serial scan."""
    data = _enc(mode, 96, 128, seed=12)
    parsed = tparse(data)
    inp = tseg.build_spec_scan_input(parsed, sb_target=tde.SCAN_SB_TARGET)
    assert inp.bpm == bpm
    bitpos, ok, stats = _torch_scan(inp)
    assert bool(ok), stats
    ref, _, _ = t_native.index_scan(parsed, 1)
    np.testing.assert_array_equal(bitpos.numpy(), ref.astype(np.int32))
    a = tde.entropy_decode_device(parsed, device="cpu")
    b = tde.entropy_decode_device(parsed, device="cpu", specsync=False)
    assert a.specsync_stats is not None and b.specsync_stats is None
    for x, y in zip(a.coefs, b.coefs):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_restart_streams_skip_the_scan():
    res = tde.entropy_decode_device(tparse(_enc("4:2:0", 48, 48, seed=7, restart=1)), device="cpu")
    assert res.specsync_stats is None


def test_gather_entropy_streams_vs_jax():
    """Inside the window grid the realigned rows equal the reference's;
    words past the grid read 0xFFFFFFFF, where the reference repeats the
    grid's last word."""
    rng = np.random.default_rng(3)
    spw, nws, nw = 8, 11, 5
    windows = rng.integers(-2**31, 2**31, size=(1, nws, 8, 128), dtype=np.int64).astype(np.int32)
    last_bit = 1024 * spw * 32
    bitpos = np.sort(rng.integers(0, last_bit - 32 * (nw + 2), size=700)).astype(np.int32)
    bitpos[-1] = last_bit - 40  # this segment runs past the grid
    got = tsd.gather_entropy_streams(torch.from_numpy(windows), torch.from_numpy(bitpos),
                                     nw=nw, spw=spw, nws=nws).numpy()
    ref = np.asarray(jsd.gather_entropy_streams(jnp.asarray(windows), jnp.asarray(bitpos),
                                                nw=nw, spw=spw, nws=nws))
    flat_got, flat_ref = got.transpose(0, 2, 3, 1).reshape(-1, nw), ref.transpose(0, 2, 3, 1).reshape(-1, nw)
    np.testing.assert_array_equal(flat_got[:699], flat_ref[:699])
    np.testing.assert_array_equal(flat_got[700:], flat_ref[700:])  # padding lanes
    # The last segment: 40 bits left in the grid, then all ones.
    grid_word = int(windows[0, spw - 1, 7, 127]) & 0xFFFFFFFF
    prev_word = int(windows[0, spw - 2, 7, 127]) & 0xFFFFFFFF
    bits = (((prev_word << 32 | grid_word) << 24) | 0xFFFFFF) & (2**64 - 1)
    want = [bits >> 32, bits & 0xFFFFFFFF]
    assert [int(x) & 0xFFFFFFFF for x in flat_got[699, :2]] == want
    assert (flat_got[699, 2:] == -1).all()


def test_dc_base_from_coefs_vs_jax():
    kout = np.random.default_rng(5).integers(
        -2048, 2048, size=(2, 6, 64, 8, 128), dtype=np.int16)
    got = tsd.dc_base_from_coefs(torch.from_numpy(kout), (3, 4, 5))
    ref = jsd.dc_base_from_coefs(jnp.asarray(kout), (3, 4, 5))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wrapper_has_no_fallback_for_other_devices():
    inp = tseg.build_spec_scan_input(tparse(_enc("mono", 16, 32, seed=1)))
    w, e = plan_tensors((inp.windows, np.zeros((1, 4, 8, 128))), "meta")
    tabs = plan_tensors(
        (inp.dcslot_of_c, inp.acslot_of_c, inp.cbase, inp.counts, inp.symbols), "meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tsd.scan_round(w, e, inp.n_bits, *tabs, sb=inp.subseq_bytes,
                       maxrec=inp.maxrec, record=False)


def _scan_args(inp, device):
    w, = plan_tensors((inp.windows,), device)
    tabs = plan_tensors(
        (inp.dcslot_of_c, inp.acslot_of_c, inp.cbase, inp.counts, inp.symbols), device)
    return (w, inp.n_bits, *tabs), dict(sb=inp.subseq_bytes, maxrec=inp.maxrec,
                                        n_mcus=inp.n_mcus)


def _prefix_check(lut, cbase, counts, symbols, sublanes=(0,)):
    """For every slot and every 16-bit prefix, zero- and one-extended: where
    K3's tables answer, the entry is the chain entry of what decode_symbol
    gives for that window (elsewhere K3 calls decode_symbol), with the
    symbol rows of ``sublanes`` (real tables repeat one row in all eight).
    Returns the share of windows the tables answer, per slot."""
    tab = _Tables(cbase, counts, symbols)
    prefix = torch.arange(1 << 16, dtype=torch.int64, device=cbase.device) << 16
    hi = torch.cat([prefix, prefix | 0xFFFF]).expand(8, -1)          # (slot, window)
    for sub in sublanes:
        want = tsd.chain_entry(*decode_symbol(
            hi, tab.cbase[:, None], tab.counts[:, None],
            tab.symbols[:, sub, None].expand(-1, hi.shape[1], -1), tab.limit[:, None]))
        got = tsd.lut_lookup(lut[sub], hi)
        answered = got != tsd.LUT_MISS
        assert torch.equal(torch.where(answered, got, want), want)
    return answered.float().mean(1)


def test_many_long_codes_miss_in_the_first_level_only():
    """A valid table with long codes under more than SUB_TABLES prefixes of
    LUT_BITS bits: the first level leaves the prefixes past the first
    SUB_TABLES to decode_symbol, the second level answers all it is asked,
    and only that slot is incomplete."""
    tabs = plan_tensors(_lut_case("deep codes"), "cpu")
    lut = tsd.scan_lut_reference(*tabs)
    answered = _prefix_check(lut, *tabs)
    first = lut[0, 4, : 1 << tsd.LUT_BITS]
    assert int(((first & tsd.LUT_SUB) != 0).sum()) == tsd.SUB_TABLES
    assert int((first == tsd.LUT_MISS).sum()) == scan_cases.DEEP_CODES // 2 - tsd.SUB_TABLES
    second = lut[0, 4, 1 << tsd.LUT_BITS:]
    assert int((second == tsd.LUT_MISS).sum()) == 0
    assert 0.9 < float(answered[4]) < 1.0
    complete = tsd.lut_complete(lut)
    assert not bool(complete[:, 4].any()) and bool(complete[:, [0, 1, 5]].all())


def test_chain_entry_fields():
    """The tables' entries: the bits a DC and an AC symbol consume, the zero
    run, EOB; an invalid code (length above 16) as EOB of 17 bits."""
    sym, ln = torch.meshgrid(torch.arange(256), torch.arange(32), indexing="ij")
    e = tsd.chain_entry(sym, ln)
    bad = ln > 16
    s, n = torch.where(bad, 0, sym), torch.where(bad, 17, ln)
    assert torch.equal(e & 31, n + (s & 15))
    assert torch.equal((e >> 5) & 31, n + torch.clamp(s, max=15))
    assert torch.equal((e >> 10) & 15, s >> 4) and torch.equal(e >> 14, (s == 0).long())
    assert int(e.min()) > tsd.LUT_MISS and int(e.max()) < tsd.LUT_SUB


def _lut_case(name):
    """Table tensors of an encoded image: the own encoder writes optimised
    tables, Pillow the standard ones; "random" is not a Huffman table at all;
    "deep codes" is a valid AC table in slot 4 with more long codes than the
    first level has second-level tables for."""
    kind, _, mode = name.partition(" ")
    if kind == "deep":
        return scan_cases.deep_code_tables(_lut_case("optimised 4:2:0"))
    if kind == "random":
        return scan_cases.random_tables(7)
    if kind == "standard":
        img = corpus.synthetic_rgb(48, 64, seed=21)
        data = corpus.pil_jpeg(img[..., 1].copy() if mode == "mono" else img,
                               quality=85, **({} if mode == "mono" else {"subsampling": mode}))
    else:
        data = _enc(mode, 48, 64, seed=21)
    return tseg._table_tensors(tparse(data).header)


LUT_CASES = ([f"optimised {m}" for m in ("mono", "4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1")]
             + [f"standard {m}" for m in ("mono", "4:4:4", "4:2:2", "4:2:0")] + ["random tables"])


@pytest.mark.parametrize("name", LUT_CASES)
def test_first_level_table_equals_decode_symbol(name):
    """The table K3 looks symbols up in, built in plain PyTorch by the
    kernel's rule: with the fall-through it gives decode_symbol's (sym,
    len), and the bits consumed that follow from them, for every 16-bit
    prefix of every slot, invalid windows included."""
    tabs = plan_tensors(_lut_case(name), "cpu")
    lut = tsd.scan_lut_reference(*tabs)
    assert lut.shape == (8, 8, tsd.LUT_WORDS) and lut.dtype == torch.int32
    direct = _prefix_check(lut, *tabs, sublanes=(0, 5) if name.startswith("random") else (0,))
    if not name.startswith("random"):
        # Huffman tables: two levels cover every code (a code has at most
        # 16 bits; unused slots are invalid throughout).
        assert float(direct.min()) == 1.0, direct
        first = lut[..., : 1 << tsd.LUT_BITS]
        assert float(((first & tsd.LUT_SUB) == 0).float().mean()) > 0.9
    # Complete tables are those that leave no window to decode_symbol.
    assert torch.equal(tsd.lut_complete(lut)[0], direct == 1.0)
    assert bool(tsd.lut_complete(lut).all()) != name.startswith("random")


@pytest.mark.parametrize("mode,q", [("4:2:0", 85), ("4:4:4", 92), ("mono", 75)])
def test_lazy_scheme_equals_rounds_plus_record_pass(mode, q):
    """What K3's kernel rests on: a lane that decodes only when its entry
    changed, and records while it decodes, ends with the records of the
    separate record pass (4:2:0 here runs out of rounds first)."""
    data = _enc(mode, 56, 72, seed=9, quality=q)
    inp = tseg.build_spec_scan_input(tparse(data), subseq_bytes=32)
    a, kw = _scan_args(inp, "cpu")
    want = tsd.device_index_scan(*a, **kw)
    bitpos, ok, stats, round_lanes, rec, recn = tsd.device_index_scan_lazy_reference(*a, **kw)
    for x, y in zip((bitpos, ok, stats), want):
        assert torch.equal(x, y)
    # The record pass of the plain version, from the entries its rounds end on.
    entry = tsd._start_entry(a[0].shape[0], "cpu")
    for _ in range(int(stats[0])):
        exit_state, = tsd.scan_round_reference(a[0], entry, *a[1:], **_round_kw(kw), record=False)
        entry = tsd._pin_and_shift(exit_state, inp.n_bits, inp.subseq_bytes * 8)
    _, rec_pass, recn_pass = tsd.scan_round_reference(a[0], entry, *a[1:], **_round_kw(kw), record=True)
    assert torch.equal(recn, recn_pass)
    kept = torch.arange(inp.maxrec)[None, :, None, None] < recn_pass
    assert torch.equal(torch.where(kept, rec, 0), torch.where(kept, rec_pass, 0))
    live = min(a[0].shape[0] * 1024, -(-inp.n_bits // (inp.subseq_bytes * 8)))
    assert round_lanes[0] == live and len(round_lanes) == int(stats[0]) + 1
    assert all(0 < n < live for n in round_lanes[1:-1])
    assert (round_lanes[-1] == 0) == bool(ok)


def _round_kw(kw):
    return dict(sb=kw["sb"], maxrec=kw["maxrec"])


@pytest.mark.parametrize("mode", ["4:2:0", "4:2:2", "4:4:4", "mono"])
def test_engine_default_subsequences_match_jax_and_native(mode):
    """The subsequence size the engine asks for: the plain scan still equals
    the JAX package's and the serial native scan."""
    data = _enc(mode, 64, 96, seed=14)
    inp = tseg.build_spec_scan_input(tparse(data), sb_target=tde.SCAN_SB_TARGET)
    bitpos, ok, stats = _torch_scan(inp)
    ji = jseg.build_spec_scan_input(jparse(data), sb_target=tde.SCAN_SB_TARGET)
    assert ji.subseq_bytes == inp.subseq_bytes
    jb, jok, jst = jsd.device_index_scan(
        jnp.asarray(ji.windows), jnp.asarray(np.array([ji.n_bits], np.int32)),
        *(jnp.asarray(x) for x in (ji.dcslot_of_c, ji.acslot_of_c, ji.cbase,
                                   ji.counts, ji.symbols)),
        used_slots=ji.used_slots, bpm=ji.bpm, sb=ji.subseq_bytes,
        maxrec=ji.maxrec, n_mcus=ji.n_mcus, interpret=True)
    assert bool(ok) and bool(jok)
    np.testing.assert_array_equal(bitpos.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(jst))
    ref, _, _ = t_native.index_scan(tparse(data), 1)
    np.testing.assert_array_equal(bitpos.numpy(), ref.astype(np.int32))


def test_engine_passes_its_subsequence_target(monkeypatch):
    seen = {}
    real_build = tseg.build_spec_scan_input

    def spy(parsed, **kw):
        seen.update(kw)
        return real_build(parsed, **kw)

    monkeypatch.setattr(tde, "build_spec_scan_input", spy)
    res = tde.entropy_decode_device(tparse(_enc("4:2:0", 48, 64, seed=3)), device="cpu")
    assert res.specsync_stats is not None and seen == {"sb_target": tde.SCAN_SB_TARGET}


@pytest.mark.parametrize("bad", ["windows", "dtype", "tables", "n_mcus", "maxrec"])
def test_index_scan_rejects_bad_arguments(bad):
    inp = tseg.build_spec_scan_input(tparse(_enc("mono", 16, 32, seed=1)))
    a, kw = _scan_args(inp, "cpu")
    a = list(a)
    if bad == "windows":
        a[0] = a[0].reshape(1, -1, 1024)
    elif bad == "dtype":
        a[0] = a[0].to(torch.int64)
    elif bad == "tables":
        a[4] = a[4][:, :15]
    else:
        kw[bad] = 0
    with pytest.raises(TypeError if bad == "dtype" else ValueError):
        tsd.device_index_scan(*a, **kw)


def test_index_scan_has_no_fallback_for_other_devices():
    inp = tseg.build_spec_scan_input(tparse(_enc("mono", 16, 32, seed=1)))
    a, kw = _scan_args(inp, "meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tsd.device_index_scan(*a, **kw)
    with pytest.raises(RuntimeError, match="no kernel"):
        tsd.scan_lut(*a[4:])


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K3 kernel has no CPU mode")


def _kernel_vs_plain(a, kw):
    """The whole scan on the card, kernel against plain: one call into the
    kernel, and bitpos, ok and stats equal."""
    before = tsd.launches
    got = tsd.device_index_scan(*a, **kw)
    assert tsd.launches == before + 2   # the tables' kernel and the scan's
    ref = tsd.device_index_scan(*a, **kw, plain=True)
    torch.cuda.synchronize()
    for x, y in zip(got, ref):
        assert x.dtype == y.dtype and torch.equal(x, y)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("mode,sb", [("4:2:0", 32), ("4:2:2", 32), ("4:4:4", None), ("mono", 64),
                                     ("h4v4", None), ("4:4:4-2x2", 64)])
def test_kernel_vs_plain_on_gpu(mode, sb):
    _need_card()
    data = _enc(mode, 130, 1100, seed=13)
    inp = tseg.build_spec_scan_input(tparse(data), subseq_bytes=sb)
    bitpos, ok, _ = _kernel_vs_plain(*_scan_args(inp, "cuda"))
    if bool(ok):
        ref, _, _ = t_native.index_scan(tparse(data), 1)
        np.testing.assert_array_equal(bitpos.cpu().numpy(), ref.astype(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["out of rounds", "record overflow", "one round allowed",
                                  "no round allowed"])
def test_kernel_vs_plain_when_the_scan_fails_on_gpu(case):
    """ok False on both sides, and the same bitpos, rounds and record count."""
    _need_card()
    overflow = case == "record overflow"
    # 32-byte subsequences of a colour stream never sync in 16 rounds;
    # 64-byte subsequences of a grayscale one hold several MCU starts each.
    data = _enc("mono", 130, 500, seed=15) if overflow else _enc("4:2:0", 130, 500, seed=15)
    inp = tseg.build_spec_scan_input(tparse(data), subseq_bytes=64 if overflow else 32)
    a, kw = _scan_args(inp, "cuda")
    if overflow:
        kw["maxrec"] = 1
    elif case != "out of rounds":
        kw["max_rounds"] = 1 if case == "one round allowed" else 0
    _, ok, stats = _kernel_vs_plain(a, kw)
    assert not bool(ok)
    assert int(stats[2]) == overflow
    assert overflow or int(stats[0]) == kw.get("max_rounds", 16)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["random tables", "deep codes"])
def test_kernel_vs_plain_with_tables_that_miss_on_gpu(name):
    """Tables that are no Huffman tables, or hold very many long codes,
    leave windows to decode_symbol: the kernel then runs its step with that
    call, and still equals plain."""
    _need_card()
    inp = tseg.build_spec_scan_input(tparse(_enc("4:2:0", 64, 96, seed=17)), subseq_bytes=32)
    a, kw = _scan_args(inp, "cuda")
    tabs = plan_tensors(_lut_case(name), "cuda")
    assert not bool(tsd.scan_lut(*tabs)[1].all())
    _kernel_vs_plain((*a[:4], *tabs), dict(kw, max_rounds=3))


@pytest.mark.gpu
def test_stream_that_fills_its_last_batch_on_gpu():
    """No padding lane: a stream cut at the end of its first batch of lanes
    (the last lane's window still holds the words that follow)."""
    _need_card()
    data = _enc("mono", 384, 768, seed=16)
    inp = tseg.build_spec_scan_input(tparse(data), subseq_bytes=64)
    assert inp.windows.shape[0] >= 2
    nbits = 1024 * 64 * 8
    ref, _, _ = t_native.index_scan(tparse(data), 1)
    n_mcus = int((ref < nbits).sum())
    a, kw = _scan_args(inp, "cuda")
    a = (a[0][:1].contiguous(), nbits, *a[2:])
    kw.update(n_mcus=n_mcus, max_rounds=32)
    bitpos, ok, _ = _kernel_vs_plain(a, kw)
    assert bool(ok)
    np.testing.assert_array_equal(bitpos.cpu().numpy(), ref[:n_mcus].astype(np.int32))


@pytest.mark.gpu
def test_scan_never_waits_for_the_card_on_gpu():
    """The whole scan under the sync debug mode: a host sync would raise."""
    _need_card()
    inp = tseg.build_spec_scan_input(tparse(_enc("4:2:0", 130, 1100, seed=13)))
    a, kw = _scan_args(inp, "cuda")
    tsd.device_index_scan(*a, **kw)   # the build, outside the checked call
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bitpos, ok, stats = tsd.device_index_scan(*a, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    ref, _, _ = t_native.index_scan(tparse(_enc("4:2:0", 130, 1100, seed=13)), 1)
    assert bool(ok)
    np.testing.assert_array_equal(bitpos.cpu().numpy(), ref.astype(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("mode,sb", [("4:2:0", 32), ("mono", 64)])
def test_lanes_decoded_per_pass_on_gpu(mode, sb):
    """The kernel's count of lanes that decoded in each pass equals the
    plain lazy scheme's."""
    _need_card()
    inp = tseg.build_spec_scan_input(tparse(_enc(mode, 130, 1100, seed=13)), subseq_bytes=sb)
    a, kw = _scan_args(inp, "cuda")
    *got, lanes = tsd.index_scan_kernel(*a, **kw)
    lanes = lanes.tolist()
    want = tsd.device_index_scan_lazy_reference(*a, **kw)
    for x, y in zip(got, want[:3]):
        assert torch.equal(x, y)
    assert lanes[: len(want[3])] == want[3] and not any(lanes[len(want[3]):])


@pytest.mark.gpu
@pytest.mark.parametrize("name", LUT_CASES + ["deep codes"])
def test_first_level_table_on_gpu(name):
    """The table the kernel builds equals the plain version's, and with the
    fall-through decode_symbol, for every 16-bit prefix."""
    _need_card()
    if name.startswith("standard"):
        pytest.importorskip("PIL")
    tabs = plan_tensors(_lut_case(name), "cuda")
    lut, complete = tsd.scan_lut(*tabs)
    assert lut.dtype == torch.int32 and torch.equal(lut, tsd.scan_lut_reference(*tabs))
    assert torch.equal(complete, tsd.lut_complete(lut))
    _prefix_check(lut, *tabs, sublanes=range(8))


@pytest.mark.gpu
@pytest.mark.parametrize("record", [False, True])
def test_single_round_kernel_vs_plain_on_gpu(record):
    """scan_round on the card from arbitrary entry states: the scan's kernel,
    stopped after its first pass."""
    _need_card()
    inp = tseg.build_spec_scan_input(tparse(_enc("4:2:0", 130, 1100, seed=13)), subseq_bytes=64)
    a, kw = _scan_args(inp, "cuda")
    rng = np.random.default_rng(4)
    shape = (a[0].shape[0], 8, 128)
    entry = np.stack([rng.integers(0, 64 * 8, shape), rng.integers(0, inp.bpm, shape),
                      rng.integers(0, 2, shape), rng.integers(0, 64, shape)], axis=1)
    entry = torch.from_numpy(entry.astype(np.int32)).cuda()
    before = tsd.launches
    got = tsd.scan_round(a[0], entry, *a[1:], **_round_kw(kw), record=record)
    ref = tsd.scan_round_reference(a[0], entry, *a[1:], **_round_kw(kw), record=record)
    torch.cuda.synchronize()
    assert tsd.launches == before + 2 and len(got) == len(ref) == (3 if record else 1)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
