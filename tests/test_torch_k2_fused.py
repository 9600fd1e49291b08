"""K2's fused form and its symbol tables in the port vs the JAX reference.

``decode_mcus_at_bitpos`` decodes MCU m of a stream without restart markers
from bit ``bitpos[m]`` of the index scan's window tensor and applies the DC
predictors; on a CPU tensor it runs its plain PyTorch version.  That is held
to the JAX package's chain ``gather_entropy_streams`` ->
``decode_segments_device(interpret=True)`` -> ``dc_base_from_coefs`` ->
``apply_dc_base`` on the same arrays, coefficients and flags of the real
lanes, tolerance 0.  The symbol tables the kernel looks symbols up in are
held, in plain PyTorch, to ``decode_symbol`` for every 16-bit prefix.  The
CUDA kernel itself is compared with the plain version only where a card is
present.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_gpu_tpu.ops import entropy_device as jed
from jpeg_gpu_tpu.ops import specsync_device as jsd
from jpeg_gpu_tpu_torch.host import entropy_native as t_native
from jpeg_gpu_tpu_torch.host import segments as tseg
from jpeg_gpu_tpu_torch.host.parser import parse as tparse
from jpeg_gpu_tpu_torch.ops import entropy_device as ted
from jpeg_gpu_tpu_torch.ops import specsync_device as tsd
from jpeg_gpu_tpu_torch.ops.entropy_device import plan_tensors
from jpeg_gpu_tpu_torch.testing import corpus, scan_cases

MODES = ["4:2:0", "4:4:4", "4:2:2", "mono"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of tiny ops; one intra-op thread
    keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _enc(mode, h, w, seed, quality=85):
    img = corpus.synthetic_rgb(h, w, seed=seed)
    if mode == "mono":
        img, mode = img[..., 1].copy(), "4:2:0"
    return corpus.own_jpeg(img, subsampling=mode, quality=quality).data


def _fused_args(data, device, serial=True):
    """(inp, bitpos, args): the scan input of ``data``, its MCU bit positions
    -- the serial host scan's, or (a corrupt stream, which the host scan
    refuses) the device index scan's -- and decode_mcus_at_bitpos's tensors
    on ``device``."""
    parsed = tparse(data, validate=False)
    inp = tseg.build_spec_scan_input(parsed, sb_target=256)
    if serial:
        bitpos = t_native.index_scan(parsed, 1)[0].astype(np.int32)
    else:
        t = plan_tensors((inp.windows, inp.dcslot_of_c, inp.acslot_of_c, inp.cbase, inp.counts,
                          inp.symbols), device)
        bitpos = tsd.device_index_scan(
            t[0], inp.n_bits, *t[1:], sb=inp.subseq_bytes, maxrec=inp.maxrec,
            n_mcus=inp.n_mcus)[0].cpu().numpy()
    w, pos, cm, dm, am, cb, cn, sy = plan_tensors(
        (inp.windows, bitpos, inp.comp_of_step, inp.dc_slot_of_step, inp.ac_slot_of_step,
         inp.cbase, inp.counts, inp.symbols), device)
    return inp, bitpos, (w, pos, inp.n_bits, cm, dm, am, cb, cn, sy)


def _real(x, n):
    """Lanes 0..n-1 of a (B, ..., 8, 128) array, lane-major."""
    x = np.asarray(x)
    return np.moveaxis(x.reshape(x.shape[0], -1, 1024), -1, 1).reshape(x.shape[0] * 1024, -1)[:n]


def _jax_chain(inp, bitpos):
    streams = jsd.gather_entropy_streams(
        jnp.asarray(inp.windows), jnp.asarray(bitpos), nw=inp.nw, spw=inp.spw, nws=inp.nws)
    out, err = jed.decode_segments_device(
        streams, *(jnp.asarray(x) for x in (
            inp.comp_of_step, inp.dc_slot_of_step, inp.ac_slot_of_step, inp.seg_meta,
            inp.cbase, inp.counts, inp.symbols)), interpret=True)
    dcb = jsd.dc_base_from_coefs(out, inp.t_last)
    return jed.apply_dc_base(out, dcb, jnp.asarray(inp.comp_of_step)), err


@pytest.mark.parametrize("mode", MODES)
def test_plain_fused_matches_jax_chain(mode):
    inp, bitpos, args = _fused_args(_enc(mode, 40, 56, seed=31), "cpu")
    got, gerr = ted.decode_mcus_at_bitpos(*args, spw=inp.spw)
    ref, rerr = _jax_chain(inp, bitpos)
    n = inp.n_mcus
    assert got.dtype == torch.int16 and gerr.dtype == torch.int32
    assert got.shape == (1, inp.bpm, 64, 8, 128) and gerr.shape == (1, 8, 128)
    np.testing.assert_array_equal(_real(got.numpy(), n), _real(ref, n))
    np.testing.assert_array_equal(_real(gerr.numpy(), n), _real(rerr, n))
    assert not gerr.any()
    # Lanes past the last MCU hold zeros and no flag.
    assert not _real(got.numpy(), 1024)[n:].any()


def test_plain_fused_equals_host_coefficients():
    """Two batches of lanes (1200 MCUs): the DC predictors carry across the
    batch boundary, and the assembled coefficients are the host decoder's."""
    data = _enc("mono", 240, 320, seed=32)
    parsed = tparse(data)
    inp, _, args = _fused_args(data, "cpu")
    got, gerr = ted.decode_mcus_at_bitpos(*args, spw=inp.spw)
    assert got.shape[0] == 2 and not gerr.any()
    hdr = parsed.header
    coefs = ted.assemble_components(got, hdr.n_mcus, 1, hdr.n_mcus, hdr.nhmb, hdr.nvmb,
                                    ((1, 1),))
    np.testing.assert_array_equal(coefs[0].numpy(), t_native.decode_scan(parsed).coefs[0])


def test_lane_is_held_to_its_mcus_end():
    """A lane given too few bits (its neighbour's start moved up) runs past
    its end and is flagged ERR_OVERRUN; a lane given too many is not."""
    inp, bitpos, args = _fused_args(_enc("4:2:0", 40, 56, seed=33), "cpu")
    moved = bitpos.copy()
    moved[5] -= 9   # MCU 4 loses its last 9 bits to MCU 5
    _, err = ted.decode_mcus_at_bitpos(args[0], torch.from_numpy(moved), *args[2:], spw=inp.spw)
    flags = _real(err.numpy(), inp.n_mcus)[:, 0]
    assert flags[4] & ted.ERR_OVERRUN
    assert not flags[:4].any()


def test_corrupt_stream_flags_match_the_chain():
    """Ones over the middle of the scan: the same lanes are flagged, with the
    same coefficients, as by the chain on rows wide enough for every lane."""
    data = _enc("4:2:0", 40, 56, seed=34)
    s, e = tparse(data).segments[0]
    mid = (s + e) // 2
    bad = data[:mid] + b"\xff\x00" * 10 + data[mid + 20:]
    inp, bitpos, args = _fused_args(bad, "cpu", serial=False)
    got, gerr = ted.decode_mcus_at_bitpos(*args, spw=inp.spw)
    w, pos, _, cm, dm, am, cb, cn, sy = args
    wide = min(cm.shape[0] * 64 * 31 // 32, w.shape[0] * 1024 * inp.spw) + 3
    streams = ted.gather_entropy_streams(w, pos, nw=wide, spw=inp.spw, nws=inp.nws)
    old, oerr = ted.decode_segments_device(
        streams, cm, dm, am, torch.from_numpy(inp.seg_meta), cb, cn, sy)
    old = ted.apply_dc_base(old, ted.dc_base_from_coefs(old, inp.t_last), cm)
    n = inp.n_mcus
    assert gerr.any()
    np.testing.assert_array_equal(_real(got.numpy(), n), _real(old.numpy(), n))
    np.testing.assert_array_equal(_real(gerr.numpy(), n) | ted.ERR_OVERRUN,
                                  _real(oerr.numpy(), n) | ted.ERR_OVERRUN)


def test_dc_add_wraps_in_int16():
    args, kw, dc = scan_cases.dc_ramp_case()
    assert dc.min() < 0 < dc.max() and int(dc[16]) == 2047 * 17 - 65536
    t = plan_tensors(args[:2] + args[3:], "cpu")
    got, err = ted.decode_mcus_at_bitpos(*t[:2], args[2], *t[2:], **kw)
    assert not err.any()
    np.testing.assert_array_equal(_real(got[:, 0, 0].numpy(), len(dc))[:, 0], dc)
    assert not got[:, 0, 1:].any()
    # The same wrap as the reference's int16 add.
    base = np.concatenate([[0], 2047 * np.arange(1, len(dc))]).astype(np.int32)
    ref = jed.apply_dc_base(
        jnp.full((2, 1, 64, 8, 128), 2047, jnp.int16),
        jnp.asarray(np.resize(base, 2048).reshape(2, 8, 128, 1)), jnp.zeros(1, jnp.int32))
    np.testing.assert_array_equal(_real(np.asarray(ref)[:, 0, 0], len(dc))[:, 0], dc)


def _lut_case(name):
    kind, _, mode = name.partition(" ")
    if kind == "deep":
        return scan_cases.deep_code_tables(_lut_case("optimised 4:2:0"))
    if kind == "random":
        return scan_cases.random_tables(11)
    if kind == "ramp":
        return scan_cases.dc_ramp_case(4)[0][6:]
    if kind == "standard":
        img = corpus.synthetic_rgb(48, 64, seed=21)
        data = corpus.pil_jpeg(img[..., 1].copy() if mode == "mono" else img,
                               quality=85, **({} if mode == "mono" else {"subsampling": mode}))
    else:
        data = _enc(mode, 48, 64, seed=21)
    return tseg._table_tensors(tparse(data).header)


def _prefix_check(lut, cbase, counts, symbols, sublanes=(0,)):
    """Every slot, every 16-bit prefix, zero- and one-extended: where the
    tables answer, the entry is symbol_entry of what decode_symbol gives."""
    tab = ted._Tables(cbase, counts, symbols)
    prefix = torch.arange(1 << 16, dtype=torch.int64) << 16
    hi = torch.cat([prefix, prefix | 0xFFFF]).expand(8, -1)
    for sub in sublanes:
        want = ted.symbol_entry(*ted.decode_symbol(
            hi, tab.cbase[:, None], tab.counts[:, None],
            tab.symbols[:, sub, None].expand(-1, hi.shape[1], -1), tab.limit[:, None]))
        got = ted.lut_lookup(lut[sub], hi)
        answered = got != ted.LUT_MISS
        assert torch.equal(torch.where(answered, got, want), want)
    return answered.float().mean(1)


@pytest.mark.parametrize("name", ["optimised 4:2:0", "optimised mono", "standard 4:2:0",
                                  "standard mono", "ramp", "deep codes", "random tables"])
def test_symbol_tables_equal_decode_symbol(name):
    tabs = plan_tensors(_lut_case(name), "cpu")
    lut = ted.lut_reference(*tabs)
    assert lut.shape == (8, 8, ted.LUT_WORDS) and lut.dtype == torch.int32
    direct = _prefix_check(lut, *tabs, sublanes=(0, 5) if name.startswith("random") else (0,))
    complete = ted.lut_complete(lut)
    assert torch.equal(complete[0], direct == 1.0)
    if name.startswith("random"):
        assert not bool(complete.all())
    elif name.startswith("deep"):
        assert not bool(complete[:, 4].any()) and bool(complete[:, [0, 1, 5]].all())
    else:
        assert bool(complete.all())


def test_symbol_entry_fields():
    """Code length and symbol apart; any invalid code as length 17, symbol 0;
    never the miss marker, never a pointer to a second-level table."""
    sym, ln = torch.meshgrid(torch.arange(256), torch.arange(32), indexing="ij")
    e = ted.symbol_entry(sym, ln)
    bad = ln > 16
    assert torch.equal(e & 31, torch.where(bad, 17, ln))
    assert torch.equal((e >> 5) & 255, torch.where(bad, 0, sym))
    assert int(e.min()) > ted.LUT_MISS and int(e.max()) < ted.LUT_SUB


@pytest.mark.parametrize("bad", ["dtype", "windows", "spw", "maps", "tables", "nbits"])
def test_fused_entry_rejects_bad_arguments(bad):
    inp, _, args = _fused_args(_enc("mono", 16, 32, seed=1), "cpu")
    a, kw = list(args), {"spw": inp.spw}
    want = ValueError
    if bad == "dtype":
        a[1], want = a[1].to(torch.int64), TypeError
    elif bad == "windows":
        a[0] = a[0][:, :, :4]
    elif bad == "spw":
        kw["spw"] = a[0].shape[1] + 1
    elif bad == "maps":
        a[4] = a[4][:0]
    elif bad == "tables":
        a[6] = a[6][:, :8]
    else:
        a[2] = -1
    with pytest.raises(want):
        ted.decode_mcus_at_bitpos(*a, **kw)


def test_fused_entry_has_no_fallback_for_other_devices():
    inp, bitpos, _ = _fused_args(_enc("mono", 16, 32, seed=1), "cpu")
    t = plan_tensors((inp.windows, bitpos, inp.comp_of_step, inp.dc_slot_of_step,
                      inp.ac_slot_of_step, inp.cbase, inp.counts, inp.symbols), "meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ted.decode_mcus_at_bitpos(*t[:2], inp.n_bits, *t[2:], spw=inp.spw)
    with pytest.raises(RuntimeError, match="no kernel"):
        ted.symbol_lut(*t[5:])


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K2 kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_fused_kernel_vs_plain_on_gpu(mode):
    _needs_card()
    inp, _, args = _fused_args(_enc(mode, 130, 1100, seed=35), "cuda")
    lut = ted.symbol_lut(*args[6:])
    before = ted.launches
    got, gerr = ted.decode_mcus_at_bitpos(*args, spw=inp.spw, lut=lut)
    assert ted.launches == before + 2
    ref, rerr = ted.decode_mcus_at_bitpos_reference(*args, spw=inp.spw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(gerr, rerr) and not bool(gerr.any())


@pytest.mark.gpu
def test_fused_kernel_on_a_corrupt_stream_on_gpu():
    _needs_card()
    data = _enc("4:2:0", 130, 250, seed=36)
    s, e = tparse(data).segments[0]
    mid = (s + e) // 2
    inp, _, args = _fused_args(data[:mid] + b"\xff\x00" * 20 + data[mid + 40:], "cuda",
                               serial=False)
    got, gerr = ted.decode_mcus_at_bitpos(*args, spw=inp.spw)
    ref, rerr = ted.decode_mcus_at_bitpos_reference(*args, spw=inp.spw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(gerr, rerr) and bool(gerr.any())


@pytest.mark.gpu
def test_dc_add_wraps_in_int16_on_gpu():
    _needs_card()
    args, kw, dc = scan_cases.dc_ramp_case()
    t = plan_tensors(args[:2] + args[3:], "cuda")
    got, err = ted.decode_mcus_at_bitpos(*t[:2], args[2], *t[2:], **kw)
    ref, rerr = ted.decode_mcus_at_bitpos_reference(*t[:2], args[2], *t[2:], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(err, rerr) and not bool(err.any())
    np.testing.assert_array_equal(_real(got[:, 0, 0].cpu().numpy(), len(dc))[:, 0], dc)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["optimised 4:2:0", "ramp", "deep codes", "random tables"])
def test_symbol_tables_kernel_vs_plain_on_gpu(name):
    _needs_card()
    tabs = plan_tensors(_lut_case(name), "cuda")
    tables, complete = ted.lut_views(ted.symbol_lut(*tabs))
    ref = ted.lut_reference(*tabs)
    torch.cuda.synchronize()
    assert torch.equal(tables[0], ref) and torch.equal(complete[0], ted.lut_complete(ref))


@pytest.mark.gpu
def test_row_form_with_tables_that_miss_on_gpu():
    """Random numbers for tables: the row form takes decode_symbol on a miss
    and still equals its plain version."""
    _needs_card()
    plan = tseg.build_plan(tparse(corpus.own_jpeg(
        corpus.synthetic_rgb(64, 96, seed=37), subsampling="4:2:0", restart_interval=1).data))
    t = plan_tensors((plan.streams,) + plan.kernel_tables[:4], "cuda")
    tabs = plan_tensors(scan_cases.random_tables(12), "cuda")
    got, gerr = ted.decode_segments_device(*t, *tabs)
    ref, rerr = ted.decode_segments_reference(
        t[0], torch.zeros(t[0].shape[0], dtype=torch.int32, device="cuda"), *t[1:4],
        t[4][None], *(x[None] for x in tabs))
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(gerr, rerr)
