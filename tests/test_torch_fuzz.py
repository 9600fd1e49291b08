"""Garbage in on the port, against the JAX package, on the CPU.

The reference's contract (``tests/test_fuzz.py``): arbitrary bytes raise
``JpegError`` or decode, never anything else.  Here its five tests run on the
port with the same seeds, the port's seeded generator
(``jpeg_gpu_tpu_torch.testing.fuzz``) is held to the reference's error
classes on the host path and on a few ``entropy="device"`` cases, and each
fault the fuzz found has a test, run in a subprocess under an address-space
cap of MEMORY_CAP_GIB where the fault was an allocation sized by a frame the
stream cannot hold.  A larger seeded run is ``slow``; the card's outcomes
against the CPU's are the ``gpu`` test.
"""

import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jpeg_gpu_tpu as jr
from jpeg_gpu_tpu.errors import JpegError as RefJpegError
from jpeg_gpu_tpu.testing import corpus as rcorpus

import jpeg_gpu_tpu_torch as jt
from jpeg_gpu_tpu_torch.engine import device_entropy
from jpeg_gpu_tpu_torch.errors import JpegError
from jpeg_gpu_tpu_torch.host import entropy_native
from jpeg_gpu_tpu_torch.host.parser import parse
from jpeg_gpu_tpu_torch.host.segments import build_spec_scan_input
from jpeg_gpu_tpu_torch.ops import entropy_device, specsync_device
from jpeg_gpu_tpu_torch.testing import corpus, fuzz

REPO = pathlib.Path(__file__).resolve().parents[1]
# The address space of the subprocess that decodes the faults' streams.
# Importing torch maps about 0.9 GB; the faults asked for 3 GB (the plain
# fused K2's word index at 16000x16000) and 51 GB (K2's output for a DRI of
# 65535) on top.
MEMORY_CAP_GIB = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of tiny ops; one intra-op thread
    keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def srcs():
    return fuzz.sources()


# -- the faults' streams, decoded under the memory cap -------------------------

_CAPPED = r"""
import json, resource, sys
cap = int(sys.argv[1]) << 30
resource.setrlimit(resource.RLIMIT_AS, (cap, cap))
import torch
torch.set_num_threads(1)
import numpy as np
from jpeg_gpu_tpu_torch.testing import fuzz

def outcome(path, data, valid):
    try:
        name, arrays = fuzz.call(path, data, valid, "cpu")
    except Exception as e:
        return f"violation:{type(e).__name__}: {str(e)[:200]}", None
    return name, arrays

srcs = {s.name: s for s in fuzz.sources()}
valid = srcs["own-420-r0"].data
res = {}
for name, data in (("16000", fuzz.claimed_frame_case()), ("65535", fuzz.claimed_frame_case(65535)),
                   ("two-segment", fuzz.two_segment_case())):
    res[name] = {p: outcome(p, data, valid)[0] for p in fuzz.PATHS}
# A DRI of 65535 before the SOS of a valid frame without restart markers:
# still a valid stream, of one segment.
segs, _, _ = fuzz.markers(valid)
(sos, _), = fuzz._find(segs, fuzz.SOS)
dri = valid[:sos] + bytes([0xFF, fuzz.DRI, 0, 4, 0xFF, 0xFF]) + valid[sos:]
want = fuzz.call("auto", valid, valid, "cpu")[1]
res["dri65535"] = {}
for p in ("auto", "device", "zero", "batch_device", "resident"):
    name, arrays = outcome(p, dri, valid)
    images = [] if arrays is None else list(arrays[0]) if p == "resident" else arrays
    equal = bool(images) and all(np.array_equal(x, want[0]) for x in images)
    res["dri65535"][p] = [name, equal]
print(json.dumps(res))
"""


# The reference's entropy="device" decodes of the first cases of its own
# device-entropy fuzz test (_device_bitflips; in interpret mode, whose compile
# is most of the time), printed as [outcome, sha256 of the RGB or None].
_REFERENCE_DEVICE = r"""
import hashlib, json, sys
import numpy as np
import jpeg_gpu_tpu as jr
from jpeg_gpu_tpu.testing import corpus
enc = corpus.own_jpeg(corpus.synthetic_gray(24, 24, seed=4), quality=85)
rng = np.random.default_rng(4)
out = []
for _ in range(int(sys.argv[1])):
    buf = bytearray(enc.data)
    pos = int(rng.integers(2, len(buf)))
    buf[pos] ^= 1 << int(rng.integers(0, 8))
    data = bytes(buf)
    try:
        rgb = jr.decode(data, impl="tpu", entropy="device")
        out.append(["decoded", hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()])
    except jr.JpegError as e:
        out.append([type(e).__name__, None])
print(json.dumps(out))
"""
DEVICE_CASES = 4


@pytest.fixture(scope="module")
def background():
    """Start the two subprocesses at once, so that they run beside the
    file's other tests: the faults' streams under MEMORY_CAP_GIB, and the
    reference's device-entropy decodes."""
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    procs = {
        "capped": subprocess.Popen(
            [sys.executable, "-c", _CAPPED, str(MEMORY_CAP_GIB)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "reference_device": subprocess.Popen(
            [sys.executable, "-c", _REFERENCE_DEVICE, str(DEVICE_CASES)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True, scope="module")
def _start(background):
    """The subprocesses start with the file's first test."""


def _result(background, name):
    out, err = background[name].communicate(timeout=300)
    assert background[name].returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def capped(background):
    """The faults' streams through the port's paths in a subprocess whose
    address space is MEMORY_CAP_GIB: path -> outcome."""
    return _result(background, "capped")


def test_k2_not_enqueued_after_a_failed_scan(monkeypatch):
    """The device index scan's verdict is read before K2's fused form is
    enqueued: a scan that fails never has K2 decode at its bit positions.
    The claimed-frame stream (at 2048x2048) is scanned here, its too-short
    test disabled; its scan cannot find the frame's MCUs."""
    calls = []
    monkeypatch.setattr(device_entropy, "mcu_starts_fit", lambda *a: True)
    monkeypatch.setattr(entropy_device, "decode_mcus_at_bitpos",
                        lambda *a, **k: calls.append(a) or pytest.fail("K2 after a failed scan"))
    parsed = parse(fuzz.claimed_frame_case(2048))
    assert device_entropy._spec_decode_try(parsed, "cpu") is None
    assert calls == []


def test_sharded_scan_verdict_before_the_gather(monkeypatch):
    """The sharded decode of a stream without restart markers reads the
    scan's verdict before it gathers any MCU's row or decodes it."""
    from jpeg_gpu_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(device_entropy, "mcu_starts_fit", lambda *a: True)
    monkeypatch.setattr(specsync_device, "gather_entropy_streams",
                        lambda *a, **k: pytest.fail("gathered after a failed scan"))
    parsed = parse(fuzz.claimed_frame_case(2048))
    mesh = make_mesh(devices=["cpu"] * 2, space=1)
    assert device_entropy._spec_decode_sharded_try(parsed, mesh, True, "nearest", True) is None


def test_plain_fused_k2_reads_words_as_lanes_need_them(monkeypatch):
    """The plain fused K2 builds no index over every word a lane might read
    (it was (MCUs, 376) int64 at 4:2:0): it reads each word when a lane needs
    it, and still equals the chain gather -> row form -> DC bases, on a
    valid stream and at garbage bit positions."""
    enc = corpus.own_jpeg(corpus.synthetic_rgb(40, 48, seed=1), "4:2:0", quality=85)
    inp = build_spec_scan_input(parse(enc.data), sb_target=device_entropy.SCAN_SB_TARGET)
    t = [torch.from_numpy(np.array(a, dtype=np.int32)) for a in (
        inp.windows, inp.comp_of_step, inp.dc_slot_of_step, inp.ac_slot_of_step,
        inp.cbase, inp.counts, inp.symbols)]
    bitpos = torch.from_numpy(entropy_native.index_scan(parse(enc.data), 1)[0].astype(np.int32))
    rng = np.random.default_rng(11)
    garbage = torch.from_numpy(rng.integers(0, inp.n_bits + 4096, size=inp.n_mcus)
                               .astype(np.int32))
    nws = inp.windows.shape[1]
    for pos in (bitpos, garbage):
        nsteps = t[1].shape[0]
        nw = min(nsteps * 64 * 31 // 32, t[0].shape[0] * 1024 * inp.spw) + 3
        streams = entropy_device.gather_entropy_streams(t[0], pos, nw=nw, spw=inp.spw, nws=nws)
        seg_meta = torch.tensor([[-1, -1, 0]], dtype=torch.int32)
        b2 = streams.shape[0]
        ref, _ = entropy_device.decode_segments_reference(
            streams, torch.zeros(b2, dtype=torch.int32), *t[1:4], seg_meta,
            t[4][None], t[5][None], t[6][None])
        with monkeypatch.context() as m:
            m.setattr(entropy_device, "gather_entropy_streams",
                      lambda *a, **k: pytest.fail("the plain fused K2 gathered every word"))
            got, err = entropy_device.decode_mcus_at_bitpos(
                t[0], pos, inp.n_bits, *t[1:], spw=inp.spw)
        dcb = entropy_device.dc_base_from_coefs(ref, list(inp.t_last))
        real = (torch.arange(b2 * 1024) < inp.n_mcus).reshape(b2, 8, 128, 1)
        full = torch.zeros((b2, 8, 128, 4), dtype=torch.int32)
        full[..., : dcb.shape[-1]] = torch.where(real, dcb, 0)
        ref = entropy_device.apply_dc_base(ref, full, t[1] & 3)
        ref = torch.where(real.reshape(b2, 1, 1, 8, 128), ref, 0)
        assert torch.equal(got, ref)
    assert int(err.reshape(-1)[: inp.n_mcus].ne(0).sum()) > 0   # the garbage is flagged


def test_mcu_starts_fit_is_what_the_scan_can_find():
    """mcu_starts_fit holds exactly where a scan of that many bits could
    record that many MCU starts, each MCU at least 2 bits a block."""
    for bpm in (1, 3, 6):
        for n_bits in (1, 2 * bpm, 2 * bpm + 1, 1000):
            most = (n_bits - 1) // (2 * bpm) + 1
            assert device_entropy.mcu_starts_fit(n_bits, most, bpm)
            assert not device_entropy.mcu_starts_fit(n_bits, most + 1, bpm)
    assert not device_entropy.mcu_starts_fit(0, 1, 1)


# -- the reference's five tests (tests/test_fuzz.py:20-72), on the port -------

def _attempt(data: bytes, **kwargs) -> None:
    for impl in ("host", "torch"):
        try:
            if impl == "host":
                jt.decode(data, impl="host")
            else:
                jt.decode(data, device="cpu", **kwargs)
        except JpegError:
            pass


def test_random_bytes():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 16, 256, 4096):
        for _ in range(8):
            _attempt(rng.integers(0, 256, size=n, dtype=np.uint8).tobytes())


def test_truncations_of_valid_stream():
    img = corpus.synthetic_rgb(24, 32, seed=1)
    enc = corpus.own_jpeg(img, subsampling="4:2:0", quality=85, restart_interval=1)
    data = enc.data
    rng = np.random.default_rng(1)
    for cut in sorted(set(int(x) for x in rng.integers(1, len(data), size=24))):
        _attempt(data[:cut])


def test_bitflips_of_valid_stream():
    img = corpus.synthetic_gray(24, 24, seed=2)
    enc = corpus.own_jpeg(img, quality=85)
    rng = np.random.default_rng(2)
    for _ in range(24):
        buf = bytearray(enc.data)
        pos = int(rng.integers(2, len(buf)))
        buf[pos] ^= 1 << int(rng.integers(0, 8))
        _attempt(bytes(buf))


def test_bitflips_vsamp4_stream():
    img = corpus.synthetic_rgb(24, 24, seed=3)
    enc = corpus.own_jpeg(img, subsampling="h2v4", quality=85, restart_interval=1)
    rng = np.random.default_rng(3)
    for _ in range(16):
        buf = bytearray(enc.data)
        pos = int(rng.integers(2, len(buf)))
        buf[pos] ^= 1 << int(rng.integers(0, 8))
        _attempt(bytes(buf))


def _device_bitflips(n: int):
    """The cases of the reference's test_bitflips_device_entropy_no_dri."""
    img = corpus.synthetic_gray(24, 24, seed=4)
    enc = corpus.own_jpeg(img, quality=85)
    rng = np.random.default_rng(4)
    for _ in range(n):
        buf = bytearray(enc.data)
        pos = int(rng.integers(2, len(buf)))
        buf[pos] ^= 1 << int(rng.integers(0, 8))
        yield bytes(buf)


def test_bitflips_device_entropy_no_dri():
    for data in _device_bitflips(10):
        try:
            jt.decode(data, device="cpu", entropy="device")
        except JpegError:
            pass


# -- against the reference ---------------------------------------------------

def _outcome(fn, error):
    try:
        return "decoded", fn()
    except error as e:
        return type(e).__name__, None


HOST_CASES = 68   # four of each mutation kind


def test_host_outcomes_equal_reference(srcs):
    """Seeded garbage through the host path of both packages: the same
    error class (the classes are per package, ROADMAP.md Queue 3, so their
    names are compared), or both decoded to the same pixels."""
    for name, data in fuzz.cases(5, HOST_CASES, srcs):
        a, x = _outcome(lambda: jt.decode(data, impl="host"), JpegError)
        b, y = _outcome(lambda: jr.decode(data, impl="host"), RefJpegError)
        assert a == b, name
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=name)


# -- the generator and the runner ---------------------------------------------

def test_cases_are_deterministic(srcs):
    a = list(fuzz.cases(3, 40, srcs))
    assert a == list(fuzz.cases(3, 40, srcs))
    assert a != list(fuzz.cases(4, 40, srcs))
    assert len({name for name, _ in a}) == 40


def test_cases_cover_every_kind_and_geometry(srcs):
    geometry = {s.name: s.geometry for s in srcs}
    restart = {s.name: s.restart for s in srcs}
    used = [name.split(":") for name, _ in fuzz.cases(0, 340, srcs)]
    assert {u[2] for u in used} == set(fuzz.KINDS)
    assert {geometry[u[1]] for u in used if u[1] != "-"} == {
        "gray", "4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1", "h2v4"}
    assert {restart[u[1]] > 0 for u in used if u[1] != "-"} == {True, False}
    assert {u[1][:5] for u in used if u[1] != "-"} == {"sweep", "own-4", "own-g", "own-h"}


def test_run_on_the_cpu(srcs):
    res = fuzz.run("cpu", seed=1, n=17, paths=("auto", "zero"), srcs=srcs)
    assert res["ok"] and res["pairs"] == 34, res
    assert res["violations"] == [] and res["cuda_error"] is None
    assert sum(res["by_path"]["zero"].values()) == 17


def test_kernel_run_on_the_cpu(srcs):
    """The wrapper-level garbage (spoiled words, bit positions of no MCU,
    batches without tables) through the plain versions: no exception, and
    the harness's three calls agree."""
    res = fuzz.kernel_run("cpu", seed=3, n=3, srcs=srcs)
    assert res["ok"] and res["by_form"] == {"scan": 1, "fused": 1, "row": 1}, res


def test_poisoned_empty_fills_cuda_tensors_only():
    """On the CPU the poison leaves torch.empty alone (it fills CUDA tensors
    only) and is undone after the block."""
    real = torch.empty
    with fuzz.poisoned_empty(fuzz.POISON[0]) as zones:
        assert torch.empty is not real
        t = torch.empty(8, dtype=torch.int32)
        assert t.shape == (8,)
    assert torch.empty is real and zones.buffers == [] and zones.written() == 0


def test_cli_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuzz.main(["--n", "1", "--out", str(tmp_path / "f.json")])
    assert not (tmp_path / "f.json").exists()


# -- last, the two subprocesses' results ------------------------------------

def test_device_entropy_outcomes_equal_reference(background):
    """The first cases of the reference's device-entropy fuzz test, through
    ``entropy="device"`` in both packages (the reference in interpret mode,
    in a subprocess): the same outcome, and the same pixels where both
    decode."""
    enc = rcorpus.own_jpeg(rcorpus.synthetic_gray(24, 24, seed=4), quality=85)
    assert enc.data == corpus.own_jpeg(corpus.synthetic_gray(24, 24, seed=4), quality=85).data
    got = []
    for data in _device_bitflips(DEVICE_CASES):
        name, rgb = _outcome(lambda: jt.decode(data, device="cpu", entropy="device"), JpegError)
        got.append([name, None if rgb is None else
                    hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()])
    assert got == _result(background, "reference_device")


def test_claimed_frame_raises_format_error_on_every_path(capped):
    """A 48x40 4:2:0 stream without restart markers whose SOF claims
    16000x16000: the reference raises JpegFormatError (its device path after
    the scan fails, from the serial index scan).  The port did the same on
    its host paths, but its device paths allocated by the claimed frame
    first (K2's output before the scan's verdict; the plain fused K2's word
    index, 3 GB; a mega segment of a million MCUs in the corpus paths)."""
    assert capped["16000"] == {p: "JpegFormatError" for p in fuzz.PATHS}


def test_claimed_frame_65535_raises_format_error_on_every_path(capped):
    """The same at 65535x65535, where the host entropy stage's coefficient
    arrays alone are 12 GB: a stream of one segment that cannot hold its
    frame raises before anything is sized by the frame
    (device_entropy.check_scan_fits)."""
    assert capped["65535"] == {p: "JpegFormatError" for p in fuzz.PATHS}


def test_two_segments_of_a_claimed_frame_raise_format_error_on_every_path(capped):
    """A DRI of 65535 on a stream of two segments whose SOF claims 131070
    MCUs (two mutations at once): no single segment is too short, so the
    one-segment test let it through, and entropy="device", the corpus paths
    and mesh= sized K2's output by the interval (51 GB), the host entropy
    stage its coefficients by the frame.  The bits of all the segments
    together are held to the frame's MCUs now
    (device_entropy.check_scan_fits), before any plan or allocation."""
    assert capped["two-segment"] == {p: "JpegFormatError" for p in fuzz.PATHS}


def test_interval_longer_than_frame_decodes(capped):
    """A valid stream whose DRI (65535) exceeds its 9 MCUs: one segment.
    build_plan sized its rows' block steps by the interval (65535 x 6 steps,
    51 GB of K2 output); it now takes the frame's MCUs, and the device and
    corpus paths decode it equal to the host decode."""
    assert capped["dri65535"] == {p: ["decoded", True] for p in capped["dri65535"]}


@pytest.mark.slow
def test_larger_seeded_run_on_the_cpu(srcs):
    res = fuzz.run("cpu", seed=7, n=170, paths=fuzz.PATHS, srcs=srcs)
    assert res["ok"], (res["violations"], res["mismatches"])
    assert res["pairs"] == 170 * len(fuzz.PATHS)


@pytest.mark.gpu
def test_card_outcomes_equal_cpu():
    """64 (case, path) pairs on the card, each held to the port's CPU
    outcome and run twice with torch.empty's CUDA tensors poisoned: the
    device-entropy paths and the corpus paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 and K3 run on the card")
    paths = ("device", "zero", "batch_device", "resident")
    with fuzz.poisoned_empty(fuzz.POISON[0]) as zones:   # the red zones see a write past the end
        t = torch.empty(1000, dtype=torch.int16, device="cuda")
    assert bool((t.view(torch.uint8) == fuzz.POISON[0]).all())
    zones.buffers[0][fuzz.RED_ZONE + 2000] = 0
    assert zones.written() == 1
    res = fuzz.run("cuda", seed=9, n=16, paths=paths, compare_cpu=True, poisoned=paths)
    assert res["cuda_error"] is None, res["cuda_error"]
    assert res["ok"], (res["violations"], res["mismatches"], res["poison_mismatches"])
    assert res["compared_cpu"] == 64 and res["poisoned_pairs"] == 64
    assert res["launches"]["device"]["K2"] > 0
    kres = fuzz.kernel_run("cuda", seed=9, n=12)
    assert kres["cuda_error"] is None and kres["ok"], kres
    assert kres["launches"]["K2"] > 0 and kres["launches"]["K3"] > 0
