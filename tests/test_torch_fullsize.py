"""BASELINE configs 3 and 5 at their published sizes, against the JAX package.

``jpeg_gpu_tpu_torch/testing/fullsize.py`` builds the four full-size frames
(8K 4:2:0 and 4K 4:4:4, each with a restart marker every MCU and without)
from committed coefficients, and runs every card path over them.  Here, on
the CPU: the frames built at a reduced size with each frame's geometry and
restart layout (18x30 MCUs, across tile seams), their bytes stable and their
coefficients those it was given; every path of ``fullsize.run`` over the
reduced frames, held to the JAX package's decode of the same bytes (its
host path, and in two background subprocesses its interpret-mode
``entropy="device"`` decode and its sharded decode on its 8-device CPU
mesh); and the manifest's schema.  Under ``slow``: the four full-size frames
rebuilt to the manifest's sha256, the CPU port's decode of each equal to the
manifest's JAX and libjpeg checksums, the JAX package's own decode of each
computed live, and the reference's device and sharded decodes of every
reduced frame.

Run as a script to rebuild the manifest (the JAX package on the CPU, about a
minute and a few GB):

    JAX_PLATFORMS=cpu python tests/test_torch_fullsize.py --rebuild-manifest
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jpeg_gpu_tpu as jr

import jpeg_gpu_tpu_torch as jt
from jpeg_gpu_tpu_torch.engine import device_entropy
from jpeg_gpu_tpu_torch.host.parser import parse
from jpeg_gpu_tpu_torch.ops import specsync_device
from jpeg_gpu_tpu_torch.testing import encoder, fullsize

REPO = pathlib.Path(__file__).resolve().parents[1]
NAMES = [f.name for f in fullsize.FRAMES]


def reference_decode(data: bytes, stage: str, upsample: str):
    """The JAX package's decode: its host path, bit-identical to its device
    path by its contract."""
    return jr.decode(data, out=stage, impl="host", upsample=upsample)


def jax_expected(data: bytes) -> dict:
    """A manifest entry for ``data``: its facts, the JAX package's checksums
    and libjpeg's (Pillow)."""
    return {**fullsize.facts(data),
            "jax": {kind: fullsize.checksum(reference_decode(data, stage, ups))
                    for kind, (stage, ups) in fullsize.KINDS.items()},
            "libjpeg": {"rgb-fancy": fullsize.checksum(jt.decode(data, impl="pil"))}}


# The reference's interpret-mode decodes, in subprocesses started with the
# first test (their compiles take about 10 s each): argv = [what, file, ...].
_REFERENCE = r"""
import hashlib, json, sys
import numpy as np
from jpeg_gpu_tpu.engine import device_entropy as jde
from jpeg_gpu_tpu.host.parser import parse
from jpeg_gpu_tpu.parallel import mesh as jmesh
import jpeg_gpu_tpu as jr
what, paths = sys.argv[1], sys.argv[2:]
out = {}
for path in paths:
    data = open(path, "rb").read()
    if what == "device":
        kinds = {"rgb-nearest": ("rgb", "nearest"), "rgb-fancy": ("rgb", "fancy"),
                 "yuv": ("yuv", "nearest")}
        res = {}
        for kind, (stage, ups) in kinds.items():
            r = jr.decode(data, out=stage, impl="tpu", entropy="device", upsample=ups)
            planes = r.planes if hasattr(r, "planes") else [r]
            h = hashlib.sha256()
            for p in planes:
                h.update(np.ascontiguousarray(np.asarray(p)).tobytes())
            res[kind] = h.hexdigest()
            if len(paths) == 1:
                break
    else:
        res = {}
        for ups in ("nearest", "fancy"):
            rgb = jde.decode_image_device_sharded(parse(data), jmesh.make_mesh(8, space=2),
                                                  upsample=ups)
            res[ups] = hashlib.sha256(np.ascontiguousarray(np.asarray(rgb)).tobytes()).hexdigest()
            if len(paths) == 1:
                break
    out[path] = res
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain K2 and K3 run thousands of tiny ops; one intra-op thread
    keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reduced():
    """name -> the frame's bytes at its reduced size."""
    return {f.name: fullsize.build(f.name, f.reduced) for f in fullsize.FRAMES}


@pytest.fixture(autouse=True, scope="module")
def background(reduced, tmp_path_factory):
    """The reference's device decode (nearest) and sharded decode (nearest,
    (data=4, space=2)) of the reduced 8k-420-r1 frame, started with the
    first test so that their compiles overlap the others."""
    path = tmp_path_factory.mktemp("fullsize") / "8k-420-r1.jpg"
    path.write_bytes(reduced["8k-420-r1"])
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {what: subprocess.Popen([sys.executable, "-c", _REFERENCE, what, str(path)],
                                    cwd=REPO, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for what in ("device", "sharded")}
    yield path, procs
    for p in procs.values():
        p.kill()
        p.communicate()


def _result(background, what):
    path, procs = background
    out, err = procs[what].communicate(timeout=300)
    assert procs[what].returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])[str(path)]


@pytest.fixture
def memo_scan(monkeypatch):
    """The plain K3 costs seconds a scan on the CPU whatever the frame's size
    (its rounds step through a subsequence's symbols one torch op at a time),
    and fullsize.run scans each frame without restart markers seven times
    over the same windows: the first scan of each set of inputs is kept.
    Returns the scans run."""
    real = specsync_device.device_index_scan
    seen = {}

    def scan(windows, *a, **k):
        key = (windows.numpy().tobytes(), repr(a),
               repr(sorted((n, v) for n, v in k.items() if n != "lut")))
        if key not in seen:
            seen[key] = real(windows, *a, **k)
        return seen[key]

    monkeypatch.setattr(specsync_device, "device_index_scan", scan)
    return seen


# -- the frames --------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_reduced_frame_is_stable_and_holds_its_coefficients(name, reduced):
    """The reduced frame rebuilds to the same bytes; its header is the
    frame's geometry and restart layout; the host decode gives back the
    tiled coefficients, which differ between neighbouring tiles."""
    f = fullsize.BY_NAME[name]
    data = reduced[name]
    assert fullsize.build(name, f.reduced) == data
    hdr = parse(data).header
    assert (hdr.height, hdr.width) == f.reduced
    assert (hdr.nvmb, hdr.nhmb) == (18, 30)
    assert [(c.hsamp, c.vsamp) for c in hdr.components] == list(encoder.SAMPLING[f.sampling])
    assert hdr.restart_interval == f.restart
    assert len(parse(data).segments) == (hdr.n_mcus if f.restart else 1)
    coefs, *_ = fullsize.frame_coefficients(f, f.reduced)
    got = jt.decode(data, out="quant", impl="host").coefs
    assert all(np.array_equal(a, b) for a, b in zip(got, coefs))
    # Tiles of 16x24 MCUs: the one right of the first is not a copy of it.
    luma = coefs[0]
    tile_w = 24 * encoder.SAMPLING[f.sampling][0][0]
    assert not np.array_equal(luma[:8, :6], luma[:8, tile_w:tile_w + 6])
    # Photograph-like statistics at quality 85, not flat blocks.
    nz = np.count_nonzero(luma.reshape(-1, 64), axis=1)
    assert 10 < nz.mean() < 40 and (nz > 1).mean() > 0.9


def test_vectorised_scan_equals_the_scalar_writer():
    """encode_coefficients' scan bytes equal a scalar encode of the same
    symbols with the encoder's own _BitWriter, on a small 4:2:0 frame at
    R=0 and R=2 (its ZRL runs, EOBs, padding, stuffing and markers)."""
    f = fullsize.BY_NAME["8k-420-r0"]
    coefs, qtables, samp, h, w = fullsize.frame_coefficients(f, (48, 80))
    # Runs of 16 zeros and more (ZRL), and a block that fills to 63 (no EOB).
    coefs[0][0, 1, 7, 7] = 3
    coefs[0][1, 2] = 0
    coefs[0][1, 2, 7, 7] = -1
    coefs[1][1, 1] = 5
    for restart in (0, 2):
        data = fullsize.encode_coefficients(coefs, qtables, samp, h, w, restart)
        parsed = parse(data)
        scan = data[int(parsed.segments[0][0]):int(parsed.segments[-1][1])]
        assert scan == _scalar_scan(parsed, coefs, samp, restart)
        got = jt.decode(data, out="quant", impl="host").coefs
        assert all(np.array_equal(a, b) for a, b in zip(got, coefs))


def _scalar_scan(parsed, coefs, samp, restart) -> bytes:
    """The entropy-coded bytes of ``coefs`` with the tables ``parsed`` carries,
    one symbol at a time through encoder._BitWriter."""
    from jpeg_gpu_tpu_torch.ops.zigzag import ZIGZAG

    hdr = parsed.header
    codes = {(cls, t): encoder._assign_codes(spec.counts, spec.symbols)
             for cls, tables in ((0, hdr.dc_tables), (1, hdr.ac_tables))
             for t, spec in enumerate(tables) if spec is not None}
    w = encoder._BitWriter()

    def put(cls, tab, sym, value, size):
        code, n = codes[(cls, tab)][sym]
        w.put(code, n)
        if size:
            w.put(encoder._amplitude(value, size), size)

    preds = [0] * len(samp)
    for m in range(hdr.n_mcus):
        if restart and m and m % restart == 0:
            w.flush()
            w.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            preds = [0] * len(samp)
        my, mx = divmod(m, hdr.nhmb)
        for ci, (hs, vs) in enumerate(samp):
            tab = min(ci, 1)
            for sy in range(vs):
                for sx in range(hs):
                    zz = coefs[ci][my * vs + sy, mx * hs + sx].reshape(64)[ZIGZAG].astype(int)
                    diff = int(zz[0]) - preds[ci]
                    preds[ci] = int(zz[0])
                    put(0, tab, encoder._csize(diff), diff, encoder._csize(diff))
                    run = 0
                    for k in range(1, 64):
                        if zz[k] == 0:
                            run += 1
                            continue
                        while run > 15:
                            put(1, tab, 0xF0, 0, 0)
                            run -= 16
                        s = encoder._csize(int(zz[k]))
                        put(1, tab, run << 4 | s, int(zz[k]), s)
                        run = 0
                    if run:
                        put(1, tab, 0x00, 0, 0)
    w.flush()
    return bytes(w.out)


# -- every path on the CPU, against the JAX package ------------------------------------

def test_every_path_equals_the_jax_package(reduced, memo_scan):
    """fullsize.run on the CPU over the reduced frames: host entropy,
    entropy="device" (the plain K2's row form at R=1; the plain K3 and K2's
    fused form without restart markers, with no fallback), out="yuv",
    upload="pack", exact=False (within 2 of the CPU port's, within 4 of the
    exact decode) and the sharded decode on three meshes of the CPU: every
    exact output equal to the JAX package's host decode of the same bytes,
    fancy RGB to libjpeg's, sharded to unsharded."""
    expected = {name: jax_expected(data) for name, data in reduced.items()}
    report = fullsize.run("cpu", frames=reduced, expected=expected, reps=0, log=lambda *a: None)
    assert report["ok"], report["failures"]
    assert len(memo_scan) == 2   # one scan of each frame without restart markers
    for f in fullsize.FRAMES:
        rec = report["frames"][f.name]
        assert set(rec["paths"]) == {p for p, _, _ in fullsize.PATHS}
        assert len(rec["sharded"]) == 2 * len(fullsize.MESHES)
        stats = rec["paths"]["device nearest"]["specsync_stats"]
        assert (stats is None) == bool(f.restart)
        assert (f.restart and stats is None) or stats[2] == 0   # no record overflow


def test_reference_device_decode_agrees(reduced, background):
    """The JAX package's interpret-mode entropy="device" decode of the
    reduced 8k-420-r1 frame equals the port's, which equals its host path."""
    want = _result(background, "device")["rgb-nearest"]
    got = jt.get_decoder(reduced["8k-420-r1"], device="cpu", entropy="device").decode()
    assert fullsize.checksum(got) == want
    assert want == jax_expected(reduced["8k-420-r1"])["jax"]["rgb-nearest"]


def test_reference_sharded_decode_agrees(reduced, background):
    """The reference's decode_image_device_sharded on its 8-device CPU mesh
    (space 2) equals the port's on its 8-entry CPU mesh."""
    from jpeg_gpu_tpu_torch.parallel.mesh import make_mesh

    want = _result(background, "sharded")["nearest"]
    got = device_entropy.decode_image_device_sharded(
        parse(reduced["8k-420-r1"]), make_mesh(8, space=2, devices=["cpu"] * 8))
    assert fullsize.checksum(got) == want


# -- the manifest -----------------------------------------------------------------

def test_manifest_schema():
    """One entry per frame, with its geometry, its stream's sha256, length,
    MCU and segment counts, and a 64-hex-digit checksum of each kind from
    the JAX package and libjpeg's fancy one; the sources' sha256 as
    committed."""
    import hashlib

    m = fullsize.load_manifest()
    assert set(m["frames"]) == set(NAMES)
    for name, sha in m["sources"].items():
        assert hashlib.sha256((fullsize.SOURCES / name).read_bytes()).hexdigest() == sha
    for f in fullsize.FRAMES:
        e = m["frames"][f.name]
        assert (e["height"], e["width"], e["sampling"], e["restart"], e["source"]) == (
            f.height, f.width, f.sampling, f.restart, f.source)
        assert e["mcus"] == 129600 and e["segments"] == (129600 if f.restart else 1)
        assert 1_000_000 < e["bytes"] < 16_000_000 and len(e["sha256"]) == 64
        assert set(e["jax"]) == set(fullsize.KINDS) and set(e["libjpeg"]) == {"rgb-fancy"}
        for sha in [*e["jax"].values(), *e["libjpeg"].values()]:
            assert len(sha) == 64 and int(sha, 16) >= 0
        # The same content with and without restart markers decodes the same.
        other = m["frames"][f.name[:-1] + ("0" if f.restart else "1")]
        assert other["jax"] == e["jax"] and e["jax"]["rgb-fancy"] == e["libjpeg"]["rgb-fancy"]


def test_run_needs_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fullsize.run()


# -- full size (slow) ---------------------------------------------------------------

@pytest.fixture(scope="module")
def full_frames():
    return {name: fullsize.build(name) for name in NAMES}


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_full_frame_rebuilds_to_the_manifest(name, full_frames):
    entry = fullsize.load_manifest()["frames"][name]
    facts = fullsize.facts(full_frames[name])
    assert {k: entry[k] for k in facts} == facts


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_full_frame_cpu_port_equals_the_manifest(name, full_frames):
    """The CPU port's decode of each full-size frame (host entropy) equals
    the manifest's JAX checksum of each kind, and its fancy RGB libjpeg's."""
    entry = fullsize.load_manifest()["frames"][name]
    ref = fullsize.cpu_reference(full_frames[name])
    assert {k: ref[k] for k in fullsize.KINDS} == entry["jax"]
    assert ref["rgb-fancy"] == entry["libjpeg"]["rgb-fancy"]
    assert int(np.abs(ref["float"].astype(np.int16)
                      - jt.decode(full_frames[name], device="cpu").astype(np.int16)).max()) <= 4


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_full_frame_jax_package_equals_the_manifest(name, full_frames):
    """The JAX package's own decode of each full-size frame, live."""
    assert jax_expected(full_frames[name]) == {
        k: v for k, v in fullsize.load_manifest()["frames"][name].items()
        if k in ("bytes", "sha256", "mcus", "segments", "jax", "libjpeg")}


@pytest.mark.slow
def test_reference_device_and_sharded_decodes_of_every_reduced_frame(reduced, tmp_path):
    """The reference's interpret-mode entropy="device" decode (RGB nearest
    and fancy, YUV) and its sharded decode (nearest, fancy) of each reduced
    frame, against the port's."""
    from jpeg_gpu_tpu_torch.parallel.mesh import make_mesh

    paths = []
    for name, data in reduced.items():
        paths.append(tmp_path / f"{name}.jpg")
        paths[-1].write_bytes(data)
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = {}
    for what in ("device", "sharded"):
        proc = subprocess.run([sys.executable, "-c", _REFERENCE, what, *map(str, paths)],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=1800)
        assert proc.returncode == 0, proc.stderr[-3000:]
        res[what] = json.loads(proc.stdout.strip().splitlines()[-1])
    mesh = make_mesh(8, space=2, devices=["cpu"] * 8)
    for name, path in zip(reduced, paths):
        data = reduced[name]
        for kind, (stage, ups) in fullsize.KINDS.items():
            got = jt.get_decoder(data, device="cpu", entropy="device", upsample=ups).decode(stage)
            assert fullsize.checksum(got) == res["device"][str(path)][kind], (name, kind)
        for ups in ("nearest", "fancy"):
            got = device_entropy.decode_image_device_sharded(parse(data), mesh, upsample=ups)
            assert fullsize.checksum(got) == res["sharded"][str(path)][ups], (name, ups)


if __name__ == "__main__":
    if sys.argv[1:] != ["--rebuild-manifest"]:
        sys.exit(__doc__)
    manifest = fullsize.build_manifest(reference_decode)
    for name, e in manifest["frames"].items():
        print(name, e["bytes"], e["sha256"])
