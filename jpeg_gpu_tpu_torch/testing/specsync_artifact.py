"""The device index scan against the serial scan, on the six committed inputs.

The port's counterpart of ``scripts/specsync_device_artifact.py``.  For each
of the six scan inputs committed in ``testing/sweep_r05/`` (gray, 4:4:4,
4:2:0, 4:2:2 and 4:4:0, qualities 60-95) it records:

* the device index scan's per-MCU bit offsets (``device_index_scan``, K3 on
  a card, its plain version on the CPU) against the native serial scan
  (``host/entropy_native.index_scan``), bit for bit, at the engine's
  subsequence stride (``device_entropy.SCAN_SB_TARGET``);
* the engine's ``entropy="device"`` decode against the host pipeline, and
  that the decode went through the scan (``specsync_stats`` set).

Then the fallback: a 64x96 4:2:0 frame without restart markers, from the
package's encoder, scanned with ``maxrec`` forced to 1, must decode through
the serial scan to the same coefficients.  On a card it also measures the
1080p 4:2:0 frame of ``chip_smoke.py`` (no restart markers): the scan's
device time from ``torch.profiler``, the host's window build and the serial
scan it replaces.

    python -m jpeg_gpu_tpu_torch.testing.specsync_artifact [--device cuda] [--out PATH]

``--device`` is the card by default; the CPU runs only with ``--device
cpu``, and then ``serving_1080p`` is not measured.  Exits 1 when a check
fails.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Optional

import numpy as np
import torch

from jpeg_gpu_tpu_torch.testing import sweep


def _scan(parsed, device: torch.device):
    """The scan input of a stream at the engine's stride, and a function that
    runs the device index scan on it: (bitpos, ok, stats) tensors."""
    from jpeg_gpu_tpu_torch.engine import device_entropy as de
    from jpeg_gpu_tpu_torch.host.segments import build_spec_scan_input
    from jpeg_gpu_tpu_torch.ops import specsync_device
    from jpeg_gpu_tpu_torch.ops.entropy_device import plan_tensors

    inp = build_spec_scan_input(parsed, sb_target=de.SCAN_SB_TARGET)
    tabs = de.device_tables(inp.cbase, inp.counts, inp.symbols, device, scan=True)
    windows, dcslot, acslot = plan_tensors((inp.windows, inp.dcslot_of_c, inp.acslot_of_c),
                                           device)

    def scan():
        return specsync_device.device_index_scan(
            windows, inp.n_bits, dcslot, acslot, tabs.cbase, tabs.counts, tabs.symbols,
            sb=inp.subseq_bytes, maxrec=inp.maxrec, n_mcus=inp.n_mcus, lut=tabs.k3_lut)

    return inp, scan


def check_config(data: bytes, entry: dict, device: torch.device) -> dict:
    """One scan input: the plan bit for bit, and the decode against the host's."""
    import jpeg_gpu_tpu_torch as jt
    from jpeg_gpu_tpu_torch.host import entropy_native
    from jpeg_gpu_tpu_torch.host.parser import parse

    parsed = parse(data)
    t0 = time.perf_counter()
    inp, scan = _scan(parsed, device)
    bitpos, ok, stats = scan()
    bitpos, ok, stats = bitpos.cpu().numpy(), bool(ok), stats.cpu().numpy()
    wall = time.perf_counter() - t0
    ref_bitpos = entropy_native.index_scan(parsed, 1)[0]
    dec = jt.get_decoder(data, device=device, entropy="device")
    rgb = dec.decode()
    return {
        **{k: entry[k] for k in ("config", "h", "w", "quality", "mode", "encoder")},
        "n_mcus": int(inp.n_mcus),
        "subseq_bytes": int(inp.subseq_bytes),
        "maxrec": int(inp.maxrec),
        "rounds": int(stats[0]),
        "converged": ok,
        "plan_bit_identical": ok and bool(np.array_equal(bitpos, ref_bitpos.astype(np.int32))),
        "decode_equal_host": bool(np.array_equal(rgb, jt.decode(data, impl="host"))),
        "decode_via_scan": dec.specsync_stats is not None,
        "first_run_wall_s": wall,
    }


def check_fallback(device: torch.device) -> bool:
    """A scan forced to overflow its records (maxrec 1) decodes through the
    serial scan to the coefficients of the serial path."""
    from jpeg_gpu_tpu_torch.engine import device_entropy as de
    from jpeg_gpu_tpu_torch.host.parser import parse
    from jpeg_gpu_tpu_torch.testing import corpus

    parsed = parse(corpus.own_jpeg(corpus.synthetic_rgb(64, 96, seed=3), "4:2:0",
                                   quality=85).data)
    real_build = de.build_spec_scan_input

    def tiny_maxrec(p, **kw):
        inp = real_build(p, **kw)
        inp.maxrec = 1
        return inp

    de.build_spec_scan_input = tiny_maxrec
    try:
        forced = de.entropy_decode_device(parsed, device=device)
    finally:
        de.build_spec_scan_input = real_build
    normal = de.entropy_decode_device(parsed, device=device, specsync=False)
    return forced.specsync_stats is None and all(
        torch.equal(a.cpu(), b.cpu()) for a, b in zip(forced.coefs, normal.coefs))


def device_ms(fn, iters: int) -> dict:
    """Mean device time of each kernel fn() launches, by name, over ``iters``
    calls after a warm-up call, from torch.profiler's device-side events:
    what the card spends, without the wrapper's time on the host, which CUDA
    events around back-to-back calls include whenever the host is the slower
    of the two."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a window the profiler saw no device event in is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = {e.key[:72]: e.self_device_time_total / 1e3 / iters
                 for e in prof.key_averages() if e.self_device_time_total > 0}
        if times:
            return times
    raise RuntimeError("torch.profiler recorded no device time")


def serving_1080p(data: Optional[bytes], card: str, reps: int = 5) -> dict:
    """Serving numbers of one 1080p 4:2:0 frame without restart markers on
    the card: the scan's device time (torch.profiler, all its kernels, mean
    of ``reps`` scans), the host's window build and the serial scan it
    replaces (host clock, mean of ``reps``)."""
    from jpeg_gpu_tpu_torch.engine import device_entropy as de
    from jpeg_gpu_tpu_torch.host import entropy_native
    from jpeg_gpu_tpu_torch.host.parser import parse
    from jpeg_gpu_tpu_torch.host.segments import build_spec_scan_input
    from jpeg_gpu_tpu_torch.testing import corpus

    if data is None:
        data = corpus.own_jpeg(corpus.synthetic_rgb(1080, 1920, seed=1), "4:2:0",
                               quality=85).data
    parsed = parse(data)
    device = torch.device("cuda")
    t0 = time.perf_counter()
    for _ in range(reps):
        entropy_native.index_scan(parsed, 1)
    serial_ms = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        build_spec_scan_input(parsed, sb_target=de.SCAN_SB_TARGET)
    build_ms = (time.perf_counter() - t0) / reps * 1e3
    inp, scan = _scan(parsed, device)
    _, ok, stats = scan()
    if not bool(ok):
        raise RuntimeError(f"the 1080p scan did not converge: stats {stats.tolist()}")
    kernels = device_ms(scan, reps)
    return {
        "device_scan_ms_per_frame": sum(kernels.values()),
        "device_scan_ms_by_kernel": kernels,
        "rounds": int(stats.cpu()[0]),
        "host_window_build_ms": build_ms,
        "native_serial_scan_ms_replaced": serial_ms,
        "subseq_bytes": int(inp.subseq_bytes),
        "windows_upload_bytes": int(inp.windows.nbytes),
        "gpu": card,
    }


def run(device=None, fixture_dir=sweep.FIXTURES, serving_frame: Optional[bytes] = None) -> dict:
    """The artifact on ``device`` (None: the card, which raises without
    one).  ``launches`` counts K1..K6 over the configs and the fallback,
    not the timing of ``serving_1080p`` (measured on a card only;
    ``serving_frame`` is its JPEG, encoded here when None)."""
    from jpeg_gpu_tpu_torch.utils.device import resolve_device

    device = resolve_device(device, "specsync_artifact.run")
    manifest = sweep.load_manifest(fixture_dir)
    before = sweep.launch_counts()
    records = [check_config(sweep.read_fixture(fixture_dir, e), e, device)
               for e in manifest["specsync"]]
    fallback_ok = check_fallback(device)
    launches = [a - b for a, b in zip(sweep.launch_counts(), before)]
    info = sweep.toolchain(device)
    all_ok = fallback_ok and all(
        r["plan_bit_identical"] and r["decode_equal_host"] and r["decode_via_scan"]
        for r in records)
    return {
        "n_configs": len(records),
        "all_ok": all_ok,
        "fallback_serial_scan_ok": fallback_ok,
        "serving_1080p": (serving_1080p(serving_frame, info["gpu"]) if device.type == "cuda"
                          else "not measured: a CPU run has no device time"),
        "backend": device.type,
        **info,
        "launches": {f"K{k + 1}": n for k, n in enumerate(launches)},
        "configs": records,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; the CPU only with --device cpu)")
    ap.add_argument("--out", default="SPECSYNC_DEVICE_torch.json",
                    help="where to write the artifact")
    args = ap.parse_args(argv)
    artifact = run(args.device)
    for r in artifact["configs"]:
        print(json.dumps(r))
    print(f"fallback through the serial scan ok: {artifact['fallback_serial_scan_ok']}")
    print(f"serving_1080p: {json.dumps(artifact['serving_1080p'])}")
    pathlib.Path(args.out).write_text(json.dumps(artifact, indent=1) + "\n")
    print(f"specsync artifact on {artifact['backend']}: all_ok {artifact['all_ok']} -> {args.out}")
    return 0 if artifact["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
