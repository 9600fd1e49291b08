#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (jpeg_gpu_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

1. Environment: CUDA and nvcc versions, the card, and the build times and
   ptxas lines of the kernels -- K1 (csrc/pixel_fused.cu), K2
   (csrc/entropy_decode.cu) and K3 (csrc/specsync_scan.cu), one nvcc each,
   all started together -- and of the native host entropy decoder (g++).
2. K1 against its plain PyTorch version on the same CUDA tensors, for the
   five fused geometries x {nearest, fancy} at 17x31, 130x250 and 10x4200.
3. K2 against its plain version: coefficients and the full flag tensor, for
   the six modes x restart intervals {1, 3} at 130x250, a plan without
   restart markers with its DC bases applied, a corrupted stream, and
   1080p 4:2:0 at R=1.
4. K3 against its plain version: bitpos, ok and stats of the whole
   device_index_scan, for 4:2:0, 4:2:2, 4:4:4 and mono at 130x250 with
   32-byte subsequences, and 1080p 4:2:0 at the default stride.
5. The main path, ``jpeg_gpu_tpu_torch.decode(data, device="cuda")``:
   with host entropy on a 1080p 4:2:0 frame (nearest and fancy) and a
   3840x2160 4:2:2 fancy frame (K1); with ``entropy="device"`` on 1080p
   4:2:0 without restart markers, nearest and fancy (K3 -> K2 -> K1),
   1080p 4:2:0 with a restart marker per MCU (K2 -> K1) and 4K 4:2:2 fancy
   without restart markers.  Each equals the CPU path and is close to the
   encoder's input; every kernel's launch count rose; the frames without
   restart markers went through the device index scan (no serial
   fallback).  Then one corrupted restart-marked frame with
   ``on_error="zero"`` equals the CPU port's salvage.
6. Timings with CUDA events after warm-up, each kernel and its plain
   version in turns (plain, kernel, kernel, plain): K1 for coefs->RGB of
   1080p 4:2:0 nearest at batch 8 and of the 4K 4:2:2 fancy frame; K2 on
   the 1080p R=1 plan; K3 as a whole device_index_scan at 1080p.  Host
   clock: parse + native entropy, parse + build_spec_scan_input and parse +
   build_plan per 1080p frame, and the whole decode per 1080p frame with
   host entropy and with ``entropy="device"`` (with and without restart
   markers); upload bytes of the bits cut against the coefficient cut; the
   split of an ``entropy="device"`` decode into its stages (host clock, a
   sync after each); the card's busy share over five decodes, from
   torch.profiler's device-side events.

Images come from the package's own baseline encoder, seeded.  Any failure
raises and exits non-zero; without a CUDA device it exits non-zero at once.
The last three lines are the kernels' JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

GEOMETRIES = [("4:4:4", 1, 1), ("4:2:2", 2, 1), ("4:2:0", 2, 2),
              ("4:4:0", 1, 2), ("4:1:1", 4, 1)]
SIZES = [(17, 31), (130, 250), (10, 4200)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over ``iters`` back-to-back launches."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    import jpeg_gpu_tpu_torch as jt
    from jpeg_gpu_tpu_torch import cuda_build
    from jpeg_gpu_tpu_torch.engine import pipeline
    from jpeg_gpu_tpu_torch.host import entropy_native, segments
    from jpeg_gpu_tpu_torch.host.parser import parse
    from jpeg_gpu_tpu_torch.ops import entropy_device, pixel_fused, specsync_device
    from jpeg_gpu_tpu_torch.ops.entropy_device import plan_tensors
    from jpeg_gpu_tpu_torch.testing import corpus

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # -- 1. environment and builds ------------------------------------------
    nvcc_version = subprocess.run(
        [cuda_build.nvcc_path(), "--version"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvcc: {nvcc_version}")
    print(f"card: {card}")
    t0 = time.perf_counter()
    cuda_build.load_all(["pixel_fused", "entropy_decode", "specsync_scan"])
    print(f"kernel builds, in parallel: {time.perf_counter() - t0} s wall")
    pixel_fused._kernel()
    entropy_device._kernel()
    specsync_device._kernel()
    for name, stem in (("K1", "pixel_fused"), ("K2", "entropy_decode"),
                       ("K3", "specsync_scan")):
        info = cuda_build.BUILD_INFO[stem]
        print(f"{name} build (nvcc, sm_90a, csrc/{stem}.cu): {info['seconds']} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    t0 = time.perf_counter()
    assert entropy_native.available(), "native host entropy decoder did not build"
    print(f"native entropy build + load (g++): {time.perf_counter() - t0} s")

    def soa_inputs(images, mode, upsample):
        """Encode ``images`` (one geometry) -> (spec, geom, comps, qts) on
        the card, batched along a leading axis when there are several."""
        soas, spec, qts = [], None, None
        for img in images:
            data = corpus.own_jpeg(img, subsampling=mode, quality=85).data
            parsed = parse(data)
            hdr = parsed.header
            spec = pipeline.PipelineSpec.from_header(hdr, upsample=upsample)
            qts = [hdr.quant_for(c).values.astype(np.int32).reshape(64)
                   for c in hdr.components]
            soas.append(entropy_native.decode_scan(parsed, soa=True).coefs)
        geom = pipeline.fused_rgb_geometry(spec)
        assert geom is not None, (mode, spec)
        planes = [np.stack(p) if len(images) > 1 else p[0] for p in zip(*soas)]
        comps, qt = pipeline.to_torch_inputs(planes, qts, dev)
        return spec, geom, comps, qt

    # -- 2. K1 against its plain version -------------------------------------
    max_err = 0
    for mode, _, _ in GEOMETRIES:
        for h, w in SIZES:
            img = corpus.synthetic_rgb(h, w, seed=args.seed + h + w)
            for ups in ("nearest", "fancy"):
                spec, geom, comps, qt = soa_inputs([img], mode, ups)
                a, kw = pipeline.fused_soa_args(spec, geom, comps, qt)
                got = pixel_fused.decode_rgb_fused_soa(*a, **kw)
                ref = pixel_fused.decode_rgb_fused_soa_reference(*a, **kw)
                torch.cuda.synchronize()
                assert got.shape == ref.shape == (h, w, 3), (got.shape, ref.shape)
                err = int((got.int() - ref.int()).abs().max())
                max_err = max(max_err, err)
                print(f"K1 vs plain {mode} {ups:7s} {h}x{w} "
                      f"(fancy filter {'on' if kw['fancy'] else 'off'}): "
                      f"max abs err {err}")
                assert err == 0, (mode, ups, h, w)

    def encode(h, w, mode, seed, restart=0):
        img = corpus.synthetic_rgb(h, w, seed=seed)
        if mode == "mono":
            img, mode = img[..., 1].copy(), "4:2:0"
        return img, corpus.own_jpeg(img, subsampling=mode, quality=85,
                                    restart_interval=restart).data

    def corrupt_segment(data, si):
        """All-ones bits over restart segment ``si``: invalid codes."""
        s, e = parse(data).segments[si]
        out = bytearray(data)
        out[s:e] = (b"\xff\x00" * ((e - s) // 2 + 1))[: e - s]
        return bytes(out)

    # -- 3. K2 against its plain version -------------------------------------
    def k2_case(name, plan, corrupt_ok=False):
        t = plan_tensors((plan.streams,) + plan.kernel_tables, dev)
        got, gerr = entropy_device.decode_segments_device(*t)
        ref, rerr = entropy_device.decode_segments_reference(
            t[0], torch.zeros(t[0].shape[0], dtype=torch.int32, device=dev),
            t[1], t[2], t[3], t[4][None], t[5][None], t[6][None], t[7][None])
        if plan.dc_base is not None:
            nb = got.shape[0]
            dcb = np.zeros((nb * 1024, plan.dc_base.shape[1]), np.int32)
            dcb[: plan.n_segments] = plan.dc_base
            dcb = torch.from_numpy(dcb.reshape(nb, 8, 128, -1)).to(dev)
            got = entropy_device.apply_dc_base(got, dcb, t[1])
            ref = entropy_device.apply_dc_base(ref, dcb, t[1])
        torch.cuda.synchronize()
        err = int((got.int() - ref.int()).abs().max())
        nflag = int((gerr.reshape(-1)[: plan.n_segments] != 0).sum())
        print(f"K2 vs plain {name}: coefs {tuple(got.shape)} max abs err {err}, "
              f"flags equal {torch.equal(gerr, rerr)} ({nflag} of "
              f"{plan.n_segments} segments flagged)")
        assert err == 0 and torch.equal(gerr, rerr), name
        assert corrupt_ok or nflag == 0, name
        return err

    k2_err = 0
    for mode in ("mono", "4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1"):
        for r in (1, 3):
            _, data = encode(130, 250, mode, args.seed + 20, restart=r)
            k2_err = max(k2_err, k2_case(f"{mode} R={r} 130x250",
                                         segments.build_plan(parse(data))))
    _, data = encode(130, 250, "4:2:0", args.seed + 21)
    k2_err = max(k2_err, k2_case("4:2:0 130x250 without restart markers (dc_base)",
                                 segments.build_plan_no_dri(parse(data))))
    _, data = encode(130, 250, "4:2:0", args.seed + 22, restart=1)
    bad = corrupt_segment(data, 5)
    k2_err = max(k2_err, k2_case("4:2:0 130x250 R=1, segment 5 corrupted",
                                 segments.build_plan(parse(bad, validate=False)),
                                 corrupt_ok=True))
    img1080r, data1080r = encode(1080, 1920, "4:2:0", args.seed + 1, restart=1)
    plan1080 = segments.build_plan(parse(data1080r))
    k2_err = max(k2_err, k2_case("1080p 4:2:0 R=1", plan1080))

    # -- 4. K3 against its plain version -------------------------------------
    def scan_inputs(data, subseq_bytes=None):
        inp = segments.build_spec_scan_input(parse(data), subseq_bytes=subseq_bytes)
        w, = plan_tensors((inp.windows,), dev)
        tabs = plan_tensors((inp.dcslot_of_c, inp.acslot_of_c, inp.cbase,
                             inp.counts, inp.symbols), dev)
        kw = dict(sb=inp.subseq_bytes, maxrec=inp.maxrec, n_mcus=inp.n_mcus)
        return (w, inp.n_bits, *tabs), kw

    def k3_case(name, data, subseq_bytes=None):
        a, kw = scan_inputs(data, subseq_bytes)
        got = specsync_device.device_index_scan(*a, **kw)
        ref = specsync_device.device_index_scan(*a, **kw, plain=True)
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip(got, ref)]
        err = int((got[0].long() - ref[0].long()).abs().max())
        stats = got[2].tolist()
        # Unconverged scans (ok False) leave bitpos undefined; the engine
        # then falls back to the serial scan.
        serial = "n/a, not converged"
        if bool(got[1]):
            native = entropy_native.index_scan(parse(data), 1)[0].astype(np.int32)
            serial = np.array_equal(got[0].cpu().numpy(), native)
        print(f"K3 vs plain {name} (SB {kw['sb']}): bitpos/ok/stats equal {same}; "
              f"ok {bool(got[1])}, stats (rounds, records, overflow) {stats}; "
              f"bitpos == serial scan: {serial}")
        assert all(same) and serial is not False, name
        return stats, err

    k3_err = 0
    for mode in ("4:2:0", "4:2:2", "4:4:4", "mono"):
        _, err = k3_case(f"{mode} 130x250", encode(130, 250, mode, args.seed + 23)[1], 32)
        k3_err = max(k3_err, err)
    img1080, data1080 = encode(1080, 1920, "4:2:0", args.seed + 1)
    k3_stats, err = k3_case("1080p 4:2:0", data1080)
    k3_err = max(k3_err, err)

    # -- 5. the main path ----------------------------------------------------
    img4k, data4k = encode(2160, 3840, "4:2:2", args.seed + 1)
    frames = [("1080p 4:2:0", img1080, data1080, "nearest", "auto"),
              ("1080p 4:2:0", img1080, data1080, "fancy", "auto"),
              ("4K 4:2:2", img4k, data4k, "fancy", "auto"),
              ("1080p 4:2:0", img1080, data1080, "nearest", "device"),
              ("1080p 4:2:0", img1080, data1080, "fancy", "device"),
              ("1080p 4:2:0 R=1", img1080r, data1080r, "nearest", "device"),
              ("4K 4:2:2", img4k, data4k, "fancy", "device")]
    kernels = (pixel_fused, entropy_device, specsync_device)
    for mod in kernels:
        mod.launches = 0
    outs, scan_stats = [], []
    for _, _, data, ups, ent in frames:
        dec = jt.get_decoder(data, device="cuda", upsample=ups, entropy=ent)
        outs.append(dec.decode())
        scan_stats.append(dec.specsync_stats)
    torch.cuda.synchronize()
    main_launches = [mod.launches for mod in kernels]
    print(f"main path: {len(frames)} decodes; launches K1 {main_launches[0]}, "
          f"K2 {main_launches[1]}, K3 {main_launches[2]}")
    n_dev = sum(ent == "device" for *_, ent in frames)
    assert main_launches[0] >= len(frames), main_launches
    assert main_launches[1] >= n_dev, main_launches
    assert main_launches[2] >= 2 * 3, main_launches  # >= 1 round + record, 3 frames
    for (name, img, data, ups, ent), out, st in zip(frames, outs, scan_stats):
        h, w = img.shape[:2]
        cpu = jt.decode(data, device="cpu", upsample=ups)
        assert out.shape == (h, w, 3) and out.dtype == np.uint8, out.shape
        assert np.array_equal(out, cpu), (name, ups, ent)
        q = psnr(out, img)
        print(f"main path {name} {ups} entropy={ent}: equal to the CPU path, "
              f"PSNR vs encoder input {q:.2f} dB, index scan stats {st}")
        # synthetic_rgb carries sigma-12 Gaussian noise that subsampling and
        # quality 85 cannot keep (~27 dB); a wrong decode lands far lower.
        assert q > 24.0, (name, ups, q)
        if ent == "device" and "R=1" not in name:
            assert st is not None, f"{name}: the serial index scan ran, not K3"

    _, small = encode(256, 384, "4:2:0", args.seed + 24, restart=1)
    bad = corrupt_segment(small, 40)
    salvaged = jt.decode(bad, device="cuda", entropy="device", on_error="zero")
    cpu_salvaged = jt.decode(bad, device="cpu", entropy="device", on_error="zero")
    assert np.array_equal(salvaged, cpu_salvaged)
    print("on_error='zero', 256x384 4:2:0 R=1 with segment 40 corrupted: "
          "equal to the CPU port's salvage")

    # -- 6. timings ----------------------------------------------------------
    def stage_split(data, reps):
        """Mean host-clock ms of each stage of an entropy='device' RGB decode
        (nearest) as decode_image_device runs it, with a sync after each."""
        split = {}

        def mark(name, t0):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            split[name] = split.get(name, 0.0) + (t1 - t0) * 1e3
            return t1

        for i in range(reps + 1):  # the first pass warms up
            if i == 1:
                split.clear()
            t = time.perf_counter()
            parsed = parse(data)
            hdr = parsed.header
            spec = pipeline.PipelineSpec.from_header(hdr)
            if hdr.restart_interval:
                plan = segments.build_plan(parsed)
                t = mark("host parse + destuff and pack (build_plan)", t)
                tens = plan_tensors((plan.streams,) + plan.kernel_tables, dev)
                t = mark("H2D of the bits and tables", t)
                out, err = entropy_device.decode_segments_device(*tens)
                t = mark("K2", t)
                nseg, mps = plan.n_segments, plan.mcus_per_segment
            else:
                inp = segments.build_spec_scan_input(parsed)
                t = mark("host parse + destuff and windows (build_spec_scan_input)", t)
                w, = plan_tensors((inp.windows,), dev)
                tabs = plan_tensors((inp.dcslot_of_c, inp.acslot_of_c, inp.cbase,
                                     inp.counts, inp.symbols, inp.comp_of_step,
                                     inp.dc_slot_of_step, inp.ac_slot_of_step,
                                     inp.seg_meta), dev)
                t = mark("H2D of the bits and tables", t)
                bitpos, ok, _ = specsync_device.device_index_scan(
                    w, inp.n_bits, *tabs[:5], sb=inp.subseq_bytes,
                    maxrec=inp.maxrec, n_mcus=inp.n_mcus)
                assert bool(ok)
                t = mark("K3 rounds + record pass + stitch", t)
                streams = specsync_device.gather_entropy_streams(
                    w, bitpos, nw=inp.nw, spw=inp.spw, nws=inp.nws)
                t = mark("stream gather", t)
                out, err = entropy_device.decode_segments_device(
                    streams, *tabs[5:], *tabs[2:5])
                t = mark("K2", t)
                dcb = specsync_device.dc_base_from_coefs(out, inp.t_last)
                out = entropy_device.apply_dc_base(out, dcb, tabs[5])
                t = mark("DC bases", t)
                nseg, mps = hdr.n_mcus, 1
            geom_c = tuple((hdr.components[c].hsamp, hdr.components[c].vsamp)
                           for c in hdr.scan.comp_idx)
            coefs = entropy_device.assemble_components(
                out, nseg, mps, hdr.n_mcus, hdr.nhmb, hdr.nvmb, geom_c, soa=True,
                frame_order=hdr.scan.comp_idx)
            assert not err.reshape(-1)[:nseg].cpu().numpy().any()
            t = mark("assembly + flag check", t)
            qts = plan_tensors([hdr.quant_for(c).values for c in hdr.components], dev)
            rgb = pipeline.decode_rgb_soa(spec, pipeline.fused_rgb_geometry(spec), coefs, qts)
            t = mark("K1 (with the quant tables' upload)", t)
            rgb.cpu().numpy()
            mark("D2H of RGB", t)
        return {k: v / reps for k, v in split.items()}

    def busy_share(data, card):
        """Device time by kernel over 5 entropy='device' decodes, from
        torch.profiler, against the host clock of the same window."""
        from torch.profiler import ProfilerActivity, profile

        jt.decode(data, device="cuda", entropy="device")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                jt.decode(data, device="cuda", entropy="device")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # Device-side events only (kernels, copies): a CPU op's row repeats
        # the device time of the kernels it launched.
        rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        dev_ms = sum(ms for _, ms in rows)
        print(f"profiler, 5 entropy='device' decodes of 1080p 4:2:0 without restart "
              f"markers: device busy {dev_ms} ms of {wall_ms} ms wall "
              f"(busy share {dev_ms / wall_ms}, under the profiler)  [{card}]")
        for key, ms in rows[:10]:
            print(f"  {ms / 5} ms/frame  {key[:90]}")

    def time_k1(name, images, mode, upsample):
        """Kernel and plain version on the same batch, in turns."""
        spec, geom, comps, qt = soa_inputs(images, mode, upsample)
        a, kw = pipeline.fused_soa_args(spec, geom, comps, qt)
        kernel = lambda: pixel_fused.decode_rgb_fused_soa(*a, **kw)  # noqa: E731
        plain = lambda: pixel_fused.decode_rgb_fused_soa_reference(*a, **kw)  # noqa: E731
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = int((got.int() - ref.int()).abs().max())
        print(f"K1 vs plain {name}: max abs err {err}")
        assert err == 0, name
        for _ in range(3):
            kernel()
            plain()
        plain_ms = [cuda_ms(plain, 10)]
        kernel_ms = [cuda_ms(kernel, 50), cuda_ms(kernel, 50)]
        plain_ms.append(cuda_ms(plain, 10))
        k_ms, p_ms = sum(kernel_ms) / 2, sum(plain_ms) / 2
        mpix = len(images) * spec.height * spec.width / 1e6
        print(f"K1 coefs->RGB {name}: kernel {k_ms} ms ({mpix / k_ms * 1e3} Mpix/s) "
              f"runs {kernel_ms}; plain torch {p_ms} ms ({mpix / p_ms * 1e3} Mpix/s) "
              f"runs {plain_ms}  [{card}]")
        return k_ms, p_ms

    batch = 8
    k_ms, p_ms = time_k1(
        f"1080p 4:2:0 nearest, batch {batch}",
        [corpus.synthetic_rgb(1080, 1920, seed=args.seed + 10 + b) for b in range(batch)],
        "4:2:0", "nearest")
    time_k1("4K 4:2:2 fancy, batch 1", [img4k], "4:2:2", "fancy")

    reps = 20

    def in_turns(kernel, plain, k_iters, p_iters):
        """(kernel ms, plain ms, runs) in turns: plain, kernel, kernel, plain."""
        kernel()
        plain()
        p_runs = [cuda_ms(plain, p_iters)]
        k_runs = [cuda_ms(kernel, k_iters), cuda_ms(kernel, k_iters)]
        p_runs.append(cuda_ms(plain, p_iters))
        return sum(k_runs) / 2, sum(p_runs) / 2, k_runs, p_runs

    t = plan_tensors((plan1080.streams,) + plan1080.kernel_tables, dev)
    zero_img = torch.zeros(t[0].shape[0], dtype=torch.int32, device=dev)
    k2_ms, k2_plain_ms, kr, pr = in_turns(
        lambda: entropy_device.decode_segments_device(*t),
        lambda: entropy_device.decode_segments_reference(
            t[0], zero_img, t[1], t[2], t[3], t[4][None], t[5][None], t[6][None],
            t[7][None]),
        20, 1)
    print(f"K2 Huffman decode, 1080p 4:2:0 R=1 plan {tuple(t[0].shape)}: kernel "
          f"{k2_ms} ms runs {kr}; plain torch {k2_plain_ms} ms runs {pr}  [{card}]")

    a, kw = scan_inputs(data1080)
    k3_ms, k3_plain_ms, kr, pr = in_turns(
        lambda: specsync_device.device_index_scan(*a, **kw),
        lambda: specsync_device.device_index_scan(*a, **kw, plain=True), 10, 1)
    print(f"K3 whole device_index_scan, 1080p 4:2:0 (windows {tuple(a[0].shape)}, "
          f"{k3_stats[0]} rounds + record pass): kernel {k3_ms} ms runs {kr}; "
          f"plain torch {k3_plain_ms} ms runs {pr}  [{card}]")

    def host_ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    spec_ms = host_ms(lambda: segments.build_spec_scan_input(parse(data1080)))
    plan_ms = host_ms(lambda: segments.build_plan(parse(data1080r)))
    print(f"host parse + build_spec_scan_input, 1080p 4:2:0 without restart "
          f"markers: {spec_ms} ms/frame  [{card}]")
    print(f"host parse + build_plan, 1080p 4:2:0 R=1: {plan_ms} ms/frame  [{card}]")
    for name, data in (("without restart markers", data1080), ("R=1", data1080r)):
        ms = host_ms(lambda: jt.decode(data, device="cuda", entropy="device"))
        print(f"whole decode jt.decode(device='cuda', entropy='device') 1080p 4:2:0 "
              f"{name}: {ms} ms/frame  [{card}]")
    for name, data in (("without restart markers", data1080), ("R=1", data1080r)):
        bits = jt.get_decoder(data, device="cuda", entropy="device").io_bytes()
        coefs = jt.get_decoder(data, device="cuda").io_bytes()
        print(f"io_bytes 1080p 4:2:0 {name}: bits cut upload {bits['upload']} B "
              f"(+{bits['tables']} B tables), coefficient cut upload "
              f"{coefs['upload']} B, ratio {bits['upload'] / coefs['upload']}")

    native_ms = host_ms(lambda: entropy_native.decode_scan(parse(data1080), soa=True))
    print(f"host parse + native entropy (SoA), 1080p 4:2:0, "
          f"{entropy_native.default_threads()} threads: {native_ms} ms/frame  [{card}]")
    e2e_ms = host_ms(lambda: jt.decode(data1080, device="cuda"))
    print(f"whole decode jt.decode(device='cuda') 1080p 4:2:0 nearest: "
          f"{e2e_ms} ms/frame  [{card}]")

    for name, data in (("without restart markers", data1080), ("R=1", data1080r)):
        split = stage_split(data, reps)
        print(f"entropy='device' stages, 1080p 4:2:0 {name}, host clock with a "
              f"sync after each stage, mean of {reps}  [{card}]:")
        for stage, ms in split.items():
            print(f"  {stage}: {ms} ms")
        print(f"  sum: {sum(split.values())} ms")
    busy_share(data1080, card)

    print(json.dumps({"kernels": [{
        "name": "pixel_fused",
        "route": "cuda",
        "source": "jpeg_gpu_tpu_torch/csrc/pixel_fused.cu",
        "replaces": "jpeg_gpu_tpu/ops/pixel_fused.py:237",
        "launches": main_launches[0],
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "entropy_decode",
        "route": "cuda",
        "source": "jpeg_gpu_tpu_torch/csrc/entropy_decode.cu",
        "replaces": "jpeg_gpu_tpu/ops/entropy_device.py:128",
        "launches": main_launches[1],
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
    }, {
        "name": "specsync_scan",
        "route": "cuda",
        "source": "jpeg_gpu_tpu_torch/csrc/specsync_scan.cu",
        "replaces": "jpeg_gpu_tpu/ops/specsync_device.py:98",
        "launches": main_launches[2],
        "max_abs_err": k3_err,
        "ms": k3_ms,
        "plain_ms": k3_plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
