#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (jpeg_gpu_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

1. Environment: CUDA and nvcc versions, the card, and the build times of the
   K1 kernel (csrc/pixel_fused.cu, nvcc) and of the native host entropy
   decoder (g++).
2. K1 against its plain PyTorch version on the same CUDA tensors, for the
   five fused geometries x {nearest, fancy} at 17x31, 130x250 and 10x4200:
   bit-exact (tolerance 0: every step is integer arithmetic).
3. The main path, ``jpeg_gpu_tpu_torch.decode(data, device="cuda")``, on a
   1080p 4:2:0 frame (nearest and fancy) and a 3840x2160 4:2:2 fancy frame:
   equal to the CPU path, close to the encoder's input, and the K1 launch
   count rose.
4. Timings with CUDA events after warm-up: K1 and its plain version for
   coefs->RGB of 1080p 4:2:0 nearest at batch 8 and of the 4K 4:2:2 fancy
   frame (in turns: plain, kernel, kernel, plain), the host parse + native
   entropy per 1080p frame, and the whole decode per 1080p frame.

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
    from jpeg_gpu_tpu_torch.host import entropy_native
    from jpeg_gpu_tpu_torch.host.parser import parse
    from jpeg_gpu_tpu_torch.ops import pixel_fused
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
    pixel_fused._kernel()
    k1 = cuda_build.BUILD_INFO["pixel_fused"]
    print(f"K1 build (nvcc, sm_90a): {k1['seconds']} s")
    for line in k1["log"].splitlines():
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

    # -- 3. the main path ----------------------------------------------------
    frames = [("1080p 4:2:0", 1080, 1920, "4:2:0", "nearest"),
              ("1080p 4:2:0", 1080, 1920, "4:2:0", "fancy"),
              ("4K 4:2:2", 2160, 3840, "4:2:2", "fancy")]
    encoded = {}
    for _, h, w, mode, _ in frames:
        if (h, w, mode) not in encoded:
            img = corpus.synthetic_rgb(h, w, seed=args.seed + 1)
            encoded[(h, w, mode)] = (img, corpus.own_jpeg(img, subsampling=mode).data)
    pixel_fused.launches = 0
    outs = [jt.decode(encoded[(h, w, mode)][1], device="cuda", upsample=ups)
            for _, h, w, mode, ups in frames]
    torch.cuda.synchronize()
    main_launches = pixel_fused.launches
    print(f"main path: {len(frames)} decodes, K1 launches {main_launches}")
    assert main_launches >= len(frames), main_launches
    for (name, h, w, mode, ups), out in zip(frames, outs):
        img, data = encoded[(h, w, mode)]
        cpu = jt.decode(data, device="cpu", upsample=ups)
        assert out.shape == (h, w, 3) and out.dtype == np.uint8, out.shape
        assert np.array_equal(out, cpu), name
        q = psnr(out, img)
        print(f"main path {name} {ups}: equal to the CPU path, "
              f"PSNR vs encoder input {q:.2f} dB")
        # synthetic_rgb carries sigma-12 Gaussian noise that subsampling and
        # quality 85 cannot keep (~27 dB); a wrong decode lands far lower.
        assert q > 24.0, (name, ups, q)

    # -- 4. timings ----------------------------------------------------------
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
    time_k1("4K 4:2:2 fancy, batch 1", [encoded[(2160, 3840, "4:2:2")][0]],
            "4:2:2", "fancy")

    img1080, data1080 = encoded[(1080, 1920, "4:2:0")]
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        entropy_native.decode_scan(parse(data1080), soa=True)
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"host parse + native entropy (SoA), 1080p 4:2:0, "
          f"{entropy_native.default_threads()} threads: {host_ms} ms/frame  [{card}]")
    for _ in range(2):
        jt.decode(data1080, device="cuda")
    t0 = time.perf_counter()
    for _ in range(reps):
        jt.decode(data1080, device="cuda")
    e2e_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"whole decode jt.decode(device='cuda') 1080p 4:2:0 nearest: "
          f"{e2e_ms} ms/frame  [{card}]")

    print(json.dumps({"kernels": [{
        "name": "pixel_fused",
        "route": "cuda",
        "source": "jpeg_gpu_tpu_torch/csrc/pixel_fused.cu",
        "replaces": "jpeg_gpu_tpu/ops/pixel_fused.py:237",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
