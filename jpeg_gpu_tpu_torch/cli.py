"""Command-line front end (the reference's app layer, jpeg_gpu.c:473-700).

The port of ``jpeg_gpu_tpu/cli.py``, with the same switches plus
``--device``: pick a decoder implementation and an output stage, print
headers, dump decoded data for differential testing, or run the
repeated-decode benchmark loop (the render loop's role,
jpeg_gpu.c:1228-1461, with the host/total time split).

    python -m jpeg_gpu_tpu_torch image.jpg                   # decode, report
    python -m jpeg_gpu_tpu_torch -H image.jpg                # header only
    python -m jpeg_gpu_tpu_torch -d -o quant image.jpg       # dump stage data
    python -m jpeg_gpu_tpu_torch -b 50 image.jpg             # benchmark loop
    python -m jpeg_gpu_tpu_torch --save out.png image.jpg    # decode to PNG
    python -m jpeg_gpu_tpu_torch --device cpu image.jpg      # no card
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from jpeg_gpu_tpu_torch.engine.decoder import _BACKENDS, get_decoder
from jpeg_gpu_tpu_torch.engine.stages import OutputStage
from jpeg_gpu_tpu_torch.errors import JpegError
from jpeg_gpu_tpu_torch.utils import logging as log_util
from jpeg_gpu_tpu_torch.utils import trace
from jpeg_gpu_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="jpeg_gpu_tpu_torch",
        description="baseline JPEG decoder on PyTorch + CUDA",
    )
    p.add_argument("file", help="JPEG file to decode")
    p.add_argument(
        "-i", "--impl", default="torch", choices=sorted(_BACKENDS),
        help="decoder backend (default: torch)",
    )
    p.add_argument(
        "-o", "--out", default="rgb",
        choices=[s.value for s in OutputStage],
        help="pipeline output stage (default: rgb)",
    )
    p.add_argument(
        "-e", "--entropy", default="auto",
        choices=["auto", "native", "python", "device"],
        help="entropy decoder: host C++ (native), host python, or on the GPU (device)",
    )
    p.add_argument("-H", "--header", action="store_true", help="print header and exit")
    p.add_argument("-d", "--dump", action="store_true", help="dump decoded data")
    p.add_argument(
        "-b", "--bench", type=int, metavar="N", default=0,
        help="benchmark: decode N times, report FPS + time split",
    )
    p.add_argument(
        "--fast", action="store_true",
        help="float IDCT path: IEEE-1180-accurate, not bit-exact",
    )
    p.add_argument(
        "--fancy", action="store_true",
        help="fancy (triangle) chroma upsampling: bit-exact vs libjpeg RGB",
    )
    p.add_argument(
        "--upload", default="coefs", choices=["coefs", "pack"],
        help="host->device payload for host-entropy modes (default: coefs)",
    )
    p.add_argument("--no-validate", action="store_true", help="skip bitstream validation")
    # The reference's ablation switches (jpeg_gpu.c:481-484, 560-567) as
    # explicit aliases over the --impl/--entropy axes:
    p.add_argument(
        "--no-gpu", action="store_true",
        help="decode entirely on the host (alias for --impl host; the "
        "reference's --no-gpu)",
    )
    p.add_argument(
        "--no-cpu", action="store_true",
        help="host does no Huffman work: entropy decode (and for streams "
        "without restart markers the index scan) runs on the device (alias "
        "for --impl torch --entropy device; the reference's --no-cpu)",
    )
    p.add_argument(
        "--on-error", default="raise", choices=["raise", "zero"],
        help="device-entropy error policy: abort, or salvage (corrupt "
        "restart segments decode as flat gray)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device of the torch backend (default: cuda)",
    )
    p.add_argument("--save", metavar="PNG", help="save RGB output as PNG (needs Pillow)")
    p.add_argument(
        "--profile", metavar="DIR",
        help="write a torch.profiler trace of the decode to DIR/trace.json "
        "(chrome://tracing or Perfetto)",
    )
    return p


def _dump(result, stage: OutputStage) -> None:
    """Print decoded data for differential diffing (cf. jpeg_gpu.c:641-700)."""
    if stage in (OutputStage.QUANT, OutputStage.DCT):
        for ci, c in enumerate(result.coefs):
            vb, hb = c.shape[:2]
            print(f"plane {ci}: {hb}x{vb} blocks")
            flat = c.transpose(0, 2, 1, 3).reshape(vb * 8, hb * 8)
            for row in flat:
                print(" ".join(str(int(v)) for v in row))
    elif stage == OutputStage.PACK:
        print(f"packed entries: {len(result.pack)}")
        for ci, idx in enumerate(result.index):
            vb, hb = idx.shape
            print(f"plane {ci}: {hb}x{vb} blocks")
            for row in idx:
                print(" ".join(str(int(v)) for v in row))
        print(" ".join(f"{int(v):04x}" for v in result.pack))
    elif stage == OutputStage.YUV:
        for ci, plane in enumerate(result.planes):
            h, w = plane.shape
            print(f"plane {ci}: {w}x{h}")
            for row in plane:
                print(" ".join(str(int(v)) for v in row))
    else:
        h, w = result.shape[:2]
        print(f"rgb: {w}x{h}")
        for row in result.reshape(h, w * 3):
            print(" ".join(str(int(v)) for v in row))


def _profiled_decode(dec, stage: OutputStage, out_dir: str):
    """decode(stage) under torch.profiler (the card's activity too when
    there is one) and the program's tracer (``utils.trace``); the trace,
    with the program's spans as complete events and its counters as counter
    events at the last span's end, of category ``program`` on the profiler's
    clock, goes to ``out_dir``/trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    dec.decode(stage)  # warm-up so the trace holds steady state
    dec.reset()
    with trace.enable(), profile(activities=activities) as prof:
        result = dec.decode(stage)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base_ns = doc.get("baseTimeNanoseconds", 0)
    snap = trace.snapshot()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "program", "name": s.name, "pid": os.getpid(), "tid": s.thread,
         "ts": (s.clock_start_ns - base_ns) / 1e3, "dur": s.wall_ns / 1e3,
         "args": {"frame": s.frame, "cpu_us": None if s.cpu_ns is None else s.cpu_ns / 1e3}}
        for s in snap.spans)
    end_us = max(((s.clock_end_ns - base_ns) / 1e3 for s in snap.spans), default=0.0)
    doc["traceEvents"].extend(
        {"ph": "C", "cat": "program", "name": name, "pid": os.getpid(), "ts": end_us,
         "args": {name: n}}
        for name, n in sorted(snap.counters.items()))
    with open(path, "w") as f:
        json.dump(doc, f)
    print(f"profiler trace written to {path}")
    return result


def main(argv=None) -> int:
    log_util.init()
    args = build_parser().parse_args(argv)
    if args.no_gpu and args.no_cpu:
        print("error: --no-gpu and --no-cpu are mutually exclusive",
              file=sys.stderr)
        return 2
    if args.no_gpu:
        args.impl = "host"
    if args.no_cpu:
        args.impl = "torch"
        args.entropy = "device"
    stage = OutputStage(args.out)
    try:
        with open(args.file, "rb") as f:
            data = f.read()
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    kwargs = {"validate": not args.no_validate}
    if args.impl == "torch":
        kwargs["exact"] = not args.fast
        kwargs["entropy"] = args.entropy
        kwargs["upload"] = args.upload
        kwargs["upsample"] = "fancy" if args.fancy else "nearest"
        kwargs["on_error"] = args.on_error
        try:
            kwargs["device"] = resolve_device(args.device, "--device")
        except RuntimeError as e:  # no card, or not a device name
            print(f"error: {e}", file=sys.stderr)
            return 1
    elif args.impl in ("host", "xjpeg"):
        kwargs["entropy"] = args.entropy
        kwargs["upsample"] = "fancy" if args.fancy else "nearest"
    try:
        dec = get_decoder(data, impl=args.impl, **kwargs)
        header = dec.decode_header()
        if args.header:
            print(header.describe())
            return 0

        if args.bench:
            # Repeated decode loop with host/total split (cf. the
            # reference's title-bar metrics, jpeg_gpu.c:1444-1458).
            dec.decode(stage)  # warm-up: kernel builds, caches
            t0 = time.perf_counter()
            host_s = 0.0
            for _ in range(args.bench):
                dec.reset()
                t1 = time.perf_counter()
                dec.decode_header()
                dec.host_entropy(stage)  # the exact host work decode() uses
                host_s += time.perf_counter() - t1
                dec.decode(stage)  # numpy out: the device work is done
            total = time.perf_counter() - t0
            mpix = header.width * header.height * args.bench / 1e6
            # Bytes shipped per frame at this stage cut -- the reference's
            # central experiment variable (img.packed, jpeg_gpu.c:803,1287).
            io = dec.io_bytes(stage)
            print(
                f"{args.bench / total:.1f} FPS "
                f"(host {host_s / args.bench * 1e3:.3f} ms, "
                f"total {total / args.bench * 1e3:.3f} ms/frame, "
                f"{mpix / total:.1f} Mpix/s, impl={args.impl}, "
                f"out={stage.value}, entropy={args.entropy}, "
                f"upload={io['upload']}B/frame ({io['payload']}), "
                f"download={io['download']}B, tables={io['tables']}B)"
            )
            return 0

        if args.profile:
            result = _profiled_decode(dec, stage, args.profile)
        else:
            result = dec.decode(stage)
        if args.dump:
            _dump(result, stage)
        elif stage == OutputStage.RGB:
            h, w = result.shape[:2]
            print(f"decoded {w}x{h} rgb ({args.impl}, {header.subsampling.value})")
            if args.save:
                try:
                    from PIL import Image
                except ImportError:
                    print("error: --save needs Pillow, which is not installed",
                          file=sys.stderr)
                    return 1
                Image.fromarray(np.asarray(result)).save(args.save)
                print(f"saved {args.save}")
        else:
            print(f"decoded stage {stage.value} ({args.impl})")
        return 0
    except JpegError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
