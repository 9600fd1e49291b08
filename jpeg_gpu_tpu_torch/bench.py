"""The port's benchmark: the rows of the root ``bench.py`` on one card.

    python -m jpeg_gpu_tpu_torch.bench [--out FILE]

Prints exactly one JSON line in ``bench.py``'s shape,
``{"metric": "device_decode_1080p_420_mpix_per_s", "value": ..., "unit":
"Mpix/s", "detail": {...}}``, with the reference's detail keys (and the
corpus key of ``scripts/bench_corpus_resident.py``).  Each row is a function
of this module that takes its sizes and repetitions; :func:`run` calls them
in this order at the sizes :func:`main` gives:

* the pixel stage (K1): coefficients from the native host decoder, as SoA
  planes, uploaded once, then ``pipeline.decode_rgb_soa`` on 1080p 4:2:0 at
  batch 8, nearest (the headline) and fancy;
* the full device decode (K2's row form with its table kernel, the batched
  assembly, then K1, or K5 for gray) of frames with a restart marker every
  MCU: 1080p 4:2:0 batch 8, 3840x2160 4:2:2 batch 2, 512x512 gray batch 32,
  7680x4320 4:2:0 batch 1 nearest and fancy.  The bits are planned and
  uploaded once (``engine/batch``'s host half); the device half runs back
  to back;
* the serving loop (:func:`serve`), on 1080p 4:2:0 with a restart marker
  every MCU (24 frames) and on the same picture without restart markers
  (12 frames, K3 -> K2's fused form -> K1): a producer thread parses, plans
  and uploads frame N+1 on its own CUDA stream (``device_entropy.plan_frame``
  and ``upload_frame``) while this thread decodes frame N
  (``decode_frame``, then K1), through a queue of two.  The RGB stays on
  the card; the flags are reduced on the card and read once after the
  drain.  Beside each loop its floors: the host work alone and the host
  work with the upload, ms a frame;
* host entropy (native ``decode_scan`` of one 1080p frame) and the upload
  bytes of the coefficient cut and the bits cut;
* the corpus (BASELINE config 4's shape: 64 images of 256x256 4:2:0 with a
  restart marker every MCU), ``decode_batch_device_resident`` 8 calls back
  to back with the flags read once at the end, and ``decode_batch_device``
  with the download.

Every row's output is held once, outside its timed window, to the CPU
port's decode of the same bytes (the sha256 of its RGB); a flagged frame,
a serving frame that left the device index scan for the serial host scan,
or an output that differs raises, and no number is printed.  Device rows
are timed with CUDA events over back-to-back calls after a warm-up, with
the kernels' own device time from ``torch.profiler`` beside them
(``testing/timing.py``); host-clock rows keep every run's value.  Beside the
rows: host<->device bandwidth (pageable and pinned, both directions, 8 and
100 MB), the card's name and power limit, and the toolchain.

The frames come from the package's seeded encoder at quality 85 with
``bench.py``'s seeds (Pillow is not promised on the card's machine), and
the 8K frame from ``testing/fullsize.build``: the same bytes on every
machine, but not the bytes of the JAX bench, which Pillow encodes.

Without a card :func:`run` raises; the CPU runs only for ``device="cpu"``,
and there the times are the host's clock and no device time is read.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import multiprocessing
import os
import queue
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jpeg_gpu_tpu_torch.engine import batch as batch_mod
from jpeg_gpu_tpu_torch.engine import device_entropy, pipeline
from jpeg_gpu_tpu_torch.errors import JpegFormatError, JpegUnsupportedError
from jpeg_gpu_tpu_torch.host import entropy_native
from jpeg_gpu_tpu_torch.host.parser import parse
from jpeg_gpu_tpu_torch.ops.entropy_device import plan_tensors
from jpeg_gpu_tpu_torch.testing import fullsize, sweep, timing
from jpeg_gpu_tpu_torch.utils.device import resolve_device

METRIC = "device_decode_1080p_420_mpix_per_s"
# Frames a batch of each device row (bench.py's).
BATCHES = {"pixels": 8, "r1": 8, "k4_422": 2, "gray": 32, "k8": 1}
BANDWIDTH_BYTES = (8_000_000, 100_000_000)


class RowFailed(RuntimeError):
    """A row's output differs from the CPU port's decode of the same bytes."""


@dataclasses.dataclass
class Frame:
    """A JPEG and the sha256 of the CPU port's RGB decode of it, by upsampling
    mode: a row's output gate."""

    data: bytes
    cpu: Dict[str, str]

    @classmethod
    def of(cls, data: bytes, upsamples: Sequence[str] = ("nearest",)) -> "Frame":
        import jpeg_gpu_tpu_torch as jt

        return cls(data, {u: fullsize.checksum(jt.decode(data, device="cpu", upsample=u))
                          for u in upsamples})


@dataclasses.dataclass
class Inputs:
    """The frames of the rows, named as in :data:`INPUTS`."""

    pixels: Frame         # coefficients of the pixel-stage rows
    r1: Frame             # a restart marker every MCU: full 1080p row, serving loop
    r0: Frame             # the same picture without restart markers: serving loop
    k4_422: Frame
    gray: Frame
    k8: Frame
    corpus: List[Frame]


# name -> (height, width, subsampling or "gray", seed, restart interval,
# upsampling modes the rows decode it with); bench.py's frames.
INPUTS = {
    "pixels": (1080, 1920, "4:2:0", 0, 0, ("nearest", "fancy")),
    "r1": (1080, 1920, "4:2:0", 1, 1, ("nearest",)),
    "r0": (1080, 1920, "4:2:0", 1, 0, ("nearest",)),
    "k4_422": (2160, 3840, "4:2:2", 1, 1, ("nearest",)),
    "gray": (512, 512, "gray", 1, 1, ("nearest",)),
}
CORPUS = (64, 256, 100)   # images, side, first seed (scripts/bench_corpus_resident.py)
K8 = "8k-420-r1"          # bench.py's 8K frame: a restart marker every MCU


def encode(height: int, width: int, mode: str, seed: int, restart: int) -> bytes:
    """A frame of the package's seeded encoder at quality 85."""
    from jpeg_gpu_tpu_torch.testing import corpus

    if mode == "gray":
        img, mode = corpus.synthetic_gray(height, width, seed=seed), "4:2:0"
    else:
        img = corpus.synthetic_rgb(height, width, seed=seed)
    return corpus.own_jpeg(img, subsampling=mode, quality=85, restart_interval=restart).data


def _input_job(job) -> Frame:
    """One input, built in a worker process with its CPU decodes: a frame of
    :data:`INPUTS` or the corpus, ``(h, w, mode, seed, restart, upsamples)``,
    or the full-size 8K frame, ``(name, upsamples)``."""
    torch.set_num_threads(2)
    if len(job) == 2:
        name, upsamples = job
        return Frame.of(fullsize.build(name), upsamples)
    *shape, upsamples = job
    return Frame.of(encode(*shape), upsamples)


def input_jobs(have: Sequence[str] = ()) -> Dict[str, tuple]:
    """The jobs of :func:`_input_job` for every input whose name is not in
    ``have``, by name; the corpus images as ``corpus/<k>``."""
    jobs = {name: spec for name, spec in INPUTS.items() if name not in have}
    if "k8" not in have:
        jobs["k8"] = (K8, ("nearest", "fancy"))
    n, side, seed0 = CORPUS
    for k in range(n):
        jobs[f"corpus/{k}"] = (side, side, "4:2:0", seed0 + k, 1, ("nearest",))
    return jobs


def gather_inputs(frames: Dict[str, object]) -> Inputs:
    """:class:`Inputs` from Frames or futures of them, by the names of
    :func:`input_jobs`."""
    got = {k: (f.result() if isinstance(f, concurrent.futures.Future) else f)
           for k, f in frames.items()}
    corpus = [got.pop(f"corpus/{k}") for k in range(CORPUS[0])]
    return Inputs(corpus=corpus, **got)


def build_inputs(workers: int) -> Inputs:
    """Every input, encoded and decoded on the CPU by ``workers`` processes."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        futures = {name: pool.submit(_input_job, job) for name, job in input_jobs().items()}
        return gather_inputs(futures)


# -- helpers -----------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gate(row: str, rgb: torch.Tensor, frame: Frame, upsample: str = "nearest") -> None:
    """The row's output (one (H, W, 3) image) against the CPU port's decode."""
    got = fullsize.checksum(rgb.cpu().numpy())
    if got != frame.cpu[upsample]:
        raise RowFailed(f"{row}: the output differs from the CPU port's decode ({upsample})")


def _device_time(fn: Callable[[], object], iters: int, device: torch.device) -> dict:
    """ms a call of fn() over ``iters`` back-to-back calls after a warm-up
    (CUDA events on a card, the host clock after a synchronize elsewhere)
    and the launches of one call; on a card, the kernels' device ms a call
    from torch.profiler (None when no window recorded every launch) and by
    kernel its mean ms a recorded launch, with the launches recorded."""
    before = sweep.launch_counts()
    fn()
    _sync(device)
    launches = [a - b for a, b in zip(sweep.launch_counts(), before)]
    if device.type == "cuda":
        ms = timing.cuda_ms(fn, iters)
        profiled = min(iters, 5)
        dev_ms, recorded, by_kernel = timing.launch_device_ms(
            fn, timing.KERNEL_NAMES, sum(launches), iters=profiled)
        return {"ms": ms, "clock": "cuda events", "device_ms": dev_ms,
                "kernels_ms_a_launch": {k: v[0] for k, v in by_kernel.items()},
                "kernels_launches_recorded": {k: v[1] for k, v in by_kernel.items()},
                "launches_profiled": profiled * sum(launches), "launches": launches}
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return {"ms": (time.perf_counter() - t0) / iters * 1e3, "clock": "host",
            "device_ms": None, "kernels_ms_a_launch": {}, "launches": launches}


def _runs_ms(fn: Callable[[], object], reps: int, device: torch.device) -> List[float]:
    """Host-clock ms of each of ``reps`` calls of fn(), each ended by a sync."""
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        runs.append((time.perf_counter() - t0) * 1e3)
    return runs


def _mpix(data: bytes) -> float:
    hdr = parse(data).header
    return hdr.width * hdr.height / 1e6


def _rgb(spec, geom, coefs, qts):
    """The pixel stage the engine runs for an RGB decode: K1 on SoA planes
    for the fused geometries, else the unfused pipeline (K5)."""
    if geom is not None:
        return pipeline.decode_rgb_soa(spec, geom, coefs, qts)
    return pipeline.decode_rgb(spec, coefs, qts)


# -- the rows ----------------------------------------------------------------

def pixel_row(frame: Frame, batch: int, upsample: str, device, iters: int) -> dict:
    """Coefficients -> RGB (K1): the native host decoder's SoA planes of one
    frame, repeated ``batch`` times on a leading axis, uploaded once, then
    ``pipeline.decode_rgb_soa`` back to back.  Mpix/s of the batch."""
    device = resolve_device(device, "bench.pixel_row")
    parsed = parse(frame.data)
    hdr = parsed.header
    spec = pipeline.PipelineSpec.from_header(hdr, exact=True, upsample=upsample)
    geom = pipeline.fused_rgb_geometry(spec)
    scan = entropy_native.decode_scan(parsed, soa=geom is not None)
    coefs = tuple(torch.from_numpy(np.broadcast_to(c, (batch,) + c.shape).copy()).to(device)
                  for c in scan.coefs)
    qts = plan_tensors([hdr.quant_for(c).values for c in hdr.components], device)
    rgb = _rgb(spec, geom, coefs, qts)
    _gate(f"pixels {upsample}", rgb[0], frame, upsample)
    t = _device_time(lambda: _rgb(spec, geom, coefs, qts), iters, device)
    return {"mpix_per_s": _mpix(frame.data) * batch / (t["ms"] / 1e3), "batch": batch, **t}


def full_row(frame: Frame, batch: int, upsample: str, device, iters: int) -> dict:
    """The device half of the corpus path on ``batch`` copies of a frame with
    restart markers: the bits planned and uploaded once
    (``batch._upload_bucket``), then K2's row form with its table kernel,
    the batched assembly and K1 (K5 for gray) back to back
    (``batch._decode_uploaded_bucket``).  Mpix/s of the batch."""
    device = resolve_device(device, "bench.full_row")
    (bucket,), fallback = batch_mod._device_buckets([frame.data] * batch, True, upsample)
    if fallback:
        raise JpegUnsupportedError("full decode: the device planner rejects the frame")
    corpus_plan, tensors = batch_mod._upload_bucket(bucket, device)

    def call():
        return batch_mod._decode_uploaded_bucket(bucket, corpus_plan, tensors, "raise")

    rgb, err_img = call()
    flags = err_img.cpu().numpy()
    if flags.any():
        raise JpegFormatError(f"full decode: image {int(np.flatnonzero(flags)[0])} flagged")
    _gate(f"full {upsample}", rgb[0], frame, upsample)
    if not all(torch.equal(rgb[0], rgb[i]) for i in range(1, batch)):
        raise RowFailed("full decode: the copies of one frame differ")
    t = _device_time(call, iters, device)
    return {"mpix_per_s": _mpix(frame.data) * batch / (t["ms"] / 1e3), "batch": batch, **t}


def _put(q: "queue.Queue", stop: threading.Event, item) -> None:
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return
        except queue.Full:
            continue


def serve(frames: Sequence[Frame], n_frames: int, device, loop_reps: int = 2,
          host_reps: int = 3) -> dict:
    """The serving loop of ``bench.py``'s e2e rows: frame i is
    ``frames[i % len(frames)]``.  A producer thread runs the host half of
    frame N+1 -- parse, ``device_entropy.plan_frame`` with the first frame's
    shapes pinned (``nw``, and the window stride without restart markers),
    ``upload_frame`` on its own CUDA stream -- while this thread decodes
    frame N (``decode_frame``, then K1), two frames queued at most.  The
    first frame is decoded here beforehand: the table set and its symbol
    tables go to the card once, as ``bench.py`` uploads its tables once.

    The consumer waits on an event recorded after each upload and marks the
    frame's tensors as used on its stream.  The RGB stays on the card; each
    frame's flags are reduced on the card and read once, after the drain: a
    flagged frame raises JpegFormatError naming it, and a frame of a stream
    without restart markers that left the device index scan for the serial
    host scan raises JpegUnsupportedError.  An error of either thread is
    raised after the producer has stopped.

    Returns Mpix/s of every loop run, the floors (host ms a frame of parse +
    plan, and of parse + plan + upload, every run), the consumer's own host
    ms a frame, the bytes uploaded a frame, ``impl`` ("device_specsync"
    when the first frame took the device index scan, else "rows") and the
    last run's RGB tensors (``frames``)."""
    device = resolve_device(device, "bench.serve")
    datas = [f.data for f in frames]
    first = device_entropy.plan_frame(parse(datas[0]))
    if first.scan is not None:
        pins = {"nw": first.scan.nw, "subseq_bytes": first.scan.subseq_bytes}
        impl = "device_specsync"
    else:
        pins = {"nw": first.rows.nw}
        impl = "rows"
    hdr = first.parsed.header
    spec = pipeline.PipelineSpec.from_header(hdr, exact=True)
    geom = pipeline.fused_rgb_geometry(spec)
    qts = plan_tensors([hdr.quant_for(c).values for c in hdr.components], device)

    def host_half(i: int) -> device_entropy.FramePlan:
        return device_entropy.plan_frame(parse(datas[i % len(datas)]), **pins)

    def device_half(frame: device_entropy.UploadedFrame):
        res = device_entropy.decode_frame(frame, soa=geom is not None, check_errors=False)
        return _rgb(spec, geom, res.coefs, qts), res

    warm = device_entropy.upload_frame(first, device)
    upload_bytes = sum(t.numel() * t.element_size() for t in warm.tensors)
    if device_half(warm)[1].specsync_stats is None and impl == "device_specsync":
        raise JpegUnsupportedError("serving loop: the first frame left the device index scan "
                                   "for the serial host scan")
    _sync(device)

    def one_loop():
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None

        def producer():
            try:
                with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                    for i in range(n_frames):
                        frame = device_entropy.upload_frame(host_half(i), device)
                        event = None
                        if stream is not None:
                            event = torch.cuda.Event()
                            event.record(stream)
                        _put(q, stop, (frame, event))
            except Exception as e:  # handed to the consumer, raised after the drain
                _put(q, stop, e)

        outs, flags, left_scan, consumer_s = [], [], [], 0.0
        t0 = time.perf_counter()
        thread = threading.Thread(target=producer, name="bench-producer", daemon=True)
        thread.start()
        try:
            for i in range(n_frames):
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                frame, event = item
                c0 = time.perf_counter()
                if event is not None:
                    current = torch.cuda.current_stream(device)
                    current.wait_event(event)
                    for t in frame.tensors:
                        t.record_stream(current)
                rgb, res = device_half(frame)
                outs.append(rgb)
                flags.append(res.err.reshape(-1)[: res.n_segments].amax())
                if impl == "device_specsync" and res.specsync_stats is None:
                    left_scan.append(i)
                consumer_s += time.perf_counter() - c0
            _sync(device)
            flag_of = torch.stack(flags).cpu().numpy()
            wall = time.perf_counter() - t0
        finally:
            stop.set()
            thread.join(timeout=300)
            if thread.is_alive():
                raise RuntimeError("the serving loop's producer did not stop")
        bad = np.flatnonzero(flag_of)
        if bad.size:
            raise JpegFormatError(f"serving loop: frame {int(bad[0])} flagged by the device "
                                  f"entropy decode (flags={int(flag_of[bad[0]])})")
        if left_scan:
            raise JpegUnsupportedError(f"serving loop: frame {left_scan[0]} left the device "
                                       "index scan for the serial host scan")
        return wall, outs, consumer_s / n_frames * 1e3

    def floor(fn) -> List[float]:
        runs = []
        for _ in range(host_reps):
            t0 = time.perf_counter()
            for i in range(n_frames):
                fn(i)
            _sync(device)
            runs.append((time.perf_counter() - t0) / n_frames * 1e3)
        return runs

    host_runs = floor(host_half)
    upload_runs = floor(lambda i: device_entropy.upload_frame(host_half(i), device))
    mpx = hdr.width * hdr.height * n_frames / 1e6
    loop_runs, consumer_runs = [], []
    for _ in range(loop_reps):
        wall, outs, consumer_ms = one_loop()
        loop_runs.append(mpx / wall)
        consumer_runs.append(consumer_ms)
    for i, rgb in enumerate(outs):
        _gate(f"serving loop ({impl}) frame {i}", rgb, frames[i % len(frames)])
    busy = None
    if device.type == "cuda":
        # Everything the card ran in one loop (kernels and copies), by name.
        busy = {k: v / n_frames for k, v in timing.device_ms(one_loop, 1).items()}
    return {"mpix_per_s": max(loop_runs), "runs_mpix_per_s": loop_runs,
            "host_ms_per_frame": min(host_runs), "host_runs_ms": host_runs,
            "host_upload_ms_per_frame": min(upload_runs), "host_upload_runs_ms": upload_runs,
            "consumer_ms_per_frame": consumer_runs, "upload_bytes_frame": upload_bytes,
            "frames_per_run": n_frames, "impl": impl,
            "device_ms_per_frame": None if busy is None else sum(busy.values()),
            "device_ms_per_frame_by_name": busy, "frames": outs}


def host_entropy_row(frame: Frame, reps: int) -> dict:
    """The native host Huffman decode of one frame (``decode_scan``, block
    layout, as ``bench.py`` times it), after a warm-up: Mpix/s of every run,
    the implementation and its thread count, and the bytes of the
    coefficient cut's upload (the SoA planes the pixel rows upload)."""
    if not entropy_native.available():
        raise RuntimeError("the native host entropy decoder did not build")
    parsed = parse(frame.data)
    entropy_native.decode_scan(parsed)
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        entropy_native.decode_scan(parsed)
        runs.append(_mpix(frame.data) / (time.perf_counter() - t0))
    soa = entropy_native.decode_scan(parsed, soa=True)
    return {"mpix_per_s": max(runs), "runs_mpix_per_s": runs, "impl": "native",
            "threads": entropy_native.default_threads(),
            "upload_bytes_coefs_frame": int(sum(np.asarray(c).nbytes for c in soa.coefs))}


def corpus_resident_row(frames: Sequence[Frame], device, calls: int, reps: int) -> dict:
    """``decode_batch_device_resident`` on a corpus of one bucket, ``calls``
    calls back to back, each image's flag reduced on the card and read once
    at the end, best of ``reps`` (every run kept); the kernels' device time
    of one call beside it."""
    device = resolve_device(device, "bench.corpus_resident_row")
    datas = [f.data for f in frames]

    def call():
        return batch_mod.decode_batch_device_resident(datas, check_errors=False, device=device)

    rgb, err = call()
    if err.cpu().numpy().any():
        raise JpegFormatError("corpus: an image was flagged")
    for k, (out, f) in enumerate(zip(rgb, frames)):
        _gate(f"corpus resident image {k}", out, f)
    mpx = sum(_mpix(d) for d in datas) * calls
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [call() for _ in range(calls)]
        flag = int(torch.stack([e.amax() for _, e in outs]).amax())
        _sync(device)
        runs.append(mpx / (time.perf_counter() - t0))
        if flag:
            raise JpegFormatError("corpus: an image was flagged")
        del outs
    t = {"device_ms": None, "kernels_ms_a_launch": {}}
    if device.type == "cuda":
        before = sweep.launch_counts()
        call()
        per_call = sum(a - b for a, b in zip(sweep.launch_counts(), before))
        dev_ms, _, by_kernel = timing.launch_device_ms(call, timing.KERNEL_NAMES, per_call,
                                                       iters=1)
        t = {"device_ms": dev_ms, "kernels_ms_a_launch": {k: v[0] for k, v in by_kernel.items()}}
    return {"mpix_per_s": max(runs), "runs_mpix_per_s": runs, "calls": calls,
            "images": len(datas), **t}


def corpus_download_row(frames: Sequence[Frame], device, reps: int) -> dict:
    """``decode_batch_device`` on the corpus, RGB downloaded to numpy, best
    of ``reps`` after a warm-up call (every run kept)."""
    device = resolve_device(device, "bench.corpus_download_row")
    datas = [f.data for f in frames]
    outs = batch_mod.decode_batch_device(datas, device=device)
    for k, (out, f) in enumerate(zip(outs, frames)):
        if fullsize.checksum(out) != f.cpu["nearest"]:
            raise RowFailed(f"corpus with download: image {k} differs from the CPU port's")
    mpx = sum(_mpix(d) for d in datas)
    runs = [mpx / (ms / 1e3) for ms in _runs_ms(
        lambda: batch_mod.decode_batch_device(datas, device=device), reps, device)]
    return {"mpix_per_s": max(runs), "runs_mpix_per_s": runs, "images": len(datas)}


def bandwidth(device, sizes: Sequence[int] = BANDWIDTH_BYTES, reps: int = 5) -> dict:
    """Host<->device copy rates on the card: pageable and pinned host memory,
    both directions, at each size; GB/s of the best run and every run (host
    clock around one copy and a synchronize)."""
    device = resolve_device(device, "bench.bandwidth")
    if device.type != "cuda":
        raise ValueError("bench.bandwidth measures a card's copies; got the CPU")
    out = {}
    for size in sizes:
        dev = torch.empty(size, dtype=torch.uint8, device=device)
        for memory in ("pageable", "pinned"):
            host = torch.ones(size, dtype=torch.uint8, pin_memory=memory == "pinned")
            for way, copy in (("h2d", lambda: dev.copy_(host, non_blocking=True)),
                              ("d2h", lambda: host.copy_(dev, non_blocking=True))):
                copy()
                _sync(device)
                runs = [size / 1e9 / (ms / 1e3) for ms in _runs_ms(copy, reps, device)]
                out[f"{way}_{memory}_{size // 1_000_000}MB"] = {
                    "gb_per_s": max(runs), "runs_gb_per_s": runs}
    return out


# -- the line ----------------------------------------------------------------

def _stage(msg: str, t0: float) -> None:
    print(f"[bench +{time.perf_counter() - t0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def run(device, inputs: Inputs, *, batches: Optional[dict] = None, iters: int = 50,
        e2e_frames: Tuple[int, int] = (24, 12), loop_reps: int = 2, host_reps: int = 3,
        corpus_calls: int = 8, corpus_reps: int = 3) -> dict:
    """Every row on ``device`` (None: the card, which raises without one), in
    ``bench.py``'s order, on ``inputs`` (:func:`build_inputs`); returns the
    JSON line's object.  ``batches`` overrides :data:`BATCHES`.  The
    kernels' launches over the whole run are in ``detail["launches"]``
    (K1..K6)."""
    device = resolve_device(device, "bench.run")
    b = {**BATCHES, **(batches or {})}
    t0 = time.perf_counter()
    before = sweep.launch_counts()
    device_rows, host_rows = {}, {}

    def device_row(key, row):
        device_rows[key] = {k: v for k, v in row.items() if k != "frames"}
        return row["mpix_per_s"]

    _stage("pixel stage, 1080p 4:2:0 nearest and fancy", t0)
    head = pixel_row(inputs.pixels, b["pixels"], "nearest", device, iters)
    device_row(METRIC, head)
    fancy = device_row("fancy_parity_mpix_per_s",
                       pixel_row(inputs.pixels, b["pixels"], "fancy", device, iters))
    _stage("full device decode, 1080p 4:2:0", t0)
    full = device_row("full_on_device_decode_mpix_per_s",
                      full_row(inputs.r1, b["r1"], "nearest", device, iters))
    _stage("serving loop, 1080p 4:2:0 with a restart marker every MCU", t0)
    e2e = serve([inputs.r1], e2e_frames[0], device, loop_reps, host_reps)
    _stage("serving loop, 1080p 4:2:0 without restart markers", t0)
    nodri = serve([inputs.r0], e2e_frames[1], device, loop_reps, host_reps)
    if nodri["impl"] != "device_specsync":
        raise JpegUnsupportedError("the frame without restart markers did not take the "
                                   "device index scan")
    _stage("full device decode, 4K 4:2:2", t0)
    k4 = device_row("full_4k422_device_decode_mpix_per_s",
                    full_row(inputs.k4_422, b["k4_422"], "nearest", device, iters))
    _stage("host entropy", t0)
    host = host_entropy_row(inputs.pixels, host_reps)
    _stage("corpus, resident and with the download", t0)
    resident = corpus_resident_row(inputs.corpus, device, corpus_calls, corpus_reps)
    download = corpus_download_row(inputs.corpus, device, corpus_reps)
    _stage("full device decode, 512 gray and 8K 4:2:0 nearest and fancy", t0)
    gray = device_row("full_512gray_device_decode_mpix_per_s",
                      full_row(inputs.gray, b["gray"], "nearest", device, iters))
    k8 = device_row("full_8k420_device_decode_mpix_per_s",
                    full_row(inputs.k8, b["k8"], "nearest", device, max(1, iters // 5)))
    k8f = device_row("full_8k420_fancy_device_decode_mpix_per_s",
                     full_row(inputs.k8, b["k8"], "fancy", device, max(1, iters // 5)))
    _stage("bandwidth", t0)
    probe = bandwidth(device) if device.type == "cuda" else None
    for key, row in (("e2e_bytes_to_pixels_mpix_per_s", e2e), ("e2e_no_dri_mpix_per_s", nodri),
                     ("host_entropy_mpix_per_s", host),
                     ("corpus_device_resident_mpix_per_s", resident),
                     ("corpus_e2e_1core_host_bound_mpix_per_s", download)):
        host_rows[key] = {k: v for k, v in row.items() if k != "frames"}
    launches = [a - b for a, b in zip(sweep.launch_counts(), before)]
    _stage("done", t0)
    return {
        "metric": METRIC,
        "value": head["mpix_per_s"],
        "unit": "Mpix/s",
        "detail": {
            "batch": b["pixels"],
            "device_ms_per_batch": head["ms"],
            "fancy_parity_mpix_per_s": fancy,
            "full_on_device_decode_mpix_per_s": full,
            "full_4k422_device_decode_mpix_per_s": k4,
            "e2e_bytes_to_pixels_mpix_per_s": e2e["mpix_per_s"],
            "e2e_no_dri_mpix_per_s": nodri["mpix_per_s"],
            "e2e_host_ms_per_frame": e2e["host_ms_per_frame"],
            "e2e_host_upload_ms_per_frame": e2e["host_upload_ms_per_frame"],
            "e2e_no_dri_host_ms_per_frame": nodri["host_ms_per_frame"],
            "e2e_no_dri_host_upload_ms_per_frame": nodri["host_upload_ms_per_frame"],
            "e2e_no_dri_impl": nodri["impl"],
            "upload_bytes_coefs_frame": host["upload_bytes_coefs_frame"],
            "upload_bytes_bits_frame": e2e["upload_bytes_frame"],
            "host_entropy_mpix_per_s": host["mpix_per_s"],
            "host_entropy_impl": host["impl"],
            "host_entropy_threads": host["threads"],
            "backend": device.type,
            "corpus_device_resident_mpix_per_s": resident["mpix_per_s"],
            "corpus_e2e_1core_host_bound_mpix_per_s": download["mpix_per_s"],
            "full_512gray_device_decode_mpix_per_s": gray,
            "full_8k420_device_decode_mpix_per_s": k8,
            "full_8k420_fancy_device_decode_mpix_per_s": k8f,
            "card": sweep.card_line() if device.type == "cuda" else None,
            "toolchain": sweep.toolchain(device),
            "bandwidth": probe,
            "device_rows": device_rows,
            "host_rows": host_rows,
            "launches": launches,
            "inputs": "the package's seeded encoder at quality 85 with bench.py's seeds, and "
                      "testing/fullsize.build for 8K; not Pillow's bytes",
            "seconds": time.perf_counter() - t0,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    device = resolve_device(None, "bench")
    from jpeg_gpu_tpu_torch import cuda_build

    t0 = time.perf_counter()
    # The kernels of the bench's paths, K1, K2, K3 and K5, one nvcc each.
    cuda_build.load_all(["pixel_fused", "entropy_decode", "specsync_scan", "idct_islow_plane"])
    _stage("kernels built", t0)
    inputs = build_inputs(min(8, os.cpu_count() or 1))
    _stage("inputs built", t0)
    line = json.dumps(run(device, inputs))
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
