"""Traffic kind ``stream``: a Motion-JPEG stream served through the engine's
halves, as the program's own serving loop (``jpeg_gpu_tpu_torch/bench.py``'s
``serve``) is built.

A producer thread parses, plans and uploads frame N+1
(``host.parser.parse``, ``engine.device_entropy.plan_frame``,
``upload_frame``) on its own CUDA stream while this thread decodes frame N
(``decode_frame``, then the pixel stage), ``queue_depth`` frames queued at
most.  One client in a closed loop over a pool of distinct frames, frame
``i`` being ``pool[i % len(pool)]``.  The RGB stays on the card.

The window runs until ``seconds`` have passed (and one frame has
completed) and then finishes the frame in hand; it counts what completed
and the wall time to its completion.  Nothing is read back from the card
per frame: completion times come from CUDA events read after the window,
error flags are reduced on the card and read once.  ``compare_frames``
frames of the window, a uniform sample drawn from the seed (reservoir
sampling), are copied into slots allocated at the warm-up, for the
comparison after the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from jpegbench import check, traffic_gen
from jpegbench.drivers import Context

CONFIG_KEYS = ("width", "height", "sampling", "quality", "huffman_tables", "header",
               "upsample", "exact", "distinct_frames", "guarantees")
TRAFFIC_KEYS = ("restart_interval", "queue_depth", "compare_frames")
# Every compared frame equal to the reference's islow decode; no frame of
# the window with a raised error flag.
GUARANTEES = ("islow_exact", "no_error_flag")


def validate(config: dict, traffic: dict) -> None:
    if config["sampling"] not in traffic_gen.SAMPLING:
        raise ValueError(f"sampling {config['sampling']!r}: no committed source")
    if config["huffman_tables"] not in ("annex_k", "optimal"):
        raise ValueError(f"huffman_tables {config['huffman_tables']!r}")
    if config["header"] not in ("rfc2435", "jfif"):
        raise ValueError(f"header {config['header']!r}")
    if config["upsample"] not in ("nearest", "fancy"):
        raise ValueError(f"upsample {config['upsample']!r}")
    if config["distinct_frames"] < 1 or traffic["queue_depth"] < 1 or traffic["compare_frames"] < 1:
        raise ValueError("distinct_frames, queue_depth and compare_frames are at least 1")
    if traffic["restart_interval"] < 0:
        raise ValueError("restart_interval is at least 0")


def make_pool(config: dict, traffic: dict, seed: int) -> List[traffic_gen.Frame]:
    """``distinct_frames`` frames of the configuration's size and the mix's
    restart interval, every one with the same tables (RFC 2435: the Annex K.3
    Huffman tables, quantization tables from the Q factor)."""
    return [traffic_gen.make_frame(seed, i, config["height"], config["width"],
                                   config["sampling"], config["quality"],
                                   traffic["restart_interval"], config["huffman_tables"],
                                   config["header"] == "rfc2435")
            for i in range(config["distinct_frames"])]


@dataclasses.dataclass
class StreamRun:
    """What one window did."""

    pool_index: List[int]            # per decoded frame, its place in the pool
    wall_s: float                    # the window's start to the last frame's completion
    latency_s: List[float]           # per frame: hand-off to the producer -> RGB complete
    flags: np.ndarray                # per frame: its largest error flag (0: none)
    scan_frames: int                 # frames planned for the device index scan
    fallback_frames: int             # of those, frames the scan handed to the serial host scan
    kept: Dict[int, torch.Tensor]    # frame number -> its RGB, for the sampled frames


class Reservoir:
    """A uniform sample of ``size`` of the frames offered, in one pass
    (reservoir sampling): frame ``n`` (from 0) takes slot ``n`` while there
    are free slots, then replaces slot ``floor(u_n * (n + 1))`` where that is
    below ``size``, ``u_n`` drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.draws = np.random.default_rng([seed % (1 << 64), 1]).random(1 << 20)
        self.frame_of_slot: List[int] = []

    def offer(self, n: int) -> Optional[int]:
        """The slot frame ``n`` takes, or None."""
        slot = n if n < self.size else int(self.draws[n % self.draws.size] * (n + 1))
        if slot >= self.size:
            return None
        if slot < len(self.frame_of_slot):
            self.frame_of_slot[slot] = n
        else:
            self.frame_of_slot.append(n)
        return slot


def _put(q: "queue.Queue", stop: threading.Event, item) -> None:
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return
        except queue.Full:
            continue


def window(ctx: Context, seconds: float, warm: bool = False) -> StreamRun:
    """One window of the serving loop: frames until ``seconds`` have passed;
    the warm-up (``warm``) decodes each pool frame once and keeps nothing.
    ``ctx.exact=False`` decodes the pixels with the program's float path (the
    unfused pipeline), the comparison's control."""
    from jpeg_gpu_tpu_torch.engine import device_entropy, pipeline
    from jpeg_gpu_tpu_torch.host.parser import parse
    from jpeg_gpu_tpu_torch.ops.entropy_device import plan_tensors

    pool = [f.data for f in ctx.pool]
    device = ctx.device
    spans = ctx.spans if not warm else type(ctx.spans)()
    max_frames = len(pool) if warm else None
    cuda = device.type == "cuda"
    hdr = parse(pool[0]).header
    spec = pipeline.PipelineSpec.from_header(hdr, exact=ctx.exact,
                                             upsample=ctx.config["upsample"])
    geom = pipeline.fused_rgb_geometry(spec)
    # The stream's one set of quantization tables goes to the card once.
    qts = plan_tensors([hdr.quant_for(c).values for c in hdr.components], device)

    sample = Reservoir(ctx.traffic["compare_frames"], ctx.seed)

    q: "queue.Queue" = queue.Queue(maxsize=ctx.traffic["queue_depth"])
    stop = threading.Event()
    side = torch.cuda.Stream(device) if cuda else None

    def producer():
        try:
            with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
                i = 0
                while not stop.is_set() and (max_frames is None or i < max_frames):
                    handed = time.perf_counter()
                    with spans("producer.plan"):
                        plan = device_entropy.plan_frame(parse(pool[i % len(pool)]))
                    with spans("producer.upload"):
                        frame = device_entropy.upload_frame(plan, device)
                        ready = None
                        if cuda:
                            ready = torch.cuda.Event()
                            ready.record(side)
                    with spans("producer.queue_wait"):
                        _put(q, stop, (i, handed, frame, ready))
                    i += 1
        except Exception as e:  # handed to the consumer, raised there
            _put(q, stop, e)

    pool_index, handed_at, done, flags = [], [], [], []
    scan_frames = fallback = 0
    if cuda:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    if cuda:
        start.record()
    thread = threading.Thread(target=producer, name="jpegbench-producer", daemon=True)
    thread.start()
    try:
        with spans("window"):
            while max_frames is None or len(done) < max_frames:
                with spans("consumer.queue_wait"):
                    item = q.get(timeout=300)
                if isinstance(item, Exception):
                    raise item
                if max_frames is None and done and time.perf_counter() - t0 >= seconds:
                    break
                i, handed, frame, ready = item
                with spans("consumer.decode_frame"):
                    if ready is not None:
                        current = torch.cuda.current_stream(device)
                        current.wait_event(ready)
                        for t in frame.tensors:
                            t.record_stream(current)
                    res = device_entropy.decode_frame(frame, soa=geom is not None,
                                                      check_errors=False)
                with spans("consumer.decode_rgb"):
                    if geom is not None:
                        rgb = pipeline.decode_rgb_soa(spec, geom, res.coefs, qts)
                    else:
                        rgb = pipeline.decode_rgb(spec, res.coefs, qts)
                    ev = None
                    if cuda:
                        ev = torch.cuda.Event(enable_timing=True)
                        ev.record()
                    done.append(ev)
                    flags.append(res.err.reshape(-1)[: res.n_segments].amax())
                slot = sample.offer(len(done) - 1)
                if slot is not None:
                    if "slots" not in ctx.state:
                        ctx.state["slots"] = torch.empty((sample.size,) + tuple(rgb.shape),
                                                         dtype=rgb.dtype, device=device)
                    ctx.state["slots"][slot].copy_(rgb)
                if frame.plan.scan is not None:
                    scan_frames += 1
                    fallback += res.specsync_stats is None
                pool_index.append(i % len(pool))
                handed_at.append(handed)
            if cuda:
                torch.cuda.synchronize(device)
            t_end = time.perf_counter()
    finally:
        stop.set()
        thread.join(timeout=300)
        if thread.is_alive():
            raise RuntimeError("the stream's producer did not stop")
    if cuda:
        finished = [t0 + start.elapsed_time(ev) / 1e3 for ev in done]
    else:
        finished = [t_end] * len(done)
    kept = {} if warm else {n: ctx.state["slots"][s]
                            for s, n in enumerate(sample.frame_of_slot)}
    return StreamRun(
        pool_index=pool_index, wall_s=t_end - t0,
        latency_s=[b - a for a, b in zip(handed_at, finished)],
        flags=torch.stack(flags).cpu().numpy() if flags else np.zeros(0, np.int64),
        scan_frames=scan_frames, fallback_frames=fallback, kept=kept)


def completed(run: StreamRun, pool: Sequence) -> list:
    return [pool[i].facts for i in run.pool_index]


def verdict(run: StreamRun, pool: Sequence, config: dict) -> check.Verdict:
    """The sampled frames (RGB on the card) against the reference's frame of
    the pool that was sent in their place, and the window's error flags."""
    outputs = ((run.pool_index[n], rgb.cpu().numpy()) for n, rgb in sorted(run.kept.items()))
    return check.compare(outputs, pool, config["upsample"], int(np.count_nonzero(run.flags)))
