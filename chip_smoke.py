#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (jpeg_gpu_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--out DIR]

1. Environment: CUDA and nvcc versions, the card, and the build times and
   ptxas lines of the six kernels -- K1 (csrc/pixel_fused.cu), K2
   (csrc/entropy_decode.cu), K3 (csrc/specsync_scan.cu), K4
   (csrc/pack_expand.cu), K5 (csrc/idct_islow_plane.cu) and K6
   (csrc/idct_float.cu), one nvcc each, all started together -- and of the
   native host entropy decoder (g++).
2. K1 against its plain PyTorch version on the same CUDA tensors, for the
   five fused geometries x {nearest, fancy} at 17x31, 130x250 and 10x4200
   (rows that start at offsets that are not multiples of 16 bytes), and on
   a batch of three 37x53 frames with a table set per image.
3. K2's row form against its plain version: coefficients and the full flag
   tensor, for the six modes x restart intervals {1, 3} at 130x250, a plan
   without restart markers with its DC bases applied, a corrupted stream,
   and 1080p 4:2:0 at R=1.
4. K3 against its plain version: bitpos, ok and stats of the whole
   device_index_scan, and bitpos against the native serial scan, for 4:2:0,
   4:2:2, 4:4:4 and mono at 130x250 with 32-byte subsequences, MCUs of 18
   and 12 blocks (h4v4, 4:4:4-2x2), 1080p 4:2:0 and 4K 4:2:2 at the
   engine's stride, a scan that runs out of rounds, a record overflow (ok
   False on both sides), a stream that fills its last batch of lanes
   exactly, and tables that leave windows to decode_symbol (random numbers;
   a valid table of 200 codes of 11 bits); the symbol tables the kernel
   builds against their plain version and, with the fall-through, against
   decode_symbol for every 16-bit prefix of every slot; the lanes that
   decoded in each pass against the plain version of the lazy scheme; one
   whole scan under torch.cuda.set_sync_debug_mode("error"); and the
   engine's decode of a stream whose scan runs out of rounds or overflows
   its records (the serial fallback) and of an h4v4 frame (K3, no fallback)
   against the CPU path.  K2's symbol tables are held the same way.  Then
   K2's fused form (``decode_mcus_at_bitpos``: lane m decodes MCU m out of
   the scan's windows and the DC predictors are added on the card) against
   its plain version, coefficients and flags, and against the chain it
   replaces (gather -> row form -> DC bases): the six modes at 130x250, MCUs
   of 18 and 12 blocks, 1080p 4:2:0, 4K 4:2:2, the stream that fills its
   batch of lanes exactly, a corrupted stream, the tables that leave windows
   to decode_symbol, and a frame whose noisiest MCUs overflow what a warp
   stages in shared memory.
5. K5 against its plain version (max abs err 0): random blocks on the grids
   (1, 1), (3, 5), (17, 33) and the 1080p luma grid (136, 240), alone and
   with a leading axis of 3, int16, as contiguous planes and as strided
   views of blocks; then all four grids in one launch, each with its own
   table, contiguous, as views and mixed, equal to one call per plane.  K6
   against its plain version (max abs err <= 1, the
   count of differing samples printed): random blocks in [-300, 300) with
   tables in [1, 50), all four grids in one launch (equal to one call per
   plane), and IEEE 1180-style statistics of the card's output against a
   float64 numpy IDCT.  K5 and K6 each with a table per leading index
   ((3, 1, 1, 8, 8), as the batch code passes them) beside a plane with one
   table, in one launch.  Then K5 and K6 on the decoded coefficients of the
   frames the main paths decode, every component's grid with its own table,
   and all components in one launch: 1080p 4:2:0, 4K 4:2:2, 512x512
   grayscale and the h2v4 frame.
   K4 against its plain version and against the host's dense coefficients
   (equal): the six modes at 130x250, 64x80 grayscale, 1080p 4:2:0 and
   4K 4:2:2; then the four hand-made streams, hand-made and random streams
   side by side in the lanes of one tensor (against a scalar walk too), and
   random entries in every lane.
6. The main paths, each through ``jpeg_gpu_tpu_torch.get_decoder(data,
   device="cuda", ...).decode(...)`` with the launch counts set to 0 just
   before and read just after.  First the RGB decodes of the fused
   geometries: host entropy on a 1080p 4:2:0 frame (nearest and fancy) and
   a 3840x2160 4:2:2 fancy frame (K1); ``entropy="device"`` on 1080p 4:2:0
   without restart markers, nearest and fancy (K3 -> K2's fused form, two
   launches -> K1; each kernel's table kernel once per table set), 1080p 4:2:0
   with a restart marker per MCU (K2 -> K1) and 4K 4:2:2 fancy without
   restart markers.  Then the paths of the standalone kernels: ``out="yuv"``
   at 1080p 4:2:0 with host entropy and with ``entropy="device"`` (K5, one
   launch each), 512x512 grayscale RGB (K5) and a 3-component geometry the
   fused kernel does not take (K5, one launch); ``exact=False`` RGB at 1080p
   4:2:0 with host entropy and with ``entropy="device"`` (K6, one launch
   each; within 2 of the CPU port and within 4 of the exact decode); ``upload="pack"`` fancy RGB
   at 1080p 4:2:0 and 4K 4:2:2 (K4 -> K5, one launch) and ``upload="pack"`` with
   ``out="quant"`` equal to the host's coefficients.  The exact paths equal
   the CPU path; every kernel's launch count is the one stated; the frames
   without restart markers went through the device index scan (no serial
   fallback).  Then one corrupted restart-marked frame with
   ``on_error="zero"`` equals the CPU port's salvage.
7. The corpus, BASELINE.json config 4 on one card: 256 images of 256x256
   4:2:0 with a restart marker every MCU (32 distinct images from the
   package's encoder, seeds 100-131 and qualities 70-95, encoded by the
   worker processes from phase 1 on, repeated to 256: 32 Huffman and quant
   table sets in one bucket), through ``engine.batch`` with the launch
   counts set to 0 just before each call: ``decode_batch_device_resident``
   and ``decode_batch_device`` on the card, each one K2 launch (plus its
   table kernel, once for all 256 table sets) and one K1 launch, every
   output byte-identical to the per-image ``TorchDecoder(device="cuda",
   entropy="device")``, the first 8 equal to ``decode_batch_device`` on the
   CPU, the flags clean; an image corrupted in a corpus of 16 named by its
   index, and salvaged with ``on_error="zero"`` as its single-image decode
   is.  The bucket's host clock split by stage, Mpix/s resident, with the
   download and with host entropy, and the device time by kernel from
   torch.profiler beside K2's and K1's bounds at the corpus's shapes.
   Then a mixed corpus -- 1080p 4:2:0 with a restart marker per MCU, two
   restart-marked 512x512 gray frames, and a 1080p frame without restart
   markers too large for one segment (the host fallback) --
   through ``decode_batch`` (host entropy), ``decode_batch_device`` and
   ``decode_batch_device(exact=False)``, each output held to the CPU path
   and each call's launches of K1, K2, K5 and K6 at their stated values;
   the command line (``-b 10`` with host entropy and with ``--no-cpu``) on
   a temporary file; and the libjpeg backend, which raises
   JpegUnsupportedError for each stage whose library (a loadable libjpeg
   for the shim's cuts, Pillow for RGB) the machine lacks and equals the
   port for each stage it serves.
8. Timings with CUDA events after warm-up, each kernel and its plain
   version in turns (plain, kernel, kernel, plain): K1 for coefs->RGB of
   1080p 4:2:0 nearest and fancy at batch 8 and of the 4K 4:2:2 fancy
   frame, with its device time and swept over tiles of 1, 2 and 4 MCU
   rows; K2's row
   form on the 1080p R=1 plan, its table kernel alone, and its fused form on
   the 1080p and 4K scan inputs with the chain it replaces beside it; K3 as a whole device_index_scan at 1080p and 4K,
   its table kernel alone, the scan swept over subsequences of 128, 256 and
   512 bytes (rounds, lanes decoded per pass), and again over 1080p frames
   of quality 50, 75 and 95 in 4:4:4 and 4:2:0 (encoded by worker processes
   meanwhile) for the most rounds each target needs; K4 on the 1080p and 4K pack plans (its zero-fill
   included, a torch.zeros of the output beside it); K5 and K6 (one launch
   each, and as one call per plane) on the three planes of a 1080p 4:2:0
   frame, with the kernels' device time from torch.profiler beside the
   event timing of the wrapper, and K6's library yardstick (one
   conv_transpose2d per plane) by events and by device time.  Beside each
   its bound: the larger of the bytes it must move over the card's memory
   rate and its operations over the card's float32 rate.  Host clock: parse + native entropy, parse +
   build_spec_scan_input and parse + build_plan per 1080p frame, and the
   whole decode per 1080p frame with host entropy, ``entropy="device"``
   (with and without restart markers), ``upload="pack"``, and
   ``exact=False`` and ``out="yuv"`` with host entropy and with
   ``entropy="device"``; upload bytes of the bits cut and the pack cut against
   the coefficient cut; the split of an ``entropy="device"`` decode and of
   an ``upload="pack"`` decode into their stages (host clock, a sync after
   each); the card's busy share over five decodes, from torch.profiler's
   device-side events.

9. The sharded paths (``jpeg_gpu_tpu_torch/parallel``) on meshes of one
   card: ``make_mesh(devices=["cuda:0"] * 4, space=s)`` for s in 1, 2, 4 and
   a (data=1, space=1) mesh (and all the cards, where there are several),
   each call's launches counted after a warm-up call.  Held byte for byte to
   the unsharded decode of the same input on cuda:0:
   ``decode_batch_sharded`` on a 1080p 4:2:0 batch of 8, nearest, fancy (the
   halo) and ``exact=False`` (K5 or K6 once a shard; the checksum equal to
   its output's sum mod 2**32 and the same on every mesh);
   ``decode_image_device_sharded`` on 1080p 4:2:0 R=1 (K2's row form once a
   data shard, K1 once a space shard), 1080p without restart markers (K3
   once, then the same), 4K 4:2:2 fancy without restart markers (K5 and the
   halo; not at space 4, which its 270 MCU rows do not divide) and 512x512
   grayscale; ``decode_batch_device(mesh=)`` on phase 7's corpus (K2 and its
   table kernel, and K1, once a shard of the grid), and with image 5
   corrupted, named; ``testing/multichip.dryrun_multichip`` at (data=2,
   space=2) with BASELINE config 5's 8K 4:2:0 grid; and
   ``decode_batch_distributed`` in a process group of one NCCL rank.  Host
   clock of each sharded call beside its unsharded call, best of 3 run in
   turns, at (data=2, space=2): the mesh code's overhead (the shards run in
   turn on one card), not a scaling number.
10. The differential sweep (``testing/sweep.run("cuda")``): the 20 committed
   inputs of SWEEP_r05.json, each decoded on the card with host entropy and
   with ``entropy="device"``, equal to the host pipeline, to the TPU run's
   RGB checksum, to libjpeg's committed checksum where the reference checks
   libjpeg and to the machine's libjpeg where it serves RGB; then the
   device-scan artifact (``testing/specsync_artifact.run("cuda")``): K3's
   bit offsets on the six committed scan inputs equal to the native serial
   scan's, their ``entropy="device"`` decodes equal to the host's, a forced
   record overflow decoded through the serial scan, and the 1080p frame's
   scan time from torch.profiler beside the host window build and the serial
   scan.  Both artifacts go to ``--out`` (default ``chiprun_out/``) as
   SWEEP_torch.json and SPECSYNC_DEVICE_torch.json, and their checks'
   launches add to the kernels line.
11. Garbage in (``testing/fuzz.run("cuda")``): 90 seeded corrupt inputs
   (the SWEEP_r05 frames and the package's own, mutated: random bytes,
   truncations, bit flips, DQT, DHT, SOF, SOS, DRI, restart markers, byte
   stuffing, a second SOS, a cut EOI) through the 12 entry points of
   ``fuzz.PATHS`` -- 1080 (case, path) pairs -- each decoded or raising a
   JpegError, never anything else and never a CUDA error, with a
   synchronize after each; the seven single-image paths held to the CPU
   port (the same outcome; equal pixels, within 2 for ``exact=False``); the
   device-entropy and corpus paths run twice each, every CUDA tensor that
   ``torch.empty`` makes (the wrappers' outputs and scratch, the engine's
   uploads) filled with 0xA5 and then 0x5A between two red zones of the
   same byte (``fuzz.poisoned_empty``), and must give the same bytes both
   times with the red zones intact (an unwritten output slot or a read past
   either end would show the poison, a write past either end a red zone).
   Then K3 and K2's two forms at their wrappers on garbage the engine never
   passes them (``fuzz.kernel_run``: spoiled window and stream words, bit
   positions of no MCU, batches routed to no table set), each kernel run
   twice poisoned and held to its plain version on the card; and the 20
   sweep frames through the five single-image paths, each twice poisoned
   and equal (K1-K6 give the same bytes twice).  The outcomes by path and
   the launches by kernel are printed, K2 and K3 launched on corrupt input,
   and the launches added to the kernels line.  Beside it, in subprocesses
   with PyTorch's caching allocator off, compute-sanitizer (beside nvcc)
   runs memcheck and initcheck over 100 pairs through ``entropy="device"``
   and ``on_error="zero"`` (K3, its serial fallback, both forms of K2) and
   90 ``kernel_run`` cases, each launching K3 or K2, and racecheck over the
   20 sweep frames through every single-image path (K1-K6); an error or a
   hazard fails the phase, a tool that is missing or refuses the card is
   said so on its own line.  The phase's wall time is printed against its
   budget of 120 s.
12. BASELINE configs 3 and 5 at their published sizes
   (``testing/fullsize.py``): the four frames -- 7680x4320 4:2:0 with a
   restart marker every MCU (129,600 segments) and without, 3840x2160 4:4:4
   the same -- built from committed coefficients by the worker processes of
   phase 1 (with the CPU port's decodes of them), each sha256 held to
   ``fullsize_manifest.json`` first.  Each through host entropy (nearest and
   fancy, K1), ``entropy="device"`` (nearest and fancy: K2's row form and its
   table kernel at R=1; K3 and K2's fused form without restart markers, no
   serial or host fallback), ``out="yuv"`` (K5, one launch),
   ``upload="pack"`` fancy (K4 -> K5), ``exact=False`` (K6) and
   ``decode_image_device_sharded`` on (data, space) = (2, 2), (1, 2), (2, 1)
   meshes of one card, nearest and fancy: every exact output equal to the
   JAX package's committed checksum and to the CPU port's decode, fancy RGB
   to libjpeg's, ``exact=False`` within 2 of the CPU port and 4 of the exact
   decode, sharded equal to unsharded; each decode's launches counted from an
   empty table cache and held to their stated values, its peak device
   memory, and the host clock, best of 3.  Then the ``entropy="device"``
   stage split of the 8K frames and each kernel's device time from
   torch.profiler beside its bound at these shapes; the phase's wall time
   against its budget of 120 s.

Images come from the package's own baseline encoder, seeded.  Any failure
raises and exits non-zero; without a CUDA device it exits non-zero at once.
The last three lines are the kernels' JSON (each kernel's phase-12 numbers
under ``fullsize``), the card's name and power limit, and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import multiprocessing
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

GEOMETRIES = [("4:4:4", 1, 1), ("4:2:2", 2, 1), ("4:2:0", 2, 2),
              ("4:4:0", 1, 2), ("4:1:1", 4, 1)]
SIZES = [(17, 31), (130, 250), (10, 4200)]

# Published peaks of one H100 SXM (NVIDIA's data sheet), for the bounds: HBM
# bytes/s, and float32 operations/s outside the tensor cores.  The data
# sheet gives no int32 rate: integer operations are counted at the float32
# rate, which can only make a bound smaller than the true one.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Operations of one 8x8 block: islow = 16 passes x (12 multiplies + 50
# adds and shifts) + 64 dequant multiplies + 64 x (level shift, two
# clamps); float = 2 x 512 multiply-adds (2 operations each) + 64 x
# (two converts, multiply, add, round, two clamps).
ISLOW_OPS_PER_BLOCK = 16 * 62 + 64 + 64 * 3
FLOAT_OPS_PER_BLOCK = 2 * 512 * 2 + 64 * 7
COLOUR_OPS_PER_PIXEL = 17    # 3 multiplies, 8 adds and shifts, 6 clamps
# The least a Huffman symbol costs in one pass over the stream, whatever the
# algorithm: peek the window, look the code up, shift, extend the value,
# store or count.  What an implementation spends beyond that (a rank sum
# over the 16 code lengths, speculative rounds) is its own and is not part
# of the bound.
HUFFMAN_OPS_PER_SYMBOL = 10
PACK_OPS_PER_ENTRY = 10


def sweep_encode(job):
    """(seed, mode, quality) -> the JPEG bytes of that 1080p frame.  Runs in a
    worker process beside the checks: the encoder is Python and takes seconds
    a frame."""
    from jpeg_gpu_tpu_torch.testing import corpus

    seed, mode, quality = job
    return corpus.own_jpeg(corpus.synthetic_rgb(1080, 1920, seed=seed), subsampling=mode,
                           quality=quality).data


def corpus_encode(job):
    """(seed, quality) -> one image of BASELINE.json config 4's corpus: 256x256
    4:2:0 with a restart marker every MCU (the shape of
    scripts/bench_corpus_resident.py).  Runs in a worker process."""
    from jpeg_gpu_tpu_torch.testing import corpus

    seed, quality = job
    return corpus.own_jpeg(corpus.synthetic_rgb(256, 256, seed=seed), subsampling="4:2:0",
                           quality=quality, restart_interval=1).data


def fullsize_build(name):
    """One of the four full-size frames of phase 12 (testing/fullsize.py),
    built in a worker process beside the checks: (bytes, build seconds on
    one core, the CPU port's decodes of them, fullsize.cpu_reference)."""
    import torch as t

    from jpeg_gpu_tpu_torch.testing import fullsize

    t.set_num_threads(1)
    t0 = time.perf_counter()
    data = fullsize.build(name)
    seconds = time.perf_counter() - t0
    t.set_num_threads(2)
    return data, seconds, fullsize.cpu_reference(data)


# What each stage of engine/batch.py's _decode_bucket_device does, by the
# name it marks the stage with.
BUCKET_STAGES = {
    "corpus plan": "build_corpus_plan (the bucket's streams and tables stacked)",
    "upload": "H2D of bits, maps and tables, one pinned copy",
    "entropy": "K2: its table kernel for every table set, then the row form, one launch each",
    "assembly": "assembly, one call with the image axis in front",
    "pixels": "K1, one launch, a table row per image",
    "flags": "per-image flags reduced on the card",
}


def bucket_split(datas, dev, reps: int, kernels):
    """Mean host-clock ms of each stage of decode_batch_device_resident on a
    corpus of one bucket: the engine's own bucket decode with a sync at each
    stage it marks; the last pass's RGB tensor and its launch counts."""
    from jpeg_gpu_tpu_torch.engine import batch

    split = {}
    for i in range(reps + 1):  # the first pass warms up
        if i == 1:
            split.clear()
        for mod in kernels:
            mod.launches = 0
        t = [time.perf_counter()]

        def mark(name):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            split[name] = split.get(name, 0.0) + (t1 - t[0]) * 1e3
            t[0] = t1

        (bucket,), fallback = batch._device_buckets(datas, True, "nearest")
        assert not fallback
        mark("host parse + build_plan per image")
        rgb, err_img = batch._decode_bucket_device(bucket, "raise", dev, mark)
        batch._raise_on_flags(err_img, bucket.indices)
        mark("D2H of the NI flags")
    return {k: v / reps for k, v in split.items()}, rgb, [mod.launches for mod in kernels]


def sharded_paths(kernels, card, frames, corpus_datas, corpus_outs, bad_corpus):
    """Phase 9: the sharded paths (jpeg_gpu_tpu_torch/parallel) on meshes of
    one card, each output held byte for byte to the unsharded decode of the
    same input on cuda:0, each call's launches of K1..K6 at their stated
    values.  Returns the launches of the counted calls."""
    from jpeg_gpu_tpu_torch.engine import batch, device_entropy, pipeline
    from jpeg_gpu_tpu_torch.errors import JpegFormatError
    from jpeg_gpu_tpu_torch.host import entropy_native
    from jpeg_gpu_tpu_torch.host.parser import parse
    from jpeg_gpu_tpu_torch.parallel import distributed, shard
    from jpeg_gpu_tpu_torch.parallel.mesh import make_mesh
    from jpeg_gpu_tpu_torch.testing import multichip

    data1080, data1080r, data4k, data_gray = frames
    dev = torch.device("cuda", 0)
    meshes = {f"(data={4 // s}, space={s})": make_mesh(devices=[dev] * 4, space=s)
              for s in (1, 2, 4)}
    meshes["(data=1, space=1)"] = make_mesh(devices=[dev])
    if torch.cuda.device_count() > 1:
        meshes[f"{torch.cuda.device_count()} distinct cards"] = make_mesh()
    total = [0] * len(kernels)

    def counted(fn, warm=True):
        """fn() with the launch counts set to 0 just before (after a warm-up
        call that fills the table caches, unless ``warm`` is False)."""
        if warm:
            fn()
        torch.cuda.synchronize()
        for mod in kernels:
            mod.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = [mod.launches for mod in kernels]
        total[:] = [a + b for a, b in zip(total, counts)]
        return out, counts

    def launches(**k):
        return [k.get(name, 0) for name in ("K1", "K2", "K3", "K4", "K5", "K6")]

    def in_turns(sharded, unsharded, reps=3):
        """Host-clock ms of each call, run in turns (unsharded, sharded,
        sharded, unsharded, ...): (sharded runs, unsharded runs)."""
        runs = ([], [])
        for i in [1, 0, 0, 1, 1, 0, 0, 1][: 2 * reps]:
            t0 = time.perf_counter()
            (sharded, unsharded)[i]()
            torch.cuda.synchronize()
            runs[i].append((time.perf_counter() - t0) * 1e3)
        return runs

    # 1080p 4:2:0 coefficients from host entropy, a batch of 8 on the card.
    parsed = parse(data1080)
    hdr = parsed.header
    coefs = tuple(torch.from_numpy(c).to(dev)[None].expand(8, *c.shape).contiguous()
                  for c in entropy_native.decode_scan(parsed, soa=False).coefs)
    qts = tuple(torch.from_numpy(hdr.quant_for(c).values.astype(np.int32)).to(dev)
                for c in hdr.components)
    h, w = hdr.height, hdr.width

    def unsharded_batch(spec):
        return pipeline.decode_rgb(spec, coefs, qts)

    def image_unsharded(data, ups):
        return device_entropy.decode_image_device(parse(data), upsample=ups,
                                                  device=dev).cpu().numpy()

    image_cases = [  # (name, data, upsample, K3 runs, pixel kernel)
        ("1080p 4:2:0 R=1", data1080r, "nearest", False, "K1"),
        ("1080p 4:2:0 without restart markers", data1080, "nearest", True, "K1"),
        ("4K 4:2:2 fancy without restart markers", data4k, "fancy", True, "K5"),
        ("512x512 gray", data_gray, "nearest", True, "K5"),
    ]
    image_want = {name: image_unsharded(data, ups) for name, data, ups, _, _ in image_cases}
    times, checksums = {}, {}
    for mesh_name, mesh in meshes.items():
        d, s = mesh.shape["data"], mesh.shape["space"]
        k3_devices = len({row[0] for row in mesh.devices})
        timed = mesh_name == "(data=2, space=2)"
        for ups, exact in (("nearest", True), ("fancy", True), ("fancy", False)):
            spec = pipeline.PipelineSpec.from_header(hdr, exact=exact, upsample=ups)
            (rgb, checksum), counts = counted(
                lambda: shard.decode_batch_sharded(spec, mesh, coefs, qts))
            assert torch.equal(rgb[:, :h, :w], unsharded_batch(spec)), (mesh_name, ups, exact)
            # The checksum covers the MCU padding too, where the sharded fancy
            # filter (clamp, then halo) differs from the unsharded one by design:
            # it is held to its own output's sum and to every other mesh's.
            assert int(checksum) == int(rgb.sum(dtype=torch.int64)) & 0xFFFFFFFF
            assert checksums.setdefault((ups, exact), int(checksum)) == int(checksum)
            assert counts == launches(**{"K5" if exact else "K6": d * s}), counts
            print(f"sharded {mesh_name} decode_batch_sharded 1080p 4:2:0 batch 8 {ups} "
                  f"exact={exact}: equal to the unsharded decode, checksum {int(checksum)} "
                  f"(the sum of its 1088x1920 output, equal on every mesh); launches {counts}")
            if timed and ups == "fancy" and exact:
                times["decode_batch_sharded 1080p 4:2:0 fancy, batch 8"] = in_turns(
                    lambda: shard.decode_batch_sharded(spec, mesh, coefs, qts),
                    lambda: unsharded_batch(spec))
        for name, data, ups, scans, pixel in image_cases:
            if parse(data).header.nvmb % s:
                continue   # 4K 4:2:2 has 270 MCU rows: space 4 does not divide them
            got, counts = counted(lambda: device_entropy.decode_image_device_sharded(
                parse(data), mesh, upsample=ups))
            assert np.array_equal(got, image_want[name]), (mesh_name, name)
            want = launches(K2=d, K3=k3_devices if scans else 0, **{pixel: s})
            assert counts == want, (mesh_name, name, counts, want)
            print(f"sharded {mesh_name} decode_image_device_sharded {name} {ups}: equal to "
                  f"the unsharded entropy='device' decode; launches {counts}")
            if timed:
                if scans:   # the index scan's path, not the serial scan's fallback
                    assert device_entropy._spec_decode_sharded_try(
                        parse(data), mesh, True, ups, True) is not None, name
                times[f"decode_image_device_sharded {name}"] = in_turns(
                    lambda: device_entropy.decode_image_device_sharded(
                        parse(data), mesh, upsample=ups),
                    lambda: image_unsharded(data, ups))
        outs, counts = counted(lambda: batch.decode_batch_device(corpus_datas, mesh=mesh),
                               warm=False)
        assert all(np.array_equal(a, b) for a, b in zip(outs, corpus_outs)), mesh_name
        assert counts == launches(K1=d * s, K2=2 * d * s), (mesh_name, counts)
        print(f"sharded {mesh_name} decode_batch_device, the corpus of {len(corpus_datas)} "
              f"(config 4): every output equal to the unsharded decode; launches {counts}")
        if timed:
            times[f"decode_batch_device, corpus of {len(corpus_datas)}"] = in_turns(
                lambda: batch.decode_batch_device(corpus_datas, mesh=mesh),
                lambda: batch.decode_batch_device(corpus_datas, device=dev))
    mesh = meshes["(data=2, space=2)"]
    try:
        batch.decode_batch_device(bad_corpus, mesh=mesh)
    except JpegFormatError as e:
        assert "image 5 " in str(e), e
        print(f"sharded (data=2, space=2) corpus with image 5 corrupted: {e}")
    else:
        raise AssertionError("the corrupted image was not flagged on the mesh")
    summary = multichip.dryrun_multichip(4, devices=[dev] * 4)
    assert summary["mesh"] == (2, 2) and summary["frame_8k"] == (2, 4320, 7680, 3), summary
    print(f"dryrun_multichip on (data=2, space=2) of one card, all four checks equal to the "
          f"unsharded decode: {summary}")
    # The NCCL path at world size 1 (one card cannot hold two NCCL ranks).
    assert torch.distributed.is_nccl_available(), "this torch has no NCCL"
    with tempfile.TemporaryDirectory() as tmp:
        assert distributed.initialize_from_env(init_method=f"file://{tmp}/rdzv", world_size=1,
                                               rank=0, device=dev, timeout=60)
        try:
            backend = torch.distributed.get_backend()
            (rgbs, checksum), counts = counted(lambda: distributed.decode_batch_distributed(
                corpus_datas[:8], space=2, device=dev, return_checksum=True), warm=False)
        finally:
            torch.distributed.destroy_process_group()
    assert backend == "nccl" and counts == launches(K5=2), (backend, counts)
    assert all(np.array_equal(a, b) for a, b in zip(rgbs, corpus_outs[:8]))
    assert checksum == int(sum(int(r.astype(np.uint64).sum()) for r in rgbs)) & 0xFFFFFFFF
    print(f"decode_batch_distributed, world size 1, backend {backend}, space 2: 8 corpus "
          f"images equal to the unsharded decode, global checksum {checksum}; launches {counts}")
    print(f"sharded against unsharded, host clock ms, best of 3 run in turns, one H100, "
          f"shards run in turn on (data=2, space=2) of one card: the mesh code's overhead, "
          f"not a scaling number  [{card}]:")
    for name, (runs, runs_plain) in times.items():
        print(f"  {name}: sharded {min(runs)} ms (runs {runs}), unsharded {min(runs_plain)} "
              f"ms (runs {runs_plain}), ratio {min(runs) / min(runs_plain)}")
    return total


def artifacts(kernels, data1080: bytes, out_dir: str):
    """Phase 10: the differential sweep over the 20 committed SWEEP_r05 files
    and the device-scan artifact on the six committed scan inputs, both on
    the card, written as JSON into ``out_dir``.  Returns their launches."""
    import pathlib

    from jpeg_gpu_tpu_torch.testing import specsync_artifact, sweep

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    def counted(fn, name):
        """fn()'s artifact, written to out/name, with the launches it counts
        and those seen, the launch counts set to 0 just before."""
        torch.cuda.synchronize()
        for mod in kernels:
            mod.launches = 0
        art = fn()
        (out / name).write_text(json.dumps(art, indent=1) + "\n")
        return art, list(art["launches"].values()), [mod.launches for mod in kernels]

    art, sweep_counts, seen = counted(lambda: sweep.run("cuda"), "SWEEP_torch.json")
    assert (art["passed"], art["failed"]) == (20, 0), [c for c in art["configs"] if not c["ok"]]
    assert sweep_counts == seen, (sweep_counts, seen)
    live = sum(c.get("eq_libjpeg_live") is not None for c in art["configs"])
    print(f"sweep: {art['passed']}/{art['n']} OK on the card (cuda_eq_host, device_entropy_eq, "
          f"rgb_sha_eq_r05 everywhere; eq_libjpeg on "
          f"{sum('eq_libjpeg' in c for c in art['configs'])}, libjpeg live on {live}), "
          f"{art['wall_s']} s, launches {art['launches']} -> {out / 'SWEEP_torch.json'}")
    art, scan_counts, seen = counted(
        lambda: specsync_artifact.run("cuda", serving_frame=data1080),
        "SPECSYNC_DEVICE_torch.json")
    # The timing of serving_1080p launches K3 beyond the checks' count.
    assert all(a <= b for a, b in zip(scan_counts, seen)), (scan_counts, seen)
    assert art["all_ok"] and art["fallback_serial_scan_ok"], art
    assert art["n_configs"] == 6 and all(c["plan_bit_identical"] for c in art["configs"])
    print(f"specsync artifact: {art['n_configs']}/6 bit-identical to the serial scan and decoded "
          f"equal through it, fallback ok; serving_1080p {json.dumps(art['serving_1080p'])}; "
          f"launches {art['launches']} -> {out / 'SPECSYNC_DEVICE_torch.json'}")
    total = [a + b for a, b in zip(sweep_counts, scan_counts)]
    print(f"phase 10: launches {total} (K1..K6)")
    return total


# Phase 11: the fuzz in process, and what the sanitizer runs see.
FUZZ_CASES = 90                       # x 12 paths = 1080 (case, path) pairs
FUZZ_COMPARED = ("auto", "python", "device", "pack", "float", "yuv", "zero")
# Paths run twice, torch.empty's CUDA tensors filled with 0xA5 and then 0x5A
# (K2's two forms, K3 and its fallback, the corpus K2 with its per-image
# tables, K1 and K5 after them).
FUZZ_POISONED = ("device", "zero", "batch_device", "resident")
# The single-image paths that reach K1-K6 on valid frames.
CLEAN_PATHS = ("auto", "device", "pack", "float", "yuv")
KERNEL_CASES = 30                     # K3, K2 fused, K2 row form at their wrappers
SANITIZER_CASES = 50                  # x 2 paths (device, zero) = 100 pairs,
SANITIZER_KERNEL_CASES = 90           # then 90 that launch K3 or K2 at their wrappers
SANITIZER_TIMEOUT_S = 100


def sanitizer_runs(seed: int):
    """Start compute-sanitizer (found beside nvcc) on the fuzz CLI in three
    subprocesses at once: memcheck and initcheck on SANITIZER_CASES cases
    through ``entropy="device"`` and ``on_error="zero"`` (K3's scan and its
    serial fallback, K2's fused and row forms), then SANITIZER_KERNEL_CASES
    cases of ``fuzz.kernel_run``, each of which launches K3 or K2; racecheck
    on the 20 sweep frames through every single-image path (K1-K6).  PyTorch's caching
    allocator is off (memcheck cannot see an overrun inside a pooled
    block).  Returns [(tool, Popen or None, why None)]."""
    import os
    import pathlib

    from jpeg_gpu_tpu_torch import cuda_build

    exe = pathlib.Path(cuda_build.nvcc_path()).parent / "compute-sanitizer"
    fuzz_cli = [sys.executable, "-m", "jpeg_gpu_tpu_torch.testing.fuzz", "--device", "cuda"]
    k2k3 = ["--seed", str(seed), "--n", str(SANITIZER_CASES), "--paths", "device,zero",
            "--kernels", str(SANITIZER_KERNEL_CASES)]
    runs = {
        "memcheck": k2k3,
        "initcheck": k2k3,
        "racecheck": ["--clean", "--paths", "auto,device,pack,float,yuv"],
    }
    if not exe.exists():
        return [(tool, None, f"no compute-sanitizer beside nvcc ({exe})") for tool in runs]
    root = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1", PYTHONPATH=str(root))
    out = []
    for tool, extra in runs.items():
        cmd = [str(exe), "--tool", tool, "--error-exitcode", "9", *fuzz_cli, *extra]
        out.append((tool, subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True), cmd))
    return out


def sanitizer_verdicts(runs) -> list:
    """Wait for each sanitizer run and judge it: (tool, verdict, lines).
    "clean" where the tool ran the program to its end with 0 errors (0
    hazards for racecheck) and the fuzz CLI passed; "unavailable" where the
    tool is missing or refuses the card; "failed" otherwise."""
    verdicts = []
    for tool, proc, cmd in runs:
        if proc is None:
            verdicts.append((tool, "unavailable", [cmd]))
            continue
        try:
            text, _ = proc.communicate(timeout=SANITIZER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            verdicts.append((tool, "failed", [f"timed out after {SANITIZER_TIMEOUT_S} s"]
                             + text.splitlines()[-5:]))
            continue
        lines = text.splitlines()
        notes = [line for line in lines if line.startswith("=========")]
        summary = [line for line in lines
                   if "SUMMARY" in line or line.startswith(("fuzz on ", "kernels on "))]
        if any("Device not supported" in line for line in notes):
            verdicts.append((tool, "unavailable", [" ".join(cmd)] + notes[:3]))
        elif proc.returncode == 0 and any(
                "ERROR SUMMARY: 0 errors" in line or "RACECHECK SUMMARY: 0 hazards" in line
                for line in summary):
            verdicts.append((tool, "clean", summary))
        else:
            verdicts.append((tool, "failed", [f"rc {proc.returncode}"] + notes[:20] + lines[-5:]))
    return verdicts


def fuzz_phase(kernels, card: str, seed: int):
    """Phase 11: the port's garbage-in contract on the card
    (``testing/fuzz``): FUZZ_CASES seeded garbage inputs through every entry
    point (FUZZ_COMPARED held to the CPU port, FUZZ_POISONED run twice
    poisoned), KERNEL_CASES of K3 and K2 at their wrappers, and the 20 sweep
    frames twice poisoned through CLEAN_PATHS; meanwhile the sanitizer runs.
    Returns the in-process launches (K1..K6)."""
    from jpeg_gpu_tpu_torch.testing import fuzz

    t0 = time.perf_counter()
    runs = sanitizer_runs(seed + 11)
    # Controls: inside the block a CUDA tensor from torch.empty holds the
    # poison, and a write one byte past its end shows in its red zone.
    with fuzz.poisoned_empty(fuzz.POISON[0]) as zones:
        t = torch.empty(1000, dtype=torch.int16, device="cuda")
        u = torch.empty(1000, dtype=torch.int16, device="cuda")
    assert bool((t.view(torch.uint8) == fuzz.POISON[0]).all()) and zones.written() == 0
    with fuzz.poisoned_empty(fuzz.POISON[0]) as zones:
        t = torch.empty(1000, dtype=torch.int16, device="cuda")
    zones.buffers[0][fuzz.RED_ZONE + 2000] = 0
    assert zones.written() == 1
    del t, u
    torch.cuda.synchronize()
    for mod in kernels:
        mod.launches = 0
    res = fuzz.run("cuda", seed=seed + 11, n=FUZZ_CASES, paths=fuzz.PATHS,
                   compare_cpu=FUZZ_COMPARED, poisoned=FUZZ_POISONED)
    kres = fuzz.kernel_run("cuda", seed=seed + 11, n=KERNEL_CASES)
    # The 20 sweep frames through every single-image path, each run twice
    # poisoned: K1-K6 must give the same bytes twice (a stand-in for racecheck
    # that sees only races whose outcome varies between runs).
    clean = fuzz.run("cuda", paths=CLEAN_PATHS, srcs=fuzz.sources()[:20], clean=True,
                     poisoned=CLEAN_PATHS)
    seen = [mod.launches for mod in kernels]
    by_kernel = [sum(r["launches"][p][f"K{k + 1}"] for r, paths in
                     ((res, fuzz.PATHS), (clean, CLEAN_PATHS)) for p in paths) for k in range(6)]
    by_kernel[1] += kres["launches"]["K2"]
    by_kernel[2] += kres["launches"]["K3"]
    for path in fuzz.PATHS:
        print(f"fuzz {path}: {json.dumps(res['by_path'][path])}, launches "
              f"{json.dumps(res['launches'][path])}")
    print(f"fuzz on the card: {res['pairs']} (case, path) pairs of {res['n_cases']} cases "
          f"(seed {res['seed']}), {res['compared_cpu']} held to the CPU port, "
          f"{len(res['violations'])} violations, {len(res['mismatches'])} CPU mismatches, "
          f"CUDA error: {res['cuda_error']}, {res['seconds']:.1f} s  [{card}]")
    print(f"fuzz decodes on entropy='device' / on_error='zero' through K2 and through the "
          f"host fallback: {json.dumps(res['device_decoded_via'])}")
    print(f"fuzz with torch.empty's CUDA tensors poisoned between red zones of "
          f"{fuzz.RED_ZONE} bytes ({', '.join(FUZZ_POISONED)}; {fuzz.POISON[0]:#x} then "
          f"{fuzz.POISON[1]:#x}): {res['poisoned_pairs']} pairs twice, "
          f"{len(res['poison_mismatches'])} differ or wrote a red zone")
    print(f"K3, K2 fused and K2 row form at their wrappers on garbage the engine never passes "
          f"them (spoiled words, bit positions of no MCU, batches without tables): "
          f"{kres['cases']} cases {json.dumps(kres['by_form'])}, each kernel run twice poisoned "
          f"and its plain version on the card: {len(kres['mismatches'])} differ, "
          f"{len(kres['violations'])} violations, CUDA error: {kres['cuda_error']}, launches "
          f"{json.dumps(kres['launches'])}, {kres['seconds']:.1f} s")
    print(f"the 20 sweep frames through {', '.join(CLEAN_PATHS)}, each twice poisoned: "
          f"{json.dumps({p: clean['by_path'][p] for p in CLEAN_PATHS})}, "
          f"{clean['poisoned_pairs']} pairs, {len(clean['poison_mismatches'])} differ or wrote a "
          f"red zone, {clean['seconds']:.1f} s")
    print(f"fuzz launches by kernel (K1..K6): {by_kernel}")
    for v in (res["violations"] + res["mismatches"] + res["poison_mismatches"]
              + kres["violations"] + kres["mismatches"] + clean["violations"]
              + clean["poison_mismatches"]):
        print(f"  {json.dumps(v)}")
    assert kres["cuda_error"] is None, kres["cuda_error"]
    assert kres["ok"] and kres["cases"] == KERNEL_CASES, kres
    assert clean["ok"] and clean["poisoned_pairs"] == 20 * len(CLEAN_PATHS), clean
    assert all(clean["by_path"][p] == {"decoded": 20} for p in CLEAN_PATHS), clean["by_path"]
    assert res["cuda_error"] is None, res["cuda_error"]
    assert res["ok"], (res["violations"], res["mismatches"], res["poison_mismatches"])
    assert res["pairs"] >= 1000 and res["compared_cpu"] >= 300, res
    assert res["poisoned_pairs"] == FUZZ_CASES * len(FUZZ_POISONED) - sum(
        n for p in FUZZ_POISONED for o, n in res["by_path"][p].items() if o.startswith("viol"))
    assert by_kernel == seen, (by_kernel, seen)
    # K2 and K3 ran on corrupt input (K3 only on the device paths).
    device_k = res["launches"]["device"]
    assert device_k["K2"] > 0 and device_k["K3"] > 0, device_k
    t_fuzz = time.perf_counter() - t0
    verdicts = sanitizer_verdicts(runs)
    for tool, verdict, lines in verdicts:
        print(f"compute-sanitizer --tool {tool}: {verdict}")
        for line in lines:
            print(f"  {line}")
    assert all(v != "failed" for _, v, _ in verdicts), verdicts
    wall = time.perf_counter() - t0
    print(f"phase 11: in-process fuzz {t_fuzz:.1f} s, with the sanitizer runs {wall:.1f} s wall "
          f"(budget 120 s: {'within' if wall <= 120 else 'OVER'})")
    return by_kernel


# Phase 12: the decodes whose kernel calls are timed on each full-size frame,
# the wrapper of each kernel as the engine calls it, and the profiler's
# kernel names of K1..K6.
FULLSIZE_TIMED = ("device nearest", "auto fancy", "device yuv", "pack fancy", "device float")
WRAPPERS = ((0, "pixel_fused", "decode_rgb_fused_soa"),
            (1, "entropy_device", "decode_segments_device"),
            (1, "entropy_device", "decode_mcus_at_bitpos"),
            (2, "specsync_device", "device_index_scan"),
            (3, "pack_device", "expand_pack_device"),
            (4, "idct_islow_plane", "dequant_idct_islow_planes_soa"),
            (5, "idct_float", "dequant_idct_float_planes_soa"))
KERNEL_NAMES = (("fused_rgb_kernel",), ("decode_kernel", "dc_base_kernel"), ("index_scan_kernel",),
                ("pack_expand_kernel",), ("idct_islow_planes_kernel",),
                ("idct_float_planes_kernel",))
FULLSIZE_BUDGET_S = 120


def fullsize_bounds(data: bytes) -> dict:
    """Each kernel's bound (K1..K6 by name) for its work on this frame: the
    bytes it must move (inputs read once, outputs written once) and its
    operations, as phase 8 counts them -- the coefficients and the pixels or
    planes for K1, K5, K6; the segments' destuffed words and tables in, the
    coefficients and flags out, and a Huffman symbol as 10 operations for
    K2's row form; the windows in and the coefficients out for its fused
    form; the windows in and an offset per MCU out for K3; the pack rows in
    and the zero-filled output for K4."""
    from jpeg_gpu_tpu_torch.engine import device_entropy
    from jpeg_gpu_tpu_torch.host import entropy_native, segments
    from jpeg_gpu_tpu_torch.host.pack_plan import build_pack_plan
    from jpeg_gpu_tpu_torch.host.parser import parse

    parsed = parse(data)
    hdr = parsed.header
    blocks = sum(c.vblocks * c.hblocks for c in hdr.components)
    coef_bytes, qt_bytes, pixels = blocks * 64 * 2, len(hdr.components) * 64 * 4, hdr.height * hdr.width
    scan = entropy_native.decode_scan(parsed, want_pack=True)
    symbol_ops = symbol_count(scan.coefs) * HUFFMAN_OPS_PER_SYMBOL
    out = {"K1": bound(coef_bytes + qt_bytes + 3 * pixels,
                       blocks * ISLOW_OPS_PER_BLOCK + pixels * COLOUR_OPS_PER_PIXEL)}
    if hdr.restart_interval:
        plan = segments.build_plan(parsed)
        out["K2"] = bound(k2_bytes([parsed], plan.n_segments, plan.comp_of_step.size,
                                   plan.kernel_tables), symbol_ops)
    else:
        inp = segments.build_spec_scan_input(parsed, sb_target=device_entropy.SCAN_SB_TARGET)
        maps = inp.comp_of_step.nbytes + inp.dc_slot_of_step.nbytes + inp.ac_slot_of_step.nbytes
        out["K2"] = bound(inp.windows.nbytes + 4 * inp.n_mcus + maps + coef_bytes + 4 * inp.n_mcus,
                          symbol_ops)
        out["K3"] = bound(inp.windows.nbytes + inp.dcslot_of_c.nbytes + inp.acslot_of_c.nbytes
                          + 4 * inp.n_mcus, symbol_ops)
    pack = build_pack_plan(parsed, scan)
    out["K4"] = bound(pack.streams.nbytes
                      + pack.streams.shape[0] * pack.blocks_per_segment * 64 * 1024 * 2,
                      pack.packed_entries * PACK_OPS_PER_ENTRY)
    out["K5"] = bound(coef_bytes + qt_bytes + blocks * 64, blocks * ISLOW_OPS_PER_BLOCK)
    out["K6"] = bound(coef_bytes + qt_bytes + blocks * 64, blocks * FLOAT_OPS_PER_BLOCK)
    return out


def captured_calls(fn) -> list:
    """fn() with every kernel wrapper of WRAPPERS spied on: each call as
    (kernel index, wrapper name, the wrapper, args, kwargs), in call order;
    the arguments are the engine's own tensors on the card."""
    import importlib

    calls, restore = [], []
    for k, mod_name, attr in WRAPPERS:
        mod = importlib.import_module(f"jpeg_gpu_tpu_torch.ops.{mod_name}")
        real = getattr(mod, attr)

        def spy(*a, _k=k, _attr=attr, _real=real, **kw):
            calls.append((_k, _attr, _real, a, kw))
            return _real(*a, **kw)

        setattr(mod, attr, spy)
        restore.append((mod, attr, real))
    try:
        fn()
    finally:
        for mod, attr, real in restore:
            setattr(mod, attr, real)
    return calls


def launch_device_ms(fn, names, per_call: int, iters: int = 5):
    """Device time of the kernels of one fn() call whose names hold one of
    ``names`` (``per_call`` launches a call), from torch.profiler's device
    events over ``iters`` calls after a warm-up call: (ms a call, the
    launches recorded).  On the H100 machines tried, the profiler dropped
    records of these kernels in some windows, so a window counts only when
    it recorded every launch, and up to three are taken; otherwise the time
    is None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    recorded = 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if any(n in e.key for n in names)]
        recorded = sum(e.count for e in rows)
        if recorded == iters * per_call:
            return sum(e.self_device_time_total for e in rows) / 1e3 / iters, recorded
    return None, recorded


def fullsize_phase(kernels, card: str, jobs: dict, stage_split) -> dict:
    """Phase 12: BASELINE configs 3 and 5 at their published sizes
    (testing/fullsize.py).  The four frames (built by the worker processes
    with the CPU port's decodes of them) through every path of
    ``fullsize.run`` on the card, each sha256 held to the manifest first and
    each output to the JAX package's checksum, the CPU port's decode and,
    fancy, libjpeg's; then the entropy="device" stage split of the 8K frames
    and each kernel's device time beside its bound at these shapes.
    Returns the counted launches and, per kernel, its numbers by frame and
    path."""
    import jpeg_gpu_tpu_torch as jt
    from jpeg_gpu_tpu_torch.testing import fullsize

    t0 = time.perf_counter()
    built = {name: job.result() for name, job in jobs.items()}
    print(f"fullsize: waited {time.perf_counter() - t0} s for the worker processes")
    for name, (data, seconds, _) in built.items():
        print(f"fullsize {name}: built in {seconds} s on one core of a worker process, "
              f"{len(data)} B  [{card}]")
    report = fullsize.run("cuda", frames={n: b[0] for n, b in built.items()},
                          cpu={n: b[2] for n, b in built.items()}, reps=3)
    assert report["ok"], report["failures"]
    for name, rec in report["frames"].items():
        mpix = rec["facts"]["height"] * rec["facts"]["width"] / 1e6
        for path, p in rec["paths"].items():
            print(f"fullsize {name} {path}: best of 3 {min(p['ms'])} ms ({mpix / min(p['ms']) * 1e3} "
                  f"Mpix/s), peak {p['peak_bytes'] / 2**20} MiB, launches {p['launches']} "
                  f"(K1..K6)  [{card}]")
        if "scan" in rec:
            stats = rec["paths"]["device nearest"]["specsync_stats"]
            print(f"fullsize {name} index scan: {stats[0]} rounds, {rec['scan']['lanes']} lanes "
                  f"of {rec['scan']['subseq_bytes']} bytes, windows {rec['scan']['windows']}, "
                  f"records {stats[1]}, overflow {stats[2]}; no fallback on any path")
    for name in ("8k-420-r0", "8k-420-r1"):
        split = stage_split(built[name][0], 3)
        print(f"entropy='device' stages, {name}, host clock with a sync after each stage, mean "
              f"of 3  [{card}]:")
        for stage, ms in split.items():
            print(f"  {stage}: {ms} ms")
        print(f"  sum: {sum(split.values())} ms")
    # Each kernel call of a decode, with the engine's inputs at this size:
    # CUDA events around 20 back-to-back calls of its wrapper, and the
    # kernels' own time from torch.profiler over 5 (launch_device_ms).
    by_kernel = [{} for _ in kernels]
    for name, (data, _, _) in built.items():
        bounds = fullsize_bounds(data)
        for path, kw, stage in (p for p in fullsize.PATHS if p[0] in FULLSIZE_TIMED):
            calls = captured_calls(
                lambda: jt.get_decoder(data, device="cuda", **kw).decode(stage))
            launched = report["frames"][name]["paths"][path]["launches"]
            for k, attr, real, a, kwa in calls:
                call = lambda: real(*a, **kwa)  # noqa: E731
                call()
                ms = [cuda_ms(call, 20), cuda_ms(call, 20)]
                # K2's fused form is two kernels: the decode and the DC predictors.
                per_call = 2 if attr == "decode_mcus_at_bitpos" else 1
                dev_ms, recorded = launch_device_ms(call, KERNEL_NAMES[k], per_call)
                b = bounds[f"K{k + 1}"]
                by_kernel[k][f"{name} {path}"] = {
                    "ms": sum(ms) / 2, "device_ms": dev_ms, "bound_ms": b["bound_ms"],
                    "bound_by": b["bound_by"], "launches": launched[k]}
                print(f"fullsize {name} {path}: K{k + 1} ({attr}) kernel {sum(ms) / 2} ms runs "
                      f"{ms} by events, device {dev_ms} ms a call (profiler; {recorded} of "
                      f"{5 * per_call} launches recorded in its last window); {bound_text(b)}  "
                      f"[{card}]")
    wall = time.perf_counter() - t0
    print(f"phase 12: launches {report['launches']} (K1..K6), fullsize.run {report['seconds']} s, "
          f"{wall} s wall (budget {FULLSIZE_BUDGET_S} s: "
          f"{'within' if wall <= FULLSIZE_BUDGET_S else 'OVER'})")
    return {"launches": report["launches"], "by_kernel": by_kernel}


def verdict_order(data: bytes, card: str, reps: int = 20) -> None:
    """What reading the index scan's verdict before K2 costs: K3 -> ok and
    stats to the host in one copy -> K2's fused form (the engine's order),
    against K3 -> K2 -> ok and stats (K2 enqueued before the verdict), host
    clock from the scan's call to a sync after K2, on the 1080p frame
    without restart markers, best of ``reps`` in turns."""
    from jpeg_gpu_tpu_torch.engine import device_entropy
    from jpeg_gpu_tpu_torch.host import segments
    from jpeg_gpu_tpu_torch.host.parser import parse
    from jpeg_gpu_tpu_torch.ops import entropy_device, specsync_device
    from jpeg_gpu_tpu_torch.ops.entropy_device import plan_tensors

    dev = torch.device("cuda")
    inp = segments.build_spec_scan_input(parse(data), sb_target=device_entropy.SCAN_SB_TARGET)
    tabs = device_entropy.device_tables(inp.cbase, inp.counts, inp.symbols, dev, scan=True)
    w, dc_c, ac_c, cm, dm, am = plan_tensors(
        (inp.windows, inp.dcslot_of_c, inp.acslot_of_c, inp.comp_of_step,
         inp.dc_slot_of_step, inp.ac_slot_of_step), dev)

    def once(first: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bitpos, ok, stats = specsync_device.device_index_scan(
            w, inp.n_bits, dc_c, ac_c, tabs.cbase, tabs.counts, tabs.symbols,
            sb=inp.subseq_bytes, maxrec=inp.maxrec, n_mcus=inp.n_mcus, lut=tabs.k3_lut)
        verdict = torch.cat([stats, ok.reshape(1).to(stats.dtype)]) if first else None
        if first:
            assert verdict.cpu().numpy()[3]
        entropy_device.decode_mcus_at_bitpos(
            w, bitpos, inp.n_bits, cm, dm, am, tabs.cbase, tabs.counts, tabs.symbols,
            spw=inp.spw, lut=tabs.k2_lut)
        if not first:
            assert torch.cat([stats, ok.reshape(1).to(stats.dtype)]).cpu().numpy()[3]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    once(True), once(False)
    runs = {True: [], False: []}
    for _ in range(reps):
        for first in (True, False, False, True):
            runs[first].append(once(first))
    print(f"index scan verdict read before K2 (the engine) / after K2, K3 + K2 fused, "
          f"1080p 4:2:0, host clock, best of {2 * reps} in turns: {min(runs[True])} / "
          f"{min(runs[False])} ms (medians {float(np.median(runs[True]))} / "
          f"{float(np.median(runs[False]))})  [{card}]")


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 rate, in ms."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": n_bytes, "bytes_ms": by_bytes, "ops": n_ops, "ops_ms": by_ops}


def bound_text(b: dict) -> str:
    return (f"bound {b['bound_ms']} ms by {b['bound_by']} ({b['bytes']} B -> "
            f"{b['bytes_ms']} ms at {PEAK_BYTES_PER_S} B/s; {b['ops']} operations -> "
            f"{b['ops_ms']} ms at {PEAK_OPS_PER_S} op/s)")


def symbol_count(coefs) -> int:
    """Huffman symbols of a scan, from its dense (vb, hb, 8, 8) coefficients:
    one DC symbol per block, one per non-zero AC coefficient, and an end of
    block wherever the last zig-zag position is zero (ZRL symbols, rare at
    this quality, are left out)."""
    n = 0
    for c in coefs:
        c = np.asarray(c).reshape(-1, 64)
        n += c.shape[0] + int(np.count_nonzero(c[:, 1:])) + int((c[:, 63] == 0).sum())
    return n


def segment_words(parsed) -> int:
    """32-bit words of entropy data in a scan's segments once destuffed, each
    segment rounded up to whole words: what a decoder of the scan must read."""
    d = np.frombuffer(parsed.data, np.uint8)
    removed = np.zeros(d.size + 1, np.int64)   # stuffed zeros before byte k
    removed[2:] = np.cumsum((d[:-1] == 0xFF) & (d[1:] == 0))
    starts, ends = parsed.segments[:, 0], parsed.segments[:, 1]
    lens = ends - starts - (removed[ends] - removed[starts])
    return int(((lens + 3) // 4).sum())


def k2_bytes(parsed, n_segments: int, steps: int, tables) -> int:
    """Bytes K2's row form must move for these scans: every segment's
    destuffed words and the tables in, each segment's coefficients and flag
    out.  The padding of its layout (lanes past an image's last segment,
    words past a segment's end) is none of the function's work."""
    return (4 * sum(segment_words(p) for p in parsed) + sum(t.nbytes for t in tables)
            + len(parsed) * n_segments * (steps * 64 * 2 + 4))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out",
                    help="directory for SWEEP_torch.json and SPECSYNC_DEVICE_torch.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    import jpeg_gpu_tpu_torch as jt
    from jpeg_gpu_tpu_torch import cuda_build
    from jpeg_gpu_tpu_torch.engine import device_entropy, pipeline
    from jpeg_gpu_tpu_torch.host import entropy_native, segments
    from jpeg_gpu_tpu_torch.host.pack_plan import build_pack_plan
    from jpeg_gpu_tpu_torch.host.parser import parse
    from jpeg_gpu_tpu_torch.ops import (
        entropy_device, idct_float, idct_islow_plane, pack_device, pixel_fused,
        specsync_device,
    )
    from jpeg_gpu_tpu_torch.ops import color as color_ops
    from jpeg_gpu_tpu_torch.ops import idct as idct_ops
    from jpeg_gpu_tpu_torch.ops.block_plane import blocks_as_soa
    from jpeg_gpu_tpu_torch.ops.entropy_device import plan_tensors
    from jpeg_gpu_tpu_torch.testing import corpus, fullsize, pack_cases, scan_cases
    from jpeg_gpu_tpu_torch.testing.encoder import _M as DCT_BASIS_F64
    from jpeg_gpu_tpu_torch.testing.specsync_artifact import device_ms
    from jpeg_gpu_tpu_torch.testing.sweep import card_line

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def phase_done(n):
        print(f"-- phase {n} done {time.perf_counter() - t_start:.1f} s after the start")

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
    stems = (("K1", "pixel_fused"), ("K2", "entropy_decode"), ("K3", "specsync_scan"),
             ("K4", "pack_expand"), ("K5", "idct_islow_plane"), ("K6", "idct_float"))
    cuda_build.load_all([stem for _, stem in stems])
    print(f"kernel builds, in parallel: {time.perf_counter() - t0} s wall")
    kernels = (pixel_fused, entropy_device, specsync_device, pack_device,
               idct_islow_plane, idct_float)
    for mod in kernels:
        mod._kernel()
    for name, stem in stems:
        info = cuda_build.BUILD_INFO[stem]
        print(f"{name} build (nvcc, sm_90a, csrc/{stem}.cu): {info['seconds']} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    # The plain versions of K6 take float32 products through torch.einsum.
    assert not torch.backends.cuda.matmul.allow_tf32
    t0 = time.perf_counter()
    assert entropy_native.available(), "native host entropy decoder did not build"
    print(f"native entropy build + load (g++): {time.perf_counter() - t0} s")

    phase_done(1)
    # The frames of K3's rounds sweep, encoded in the background from here.
    sweep_jobs = [(args.seed + 1, mode, quality)
                  for quality in (50, 75, 95) for mode in ("4:4:4", "4:2:0")]
    sweep_pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    sweep_data = [sweep_pool.submit(sweep_encode, job) for job in sweep_jobs]
    # BASELINE.json config 4's corpus: 32 distinct images (seeds 100-131,
    # qualities 70-95), each with its own Huffman and quant tables.
    corpus_jobs = [(100 + k, 70 + (25 * k) // 31) for k in range(32)]
    corpus_data = [sweep_pool.submit(corpus_encode, job) for job in corpus_jobs]
    # Phase 12's full-size frames (BASELINE configs 3 and 5) and their CPU decodes.
    fullsize_jobs = {f.name: sweep_pool.submit(fullsize_build, f.name) for f in fullsize.FRAMES}
    sweep_pool.shutdown(wait=False)   # the workers end with their last job

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
    # A batch of three odd-sized frames in one launch, a table set per
    # image: the second and third images start at offsets that are not
    # multiples of 16 bytes.
    trng = np.random.default_rng(args.seed + 8)
    for mode, _, _ in GEOMETRIES:
        imgs = [corpus.synthetic_rgb(37, 53, seed=args.seed + 40 + b) for b in range(3)]
        for ups in ("nearest", "fancy"):
            spec, geom, comps, _ = soa_inputs(imgs, mode, ups)
            tables = [torch.from_numpy(trng.integers(1, 64, size=(3, 64)).astype(np.int32))
                      .to(dev) for _ in range(3)]
            a, kw = pipeline.fused_soa_args(spec, geom, comps, tables)
            got = pixel_fused.decode_rgb_fused_soa(*a, **kw)
            ref = pixel_fused.decode_rgb_fused_soa_reference(*a, **kw)
            torch.cuda.synchronize()
            assert got.shape == ref.shape == (3, 37, 53, 3), (got.shape, ref.shape)
            err = int((got.int() - ref.int()).abs().max())
            max_err = max(max_err, err)
            print(f"K1 vs plain {mode} {ups:7s} batch of 3 frames 37x53, a table set per "
                  f"image: max abs err {err}")
            assert err == 0, (mode, ups, "batch")

    phase_done(2)
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

    phase_done(3)
    # -- 4. K3 against its plain version -------------------------------------
    def scan_inputs(data, subseq_bytes=None, sb_target=device_entropy.SCAN_SB_TARGET):
        """A scan's inputs on the card, at the engine's subsequence size
        unless one is pinned."""
        inp = segments.build_spec_scan_input(parse(data), subseq_bytes=subseq_bytes,
                                             sb_target=sb_target)
        w, = plan_tensors((inp.windows,), dev)
        tabs = plan_tensors((inp.dcslot_of_c, inp.acslot_of_c, inp.cbase,
                             inp.counts, inp.symbols), dev)
        kw = dict(sb=inp.subseq_bytes, maxrec=inp.maxrec, n_mcus=inp.n_mcus)
        return (w, inp.n_bits, *tabs), kw

    def k3_check(name, a, kw, serial):
        """Kernel against plain on one scan's inputs; ``serial`` is the
        native scan's bitpos, held wherever the scan came out ok."""
        before = specsync_device.launches
        *got, lanes = specsync_device.index_scan_kernel(*a, **kw)
        # Two kernels a scan: the symbol tables', then the cooperative scan.
        assert specsync_device.launches == before + 2, name
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = specsync_device.device_index_scan(*a, **kw, plain=True)
        stop.record()
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip(got, ref)]
        err = int((got[0].long() - ref[0].long()).abs().max())
        stats = got[2].tolist()
        # Scans that are not ok leave bitpos undefined; the engine then
        # falls back to the serial scan.
        vs_serial = "n/a, not ok"
        if bool(got[1]) and serial is not None:
            vs_serial = np.array_equal(got[0].cpu().numpy(), serial[: kw["n_mcus"]])
        lanes = lanes.tolist()[: stats[0] + 1]
        print(f"K3 vs plain {name} (SB {kw['sb']}, windows {tuple(a[0].shape)}): "
              f"bitpos/ok/stats equal {same}; ok {bool(got[1])}, stats (rounds, records, "
              f"overflow) {stats}; lanes decoded per pass {lanes}; bitpos == serial scan: "
              f"{vs_serial}")
        assert all(same) and vs_serial is not False, name
        return stats, err, bool(got[1]), lanes, start.elapsed_time(stop)

    def k3_case(name, data, subseq_bytes=None, want_ok=None, **over):
        a, kw = scan_inputs(data, subseq_bytes)
        kw.update(over)
        serial = entropy_native.index_scan(parse(data), 1)[0].astype(np.int32)
        out = k3_check(name, a, kw, serial)
        assert want_ok is None or out[2] == want_ok, name
        return out

    k3_err = 0
    for mode in ("4:2:0", "4:2:2", "4:4:4", "mono"):
        _, err, *_ = k3_case(f"{mode} 130x250", encode(130, 250, mode, args.seed + 23)[1], 32)
        k3_err = max(k3_err, err)
    # MCUs of more than 10 blocks, which the parser accepts: 18 and 12.
    _, data_h4v4 = encode(260, 500, "h4v4", args.seed + 23)
    for name, data in (("h4v4 260x500", data_h4v4),
                       ("4:4:4-2x2 130x250", encode(130, 250, "4:4:4-2x2", args.seed + 23)[1])):
        _, err, *_ = k3_case(f"{name}, {parse(data).header.blocks_per_mcu()} blocks per MCU",
                             data, want_ok=True)
        k3_err = max(k3_err, err)
    img1080, data1080 = encode(1080, 1920, "4:2:0", args.seed + 1)
    img4k, data4k = encode(2160, 3840, "4:2:2", args.seed + 1)
    k3_stats, err, _, k3_lanes, _ = k3_case("1080p 4:2:0", data1080, want_ok=True)
    k3_err = max(k3_err, err)
    k3_stats4k, err, _, _, k3_plain4k_ms = k3_case("4K 4:2:2", data4k, want_ok=True)
    k3_err = max(k3_err, err)
    _, small_colour = encode(256, 640, "4:2:0", args.seed + 25)
    _, small_gray = encode(130, 500, "mono", args.seed + 25)
    stats, err, *_ = k3_case("4:2:0 256x640, runs out of its 16 rounds", small_colour, 32,
                             want_ok=False)
    assert stats[0] == 16 and stats[2] == 0, stats
    k3_err = max(k3_err, err)
    stats, err, *_ = k3_case("mono 130x500, one record allowed per lane (overflow)",
                             small_gray, 64, want_ok=False, maxrec=1)
    assert stats[2] == 1, stats
    k3_err = max(k3_err, err)
    # No padding lane: a stream cut at the end of its first batch of
    # lanes (the last lane's window still holds the words that follow).
    _, fill_gray = encode(384, 768, "mono", args.seed + 25)
    a, kw = scan_inputs(fill_gray, 64)
    assert a[0].shape[0] >= 2, a[0].shape
    serial = entropy_native.index_scan(parse(fill_gray), 1)[0].astype(np.int32)
    cut_bits = 1024 * 64 * 8
    kw["n_mcus"] = int((serial < cut_bits).sum())
    fill_serial = serial
    _, err, ok, *_ = k3_check("mono 384x768 cut to fill one batch of lanes exactly",
                              (a[0][:1].contiguous(), cut_bits, *a[2:]),
                              dict(kw, max_rounds=32), serial)
    assert ok
    k3_err = max(k3_err, err)

    # Tables that are no Huffman tables leave windows to decode_symbol: the
    # kernel then runs its step with that call compiled in.
    a, kw = scan_inputs(encode(64, 96, "4:2:0", args.seed + 26)[1], 32)
    junk = plan_tensors(scan_cases.random_tables(args.seed + 7), dev)
    # So does a valid table with long codes under more 10-bit prefixes than
    # the first level has second-level tables for.
    deep = plan_tensors(scan_cases.deep_code_tables([t.cpu().numpy() for t in a[4:]]), dev)
    for name, tabs in (("random numbers for tables", junk),
                       (f"an AC table of {scan_cases.DEEP_CODES} codes of 11 bits", deep)):
        assert not bool(specsync_device.scan_lut(*tabs)[1].all()), name
        _, err, *_ = k3_check(f"4:2:0 64x96 with {name}", (*a[:4], *tabs),
                              dict(kw, max_rounds=3), None)
        k3_err = max(k3_err, err)

    # The symbol tables, K3's and K2's: the kernel's against the plain
    # version's, and their lookup against decode_symbol, every 16-bit prefix
    # (zero- and one-extended) of every slot and sublane.
    def lut_check(kname, build, reference, entry, what):
        for name, tabs in (("1080p 4:2:0", scan_inputs(data1080)[0][4:]),
                           ("mono 130x500", scan_inputs(small_gray)[0][4:]),
                           ("deep AC table", deep)):
            lut, complete = build(*tabs)
            assert torch.equal(lut, reference(*tabs)), (kname, name)
            assert torch.equal(complete, entropy_device.lut_complete(lut)), (kname, name)
            # An encoder's tables leave nothing to decode_symbol; the deep table
            # leaves its slot's first-level misses.
            whole = name != "deep AC table"
            assert bool(complete.all()) == whole and bool(complete[:, :4].all()), (kname, name)
            tab = entropy_device._Tables(*tabs)
            prefix = torch.arange(1 << 16, dtype=torch.int64, device=dev) << 16
            hi = torch.cat([prefix, prefix | 0xFFFF]).expand(8, -1)
            for sub in range(8):
                t = (tab.cbase[:, None], tab.counts[:, None],
                     tab.symbols[:, sub, None].expand(-1, hi.shape[1], -1), tab.limit[:, None])
                want = entry(*entropy_device.decode_symbol(hi, *t))
                got = entropy_device.lut_lookup(lut[sub], hi)
                answered = got != entropy_device.LUT_MISS
                assert torch.equal(torch.where(answered, got, want), want), (kname, name, sub)
                assert bool(answered.all()) == whole, (kname, name, sub)
            first = lut[..., : 1 << entropy_device.LUT_BITS]
            direct = float(((first & entropy_device.LUT_SUB) == 0).float().mean())
            print(f"{kname} symbol tables {name}: equal to their plain version; equal to "
                  f"decode_symbol ({what}) for 2 x 65536 windows x 8 slots x 8 sublanes "
                  f"wherever they answer, {float(answered.float().mean())} of sublane 7's "
                  f"windows; {direct} of the first level's {first.numel()} entries answer "
                  f"without the second")

    lut_check("K3", specsync_device.scan_lut, specsync_device.scan_lut_reference,
              specsync_device.chain_entry,
              "symbol, length, bits consumed; an invalid code as EOB of 17 bits")

    def k2_lut(*tabs):
        tables, complete = entropy_device.lut_views(entropy_device.symbol_lut(*tabs))
        return tables[0], complete[0]

    lut_check("K2", k2_lut, entropy_device.lut_reference, entropy_device.symbol_entry,
              "code length and symbol; any invalid code as length 17")

    # K2's fused form against its plain version (coefficients with the DC
    # predictors applied, and the full flag tensor) and against the chain it
    # replaces, gather -> row form -> DC bases, on rows as wide as the plain
    # version's: equal on the real lanes, flags equal but for the end check's
    # ERR_OVERRUN (0 on both sides for a valid stream).
    def fused_inputs(data, subseq_bytes=None):
        inp = segments.build_spec_scan_input(parse(data, validate=False),
                                             subseq_bytes=subseq_bytes,
                                             sb_target=device_entropy.SCAN_SB_TARGET)
        return inp, plan_tensors(
            (inp.windows, inp.dcslot_of_c, inp.acslot_of_c, inp.cbase, inp.counts, inp.symbols,
             inp.comp_of_step, inp.dc_slot_of_step, inp.ac_slot_of_step, inp.seg_meta), dev)

    def real_lanes(x, n):
        return x.reshape(x.shape[0], -1, 1024).movedim(-1, 1).reshape(x.shape[0] * 1024, -1)[:n]

    def old_chain(inp, t, bitpos, tabs, nw, lut=None):
        w, cm, dm, am, meta = t[0], *t[6:10]
        streams = entropy_device.gather_entropy_streams(w, bitpos, nw=nw, spw=inp.spw,
                                                        nws=inp.nws)
        out, err = entropy_device.decode_segments_device(streams, cm, dm, am, meta, *tabs,
                                                         lut=lut)
        dcb = entropy_device.dc_base_from_coefs(out, inp.t_last)
        return entropy_device.apply_dc_base(out, dcb, cm), err

    k2_fused_err = 0

    def k2_fused_case(name, inp, t, bitpos=None, n_bits=None, tables=None, valid=True):
        nonlocal k2_fused_err
        w, dc_c, ac_c, cm, dm, am = t[0], t[1], t[2], *t[6:9]
        tabs = tables or t[3:6]
        n_bits = inp.n_bits if n_bits is None else n_bits
        ok = None
        if bitpos is None:
            bitpos, ok, _ = specsync_device.device_index_scan(
                w, n_bits, dc_c, ac_c, *tabs, sb=inp.subseq_bytes, maxrec=inp.maxrec,
                n_mcus=inp.n_mcus)
        n = bitpos.shape[0]
        before = entropy_device.launches
        got, gerr = entropy_device.decode_mcus_at_bitpos(w, bitpos, n_bits, cm, dm, am, *tabs,
                                                         spw=inp.spw)
        # The table kernel (none were given), the decode, the DC predictors.
        assert entropy_device.launches == before + 3, name
        ref, rerr = entropy_device.decode_mcus_at_bitpos_reference(
            w, bitpos, n_bits, cm, dm, am, *tabs, spw=inp.spw)
        wide = min(cm.shape[0] * 64 * 31 // 32, w.shape[0] * 1024 * inp.spw) + 3
        old, oerr = old_chain(inp, t, bitpos, tabs, wide)
        torch.cuda.synchronize()
        err = int((got.int() - ref.int()).abs().max())
        k2_fused_err = max(k2_fused_err, err)
        over = entropy_device.ERR_OVERRUN
        same_old = (torch.equal(real_lanes(got, n), real_lanes(old, n))
                    and torch.equal(real_lanes(gerr, n) | over, real_lanes(oerr, n) | over))
        nflag = int((gerr != 0).sum())
        # The longest span of the stream one warp's MCUs cover, in words.
        bp = bitpos.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
        ends = np.append(bp[1:], n_bits)
        span = max(int((ends[min(i + 31, n - 1)] >> 5) + 3 - (bp[i] >> 5))
                   for i in range(0, n, 32))
        print(f"K2 fused vs plain {name}: windows {tuple(w.shape)}, {n} MCUs x "
              f"{cm.shape[0]} blocks, scan ok {None if ok is None else bool(ok)}: coefs "
              f"{tuple(got.shape)} max abs err {err}, flags equal {torch.equal(gerr, rerr)} "
              f"({nflag} lanes flagged); equal to gather -> row form -> DC bases on the "
              f"real lanes: {same_old}; longest warp span {span} words (2048 are staged)")
        assert err == 0 and torch.equal(gerr, rerr) and same_old, name
        if valid:
            assert nflag == 0 and (ok is None or bool(ok)), name
            assert torch.equal(real_lanes(gerr, n), real_lanes(oerr, n)), name
        return span, nflag

    for mode in ("mono", "4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1"):
        k2_fused_case(f"{mode} 130x250", *fused_inputs(encode(130, 250, mode, args.seed + 23)[1]))
    k2_fused_case("h4v4 260x500, 18 blocks per MCU", *fused_inputs(data_h4v4))
    k2_fused_case("4:4:4-2x2 130x250, 12 blocks per MCU",
                  *fused_inputs(encode(130, 250, "4:4:4-2x2", args.seed + 23)[1]))
    k2_fused_case("1080p 4:2:0", *fused_inputs(data1080))
    k2_fused_case("4K 4:2:2", *fused_inputs(data4k))
    # The stream that fills its one batch of lanes exactly: the last MCU
    # runs past the grid, into the 0xFFFFFFFF padding.
    inp, t = fused_inputs(fill_gray, 64)
    cut_pos = torch.from_numpy(fill_serial[fill_serial < cut_bits].copy()).to(dev)
    k2_fused_case("mono 384x768 cut to fill one batch of lanes exactly", inp,
                  (t[0][:1].contiguous(), *t[1:]), bitpos=cut_pos, n_bits=cut_bits,
                  valid=False)
    # A corrupted stream: 40 bytes of ones in the middle of the scan.
    _, data = encode(130, 250, "4:2:0", args.seed + 27)
    s0, e0 = parse(data).segments[0]
    mid = (s0 + e0) // 2
    bad = data[:mid] + (b"\xff\x00" * 20) + data[mid + 40:]
    _, nflag = k2_fused_case("4:2:0 130x250, 40 bytes of the scan overwritten with ones",
                             *fused_inputs(bad), valid=False)
    assert nflag > 0
    # Tables that leave windows to decode_symbol.
    inp, t = fused_inputs(encode(64, 96, "4:2:0", args.seed + 26)[1], 32)
    for name, tabs in (("random numbers for tables", junk),
                       (f"an AC table of {scan_cases.DEEP_CODES} codes of 11 bits", deep)):
        assert not bool(k2_lut(*tabs)[1].all()), name
        k2_fused_case(f"4:2:0 64x96 with {name}", inp, t, tables=tabs, valid=False)
    # A few MCUs of noise at quality 100 among flat ones: one warp's MCUs
    # cover more of the stream than is staged, the rest is read from device
    # memory.  (The bit positions are the serial scan's: MCUs of a few bytes
    # beside MCUs of a kilobyte overflow the index scan's records.)
    noisy = np.full((64, 1024, 3), 128, np.uint8)
    noisy[16:32] = np.random.default_rng(args.seed + 28).integers(0, 256, (16, 1024, 3))
    data = corpus.own_jpeg(noisy, subsampling="4:2:0", quality=100).data
    noisy_pos = entropy_native.index_scan(parse(data), 1)[0].astype(np.int32)
    span, _ = k2_fused_case(
        "4:2:0 64x1024 quality 100, one MCU row of noise among flat ones",
        *fused_inputs(data), bitpos=torch.from_numpy(noisy_pos).to(dev))
    assert span > 2048, span

    # Lanes decoded per pass: the kernel's count against the plain version
    # of its scheme (a lane decodes only when its entry changed).
    a, kw = scan_inputs(data1080)
    lazy = specsync_device.device_index_scan_lazy_reference(*a, **kw)
    torch.cuda.synchronize()
    print(f"K3 lanes decoded per pass, 1080p 4:2:0: kernel {k3_lanes}, plain lazy scheme "
          f"{lazy[3]}; of {a[0].shape[0] * 1024} lanes x {len(k3_lanes)} passes = "
          f"{a[0].shape[0] * 1024 * len(k3_lanes)} lane decodes when every lane decodes "
          f"every pass, {sum(k3_lanes)} ran")
    assert k3_lanes == lazy[3], (k3_lanes, lazy[3])

    # A host sync inside the scan raises under the sync debug mode.
    sync_mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        unsynced = specsync_device.device_index_scan(*a, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(sync_mode)
    assert all(torch.equal(x, y) for x, y in zip(unsynced, lazy[:3]))
    print("K3 whole device_index_scan, 1080p 4:2:0, under "
          "torch.cuda.set_sync_debug_mode('error'): ran, result equal")

    # The engine on streams whose scan fails: the serial fallback runs and
    # the decode equals the CPU path.
    real_build = device_entropy.build_spec_scan_input

    def failing_build(subseq_bytes, maxrec=None):
        def build(parsed, **kw):
            inp = real_build(parsed, subseq_bytes=subseq_bytes, **kw)
            inp.maxrec = maxrec or inp.maxrec
            return inp
        return build

    for name, data, pins in (("runs out of rounds", small_colour, {"subseq_bytes": 32}),
                             ("overflows its records", small_gray,
                              {"subseq_bytes": 64, "maxrec": 1})):
        device_entropy.build_spec_scan_input = failing_build(**pins)
        device_entropy._DEVICE_TABLES.clear()   # the tables' build counts below
        try:
            before = specsync_device.launches
            dec = jt.get_decoder(data, device="cuda", entropy="device")
            out = dec.decode()
        finally:
            device_entropy.build_spec_scan_input = real_build
        # K3's table kernel (once per table set) and its scan.
        assert specsync_device.launches == before + 2 and dec.specsync_stats is None, name
        assert np.array_equal(out, jt.decode(data, device="cpu")), name
        print(f"engine, entropy='device', a stream whose scan {name}: K3 ran, the serial "
              f"fallback took over, equal to the CPU path")

    # An MCU of 18 blocks through the engine: K3 runs, no fallback.
    dec = jt.get_decoder(data_h4v4, device="cuda", entropy="device")
    out = dec.decode()
    assert dec.specsync_stats is not None, "h4v4: the serial index scan ran, not K3"
    assert np.array_equal(out, jt.decode(data_h4v4, device="cpu"))
    print(f"engine, entropy='device', h4v4 260x500 (18 blocks per MCU): K3 ran, index scan "
          f"stats {dec.specsync_stats}, equal to the CPU path")

    phase_done(4)
    # -- 5. K5, K6 and K4 against their plain versions -----------------------
    rng = np.random.default_rng(args.seed + 30)

    def random_blocks(shape, lim, qhi):
        c = rng.integers(-lim, lim, size=shape + (8, 8), dtype=np.int16)
        q = rng.integers(1, qhi, size=64).astype(np.int32)
        return torch.from_numpy(c).to(dev), torch.from_numpy(q).to(dev)

    k5_err = 0
    for vb, hb in ((1, 1), (3, 5), (17, 33), (136, 240)):
        for lead in ((), (3,)):
            c, q = random_blocks(lead + (vb, hb), 1500, 64)
            for layout, soa in (("planes", blocks_as_soa(c).contiguous()),
                                ("view of blocks", blocks_as_soa(c))):
                got = idct_islow_plane.dequant_idct_islow_plane_soa(soa, q)
                ref = idct_islow_plane.dequant_idct_islow_plane_soa_reference(soa, q)
                torch.cuda.synchronize()
                assert got.shape == ref.shape == lead + (vb * 8, hb * 8)
                err = int((got.int() - ref.int()).abs().max())
                k5_err = max(k5_err, err)
                print(f"K5 vs plain {lead + (vb, hb)} blocks, int16, {layout}: "
                      f"max abs err {err}")
                assert err == 0, (lead, vb, hb, layout)

    # All four grids in one launch, each plane with its own table; planes as
    # contiguous SoA and as views of blocks, mixed too; equal to its plain
    # version and to one call per plane.
    def k5_multi(name, planes, tables):
        nonlocal k5_err
        before = idct_islow_plane.launches
        got = idct_islow_plane.dequant_idct_islow_planes_soa(planes, tables)
        assert idct_islow_plane.launches == before + 1, name
        ref = [idct_islow_plane.dequant_idct_islow_plane_soa_reference(c, q)
               for c, q in zip(planes, tables)]
        single = [idct_islow_plane.dequant_idct_islow_plane_soa(c, q)
                  for c, q in zip(planes, tables)]
        torch.cuda.synchronize()
        err = max(int((g.int() - r.int()).abs().max()) for g, r in zip(got, ref))
        same = all(torch.equal(g, x) for g, x in zip(got, single))
        k5_err = max(k5_err, err)
        print(f"K5 one launch vs plain {name}: {[tuple(g.shape) for g in got]} samples, "
              f"max abs err {err}; equal to one call per plane: {same}")
        assert err == 0 and same, name

    multi = [random_blocks(g, 1500, 64) for g in ((1, 1), (3, 5), (17, 33), (136, 240))]
    for layout, pick in (("contiguous planes", lambda i, c: blocks_as_soa(c).contiguous()),
                         ("views of blocks", lambda i, c: blocks_as_soa(c)),
                         ("planes and views in turn",
                          lambda i, c: blocks_as_soa(c).contiguous() if i % 2 else blocks_as_soa(c))):
        k5_multi(f"grids (1, 1), (3, 5), (17, 33), (136, 240), {layout}",
                 [pick(i, c) for i, (c, _) in enumerate(multi)], [q for _, q in multi])
    c3, q3 = random_blocks((3, 17, 33), 1500, 64)
    k5_multi("a leading axis of 3 beside a single grid",
             [blocks_as_soa(c3), blocks_as_soa(multi[1][0])], [q3, multi[1][1]])

    k6_err = 0

    def k6_case(name, got, ref):
        nonlocal k6_err
        torch.cuda.synchronize()
        diff = (got.int() - ref.int()).abs()
        err, ndiff = int(diff.max()), int((diff != 0).sum())
        k6_err = max(k6_err, err)
        print(f"K6 vs plain {name}: max abs err {err}, {ndiff} of {diff.numel()} "
              f"samples differ")
        assert err <= 1, name

    c, q = random_blocks((100000,), 300, 50)
    k6_case("100000 random blocks in [-300, 300), table in [1, 50), blocks in and out",
            idct_float.dequant_idct_pixels_fused(c, q),
            idct_float.dequant_idct_pixels_reference(c, q))
    c, q = random_blocks((3, 17, 33), 300, 50)
    k6_case("(3, 17, 33) random blocks, view of blocks",
            idct_float.dequant_idct_float_plane_soa(blocks_as_soa(c), q),
            idct_float.dequant_idct_float_plane_soa_reference(blocks_as_soa(c), q))
    # K6 with all planes in one launch, each with its own grid and table,
    # contiguous and as views: equal to one call per plane, within 1 of the
    # plain version.
    def k6_multi(name, planes, tables):
        before = idct_float.launches
        got = idct_float.dequant_idct_float_planes_soa(planes, tables)
        assert idct_float.launches == before + 1, name
        single = [idct_float.dequant_idct_float_plane_soa(c, q) for c, q in zip(planes, tables)]
        for i, (g, c, q) in enumerate(zip(got, planes, tables)):
            k6_case(f"one launch, {name}, plane {i} {tuple(g.shape)}", g,
                    idct_float.dequant_idct_float_plane_soa_reference(c, q))
        same = all(torch.equal(g, x) for g, x in zip(got, single))
        print(f"K6 one launch {name}: equal to one call per plane: {same}")
        assert same, name

    multi6 = [random_blocks(g, 300, 50) for g in ((1, 1), (3, 5), (17, 33), (136, 240))]
    for layout, pick in (("contiguous planes", lambda c: blocks_as_soa(c).contiguous()),
                         ("views of blocks", blocks_as_soa)):
        k6_multi(f"grids (1, 1), (3, 5), (17, 33), (136, 240), {layout}",
                 [pick(c) for c, _ in multi6], [q for _, q in multi6])

    # A table per leading index ((3, 1, 1, 8, 8), as the batch code passes
    # them) beside a plane with one table, K5 and K6 in one launch each.
    for multi_check, lim, qhi in ((k5_multi, 1500, 64), (k6_multi, 300, 50)):
        c3, _ = random_blocks((3, 17, 33), lim, qhi)
        q3 = torch.from_numpy(rng.integers(1, qhi, size=(3, 1, 1, 8, 8)).astype(np.int32)).to(dev)
        c1, q1 = random_blocks((68, 120), lim, qhi)
        multi_check("a table per leading index (3, 1, 1, 8, 8) beside one table",
                    [blocks_as_soa(c3), blocks_as_soa(c1).contiguous()], [q3, q1])

    for lo, hi in ((-256, 255), (-5, 5), (-300, 300)):
        # IEEE 1180-1990 style: random pixel blocks -> float64 forward DCT ->
        # integer coefficients; the card's samples against a float64 IDCT.
        pix = rng.integers(lo, hi + 1, size=(10000, 8, 8)).astype(np.float64)
        coefs = np.einsum("ui,nij,vj->nuv", DCT_BASIS_F64, pix, DCT_BASIS_F64)
        coefs = np.clip(np.round(coefs), -2048, 2047).astype(np.int16)
        exact = np.einsum("ui,nuv,vj->nij", DCT_BASIS_F64, coefs.astype(np.float64),
                          DCT_BASIS_F64)
        exact = np.clip(np.round(exact + 128.0), 0, 255)
        got = idct_float.dequant_idct_pixels_fused(
            torch.from_numpy(coefs).to(dev), torch.ones(64, dtype=torch.int32, device=dev))
        e = got.cpu().numpy().astype(np.float64) - exact
        print(f"K6 vs float64 IDCT, pixel range [{lo}, {hi}], 10000 blocks: peak error "
              f"{np.abs(e).max()}, mean square error {(e ** 2).mean()}, worst pixel "
              f"mean square error {(e ** 2).mean(axis=0).max()}, mean error {e.mean()}")
        assert np.abs(e).max() <= 1 and (e ** 2).mean() <= 0.02
        assert (e ** 2).mean(axis=0).max() <= 0.06 and abs(e.mean()) <= 0.0015

    k4_err = 0

    def k4_case(name, data):
        nonlocal k4_err
        parsed = parse(data)
        scan = entropy_native.decode_scan(parsed, want_pack=True)
        plan = build_pack_plan(parsed, scan)
        streams, = plan_tensors((plan.streams,), dev)
        got = pack_device.expand_pack_device(streams, plan.blocks_per_segment)
        ref = pack_device.expand_pack_reference(streams, plan.blocks_per_segment)
        torch.cuda.synchronize()
        err = int((got.int() - ref.int()).abs().max())
        k4_err = max(k4_err, err)
        dense = device_entropy.expand_pack_device(parsed, scan, dev)
        same = all(np.array_equal(d.cpu().numpy(), h) for d, h in zip(dense, scan.coefs))
        print(f"K4 vs plain {name}: streams {tuple(streams.shape)}, "
              f"{plan.n_segments} lanes x {plan.blocks_per_segment} blocks, "
              f"{plan.packed_entries} entries: max abs err {err}; assembled == the "
              f"host's dense coefficients: {same}")
        assert err == 0 and same, name
        return parsed, scan, plan

    for mode in ("mono", "4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1"):
        k4_case(f"{mode} 130x250", encode(130, 250, mode, args.seed + 31)[1])
    k4_case("mono 64x80", encode(64, 80, "mono", args.seed + 32)[1])
    parsed1080, scan1080, pack1080 = k4_case("1080p 4:2:0", data1080)
    parsed4k, scan4k, pack4k = k4_case("4K 4:2:2", data4k)

    def k4_streams(name, words, t, oracle=None):
        """Hand-made rows: kernel against plain, and against the scalar walk
        of each filled lane.  The allocator's next block of the output's
        size is dirtied first, so the kernel's own zero-fill is held too."""
        nonlocal k4_err
        streams, = plan_tensors((words,), dev)
        torch.full((words.shape[0], t, 64, 8, 128), -1, dtype=torch.int16, device=dev)
        got = pack_device.expand_pack_device(streams, t)
        ref = pack_device.expand_pack_reference(streams, t)
        torch.cuda.synchronize()
        err = int((got.int() - ref.int()).abs().max())
        k4_err = max(k4_err, err)
        flat = got.reshape(words.shape[0], t, 64, 1024).cpu().numpy()
        walked = all(np.array_equal(flat[0, :, :, lane], coefs)
                     for lane, coefs in (oracle or {}).items())
        print(f"K4 vs plain {name}: streams {tuple(streams.shape)}, {t} blocks: max abs err "
              f"{err}; {len(oracle or {})} lanes equal to the scalar walk: {walked}")
        assert err == 0 and walked, name

    for name, (entries, t, nw) in pack_cases.HANDMADE.items():
        k4_streams(f"hand-made {name}", pack_cases.stream_words(entries, nw), t,
                   {0: pack_cases.walk(entries, t)})
    rows = {lane: e for lane, (e, _, _) in zip((0, 1, 31, 32), pack_cases.HANDMADE.values())}
    for lane in (33, 640, 1023):
        rows[lane] = pack_cases.random_entries(rng, int(rng.integers(40, 81)))
    k4_streams("hand-made and random streams side by side", pack_cases.lanes_words(rows, 40), 5,
               {lane: pack_cases.walk(e, 5) for lane, e in rows.items()})
    for b, t, nw in ((1, 3, 1), (2, 7, 17), (1, 12, 100)):
        e = np.array(pack_cases.random_entries(rng, b * nw * 2048), dtype=np.uint32)
        e = e.reshape(b, nw, 2, 1024)
        k4_streams("random entries in every lane",
                   ((e[:, :, 0] << 16) | e[:, :, 1]).view(np.int32).reshape(b, nw, 8, 128), t)
    gray = corpus.synthetic_rgb(512, 512, seed=args.seed + 2)[..., 1].copy()
    data_gray = corpus.own_jpeg(gray, quality=85).data
    img_v4 = corpus.synthetic_rgb(130, 250, seed=args.seed + 3)
    data_v4 = corpus.own_jpeg(img_v4, subsampling="h2v4", quality=85).data

    def decoded_planes(name, parsed, coefs):
        """K5 and K6 against their plain versions on a frame's decoded
        coefficients: every component's block grid as the main path hands
        it over (a view of blocks), with the component's own table."""
        nonlocal k5_err
        hdr = parsed.header
        planes, qts = pipeline.to_torch_inputs(
            coefs, [hdr.quant_for(c).values for c in hdr.components], dev)
        for ci, (c, q) in enumerate(zip(planes, qts)):
            soa = blocks_as_soa(c)
            got = idct_islow_plane.dequant_idct_islow_plane_soa(soa, q)
            ref = idct_islow_plane.dequant_idct_islow_plane_soa_reference(soa, q)
            torch.cuda.synchronize()
            err = int((got.int() - ref.int()).abs().max())
            k5_err = max(k5_err, err)
            print(f"K5 vs plain {name} decoded coefficients, component {ci} "
                  f"{tuple(c.shape[:2])} blocks: max abs err {err}")
            assert err == 0, (name, ci)
            k6_case(f"{name} decoded coefficients, component {ci} {tuple(c.shape[:2])} blocks",
                    idct_float.dequant_idct_float_plane_soa(soa, q),
                    idct_float.dequant_idct_float_plane_soa_reference(soa, q))
        for layout, views in (("views of blocks", [blocks_as_soa(c) for c in planes]),
                              ("contiguous planes",
                               [blocks_as_soa(c).contiguous() for c in planes])):
            k5_multi(f"{name} decoded coefficients, all components, {layout}", views, list(qts))
            k6_multi(f"{name} decoded coefficients, all components, {layout}", views, list(qts))
        return planes, qts

    k6_planes, k6_qts = decoded_planes("1080p 4:2:0", parsed1080, scan1080.coefs)
    decoded_planes("4K 4:2:2", parsed4k, scan4k.coefs)
    for name, data in (("512x512 gray", data_gray), ("130x250 h2v4", data_v4)):
        parsed = parse(data)
        decoded_planes(name, parsed, entropy_native.decode_scan(parsed).coefs)

    phase_done(5)
    # -- 6. the main paths ---------------------------------------------------
    frames = [("1080p 4:2:0", img1080, data1080, "nearest", "auto"),
              ("1080p 4:2:0", img1080, data1080, "fancy", "auto"),
              ("4K 4:2:2", img4k, data4k, "fancy", "auto"),
              ("1080p 4:2:0", img1080, data1080, "nearest", "device"),
              ("1080p 4:2:0", img1080, data1080, "fancy", "device"),
              ("1080p 4:2:0 R=1", img1080r, data1080r, "nearest", "device"),
              ("4K 4:2:2", img4k, data4k, "fancy", "device")]
    # Table sets stay on the card between decodes; from an empty cache the
    # main path builds each set's symbol tables once, and that is counted.
    device_entropy._DEVICE_TABLES.clear()
    for mod in kernels:
        mod.launches = 0
    outs, scan_stats = [], []
    for _, _, data, ups, ent in frames:
        dec = jt.get_decoder(data, device="cuda", upsample=ups, entropy=ent)
        outs.append(dec.decode())
        scan_stats.append(dec.specsync_stats)
    torch.cuda.synchronize()
    main_launches = [mod.launches for mod in kernels]
    print(f"main path, RGB of the fused geometries: {len(frames)} decodes; launches "
          f"K1 {main_launches[0]}, K2 {main_launches[1]}, K3 {main_launches[2]}")
    assert main_launches[0] == len(frames), main_launches
    dev_frames = [data for _, _, data, _, ent in frames if ent == "device"]
    scan_frames = [data for data in dev_frames if not parse(data).header.restart_interval]

    def table_sets(datas):
        return len({id(segments._table_tensors(parse(d).header)[0]) for d in datas})

    # K2 per decode: two launches without restart markers (the decode out of
    # the scan's windows, then the DC predictors), one with them; K3 one, the
    # cooperative scan.  Each kernel's table kernel once per table set.
    want_k2 = 2 * len(scan_frames) + (len(dev_frames) - len(scan_frames)) + table_sets(dev_frames)
    want_k3 = len(scan_frames) + table_sets(scan_frames)
    print(f"  K2: {len(scan_frames)} fused decodes x 2 + {len(dev_frames) - len(scan_frames)} "
          f"row-form decodes + {table_sets(dev_frames)} table builds = {want_k2}; K3: "
          f"{len(scan_frames)} scans + {table_sets(scan_frames)} table builds = {want_k3}")
    assert main_launches[1] == want_k2 and main_launches[2] == want_k3, main_launches
    cpu_cache = {}

    def cpu_decode(data, stage="rgb", **kw):
        """The port's CPU path (default upload and entropy), decoded once."""
        key = (id(data), stage, tuple(sorted(kw.items())))
        if key not in cpu_cache:
            cpu_cache[key] = jt.decode(data, out=stage, device="cpu", **kw)
        return cpu_cache[key]

    for (name, img, data, ups, ent), out, st in zip(frames, outs, scan_stats):
        h, w = img.shape[:2]
        cpu = cpu_decode(data, upsample=ups)
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

    # The paths of the standalone kernels, counts set to 0 again.
    def parts(r):
        return [r] if isinstance(r, np.ndarray) else (getattr(r, "planes", None) or r.coefs)

    def maxdiff(a, b):
        return max(int(np.abs(x.astype(np.int32) - y.astype(np.int32)).max())
                   for x, y in zip(parts(a), parts(b)))

    # (name, data, stage, decoder options, launches expected of (K4, K5, K6))
    paths = [
        ("1080p 4:2:0 yuv", data1080, "yuv", {}, (0, 1, 0)),
        ("1080p 4:2:0 yuv entropy=device", data1080, "yuv", {"entropy": "device"}, (0, 1, 0)),
        ("512x512 gray rgb", data_gray, "rgb", {}, (0, 1, 0)),
        ("130x250 h2v4 fancy rgb (no fused geometry)", data_v4, "rgb",
         {"upsample": "fancy"}, (0, 1, 0)),
        ("1080p 4:2:0 rgb exact=False", data1080, "rgb", {"exact": False}, (0, 0, 1)),
        ("1080p 4:2:0 rgb exact=False entropy=device", data1080, "rgb",
         {"exact": False, "entropy": "device"}, (0, 0, 1)),
        ("1080p 4:2:0 fancy rgb upload=pack", data1080, "rgb",
         {"upload": "pack", "upsample": "fancy"}, (1, 1, 0)),
        ("4K 4:2:2 fancy rgb upload=pack", data4k, "rgb",
         {"upload": "pack", "upsample": "fancy"}, (1, 1, 0)),
        ("1080p 4:2:0 quant upload=pack", data1080, "quant", {"upload": "pack"}, (1, 0, 0)),
    ]
    for mod in kernels:
        mod.launches = 0
    path_outs, path_counts = [], []
    for name, data, stage, kw, _ in paths:
        before = [mod.launches for mod in kernels]
        path_outs.append(jt.get_decoder(data, device="cuda", **kw).decode(stage))
        path_counts.append([mod.launches - b for mod, b in zip(kernels, before)])
    torch.cuda.synchronize()
    path_launches = [mod.launches for mod in kernels]
    print(f"main paths of the standalone kernels: {len(paths)} decodes; launches "
          + ", ".join(f"K{i + 1} {n}" for i, n in enumerate(path_launches)))
    assert all(path_launches[i] > 0 for i in (3, 4, 5)), path_launches
    # The two entropy="device" decodes here find their tables on the card:
    # two launches of K2 and one of K3 each.
    assert path_launches[1] == 4 and path_launches[2] == 2, path_launches
    for (name, data, stage, kw, want), out, counts in zip(paths, path_outs, path_counts):
        assert tuple(counts[3:]) == want, (name, counts)
        # The CPU path at the default upload: upload="pack" must change nothing.
        cpu_kw = {"upsample": kw.get("upsample", "nearest")}
        if not kw.get("exact", True):
            cpu_kw["exact"] = False
        cpu = cpu_decode(data, stage, **cpu_kw)
        for a, b in zip(parts(out), parts(cpu)):
            assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape)
        d = maxdiff(out, cpu)
        text = f"max abs diff vs the CPU path {d}"
        if kw.get("exact", True):
            assert d == 0, (name, d)
        else:
            dx = maxdiff(out, cpu_decode(data, stage, upsample=cpu_kw["upsample"]))
            text += f" (allowed 2), vs the exact decode {dx} (allowed 4)"
            assert d <= 2 and dx <= 4, (name, d, dx)
        print(f"main path {name}: launches K4 {counts[3]}, K5 {counts[4]}, "
              f"K6 {counts[5]}; {text}")
    quant = parts(path_outs[-1])
    assert all(np.array_equal(a, b) for a, b in zip(quant, scan1080.coefs))
    print("main path 1080p 4:2:0 quant upload=pack: equal to the host's coefficients")
    main_launches = [a + b for a, b in zip(main_launches, path_launches)]

    _, small = encode(256, 384, "4:2:0", args.seed + 24, restart=1)
    bad = corrupt_segment(small, 40)
    salvaged = jt.decode(bad, device="cuda", entropy="device", on_error="zero")
    cpu_salvaged = jt.decode(bad, device="cpu", entropy="device", on_error="zero")
    assert np.array_equal(salvaged, cpu_salvaged)
    print("on_error='zero', 256x384 4:2:0 R=1 with segment 40 corrupted: "
          "equal to the CPU port's salvage")

    phase_done(6)
    # -- 7. the corpus: BASELINE.json config 4 on one card -------------------
    from jpeg_gpu_tpu_torch import cli
    from jpeg_gpu_tpu_torch.engine import batch
    from jpeg_gpu_tpu_torch.errors import JpegFormatError, JpegUnsupportedError
    from jpeg_gpu_tpu_torch.host import oracle_native

    distinct = [f.result() for f in corpus_data]
    n_corpus = 256
    corpus_datas = [distinct[k % len(distinct)] for k in range(n_corpus)]
    (bucket,), fallback = batch._device_buckets(corpus_datas, True, "nearest")
    assert not fallback and len(bucket.indices) == n_corpus
    n_sets = len({p.counts.tobytes() + p.symbols.tobytes() for p in bucket.plans})
    assert n_sets == len(distinct), n_sets
    corpus_mpix = n_corpus * 256 * 256 / 1e6

    def run_counted(fn):
        """fn() with the launch counts set to 0 just before; (out, counts)."""
        for mod in kernels:
            mod.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, [mod.launches for mod in kernels]

    (rgb_res, err_res), res_counts = run_counted(
        lambda: batch.decode_batch_device_resident(corpus_datas, device="cuda"))
    corpus_outs, dl_counts = run_counted(
        lambda: batch.decode_batch_device(corpus_datas, device="cuda"))
    print(f"corpus of {n_corpus} images 256x256 4:2:0 R=1 ({len(distinct)} distinct, "
          f"{n_sets} Huffman table sets, one bucket): launches resident {res_counts}, "
          f"with download {dl_counts} (K1..K6)")
    # One bucket: K2 once and its table kernel once, K1 once; nothing else.
    for counts in (res_counts, dl_counts):
        assert counts == [1, 2, 0, 0, 0, 0], counts
    assert rgb_res.is_cuda and err_res.is_cuda
    assert tuple(rgb_res.shape) == (n_corpus, 256, 256, 3) and rgb_res.dtype == torch.uint8
    assert not err_res.any(), "clean corpus flagged"
    rgb_res_np = rgb_res.cpu().numpy()
    single = {}
    for k, (data, out) in enumerate(zip(corpus_datas, corpus_outs)):
        if id(data) not in single:
            single[id(data)] = jt.get_decoder(data, device="cuda", entropy="device").decode()
        assert np.array_equal(out, single[id(data)]), k
        assert np.array_equal(rgb_res_np[k], out), k
    cpu8 = batch.decode_batch_device(corpus_datas[:8], device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(cpu8, corpus_outs[:8]))
    print(f"corpus: all {n_corpus} outputs (resident and downloaded) byte-identical to "
          f"per-image TorchDecoder(device='cuda', entropy='device'); the first 8 equal "
          f"decode_batch_device(device='cpu'); flags clean")
    corpus_launches = [a + b for a, b in zip(res_counts, dl_counts)]

    bad_corpus = list(corpus_datas[:16])
    bad_corpus[5] = corrupt_segment(bad_corpus[5], 40)
    try:
        batch.decode_batch_device(bad_corpus, device="cuda")
    except JpegFormatError as e:
        assert "image 5 " in str(e), e
        print(f"corpus with image 5 corrupted: raised JpegFormatError: {e}")
    else:
        raise AssertionError("the corrupted image was not flagged")
    rgb_bad, err_bad = batch.decode_batch_device_resident(bad_corpus, on_error="zero",
                                                          device="cuda")
    flags = err_bad.cpu().numpy()
    assert flags[5] != 0 and not np.delete(flags, 5).any(), flags
    salvaged = jt.decode(bad_corpus[5], device="cuda", entropy="device", on_error="zero")
    assert np.array_equal(rgb_bad[5].cpu().numpy(), salvaged)
    print(f"corpus with image 5 corrupted, on_error='zero': flags {flags.tolist()}, image 5 "
          f"equal to its single-image salvage")

    split, rgb_split, split_counts = bucket_split(corpus_datas, dev, 5, kernels)
    assert torch.equal(rgb_split, rgb_res) and split_counts == res_counts, split_counts
    print(f"corpus bucket stages, {n_corpus} images, host clock with a sync after each "
          f"stage, mean of 5  [{card}]:")
    for stage, ms in split.items():
        print(f"  {BUCKET_STAGES.get(stage, stage)}: {ms} ms")
    print(f"  sum: {sum(split.values())} ms")

    def wall_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return runs

    corpus_ms = {}
    for name, fn in (
            ("resident (decode_batch_device_resident)",
             lambda: batch.decode_batch_device_resident(corpus_datas, device="cuda")),
            ("with download (decode_batch_device)",
             lambda: batch.decode_batch_device(corpus_datas, device="cuda")),
            ("host entropy (decode_batch)",
             lambda: batch.decode_batch(corpus_datas, device="cuda"))):
        runs = wall_ms(fn, 3)
        corpus_ms[name] = min(runs)
        print(f"corpus {name}, {n_corpus} images, {corpus_mpix} Mpix: runs {runs} ms; "
              f"best {corpus_mpix / min(runs) * 1e3} Mpix/s, "
              f"{n_corpus / min(runs) * 1e3} images/s  [{card}]")
    corpus_dev = device_ms(
        lambda: batch.decode_batch_device_resident(corpus_datas, device="cuda"), 3)
    print(f"corpus resident decode, device time by kernel and copy (torch.profiler, per "
          f"call): {corpus_dev}; sum {sum(corpus_dev.values())} ms of "
          f"{corpus_ms['resident (decode_batch_device_resident)']} ms wall  [{card}]")
    corpus_k1_dev = sum(ms for k, ms in corpus_dev.items() if "fused_rgb_kernel" in k)
    # K2's decode and its table kernel (csrc/entropy_decode.cu).
    corpus_k2_dev = sum(ms for k, ms in corpus_dev.items()
                        if "decode_kernel" in k or "symbol_lut_kernel" in k)
    assert corpus_k2_dev > 0, corpus_dev
    cp = segments.build_corpus_plan(bucket.plans)
    corpus_k2_bound = bound(
        k2_bytes(bucket.parsed, cp.n_segments, cp.comp_of_step.size, cp.kernel_tables),
        sum(symbol_count(entropy_native.decode_scan(parse(d)).coefs) for d in corpus_datas)
        * HUFFMAN_OPS_PER_SYMBOL)
    # The same work in the padded layout the kernel reads and writes: every
    # lane of every segment batch, every word of NW.
    k2_layout_bytes = (cp.streams.nbytes + sum(t.nbytes for t in cp.kernel_tables)
                       + cp.streams.shape[0] * 1024 * (cp.comp_of_step.size * 64 * 2 + 4))
    blocks = n_corpus * cp.n_mcus * bucket.parsed[0].header.blocks_per_mcu()
    corpus_k1_bound = bound(blocks * 64 * 2 + n_corpus * 3 * 64 * 4 + rgb_res.numel(),
                            blocks * ISLOW_OPS_PER_BLOCK
                            + rgb_res.numel() // 3 * COLOUR_OPS_PER_PIXEL)
    print(f"corpus K2 (decode and table kernel) device {corpus_k2_dev} ms, "
          f"{bound_text(corpus_k2_bound)}; its padded layout moves {k2_layout_bytes} B "
          f"({k2_layout_bytes / PEAK_BYTES_PER_S * 1e3} ms); K1 device {corpus_k1_dev} ms, "
          f"{bound_text(corpus_k1_bound)}  [{card}]")

    # A mixed corpus: a restart-marked 1080p frame, two restart-marked gray
    # frames (a K5 bucket), and a 1080p frame without restart markers that
    # is too large for one segment (the host fallback).
    grays = [corpus.own_jpeg(corpus.synthetic_rgb(512, 512, seed=args.seed + 60 + k)[..., 1]
                             .copy(), quality=85, restart_interval=16).data for k in range(2)]
    mixed = [data1080r, grays[0], data1080, grays[1]]
    try:
        segments.build_plan(parse(data1080))
    except JpegUnsupportedError:
        pass
    else:
        raise AssertionError("the 1080p frame without restart markers fits one segment")
    # (name, call, launches expected of K1..K6, tolerance to the CPU path)
    mixed_runs = [
        ("decode_batch (host entropy)",
         lambda: batch.decode_batch(mixed, device="cuda"), [1, 0, 0, 0, 1, 0], True),
        ("decode_batch_device",
         lambda: batch.decode_batch_device(mixed, device="cuda"), [2, 4, 0, 0, 1, 0], True),
        ("decode_batch_device exact=False",
         lambda: batch.decode_batch_device(mixed, exact=False, device="cuda"),
         [0, 4, 0, 0, 0, 3], False),
    ]
    for name, fn, want, exact in mixed_runs:
        outs, counts = run_counted(fn)
        assert counts == want, (name, counts)
        corpus_launches = [a + b for a, b in zip(corpus_launches, counts)]
        diffs = []
        for data, out in zip(mixed, outs):
            exact_cpu = cpu_decode(data, upsample="nearest")
            cpu = exact_cpu if exact else cpu_decode(data, upsample="nearest", exact=False)
            assert out.shape == cpu.shape and out.dtype == cpu.dtype, (name, out.shape)
            diffs.append(maxdiff(out, cpu))
            assert exact or maxdiff(out, exact_cpu) <= 4, name
        assert max(diffs) <= (0 if exact else 2), (name, diffs)
        print(f"mixed corpus {name}: launches {counts} (K1..K6), max abs diff vs the CPU "
              f"path per image {diffs}")
    main_launches = [a + b for a, b in zip(main_launches, corpus_launches)]

    # The command line on a file, with host entropy and with --no-cpu.
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/corpus0.jpg"
        with open(path, "wb") as f:
            f.write(distinct[0])
        for argv in (["-b", "10", "--device", "cuda", path], ["-b", "10", "--no-cpu", path]):
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = cli.main(argv)
            line = text.getvalue().strip()
            print(f"cli {' '.join(argv[:-1])} <file>: rc {rc}: {line}  [{card}]")
            assert rc == 0 and "FPS" in line, (argv, rc, line)

    # The libjpeg oracle needs a loadable system libjpeg (the shim's cuts) and
    # Pillow (RGB); where either is missing its stages raise cleanly.
    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    have_shim = oracle_native.available()
    for stage, have in (("yuv", have_shim), ("rgb", have_pil)):
        try:
            got = jt.decode(distinct[0], out=stage, impl="libjpeg")
        except JpegUnsupportedError as e:
            assert not have, (stage, e)
            print(f"impl='libjpeg' out={stage}: unavailable here, JpegUnsupportedError: {e}")
        else:
            assert have, stage
            ref = jt.decode(distinct[0], out=stage, device="cuda",
                            upsample="fancy" if stage == "rgb" else "nearest")
            assert maxdiff(got, ref) == 0, stage
            print(f"impl='libjpeg' out={stage}: equal to the port on the card")

    phase_done(7)
    # -- 8. timings ----------------------------------------------------------
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
                tabs = device_entropy.device_tables(plan.cbase, plan.counts, plan.symbols, dev,
                                                    scan=False)
                tens = plan_tensors((plan.streams,) + plan.kernel_tables[:4], dev)
                t = mark("H2D of the bits and maps, one copy (tables stay on the card)", t)
                out, err = entropy_device.decode_segments_device(
                    *tens, tabs.cbase, tabs.counts, tabs.symbols, lut=tabs.k2_lut)
                t = mark("K2 row form", t)
                nseg, mps = plan.n_segments, plan.mcus_per_segment
            else:
                inp = segments.build_spec_scan_input(
                    parsed, sb_target=device_entropy.SCAN_SB_TARGET)
                t = mark("host parse + destuff and windows (build_spec_scan_input)", t)
                tabs = device_entropy.device_tables(inp.cbase, inp.counts, inp.symbols, dev,
                                                    scan=True)
                w, dc_c, ac_c, cm, dm, am = plan_tensors(
                    (inp.windows, inp.dcslot_of_c, inp.acslot_of_c, inp.comp_of_step,
                     inp.dc_slot_of_step, inp.ac_slot_of_step), dev)
                t = mark("H2D of the bits and maps, one copy (tables stay on the card)", t)
                bitpos, ok, _ = specsync_device.device_index_scan(
                    w, inp.n_bits, dc_c, ac_c, tabs.cbase, tabs.counts, tabs.symbols,
                    sb=inp.subseq_bytes, maxrec=inp.maxrec, n_mcus=inp.n_mcus,
                    lut=tabs.k3_lut)
                assert bool(ok)
                t = mark("K3 whole scan (one call; ok read on the host)", t)
                out, err = entropy_device.decode_mcus_at_bitpos(
                    w, bitpos, inp.n_bits, cm, dm, am, tabs.cbase, tabs.counts, tabs.symbols,
                    spw=inp.spw, lut=tabs.k2_lut)
                t = mark("K2 fused form (decode + DC predictors)", t)
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

    def time_k1(name, inputs):
        """Kernel and plain version on the same batch (soa_inputs' tuple),
        in turns."""
        spec, geom, comps, qt = inputs
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
        mpix = got.numel() // 3 / 1e6
        tensors = [t for t in a if isinstance(t, torch.Tensor)]
        b = bound(nbytes(*tensors, got),
                  sum(t.numel() for t in a[:3]) // 64 * ISLOW_OPS_PER_BLOCK
                  + got.numel() // 3 * COLOUR_OPS_PER_PIXEL)
        dev_ms = device_ms(kernel, 20)
        print(f"K1 coefs->RGB {name}: kernel {k_ms} ms ({mpix / k_ms * 1e3} Mpix/s) "
              f"runs {kernel_ms} (device time by kernel {dev_ms}); plain torch {p_ms} ms "
              f"({mpix / p_ms * 1e3} Mpix/s) runs {plain_ms}; {bound_text(b)}  [{card}]")
        return k_ms, p_ms, b, sum(ms for k, ms in dev_ms.items() if "fused_rgb_kernel" in k)

    batch = 8
    batch1080 = soa_inputs(
        [corpus.synthetic_rgb(1080, 1920, seed=args.seed + 10 + b) for b in range(batch)],
        "4:2:0", "nearest")
    k_ms, p_ms, k1_bound, k1_dev_ms = time_k1(f"1080p 4:2:0 nearest, batch {batch}", batch1080)
    time_k1(f"1080p 4:2:0 fancy, batch {batch}",
            (dataclasses.replace(batch1080[0], upsample="fancy"), *batch1080[1:]))
    time_k1("4K 4:2:2 fancy, batch 1", soa_inputs([img4k], "4:2:2", "fancy"))

    reps = 20

    def in_turns(kernel, plain, k_iters, p_iters, warm_plain=True, plain_twice=True):
        """(kernel ms, plain ms, runs) in turns: plain, kernel, kernel, plain.
        A plain version that takes seconds and ran before is not warmed up,
        and runs once (plain, kernel, kernel) with ``plain_twice`` off."""
        kernel()
        if warm_plain:
            plain()
        p_runs = [cuda_ms(plain, p_iters)]
        k_runs = [cuda_ms(kernel, k_iters), cuda_ms(kernel, k_iters)]
        if plain_twice:
            p_runs.append(cuda_ms(plain, p_iters))
        return sum(k_runs) / 2, sum(p_runs) / len(p_runs), k_runs, p_runs

    t = plan_tensors((plan1080.streams,) + plan1080.kernel_tables, dev)
    zero_img = torch.zeros(t[0].shape[0], dtype=torch.int32, device=dev)
    row_lut = entropy_device.symbol_lut(*t[5:])
    k2_ms, k2_plain_ms, kr, plr = in_turns(
        lambda: entropy_device.decode_segments_device(*t, lut=row_lut),
        lambda: entropy_device.decode_segments_reference(
            t[0], zero_img, t[1], t[2], t[3], t[4][None], t[5][None], t[6][None],
            t[7][None]),
        20, 1)
    symbols1080 = symbol_count(scan1080.coefs)
    k2_bound = bound(
        k2_bytes([parse(data1080r)], plan1080.n_segments, plan1080.comp_of_step.size,
                 plan1080.kernel_tables),
        symbols1080 * HUFFMAN_OPS_PER_SYMBOL)
    k2_dev = device_ms(lambda: entropy_device.decode_segments_device(*t, lut=row_lut), 20)
    k2_tables_ms = [cuda_ms(lambda: entropy_device.symbol_lut(*t[5:]), 50) for _ in range(2)]
    print(f"K2 Huffman decode, row form, 1080p 4:2:0 R=1 plan {tuple(t[0].shape)}, "
          f"{symbols1080} symbols, symbol tables given: kernel {k2_ms} ms runs {kr} (device "
          f"time by kernel {k2_dev}); plain torch {k2_plain_ms} ms runs {plr}; "
          f"{bound_text(k2_bound)}  [{card}]")
    print(f"K2's table kernel alone (64 blocks of 1024 threads, once per table set): "
          f"{sum(k2_tables_ms) / 2} ms runs {k2_tables_ms}  [{card}]")
    k2_tables_ms = sum(k2_tables_ms) / 2

    # The fused form on the scan's inputs, the chain it replaces beside it
    # (gather -> row form -> DC bases, at the engine's row width, tables
    # given to both).
    fused_ms = {}
    for name, data, syms in (("1080p 4:2:0", data1080, symbols1080),
                             ("4K 4:2:2", data4k, symbol_count(scan4k.coefs))):
        inp, ft = fused_inputs(data)
        w, dc_c, ac_c, cb, cn, sy, cm, dm, am, _ = ft
        bitpos, ok, _ = specsync_device.device_index_scan(
            w, inp.n_bits, dc_c, ac_c, cb, cn, sy, sb=inp.subseq_bytes, maxrec=inp.maxrec,
            n_mcus=inp.n_mcus)
        assert bool(ok)
        lut = entropy_device.symbol_lut(cb, cn, sy)

        def fused():
            return entropy_device.decode_mcus_at_bitpos(
                w, bitpos, inp.n_bits, cm, dm, am, cb, cn, sy, spw=inp.spw, lut=lut)

        def chain():
            return old_chain(inp, ft, bitpos, (cb, cn, sy), inp.nw, lut=lut)

        def plain():
            return entropy_device.decode_mcus_at_bitpos_reference(
                w, bitpos, inp.n_bits, cm, dm, am, cb, cn, sy, spw=inp.spw)

        ms, plain_ms, kr, plr = in_turns(fused, plain, 50, 1, warm_plain=False,
                                         plain_twice=False)
        chain()
        chain_runs = [cuda_ms(chain, 20), cuda_ms(chain, 20)]
        b = bound(nbytes(w, bitpos, cm, dm, am, cb, cn, sy, *fused()),
                  syms * HUFFMAN_OPS_PER_SYMBOL)
        print(f"K2 fused form (decode out of the scan's windows + DC predictors, 2 launches), "
              f"{name}, windows {tuple(w.shape)}, {inp.n_mcus} MCUs, {syms} symbols: kernel "
              f"{ms} ms runs {kr} (device time by kernel {device_ms(fused, 20)}); the chain "
              f"gather -> row form -> DC bases {sum(chain_runs) / 2} ms runs {chain_runs}; "
              f"plain torch {plain_ms} ms runs {plr}; {bound_text(b)}  [{card}]")
        fused_ms[name] = (ms, plain_ms, b, sum(chain_runs) / 2)

    a, kw = scan_inputs(data1080)
    k3_ms, k3_plain_ms, kr, plr = in_turns(
        lambda: specsync_device.device_index_scan(*a, **kw),
        lambda: specsync_device.device_index_scan(*a, **kw, plain=True), 50, 1,
        warm_plain=False, plain_twice=False)
    k3_out = specsync_device.device_index_scan(*a, **kw)
    k3_bound = bound(nbytes(*(x for x in a if isinstance(x, torch.Tensor)), *k3_out),
                     symbols1080 * HUFFMAN_OPS_PER_SYMBOL)
    chain = ("one pass over the symbols -- a lane is one serial chain of dependent symbol "
             "decodes, so the chain's length and not the bytes sets the kernel's time")
    print(f"K3 whole device_index_scan, 1080p 4:2:0 (SB {kw['sb']}, windows "
          f"{tuple(a[0].shape)}, {symbols1080} symbols; {k3_stats[0]} rounds, lanes decoded "
          f"per pass {k3_lanes}; one call: the table kernel and one cooperative kernel): "
          f"kernel {k3_ms} ms runs {kr}; plain torch {k3_plain_ms} ms runs {plr}; "
          f"{bound_text(k3_bound)}, {chain}  [{card}]")
    lib = specsync_device._kernel()
    lut_raw = torch.empty(entropy_device.LUT_IMAGE, dtype=torch.int16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    k3_tables_ms = [cuda_ms(lambda: lib.jgt_specsync_lut(
        *(t.data_ptr() for t in a[4:]), lut_raw.data_ptr(), stream), 50) for _ in range(2)]
    print(f"K3's table kernel alone (64 blocks of 1024 threads; inside the time above, which "
          f"is a scan that was not given its tables; the engine builds them once per table "
          f"set): {sum(k3_tables_ms) / 2} ms runs {k3_tables_ms}  [{card}]")
    k3_tables_ms = sum(k3_tables_ms) / 2
    a4k, kw4k = scan_inputs(data4k)
    symbols4k = symbol_count(scan4k.coefs)
    k3_4k = [cuda_ms(lambda: specsync_device.device_index_scan(*a4k, **kw4k), 50)
             for _ in range(2)]
    b4k = bound(nbytes(a4k[0], *a4k[2:], *specsync_device.device_index_scan(*a4k, **kw4k)),
                symbols4k * HUFFMAN_OPS_PER_SYMBOL)
    print(f"K3 whole device_index_scan, 4K 4:2:2 (SB {kw4k['sb']}, windows "
          f"{tuple(a4k[0].shape)}, {symbols4k} symbols; {k3_stats4k[0]} rounds): kernel "
          f"{sum(k3_4k) / 2} ms runs {k3_4k}; plain torch {k3_plain4k_ms} ms (the one run of "
          f"the check above); {bound_text(b4k)}  [{card}]")

    # Subsequence size: shorter chains and more lanes against more rounds.
    for name, data in (("1080p 4:2:0", data1080), ("4K 4:2:2", data4k)):
        serial = entropy_native.index_scan(parse(data), 1)[0].astype(np.int32)
        for label, pin, target in (("pinned", 128, 512), ("pinned", 256, 512),
                                   ("pinned", 512, 512), ("aimed at 128,", None, 128),
                                   ("aimed at 256,", None, 256), ("aimed at 512,", None, 512)):
            if target == device_entropy.SCAN_SB_TARGET and pin is None:
                label = "the engine's: " + label
            sa, skw = scan_inputs(data, pin, target)
            *got, lanes = specsync_device.index_scan_kernel(*sa, **skw)
            ok = bool(got[1])
            rounds = int(got[2][0])
            assert not ok or np.array_equal(got[0].cpu().numpy(), serial), (name, pin)
            assert ok or pin is not None, name
            runs = [cuda_ms(lambda: specsync_device.device_index_scan(*sa, **skw), 20)
                    for _ in range(2)]
            print(f"K3 subsequence sweep {name}, {label} SB {skw['sb']} (windows "
                  f"{tuple(sa[0].shape)}, maxrec {skw['maxrec']}): ok {ok}, {rounds} rounds, "
                  f"lanes decoded per pass {lanes.tolist()[: rounds + 1]}; whole scan "
                  f"{sum(runs) / 2} ms runs {runs}  [{card}]")

    # Rounds depend on how far a lane decodes before it falls in step with
    # the true chain, and that moves with quality and subsampling: the
    # engine's target must converge with room on all of them.
    worst = {}
    for (_, mode, quality), data in zip(sweep_jobs, sweep_data):
        data = data.result()
        serial = entropy_native.index_scan(parse(data), 1)[0].astype(np.int32)
        for target in (128, 256, 512):
            sa, skw = scan_inputs(data, None, target)
            *got, lanes = specsync_device.index_scan_kernel(*sa, **skw)
            ok, rounds = bool(got[1]), int(got[2][0])
            assert not ok or np.array_equal(got[0].cpu().numpy(), serial), (quality, mode)
            assert ok or target != device_entropy.SCAN_SB_TARGET, (quality, mode)
            worst[target] = max(worst.get(target, 0), rounds)
            runs = [cuda_ms(lambda: specsync_device.device_index_scan(*sa, **skw), 20)
                    for _ in range(2)]
            print(f"K3 rounds sweep 1080p {mode} quality {quality}, {len(data)} B, aimed "
                  f"at {target}: SB {skw['sb']} (windows {tuple(sa[0].shape)}), ok {ok}, "
                  f"{rounds} rounds of 16 allowed, lanes decoded per pass "
                  f"{lanes.tolist()[: rounds + 1]}; whole scan {sum(runs) / 2} ms "
                  f"runs {runs}  [{card}]")
    print(f"K3 rounds sweep, most rounds per target over 3 qualities x 2 modes: {worst}")

    def time_k4(name, plan, p_iters):
        streams, = plan_tensors((plan.streams,), dev)
        t_blocks = plan.blocks_per_segment
        ms, plain_ms, kr, plr = in_turns(
            lambda: pack_device.expand_pack_device(streams, t_blocks),
            lambda: pack_device.expand_pack_reference(streams, t_blocks), 50, p_iters)
        out = pack_device.expand_pack_device(streams, t_blocks)
        b = bound(nbytes(streams, out), plan.packed_entries * PACK_OPS_PER_ENTRY)
        zeros_ms = cuda_ms(lambda: torch.zeros(out.shape, dtype=out.dtype, device=dev), 50)
        print(f"K4 PACK expansion with its zero-fill, {name} plan {tuple(streams.shape)}, "
              f"{plan.n_segments} lanes x {t_blocks} blocks, {plan.packed_entries} entries: "
              f"kernel {ms} ms runs {kr}; plain torch {plain_ms} ms runs {plr}; "
              f"{bound_text(b)}; a torch.zeros of the output alone {zeros_ms} ms  [{card}]")
        return ms, plain_ms, b

    k4_ms, k4_plain_ms, k4_bound = time_k4("1080p 4:2:0", pack1080, 1)
    time_k4("4K 4:2:2", pack4k, 1)

    def time_planes(name, kernel_fn, plain_fn, ops_per_block, launches):
        """The three planes of the 1080p 4:2:0 frame as the main path hands
        them over (strided views of blocks); ``kernel_fn`` takes the lists of
        planes and tables.  Beside it the same planes as contiguous SoA
        tensors."""
        views = [blocks_as_soa(c) for c in k6_planes]
        tables = list(k6_qts)
        outs = kernel_fn(views, tables)
        ms, plain_ms, kr, plr = in_turns(
            lambda: kernel_fn(views, tables),
            lambda: [plain_fn(v, q) for v, q in zip(views, tables)], 50, 5)
        soas = [v.contiguous() for v in views]
        soa_ms = cuda_ms(lambda: kernel_fn(soas, tables), 50)
        b = bound(nbytes(*k6_planes, *k6_qts, *outs),
                  sum(c.numel() for c in k6_planes) // 64 * ops_per_block)
        dev = device_ms(lambda: kernel_fn(views, tables), 20)
        print(f"{name}, the three planes of 1080p 4:2:0 "
              f"{[tuple(c.shape[:2]) for c in k6_planes]} blocks, {launches}: kernel "
              f"{ms} ms runs {kr} (contiguous SoA planes: {soa_ms} ms; device time by kernel "
              f"{dev}); plain torch {plain_ms} ms runs {plr}; {bound_text(b)}  [{card}]")
        return ms, plain_ms, b, sum(dev.values())

    k5_ms, k5_plain_ms, k5_bound, k5_dev_ms = time_planes(
        "K5 islow plane IDCT", idct_islow_plane.dequant_idct_islow_planes_soa,
        idct_islow_plane.dequant_idct_islow_plane_soa_reference, ISLOW_OPS_PER_BLOCK,
        "1 launch")
    k5_each = cuda_ms(lambda: [idct_islow_plane.dequant_idct_islow_plane_soa(blocks_as_soa(c), q)
                               for c, q in zip(k6_planes, k6_qts)], 50)
    print(f"K5 as one call per plane (3 launches of the same kernel): {k5_each} ms  [{card}]")
    k6_ms, k6_plain_ms, k6_bound, k6_dev_ms = time_planes(
        "K6 float plane IDCT", idct_float.dequant_idct_float_planes_soa,
        idct_float.dequant_idct_float_plane_soa_reference, FLOAT_OPS_PER_BLOCK, "1 launch")
    k6_each = cuda_ms(lambda: [idct_float.dequant_idct_float_plane_soa(blocks_as_soa(c), q)
                               for c, q in zip(k6_planes, k6_qts)], 50)
    print(f"K6 as one call per plane (3 launches of the same kernel): {k6_each} ms  [{card}]")

    # One library call for K6's function: the IDCT as a transposed
    # convolution of the 64 coefficient planes with stride 8, the quant table
    # folded into the weights and the level shift as the bias.  Full float32
    # (no TF32); the rounding and the cast to u8 are outside the timed call.
    # Timed as a yardstick only: the package never calls it.
    tf32_before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    basis = torch.from_numpy(idct_ops.IDCT_BASIS).to(dev)
    lib_in, lib_w = [], []
    for c, q in zip(k6_planes, k6_qts):
        lib_in.append(blocks_as_soa(c).to(torch.float32).contiguous()[None])
        w = torch.einsum("ui,vj->uvij", basis, basis).reshape(64, 1, 8, 8)
        lib_w.append(w * q.reshape(64, 1, 1, 1).to(torch.float32))
    shift = torch.full((1,), 128.0, device=dev)

    def library():
        return [torch.nn.functional.conv_transpose2d(x, w, shift, stride=8)
                for x, w in zip(lib_in, lib_w)]

    lib_err = 0
    for z, c, q in zip(library(), k6_planes, k6_qts):
        z = torch.round(z[0, 0]).clamp(0, 255).to(torch.uint8)
        got = idct_float.dequant_idct_float_plane_soa(blocks_as_soa(c), q)
        lib_err = max(lib_err, int((z.int() - got.int()).abs().max()))
    assert lib_err <= 1, lib_err
    for _ in range(3):
        library()
    k6_library_ms = (cuda_ms(library, 20) + cuda_ms(library, 20)) / 2
    k6_library_dev = device_ms(library, 20)
    torch.backends.cudnn.allow_tf32 = tf32_before
    print(f"K6's function as one library call per plane "
          f"(torch.nn.functional.conv_transpose2d, stride 8, float32 input ready): "
          f"{k6_library_ms} ms for the three planes (device time by kernel "
          f"{k6_library_dev}, sum {sum(k6_library_dev.values())}), max abs diff vs K6 "
          f"{lib_err}  [{card}]")

    def host_ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    spec_ms = host_ms(lambda: segments.build_spec_scan_input(
        parse(data1080), sb_target=device_entropy.SCAN_SB_TARGET))
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

    for name, kw in (("upload='pack'", {"upload": "pack"}), ("exact=False", {"exact": False}),
                     ("out='yuv'", {}),
                     ("exact=False, entropy='device'", {"exact": False, "entropy": "device"}),
                     ("out='yuv', entropy='device'", {"entropy": "device"})):
        stage = "yuv" if "yuv" in name else "rgb"
        ms = host_ms(lambda: jt.decode(data1080, out=stage, device="cuda", **kw))
        print(f"whole decode jt.decode(device='cuda', {name}) 1080p 4:2:0 nearest: "
              f"{ms} ms/frame  [{card}]")
    pack_io = jt.get_decoder(data1080, device="cuda", upload="pack").io_bytes()
    coef_io = jt.get_decoder(data1080, device="cuda").io_bytes()
    bits_io = jt.get_decoder(data1080, device="cuda", entropy="device").io_bytes()
    print(f"io_bytes 1080p 4:2:0 without restart markers: pack cut upload "
          f"{pack_io['upload']} B ({pack1080.packed_entries} entries of 2 B + the block "
          f"index), coefficient cut {coef_io['upload']} B, bits cut {bits_io['upload']} B; "
          f"pack / coefficients {pack_io['upload'] / coef_io['upload']}; the K4 rows that "
          f"are shipped: {pack1080.streams.nbytes} B")

    def pack_split(data, reps):
        """Mean host-clock ms of each stage of an upload='pack' RGB decode
        (nearest) as TorchDecoder runs it, with a sync after each."""
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
            scan = entropy_native.decode_scan(parsed, want_pack=True)
            t = mark("host parse + native entropy with the pack stream", t)
            plan = build_pack_plan(parsed, scan)
            t = mark("host build_pack_plan (lane rows)", t)
            streams, = plan_tensors((plan.streams,), dev)
            t = mark("H2D of the pack rows", t)
            out = pack_device.expand_pack_device(streams, plan.blocks_per_segment)
            t = mark("K4 (one launch, its zero-fill included)", t)
            geom_c = tuple((hdr.components[c].hsamp, hdr.components[c].vsamp)
                           for c in hdr.scan.comp_idx)
            coefs = entropy_device.assemble_components(
                out, plan.n_segments, plan.mcus_per_segment, hdr.n_mcus, hdr.nhmb,
                hdr.nvmb, geom_c, soa=False, frame_order=hdr.scan.comp_idx)
            t = mark("assembly into blocks", t)
            spec = pipeline.PipelineSpec.from_header(hdr)
            qts = plan_tensors([hdr.quant_for(c).values for c in hdr.components], dev)
            planes = idct_islow_plane.dequant_idct_islow_planes_soa(
                [blocks_as_soa(c) for c in coefs], list(qts))
            t = mark("K5, one launch (with the quant tables' upload)", t)
            up = [color_ops.upsample_nearest(p, *dec)[: spec.height, : spec.width]
                  for p, dec in zip(planes, spec.comp_decs)]
            rgb = color_ops.ycbcr_to_rgb_exact(*up)
            t = mark("upsampling + colour (torch ops)", t)
            rgb.cpu().numpy()
            mark("D2H of RGB", t)
        return {k: v / reps for k, v in split.items()}

    split = pack_split(data1080, reps)
    print(f"upload='pack' stages, 1080p 4:2:0 without restart markers, host clock with a "
          f"sync after each stage, mean of {reps}  [{card}]:")
    for stage, ms in split.items():
        print(f"  {stage}: {ms} ms")

    for name, data in (("without restart markers", data1080), ("R=1", data1080r)):
        split = stage_split(data, reps)
        print(f"entropy='device' stages, 1080p 4:2:0 {name}, host clock with a "
              f"sync after each stage, mean of {reps}  [{card}]:")
        for stage, ms in split.items():
            print(f"  {stage}: {ms} ms")
        print(f"  sum: {sum(split.values())} ms")
    verdict_order(data1080, card)
    busy_share(data1080, card)

    phase_done(8)
    # -- 9. the sharded paths on meshes of one card -------------------------
    sharded_launches = sharded_paths(
        kernels, card, (data1080, data1080r, data4k, data_gray), corpus_datas, corpus_outs,
        bad_corpus)
    main_launches = [a + b for a, b in zip(main_launches, sharded_launches)]
    print(f"sharded paths: launches {sharded_launches} (K1..K6)")

    phase_done(9)
    # -- 10. the differential sweep and the device-scan artifact -------------
    artifact_launches = artifacts(kernels, data1080, args.out)
    main_launches = [a + b for a, b in zip(main_launches, artifact_launches)]

    phase_done(10)
    # -- 11. garbage in: the fuzz on the card, and the sanitizer runs ----------
    fuzz_launches = fuzz_phase(kernels, card, args.seed)
    main_launches = [a + b for a, b in zip(main_launches, fuzz_launches)]

    phase_done(11)
    # -- 12. BASELINE configs 3 and 5 at their published sizes ---------------
    full = fullsize_phase(kernels, card, fullsize_jobs, stage_split)
    main_launches = [a + b for a, b in zip(main_launches, full["launches"])]

    phase_done(12)

    def entry(i, stem, replaces, err, ms, plain_ms, b, library_ms=None, **more):
        return {
            "name": stem,
            "route": "cuda",
            "source": f"jpeg_gpu_tpu_torch/csrc/{stem}.cu",
            "replaces": replaces,
            "launches": main_launches[i],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
            "library_ms": library_ms,
            "fullsize": full["by_kernel"][i],
            **more,
        }

    print(json.dumps({"kernels": [
        entry(0, "pixel_fused", "jpeg_gpu_tpu/ops/pixel_fused.py:237",
              max_err, k_ms, p_ms, k1_bound, device_ms=k1_dev_ms,
              corpus_device_ms=corpus_k1_dev, corpus_bound_ms=corpus_k1_bound["bound_ms"]),
        entry(1, "entropy_decode", "jpeg_gpu_tpu/ops/entropy_device.py:128",
              max(k2_err, k2_fused_err), k2_ms, k2_plain_ms, k2_bound,
              entries=["jgt_entropy_decode", "jgt_entropy_decode_fused", "jgt_entropy_lut"],
              tables_kernel_ms=k2_tables_ms, fused_ms=fused_ms["1080p 4:2:0"][0],
              fused_plain_ms=fused_ms["1080p 4:2:0"][1],
              fused_bound_ms=fused_ms["1080p 4:2:0"][2]["bound_ms"],
              fused_replaces_chain_ms=fused_ms["1080p 4:2:0"][3],
              corpus_device_ms=corpus_k2_dev, corpus_bound_ms=corpus_k2_bound["bound_ms"],
              corpus_layout_bytes_ms=k2_layout_bytes / PEAK_BYTES_PER_S * 1e3),
        entry(2, "specsync_scan", "jpeg_gpu_tpu/ops/specsync_device.py:98",
              k3_err, k3_ms, k3_plain_ms, k3_bound, tables_kernel_ms=k3_tables_ms),
        entry(3, "pack_expand", "jpeg_gpu_tpu/ops/pack_device.py:42",
              k4_err, k4_ms, k4_plain_ms, k4_bound),
        entry(4, "idct_islow_plane", "jpeg_gpu_tpu/ops/idct_islow_pallas.py:54",
              k5_err, k5_ms, k5_plain_ms, k5_bound, device_ms=k5_dev_ms),
        entry(5, "idct_float", "jpeg_gpu_tpu/ops/idct_pallas.py:78",
              k6_err, k6_ms, k6_plain_ms, k6_bound, k6_library_ms, device_ms=k6_dev_ms,
              library_device_ms=sum(k6_library_dev.values())),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
