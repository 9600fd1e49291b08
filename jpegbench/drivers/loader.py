"""Traffic kind ``loader``: a training job's data loader, one caller in a
closed loop, each call ``engine.batch.decode_batch_device`` on a batch of
``batch`` images; the RGB comes back to the host.

The pool holds ``pool_batches`` batches of distinct images, at least two.
The batches are consecutive slices of one permutation of the pool drawn
from the seed, each in a fresh order, so that no image repeats between
neighbouring batches: a cache keyed on an image's bytes that holds less
than the whole pool finds nothing to reuse, as in an epoch that sees each
image once.  The window runs until ``seconds`` have passed (and one batch
has returned); ``compare_per_batch`` outputs of each batch, at places drawn
from the seed, are kept for the comparison.

The configuration's ``scan_script`` says how the images are coded:
``sequential``, one interleaved baseline scan (``traffic_gen.frames``), or
``simple_progression``, libjpeg's ten-scan progressive script
(``traffic_gen.progressive``); both of the same coefficients for a seed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import numpy as np

from jpegbench import check, traffic_gen
from jpegbench.drivers import Context
from jpegbench.traffic_gen import progressive

CONFIG_KEYS = ("sizes", "sampling", "quality", "huffman_tables", "header", "restart_interval",
               "scan_script", "upsample", "exact", "guarantees")
TRAFFIC_KEYS = ("batch", "pool_batches", "compare_per_batch")
# Every compared image equal to the reference's islow decode of the image
# sent at its place of the batch.
GUARANTEES = ("islow_exact", "batch_order")


def validate(config: dict, traffic: dict) -> None:
    if config["sampling"] not in traffic_gen.SAMPLING:
        raise ValueError(f"sampling {config['sampling']!r}: no committed source")
    if config["huffman_tables"] not in ("annex_k", "optimal"):
        raise ValueError(f"huffman_tables {config['huffman_tables']!r}")
    if config["header"] not in ("rfc2435", "jfif"):
        raise ValueError(f"header {config['header']!r}")
    if config["scan_script"] not in ("sequential", "simple_progression"):
        raise ValueError(f"scan_script {config['scan_script']!r}")
    if config["scan_script"] == "simple_progression":
        if config["header"] == "rfc2435":
            raise ValueError("scan_script simple_progression with header rfc2435: RFC 2435 "
                             "carries baseline frames only")
        if config["huffman_tables"] != "optimal":
            raise ValueError("scan_script simple_progression with huffman_tables "
                             f"{config['huffman_tables']!r}: libjpeg optimises every "
                             "progressive scan's tables (the Annex K AC tables hold no EOBRUN "
                             "symbols)")
    if config["upsample"] not in ("nearest", "fancy"):
        raise ValueError(f"upsample {config['upsample']!r}")
    if abs(sum(s[2] for s in config["sizes"]) - 1.0) > 1e-9:
        raise ValueError("the shares of sizes add up to 1")
    if traffic["pool_batches"] < 2:
        raise ValueError("pool_batches is at least 2: neighbouring batches share no image")
    if not 1 <= traffic["compare_per_batch"] <= traffic["batch"]:
        raise ValueError("compare_per_batch lies in 1..batch")


def make_pool(config: dict, traffic: dict, seed: int) -> List[traffic_gen.Frame]:
    """``pool_batches * batch`` images whose sizes follow the configuration's
    shares (the same counts for every seed: the largest remainders of share x
    images; the seed only orders them), each with its own tables where the
    configuration says ``optimal`` (a progressive file: each scan's own)."""
    n = traffic["pool_batches"] * traffic["batch"]
    sizes = [s for s, c in zip(config["sizes"], traffic_gen.size_counts(config["sizes"], n))
             for _ in range(c)]
    order = np.random.default_rng([seed % (1 << 64), 0]).permutation(n)
    args = (config["sampling"], config["quality"], config["restart_interval"])
    if config["scan_script"] == "simple_progression":
        return [progressive.make_frame(seed, i, sizes[j][1], sizes[j][0], *args)
                for i, j in enumerate(order)]
    return [traffic_gen.make_frame(seed, i, sizes[j][1], sizes[j][0], *args,
                                   config["huffman_tables"], config["header"] == "rfc2435")
            for i, j in enumerate(order)]


@dataclasses.dataclass
class LoaderRun:
    """What one window did."""

    batches: int
    order: List[int]                 # per image of the window, its place in the pool
    wall_s: float
    kept: List[tuple]                # (pool index, the RGB the call returned for it)

    @property
    def images(self) -> int:
        return len(self.order)


def window(ctx: Context, seconds: float, warm: bool = False) -> LoaderRun:
    """One window of the loader: batches until ``seconds`` have passed; the
    warm-up (``warm``) makes one call on one batch of the pool."""
    from jpeg_gpu_tpu_torch.engine.batch import decode_batch_device

    pool = [f.data for f in ctx.pool]
    batch = ctx.traffic["batch"]
    spans = ctx.spans if not warm else type(ctx.spans)()
    rng = np.random.default_rng([ctx.seed % (1 << 64), 3 if warm else 2])
    slices = rng.permutation(len(pool)).reshape(-1, batch)
    kept, decoded, n_batches = [], [], 0
    t0 = time.perf_counter()
    with spans("window"):
        while (not warm and (not n_batches or time.perf_counter() - t0 < seconds)) or (
                warm and n_batches < 1):
            order = rng.permutation(slices[n_batches % len(slices)])
            with spans("loader.call"):
                out = decode_batch_device([pool[j] for j in order], exact=ctx.exact,
                                          upsample=ctx.config["upsample"], device=ctx.device)
            if not warm:
                for k in rng.choice(batch, size=ctx.traffic["compare_per_batch"], replace=False):
                    kept.append((int(order[k]), out[k]))
            decoded.extend(order.tolist())
            n_batches += 1
    wall = time.perf_counter() - t0
    return LoaderRun(batches=n_batches, order=decoded, wall_s=wall, kept=kept)


def completed(run: LoaderRun, pool: Sequence) -> list:
    return [pool[i].facts for i in run.order]


def verdict(run: LoaderRun, pool: Sequence, config: dict) -> check.Verdict:
    """The kept outputs (RGB on the host) against the reference's image of
    the pool that was sent at their place."""
    return check.compare(((i, np.asarray(rgb)) for i, rgb in run.kept), pool,
                         config["upsample"], 0)
