"""Multi-process decode: ``torch.distributed`` glue and per-rank inputs.

The port of ``jpeg_gpu_tpu/parallel/distributed.py``.  One process (rank)
drives each card:

* the network carries only the *inputs* in the sense that each rank parses
  and entropy-decodes its own share of the corpus -- compressed bits and
  pixels never cross ranks;
* each rank decodes its share with the same sharded program as a single
  process (``parallel/shard.decode_batch_sharded``) on a mesh of its own
  card (``cuda:{LOCAL_RANK}``), its space axis repeating that card;
* what does cross ranks is small: the geometry check
  (``all_gather_object``) and the global checksum (``all_reduce``).

Without an initialized process group everything degrades to one process
that owns the whole corpus.  The group uses NCCL on the cards, and gloo
only for a caller that passes ``device="cpu"``: without a card and without
that, the entry points raise.
One card cannot host two NCCL ranks, so the NCCL path is checked on the
card at world size 1 only; across processes it is checked with gloo on the
CPU (``tests/test_torch_distributed.py``).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from jpeg_gpu_tpu_torch.parallel.mesh import as_device, make_mesh
from jpeg_gpu_tpu_torch.utils.device import resolve_device
from jpeg_gpu_tpu_torch.utils.logging import get_logger

log = get_logger("parallel")

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank_world() -> tuple:
    return (dist.get_rank(), dist.get_world_size()) if _grouped() else (0, 1)


def default_device() -> torch.device:
    """This rank's card, ``cuda:{LOCAL_RANK}``; raises without one (the CPU
    runs only for a caller that passes ``device="cpu"``)."""
    return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}", "distributed")


def initialize_from_env(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
    timeout: Optional[float] = None,
) -> bool:
    """Initialize ``torch.distributed`` for a multi-process run.

    Arguments default to the variables ``torchrun`` sets (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK; ``init_method`` then is
    ``env://``).  Returns False, and does nothing, when neither arguments
    nor variables configure a group (a single-process run); True once a
    group is up.  ``device`` defaults to :func:`default_device`, this rank's
    card, and raises without one; the backend is NCCL on a card and gloo for
    ``device="cpu"``.  ``timeout`` (seconds) bounds each collective.
    """
    if dist.is_initialized():
        return True
    configured = init_method is not None or world_size is not None or any(
        v in os.environ for v in _ENV)
    if not configured:
        log.debug("no process group configured; single-process mode")
        return False
    device = default_device() if device is None else as_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {"init_method": init_method or "env://"}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, **kwargs)
    log.info("distributed: rank %d/%d, backend %s, device %s",
             dist.get_rank(), dist.get_world_size(), backend, device)
    return True


def local_shard(n_items: int) -> slice:
    """This rank's contiguous share of an n_items corpus (contiguous, so
    that neighbouring images stay on one rank); without a process group,
    everything."""
    r, w = _rank_world()
    return slice(n_items * r // w, n_items * (r + 1) // w)


def decode_batch_distributed(
    local_datas: Sequence[bytes],
    exact: bool = True,
    upsample: str = "nearest",
    space: int = 1,
    device=None,
    return_checksum: bool = False,
):
    """Decode this rank's share of a same-geometry corpus.

    Every rank calls this with its own images (``local_shard`` splits a
    global list).  Each rank entropy-decodes its images on the host and
    decodes the pixels with ``decode_batch_sharded`` on a (1, ``space``)
    mesh of ``device`` (default :func:`default_device`, this rank's card,
    which raises without one; the CPU runs only for ``device="cpu"``).  The
    geometry is checked across ranks: a corpus of more than one bucket
    raises ValueError on every rank -- bucket it first (engine/batch.py).

    Returns this rank's RGB arrays in local order; with ``return_checksum``
    also the global decode signature (the sum of every output sample of
    every rank, mod 2**32, over the MCU-padded frames) as an int.
    """
    from jpeg_gpu_tpu_torch.engine.batch import _entropy_decode, _qtables
    from jpeg_gpu_tpu_torch.engine.pipeline import PipelineSpec
    from jpeg_gpu_tpu_torch.host.parser import parse
    from jpeg_gpu_tpu_torch.parallel.shard import decode_batch_sharded

    device = default_device() if device is None else as_device(device)
    parsed = [parse(d) for d in local_datas]
    specs = {PipelineSpec.from_header(p.header, exact=exact, upsample=upsample)
             for p in parsed}
    # Every rank takes part in the check (and the sum) whatever it holds,
    # so that a mixed bucket raises everywhere instead of leaving ranks
    # waiting in a collective.
    mine = [len(specs) <= 1, next(iter(specs)) if len(specs) == 1 else None]
    views = [mine]
    if _grouped():
        views = [None] * dist.get_world_size()
        dist.all_gather_object(views, mine)
    geometries = {v[1] for v in views if v[1] is not None}
    if not all(v[0] for v in views) or len(geometries) > 1:
        raise ValueError(
            "decode_batch_distributed requires one geometry bucket; "
            "bucket the corpus first (engine/batch.py)"
        )
    out: List[np.ndarray] = []
    checksum = torch.zeros((), dtype=torch.int64, device=device)
    if parsed:
        spec = specs.pop()
        results = [_entropy_decode(p, soa=False) for p in parsed]
        q = torch.from_numpy(_qtables(parsed)).to(device)
        n = len(parsed)
        coefs = tuple(
            torch.from_numpy(np.stack([r.coefs[ci] for r in results])).to(device)
            for ci in range(spec.ncomps))
        qts = tuple(q[:, ci].reshape(n, 1, 1, 8, 8) for ci in range(spec.ncomps))
        mesh = make_mesh(devices=[device] * space, space=space)
        rgb, checksum = decode_batch_sharded(spec, mesh, coefs, qts)
        rgb = rgb[:, : spec.height, : spec.width].cpu().numpy()
        out = list(rgb)
    if not return_checksum:
        return out
    if _grouped():
        dist.all_reduce(checksum)     # int64 sums of uint32 values cannot wrap
    return out, int(checksum) & 0xFFFFFFFF
