"""The (data, space) device mesh, and the copies that stand for collectives.

The port of ``jpeg_gpu_tpu/parallel/mesh.py``.  The decode distributes
along two axes:

* ``data``  -- whole images (batched throughput; the data-parallel axis),
* ``space`` -- MCU rows within an image (spatial sharding).

JAX's ``Mesh`` + ``shard_map`` is driven by one process, with XLA placing
the collectives.  Here too one process drives the whole mesh: a sharded
function loops over the grid, runs each shard's step on that shard's
device (on its current stream, with no host sync inside the loop), and
every collective is a plain tensor operation:

* ``ppermute`` of a halo row -- ``row.to(neighbour_device)``;
* ``all_gather`` over an axis -- a ``torch.cat`` of the shards onto each
  receiving device (:func:`all_gather`);
* ``psum`` -- a sum of the shards' partial sums.

A device may appear more than once in the grid (several shards on one
card, as the tests' CPU mesh and the one-card smoke run have it); a copy
onto the device a tensor already lives on is then the tensor itself.
``torch.distributed`` enters only where the reference crosses processes
(:mod:`.distributed`).

The reference's ``batch_sharding`` / ``replicated`` build ``NamedSharding``
objects, which have no meaning here; :func:`split` and :func:`all_gather`
take their place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
SPACE_AXIS = "space"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, space) grid of torch devices; a device may repeat."""

    devices: Tuple[Tuple[torch.device, ...], ...]   # devices[d][s]

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: len(self.devices), SPACE_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def first_device(self) -> torch.device:
        """Where the sharded functions gather their results."""
        return self.devices[0][0]

    def flat(self) -> List[torch.device]:
        """The grid in (data, space) row-major order: shard g = d * space + s."""
        return [dev for row in self.devices for dev in row]


def distinct(devices: Sequence[torch.device]) -> List[torch.device]:
    """``devices`` without repeats, in first-seen order."""
    return list(dict.fromkeys(devices))


def as_device(d) -> torch.device:
    """``d`` as the torch.device a tensor on it reports ("cuda" gains its
    index)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(
    n_devices: Optional[int] = None,
    space: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (data, space) mesh.

    ``space`` devices cooperate on one image (MCU-row sharding); the rest
    of the devices form the data axis.  ``devices=None`` takes every
    visible card and raises without one: there is no CPU fallback (pass
    ``devices=["cpu"] * 8`` for a CPU mesh).
    """
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cards == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices=['cpu'] * n "
                "for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(n_cards)]
    devices = [as_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"{n_devices} devices requested, {len(devices)} given")
    if space < 1 or n_devices % space != 0:
        raise ValueError(f"{n_devices} devices not divisible by space={space}")
    devices = devices[:n_devices]
    grid = tuple(tuple(devices[d * space:(d + 1) * space]) for d in range(n_devices // space))
    return Mesh(grid)


def to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: the tensor itself when it is there already, else
    an asynchronous copy (the point-to-point transfer of a collective)."""
    if x.device == device:
        return x
    # A copy to the host is left blocking: the host could read it too early.
    return x.to(device, non_blocking=device.type == "cuda")


def split(x: torch.Tensor, n: int, dim: int = 0) -> List[torch.Tensor]:
    """``n`` equal contiguous shards of ``x`` along ``dim`` (views)."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"axis of {size} does not split into {n} shards")
    return list(torch.split(x, size // n, dim=dim))


def all_gather(parts: Sequence[torch.Tensor], device: torch.device,
               dim: int = 0) -> torch.Tensor:
    """The shards ``parts`` concatenated along ``dim`` on ``device``."""
    parts = [to(p, device) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
