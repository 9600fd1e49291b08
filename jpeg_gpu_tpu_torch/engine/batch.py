"""Batched throughput decode: many JPEGs -> one device call per bucket.

The port of ``jpeg_gpu_tpu/engine/batch.py``: the throughput mode of
BASELINE.json (config #4, an image corpus).  Images are grouped into
*geometry buckets* -- same dimensions and sampling structure -- and each
bucket decodes as one batched call on ``device``:

* :func:`decode_batch` decodes the entropy bits on the host (native C++,
  restart-parallel); the fused geometries go to K1 as parity-split SoA
  planes stacked on its batch axis, the others to K5 (or K6 with
  ``exact=False``) through ``pipeline.decode_rgb``;
* :func:`decode_batch_device` decodes the bits on the device too: one K2
  launch per bucket over every image's restart segments, each image with its
  own Huffman tables, then one assembly and one pixel call for the bucket;
* :func:`decode_batch_device_resident` is the same for a corpus of one
  bucket, and leaves the pixels on the device.

Quantization tables may differ per image inside a bucket: they travel as a
batched (N, 64) tensor to K1, or (N, 1, 1, 8, 8) to K5/K6, one row per
image.  ``device=None`` means the card; the CPU, with each kernel's plain
version, runs only for ``device="cpu"``.

With ``mesh`` (a (data, space) grid of devices, ``parallel/mesh.make_mesh``)
:func:`decode_batch` and :func:`decode_batch_device` shard each bucket:
images over ``data`` (over the whole grid for the Huffman decode), MCU block
rows over ``space`` (``parallel/shard.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jpeg_gpu_tpu_torch.engine import pipeline
from jpeg_gpu_tpu_torch.engine.decoder import _numpy
from jpeg_gpu_tpu_torch.engine.device_entropy import check_scan_fits
from jpeg_gpu_tpu_torch.engine.pipeline import PipelineSpec
from jpeg_gpu_tpu_torch.errors import JpegFormatError, JpegUnsupportedError
from jpeg_gpu_tpu_torch.host.parser import ParsedJpeg, parse
from jpeg_gpu_tpu_torch.host.segments import build_corpus_plan, build_plan, plan_bucket_key
from jpeg_gpu_tpu_torch.ops import entropy_device, pixel_fused
from jpeg_gpu_tpu_torch.ops.entropy_device import plan_tensors
from jpeg_gpu_tpu_torch.parallel import shard
from jpeg_gpu_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, as_device
from jpeg_gpu_tpu_torch.utils.device import resolve_device
from jpeg_gpu_tpu_torch.utils.logging import get_logger

log = get_logger("engine")


def _mesh_device(mesh, device, who: str) -> torch.device:
    """The device a call runs on: the mesh's first device (where the
    inputs go up and the results are gathered) or ``device``."""
    if mesh is None:
        return resolve_device(device, who)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{who}: mesh must be a jpeg_gpu_tpu_torch.parallel.mesh.Mesh, "
                        f"got {type(mesh).__name__}")
    if device is not None and as_device(device) != mesh.first_device:
        raise ValueError(f"{who}: device={device} is not the mesh's first device")
    return mesh.first_device


def _bucket_key(spec: PipelineSpec) -> Tuple:
    # comp_samps matters too: equal sizes/decimations can still have
    # different sampling factors (e.g. 4:4:4 vs all-2x2 factors) and
    # therefore different MCU-aligned block grids.
    return (
        spec.width,
        spec.height,
        spec.comp_sizes,
        spec.comp_decs,
        spec.comp_samps,
    )


@dataclasses.dataclass
class _Bucket:
    """A geometry bucket: host entropy fills ``coefs``, the device planner
    ``plans``, one entry per image either way."""

    spec: PipelineSpec
    indices: List[int] = dataclasses.field(default_factory=list)
    parsed: List[ParsedJpeg] = dataclasses.field(default_factory=list)
    coefs: List[List[np.ndarray]] = dataclasses.field(default_factory=list)
    plans: list = dataclasses.field(default_factory=list)


def _entropy_decode(parsed: ParsedJpeg, soa: bool):
    """Host entropy decode: native C++ where it builds, else Python.  With
    ``soa`` the coefficients come as K1's parity-split SoA planes when the
    native decoder writes them, else as (vb, hb, 8, 8) blocks."""
    from jpeg_gpu_tpu_torch.host import entropy, entropy_native

    check_scan_fits(parsed)
    if entropy_native.available():
        return entropy_native.decode_scan(parsed, soa=soa)
    return entropy.decode_scan(parsed)


def _qtables(parsed: Sequence[ParsedJpeg]) -> np.ndarray:
    """(NI, ncomps, 64) int32: every image's quant tables, frame order."""
    return np.stack([
        np.stack([p.header.quant_for(c).values.astype(np.int32).reshape(64)
                  for c in p.header.components])
        for p in parsed
    ])


def _pixels(spec: PipelineSpec, comps, qtables: torch.Tensor) -> torch.Tensor:
    """A bucket's coefficients -> (NI, H, W, 3) uint8 in one pixel call.

    ``comps`` are per-component tensors with the image axis in front: K1's
    SoA planes for the fused geometries, else (NI, vb, hb, 8, 8) blocks;
    ``qtables`` is (NI, ncomps, 64), one row per image."""
    ni = qtables.shape[0]
    geom = pipeline.fused_rgb_geometry(spec)
    if geom is not None:
        if comps[0].dim() == 5:     # blocks from the Python decoder -> SoA
            sx, sy = geom
            comps = (pixel_fused.blocks_to_soa_split(comps[0], sx, sy),
                     pixel_fused.blocks_to_soa_split(comps[1], 1, 1),
                     pixel_fused.blocks_to_soa_split(comps[2], 1, 1))
        qts = tuple(qtables[:, ci] for ci in range(spec.ncomps))
        return pipeline.decode_rgb_soa(spec, geom, comps, qts)
    qts = tuple(qtables[:, ci].reshape(ni, 1, 1, 8, 8) for ci in range(spec.ncomps))
    return pipeline.decode_rgb(spec, comps, qts)


def decode_batch(
    datas: Sequence[bytes],
    exact: bool = True,
    mesh=None,
    upsample: str = "nearest",
    entropy: str = "host",
    device=None,
) -> List[np.ndarray]:
    """Decode a corpus of JPEGs to RGB, batching same-geometry images.

    Each bucket runs as one batched call on ``device``, or with ``mesh``
    sharded over its grid (``parallel/shard.decode_batch_sharded``: images
    over data, the bucket padded to the data axis with its last image, block
    rows over space).  ``entropy="device"`` runs the Huffman decode on the
    device too (:func:`decode_batch_device`).  Returns RGB arrays in input
    order.
    """
    if entropy == "device":
        return decode_batch_device(
            datas, exact=exact, upsample=upsample, mesh=mesh, device=device)
    device = _mesh_device(mesh, device, "decode_batch")
    buckets: Dict[Tuple, _Bucket] = {}
    for i, data in enumerate(datas):
        parsed = parse(data)
        spec = PipelineSpec.from_header(parsed.header, exact=exact, upsample=upsample)
        # The sharded pixel stage takes blocks; K1 takes SoA planes.
        soa = mesh is None and pipeline.fused_rgb_geometry(spec) is not None
        result = _entropy_decode(parsed, soa=soa)
        b = buckets.setdefault(_bucket_key(spec), _Bucket(spec))
        b.indices.append(i)
        b.coefs.append(result.coefs)
        b.parsed.append(parsed)

    out: List[Optional[np.ndarray]] = [None] * len(datas)
    for bucket in buckets.values():
        # The bucket's coefficients on an image axis, and a table row per image.
        ncomps = bucket.spec.ncomps
        arrays = [np.stack([c[ci] for c in bucket.coefs]) for ci in range(ncomps)]
        qtables = _qtables(bucket.parsed)
        if mesh is None:
            comps = tuple(torch.from_numpy(a).to(device) for a in arrays)
            rgb = _numpy(_pixels(bucket.spec, comps, torch.from_numpy(qtables).to(device)))
        else:
            rgb = _decode_bucket_sharded(bucket.spec, arrays, qtables, mesh)
        for j, i in enumerate(bucket.indices):
            out[i] = rgb[j]
    return out  # type: ignore[return-value]


def _decode_bucket_sharded(spec: PipelineSpec, arrays, qtables: np.ndarray, mesh) -> np.ndarray:
    """A host-entropy bucket over the mesh: ``arrays`` are the components'
    (N, vb, hb, 8, 8) blocks, ``qtables`` (N, ncomps, 64).  Returns the
    cropped (N, H, W, 3) RGB.  ValueError where the space axis does not
    divide a component's block rows."""
    n = qtables.shape[0]
    pad = (-n) % mesh.shape[DATA_AXIS]
    # The batch must tile the data axis: repeat the last image, then crop.
    arrays = [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) for a in arrays]
    qtables = np.concatenate([qtables, np.repeat(qtables[-1:], pad, axis=0)])
    first = mesh.first_device
    comps = tuple(torch.from_numpy(a).to(first) for a in arrays)
    q = torch.from_numpy(qtables).to(first)
    qts = tuple(q[:, ci].reshape(n + pad, 1, 1, 8, 8) for ci in range(spec.ncomps))
    rgb, _ = shard.decode_batch_sharded(spec, mesh, comps, qts)
    return _numpy(rgb[:n, : spec.height, : spec.width])


def _device_buckets(datas, exact, upsample):
    """Parse and plan every image: buckets by (geometry, restart structure),
    and the indices of the images the device planner rejects.  A stream too
    short for the frame its SOF claims raises
    JpegFormatError naming the image (``device_entropy.check_scan_fits``)
    before anything is sized by that frame."""
    buckets: Dict[Tuple, _Bucket] = {}
    fallback: List[int] = []
    for i, data in enumerate(datas):
        parsed = parse(data)
        check_scan_fits(parsed, f"image {i}")
        try:
            plan = build_plan(parsed)
        except JpegUnsupportedError:
            fallback.append(i)
            continue
        spec = PipelineSpec.from_header(parsed.header, exact=exact, upsample=upsample)
        key = (_bucket_key(spec), plan_bucket_key(plan))
        b = buckets.setdefault(key, _Bucket(spec))
        b.indices.append(i)
        b.parsed.append(parsed)
        b.plans.append(plan)
    return list(buckets.values()), fallback


def _decode_bucket_device(
    bucket: _Bucket, on_error: str, device, mark: Optional[Callable[[str], None]] = None
):
    """One bucket on ``device``: the bits and tables up in one copy, one K2
    launch for every image's segments (a Huffman table set per image, their
    symbol tables built in one launch), one assembly, one pixel call.
    Returns (rgb (NI, H, W, 3) uint8, err_img (NI,) int32), both on the
    device: an image's flag is the largest of its real segments' flags.

    ``mark``, where given, is called with each stage's name once the stage
    is issued: a caller that times the stages synchronizes there."""
    mark = mark or (lambda stage: None)
    hdr = bucket.parsed[0].header
    corpus_plan = build_corpus_plan(bucket.plans)
    ni, b1 = corpus_plan.n_images, corpus_plan.batches_per_image
    mark("corpus plan")
    streams, *tables, qtables = plan_tensors(
        (corpus_plan.streams, *corpus_plan.kernel_tables, _qtables(bucket.parsed)), device)
    mark("upload")
    out, err = entropy_device.decode_segments_device_multi(streams, *tables)
    if on_error == "zero":
        # Blank flagged segments: the damage stays inside the segment.
        out = torch.where((err != 0)[:, None, None], 0, out)
    mark("entropy")
    comps = entropy_device.assemble_components(
        out.reshape(ni, b1, *out.shape[1:]),
        n_segments=corpus_plan.n_segments,
        mcus_per_segment=corpus_plan.mcus_per_segment,
        n_mcus=corpus_plan.n_mcus,
        nhmb=hdr.nhmb,
        nvmb=hdr.nvmb,
        comp_geometry=tuple(
            (hdr.components[ci].hsamp, hdr.components[ci].vsamp) for ci in hdr.scan.comp_idx
        ),
        soa=pipeline.fused_rgb_geometry(bucket.spec) is not None,
        frame_order=hdr.scan.comp_idx,
    )
    mark("assembly")
    rgb = _pixels(bucket.spec, comps, qtables)
    mark("pixels")
    err_img = err.reshape(ni, -1)[:, : corpus_plan.n_segments].amax(1)
    mark("flags")
    return rgb, err_img


def _decode_bucket_device_sharded(bucket: _Bucket, on_error: str, mesh):
    """One bucket over the mesh (``parallel/shard.decode_corpus_device_sharded``):
    the inputs up to the mesh's first device in one copy, K2 once on each
    shard of the grid over its images, K1 (or K5 / K6) on each shard's block
    rows.  The image count is padded to a multiple of the grid with the last
    image, whose extra outputs are dropped.  Returns (rgb (NI, H, W, 3)
    uint8, flagged (2, NI) int32) on the first device: per image its largest
    segment flag and its first flagged segment."""
    n = len(bucket.indices)
    n_chips = mesh.size
    pad = (-n) % n_chips
    if pad:
        # Padding is wasted Huffman work: size buckets to the grid.
        (log.warning if pad > n else log.debug)(
            "mesh bucket pads %d image(s) to %d shards (%.0f%% of the entropy "
            "stage is padding)", n, n + pad, 100.0 * pad / (n + pad))
    plans = bucket.plans + [bucket.plans[-1]] * pad
    parsed = bucket.parsed + [bucket.parsed[-1]] * pad
    hdr = parsed[0].header
    spec = bucket.spec
    cp = build_corpus_plan(plans)
    ni, b1 = cp.n_images, cp.batches_per_image
    # Shard-local last-segment meta: every image of the bucket has the same.
    lb0, lane0, steps0 = (int(x) for x in plans[0].seg_meta)
    local_seg_meta = np.array(
        [[j * b1 + lb0, lane0, steps0] for j in range(ni // n_chips)], dtype=np.int32)
    streams, cm, dm, am, lsm, cbase, counts, symbols, qtables = plan_tensors(
        (cp.streams, cp.comp_of_step, cp.dc_slot_of_step, cp.ac_slot_of_step,
         local_seg_meta, cp.cbase, cp.counts, cp.symbols, _qtables(parsed)),
        mesh.first_device)
    geom = tuple((hdr.components[ci].hsamp, hdr.components[ci].vsamp)
                 for ci in hdr.scan.comp_idx)
    rgb, err = shard.decode_corpus_device_sharded(
        spec, mesh,
        (b1, cp.n_segments, cp.mcus_per_segment, cp.n_mcus, hdr.nhmb, hdr.nvmb, geom,
         hdr.scan.comp_idx, on_error == "zero"),
        streams, (cm, dm, am), lsm, (cbase, counts, symbols),
        tuple(qtables[:, ci] for ci in range(spec.ncomps)),
    )
    flags = err.reshape(ni, -1)[:n, : cp.n_segments]
    flagged = torch.stack([flags.amax(1), (flags != 0).to(torch.int32).argmax(1).to(torch.int32)])
    return rgb[:n, : spec.height, : spec.width], flagged


def _raise_on_flags(err_img: torch.Tensor, indices: Sequence[int]) -> None:
    flags = err_img.cpu().numpy()   # NI ints, not NI x 1024 lane flags
    if flags.any():
        bad = int(np.flatnonzero(flags)[0])
        raise JpegFormatError(
            f"device entropy decode failed: image {indices[bad]} "
            f"(flags={int(flags[bad])})"
        )


def _check_on_error(on_error: str) -> None:
    if on_error not in ("raise", "zero"):
        raise ValueError(f"on_error must be 'raise' or 'zero', got {on_error!r}")


def decode_batch_device(
    datas: Sequence[bytes],
    exact: bool = True,
    upsample: str = "nearest",
    check_errors: bool = True,
    on_error: str = "raise",
    mesh=None,
    device=None,
) -> List[np.ndarray]:
    """Fully on-device corpus decode: per-image entropy bits -> RGB.

    Images bucket by (geometry, restart structure); each bucket runs one K2
    launch over every image's segment batches (per-image Huffman tables
    routed by segment batch), one assembly, then one batched pixel call.
    The host only parses markers and packs destuffed words.

    ``on_error="raise"`` raises JpegFormatError naming the input index of
    the first image with a flagged segment; ``"zero"`` decodes flagged
    segments as flat gray blocks.  Images the device planner rejects (a
    stream without restart markers too large for one segment) fall back
    to the host-entropy :func:`decode_batch` (unsharded, on the mesh's
    first device).  With ``mesh`` each bucket shards over its grid
    (:func:`_decode_bucket_device_sharded`), and a flag names the image and
    its first flagged restart segment.  Returns RGB arrays in input order.
    """
    _check_on_error(on_error)
    device = _mesh_device(mesh, device, "decode_batch_device")
    out: List[Optional[np.ndarray]] = [None] * len(datas)
    buckets, fallback = _device_buckets(datas, exact, upsample)
    for bucket in buckets:
        if mesh is None:
            rgb, err_img = _decode_bucket_device(bucket, on_error, device)
            if check_errors and on_error == "raise":
                _raise_on_flags(err_img, bucket.indices)
        else:
            rgb, flagged = _decode_bucket_device_sharded(bucket, on_error, mesh)
            if check_errors and on_error == "raise":
                flags, first_seg = flagged.cpu().numpy()   # one copy a bucket
                if flags.any():
                    bad = int(np.flatnonzero(flags)[0])
                    raise JpegFormatError(
                        f"device entropy decode failed: image {bucket.indices[bad]} "
                        f"restart segment {int(first_seg[bad])} (flags={int(flags[bad])})"
                    )
        rgb = _numpy(rgb)
        for j, i in enumerate(bucket.indices):
            out[i] = rgb[j]
    if fallback:
        host = decode_batch(
            [datas[i] for i in fallback], exact=exact, upsample=upsample, device=device
        )
        for j, i in enumerate(fallback):
            out[i] = host[j]
    return out  # type: ignore[return-value]


def decode_batch_device_resident(
    datas: Sequence[bytes],
    exact: bool = True,
    upsample: str = "nearest",
    check_errors: bool = True,
    on_error: str = "raise",
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fully on-device corpus decode whose pixels stay on the device.

    The serving surface for consumers on the same device (vision models,
    on-device preprocessing): no pixel crosses the host link.  All images
    must share one bucket (geometry and restart structure); otherwise
    ValueError -- :func:`decode_batch_device` takes mixed corpora.

    Returns (rgb, err_img) on ``device``: rgb (N, H, W, 3) uint8, cropped,
    and err_img (N,) int32 per-image flags (0 = clean).
    """
    _check_on_error(on_error)
    device = resolve_device(device, "decode_batch_device_resident")
    buckets, fallback = _device_buckets(datas, exact, upsample)
    if fallback:
        raise JpegUnsupportedError(
            f"image {fallback[0]}: the device planner rejects it; "
            "decode_batch_device decodes such images on the host"
        )
    if len(buckets) != 1:
        raise ValueError(
            "decode_batch_device_resident needs one geometry bucket; "
            "use decode_batch_device for mixed corpora"
        )
    rgb, err_img = _decode_bucket_device(buckets[0], on_error, device)
    if check_errors and on_error == "raise":
        _raise_on_flags(err_img, buckets[0].indices)
    return rgb.contiguous(), err_img
