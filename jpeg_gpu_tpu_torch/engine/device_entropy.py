"""Engine glue: parsed JPEG -> entropy decode on the device -> coefficients.

The port of ``jpeg_gpu_tpu/engine/device_entropy.py``.  The host only
parses markers and destuffs and packs the entropy bits (host/segments.py);
the device runs the index scan for streams without restart markers (K3),
the Huffman decode with its DC predictors (K2) and the assembly into the
coefficient layouts the pixel pipeline consumes.  A table set's tensors and
the symbol tables K2 and K3 build from them stay on the card
(:func:`device_tables`), so a frame uploads its bits and a few small maps in
one copy.  For the PACK upload the
host does the Huffman work and the device expands the packed (run, value)
stream (K4, :func:`expand_pack_device`).  :func:`decode_image_device_sharded`
decodes one image over a (data, space) mesh (``parallel/shard.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from jpeg_gpu_tpu_torch.errors import JpegFormatError, JpegUnsupportedError
from jpeg_gpu_tpu_torch.host.parser import ParsedJpeg
from jpeg_gpu_tpu_torch.host.segments import (
    SpecScanInput,
    build_plan_auto,
    build_spec_scan_input,
)
from jpeg_gpu_tpu_torch.ops import entropy_device
from jpeg_gpu_tpu_torch.ops import specsync_device
from jpeg_gpu_tpu_torch.ops.entropy_device import plan_tensors
from jpeg_gpu_tpu_torch.utils.device import resolve_device
from jpeg_gpu_tpu_torch.utils.logging import get_logger

log = get_logger("engine")

# Bytes per subsequence the device index scan aims for (a lane's chain is
# that long).  Shorter subsequences give more lanes and shorter chains but
# more rounds, and the scan falls back to the host once it has run 16
# without converging; build_spec_scan_input never goes below two average
# MCUs.  On an H100 256 is faster than 512 at 1080p and at 4K.  128 is faster
# still (0.36 against 0.47 ms at 1080p 4:2:0, quality 85) but over 1080p
# frames of quality 50, 75 and 95 in 4:4:4 and 4:2:0 it needs up to 14 of the
# 16 rounds (4:4:4 at quality 95), where 256 needs at most 10 and 512 at
# most 6: a scan that runs out of rounds costs its own time and then the
# serial host scan.  chip_smoke.py prints the sweep.
SCAN_SB_TARGET = 256


@dataclasses.dataclass
class DeviceEntropyResult:
    coefs: Tuple[torch.Tensor, ...]  # per comp (vb, hb, 8, 8) int16, on the device
    err: torch.Tensor                # (B, 8, 128) int32 error flags
    # Runs through the device index scan only: (rounds, total_records,
    # overflowed) from the scan, for diagnostics.
    specsync_stats: Optional[np.ndarray] = None


@dataclasses.dataclass
class DeviceTables:
    """One Huffman table set on a device: the rank tables as tensors and the
    symbol tables the kernels build from them (None on the CPU, whose plain
    versions have no use for them)."""

    cbase: torch.Tensor
    counts: torch.Tensor
    symbols: torch.Tensor
    k2_lut: Optional[torch.Tensor]
    k3_lut: Optional[torch.Tensor]
    arrays: tuple    # the host arrays, kept alive so that their ids stay theirs


_DEVICE_TABLES: dict = {}


def device_tables(cbase, counts, symbols, device, scan: bool) -> DeviceTables:
    """The table set (host/segments.py:_table_tensors' read-only, memoized
    arrays) on ``device``: uploaded, and its symbol tables built, once per
    set and device; K3's only when a scan (``scan``) first asks."""
    device = torch.device(device)
    key = (id(cbase), id(counts), id(symbols), device.type, device.index)
    tabs = _DEVICE_TABLES.get(key)
    if tabs is None or cbase.flags.writeable:
        t = plan_tensors((cbase, counts, symbols), device)
        k2 = entropy_device.symbol_lut(*t) if device.type == "cuda" else None
        tabs = DeviceTables(*t, k2, None, (cbase, counts, symbols))
        if not cbase.flags.writeable:   # only arrays that cannot change are kept
            if len(_DEVICE_TABLES) >= 64:
                _DEVICE_TABLES.clear()
            _DEVICE_TABLES[key] = tabs
    if scan and tabs.k3_lut is None and device.type == "cuda":
        tabs.k3_lut = specsync_device.build_scan_lut(tabs.cbase, tabs.counts, tabs.symbols)
    return tabs


def mcu_starts_fit(n_bits: int, n_mcus: int, bpm: int) -> bool:
    """Whether ``n_bits`` of entropy-coded data can hold the starts of
    ``n_mcus`` MCUs of ``bpm`` blocks.  A block takes at least two codes,
    its DC and one AC (EOB at the least), and every code at least one bit,
    so MCU starts lie at least ``2 * bpm`` bits apart, the first at bit 0 and
    all before the stream's end.  Where they do not fit, the stream cannot
    be the frame its SOF claims: the device index scan cannot find its MCUs
    (its ``ok`` is False), and no buffer is sized by that frame."""
    return n_bits > 0 and n_mcus <= (n_bits - 1) // (2 * bpm) + 1


def _spec_decode_try(parsed: ParsedJpeg, device):
    """Decode a stream without restart markers through the device index scan
    (K3), then K2's fused form, which reads the scan's windows at the MCUs'
    bit positions and applies the DC predictors.

    Returns (kernel_out, err, stats) with the DC bases applied, or None
    when the scan did not converge, overflowed its records, or the stream
    is out of range: the caller then falls back to the serial host scan
    (build_plan_auto), as the reference does.  A stream too short for its
    frame (:func:`mcu_starts_fit`) is not scanned, since the scan cannot find its
    MCUs; the scan's ``ok`` is read, with its stats in one copy, before K2
    is enqueued or its output allocated, so K2 never runs on the bit
    positions of a scan that failed."""
    try:
        inp = build_spec_scan_input(parsed, sb_target=SCAN_SB_TARGET)
    except JpegUnsupportedError:
        return None
    if not mcu_starts_fit(inp.n_bits, inp.n_mcus, inp.bpm):
        log.debug("%d scan bits cannot hold %d MCUs; serial index scan",
                  inp.n_bits, inp.n_mcus)
        return None
    tabs = device_tables(inp.cbase, inp.counts, inp.symbols, device, scan=True)
    windows, dcslot_c, acslot_c, comp_map, dcslot_map, acslot_map = plan_tensors(
        (inp.windows, inp.dcslot_of_c, inp.acslot_of_c, inp.comp_of_step,
         inp.dc_slot_of_step, inp.ac_slot_of_step), device
    )
    bitpos, ok, stats = specsync_device.device_index_scan(
        windows, inp.n_bits, dcslot_c, acslot_c, tabs.cbase, tabs.counts, tabs.symbols,
        sb=inp.subseq_bytes, maxrec=inp.maxrec, n_mcus=inp.n_mcus, lut=tabs.k3_lut,
    )
    verdict = torch.cat([stats, ok.reshape(1).to(stats.dtype)]).cpu().numpy()
    stats = verdict[:3]
    if not verdict[3]:
        log.debug(
            "device index scan did not converge (stats=%s); falling back "
            "to the serial index scan", stats,
        )
        return None
    out, err = entropy_device.decode_mcus_at_bitpos(
        windows, bitpos, inp.n_bits, comp_map, dcslot_map, acslot_map,
        tabs.cbase, tabs.counts, tabs.symbols, spw=inp.spw, lut=tabs.k2_lut,
    )
    return out, err, stats


def _scan_geometry(header) -> Tuple[Tuple[int, int], ...]:
    """(hsamp, vsamp) of each scan component, in scan order."""
    return tuple(
        (header.components[i].hsamp, header.components[i].vsamp)
        for i in header.scan.comp_idx
    )


def check_scan_fits(parsed: ParsedJpeg, what: str = "the stream") -> None:
    """Raise JpegFormatError for a stream whose entropy-coded bytes, all its
    segments together, cannot hold its frame's MCUs (:func:`mcu_starts_fit`
    over their sum, counted before destuffing, so never short of the truth).
    Every MCU takes at least two bits a block inside its own segment, so
    this holds whatever the segment count.  Such a decode could only fail:
    the serial index scan and the host decode run out of bits (the error the
    reference raises), and K2 would flag the segments.  But the host's
    coefficient arrays and every plan are sized by the frame its SOF claims,
    and a plan's rows by the restart interval (a DRI of 65535 on two
    segments of a claimed 131070-MCU frame: 51 GB of K2 output), so the
    stream is refused before any of them."""
    spans = parsed.segments[:, 1] - parsed.segments[:, 0]
    n_bytes = int(spans.sum())
    bpm = sum(hs * vs for hs, vs in _scan_geometry(parsed.header))
    if not mcu_starts_fit(8 * n_bytes, parsed.header.n_mcus, bpm):
        raise JpegFormatError(
            f"{what}: its {n_bytes} bytes of scan in {len(spans)} segment(s) cannot hold "
            f"the frame's {parsed.header.n_mcus} MCUs")


def _raise_on_segment_flags(err: torch.Tensor, n_segments: int, kind: str) -> None:
    flags = err.reshape(-1)[:n_segments].cpu().numpy()
    if flags.any():
        bad = int(np.flatnonzero(flags)[0])
        raise JpegFormatError(
            f"device entropy decode failed in {kind} {bad} (flags={int(flags[bad])})"
        )


def entropy_decode_device(
    parsed: ParsedJpeg,
    device=None,
    check_errors: bool = True,
    soa: bool = False,
    on_error: str = "raise",
    specsync: bool = True,
) -> DeviceEntropyResult:
    """Decode the scan's entropy bits on ``device`` (K2 on a CUDA device).

    ``device=None`` means "cuda" and raises without a card; the CPU, with
    the kernels' plain versions, runs only for ``device="cpu"``.

    ``soa=True`` assembles parity-split coefficient planes (K1's layout)
    instead of (vb, hb, 8, 8) blocks.

    ``on_error`` makes restart segments the fault-isolation boundary they
    were designed to be: "raise" raises JpegFormatError on any flagged
    segment; "zero" salvages the image -- flagged segments decode to zero
    coefficients (flat gray blocks) and every other segment is unaffected.

    Streams without restart markers go through the device index scan (K3)
    by default: the host only destuffs and uploads window rows.  If the
    scan cannot be used, the serial host scan takes over with the same
    result.  ``specsync=False`` forces the host scan.
    """
    if on_error not in ("raise", "zero"):
        raise ValueError(f"on_error must be 'raise' or 'zero', got {on_error!r}")
    device = resolve_device(device, "entropy_decode_device")
    header = parsed.header
    check_scan_fits(parsed)
    spec_result = None
    if (
        specsync
        and not header.restart_interval
        and len(parsed.segments) == 1
        and header.n_mcus >= 2
    ):
        spec_result = _spec_decode_try(parsed, device)
    spec_stats = None
    if spec_result is not None:
        kernel_out, err, spec_stats = spec_result
        plan_nseg, plan_mps = header.n_mcus, 1
    else:
        plan = build_plan_auto(parsed)
        plan_nseg, plan_mps = plan.n_segments, plan.mcus_per_segment
        tabs = device_tables(plan.cbase, plan.counts, plan.symbols, device, scan=False)
        tensors = plan_tensors((plan.streams,) + plan.kernel_tables[:4], device)
        kernel_out, err = entropy_device.decode_segments_device(
            *tensors, tabs.cbase, tabs.counts, tabs.symbols, lut=tabs.k2_lut)
        if plan.dc_base is not None:
            # Pseudo segments of a stream without restart markers: restore
            # the DC predictor continuation the index scan recorded (before
            # salvage, so zeroed segments stay flat gray).
            nbatch = kernel_out.shape[0]
            dcb = np.zeros((nbatch * 8 * 128, plan.dc_base.shape[1]), dtype=np.int32)
            dcb[: plan.n_segments] = plan.dc_base
            kernel_out = entropy_device.apply_dc_base(
                kernel_out,
                torch.from_numpy(dcb.reshape(nbatch, 8, 128, -1)).to(device),
                tensors[1],
            )
    if on_error == "zero":
        # Blank flagged segments: the damage stays inside the segment.
        kernel_out = torch.where((err != 0)[:, None, None], 0, kernel_out)
    coefs = entropy_device.assemble_components(
        kernel_out,
        n_segments=plan_nseg,
        mcus_per_segment=plan_mps,
        n_mcus=header.n_mcus,
        nhmb=header.nhmb,
        nvmb=header.nvmb,
        comp_geometry=_scan_geometry(header),
        soa=soa,
        frame_order=header.scan.comp_idx,
    )
    if check_errors and on_error == "raise":
        # Flags are exact for every segment (K2 suppresses the spurious
        # flags of a short last segment's padded tail).
        _raise_on_segment_flags(
            err, plan_nseg, "pseudo segment" if spec_stats is not None else "restart segment")
    return DeviceEntropyResult(coefs=coefs, err=err, specsync_stats=spec_stats)


def expand_pack_device(parsed: ParsedJpeg, scan, device=None) -> Tuple[torch.Tensor, ...]:
    """PACK-upload path: ship (run, value) streams, expand them to dense
    coefficients on ``device`` (K4 on a CUDA device).

    ``scan`` is a host ScanResult made with ``want_pack=True``.  Covers
    streams without restart markers (the host did the Huffman work) and
    cuts the host->device bytes to 2 per non-zero coefficient.  Returns
    per-component (vb, hb, 8, 8) int16 tensors in frame order.
    ``device=None`` means "cuda" and raises without a card.
    """
    from jpeg_gpu_tpu_torch.host.pack_plan import build_pack_plan
    from jpeg_gpu_tpu_torch.ops import pack_device

    device = resolve_device(device, "expand_pack_device")
    header = parsed.header
    plan = build_pack_plan(parsed, scan)
    streams, = plan_tensors((plan.streams,), device)
    kernel_out = pack_device.expand_pack_device(streams, plan.blocks_per_segment)
    return entropy_device.assemble_components(
        kernel_out,
        n_segments=plan.n_segments,
        mcus_per_segment=plan.mcus_per_segment,
        n_mcus=header.n_mcus,
        nhmb=header.nhmb,
        nvmb=header.nvmb,
        comp_geometry=_scan_geometry(header),
        soa=False,
        frame_order=header.scan.comp_idx,
    )


def _spec_decode_sharded_try(parsed: ParsedJpeg, mesh, exact, upsample, check_errors):
    """Sharded decode of a stream without restart markers through the device
    index scan (``parallel/shard.decode_image_device_sharded_spec``).

    Returns the cropped RGB array, or None when the scan did not converge,
    the stream is out of its range or too short for its frame
    (:func:`mcu_starts_fit`): the caller then takes the serial host scan."""
    from jpeg_gpu_tpu_torch.engine import pipeline
    from jpeg_gpu_tpu_torch.parallel import shard

    header = parsed.header
    try:
        inp = build_spec_scan_input(parsed, sb_target=SCAN_SB_TARGET)
    except JpegUnsupportedError:
        return None
    if not mcu_starts_fit(inp.n_bits, inp.n_mcus, inp.bpm):
        return None
    spec = pipeline.PipelineSpec.from_header(header, exact=exact, upsample=upsample)
    first = mesh.first_device
    tabs = device_tables(inp.cbase, inp.counts, inp.symbols, first, scan=True)
    windows, dcslot_c, acslot_c, comp_map, dcslot, acslot, seg_meta = plan_tensors(
        (inp.windows, inp.dcslot_of_c, inp.acslot_of_c, inp.comp_of_step,
         inp.dc_slot_of_step, inp.ac_slot_of_step, inp.seg_meta), first)
    qts = plan_tensors([header.quant_for(c).values for c in header.components], first)
    result = shard.decode_image_device_sharded_spec(
        spec, mesh,
        (header.n_mcus, 1, header.n_mcus, header.nhmb, header.nvmb,
         _scan_geometry(header), header.scan.comp_idx),
        (inp.subseq_bytes, inp.maxrec, inp.nw, inp.spw, inp.nws, inp.t_last),
        windows, inp.n_bits, (dcslot_c, acslot_c),
        (comp_map, dcslot, acslot, seg_meta, tabs.cbase, tabs.counts, tabs.symbols),
        qts, luts=(tabs.k2_lut, tabs.k3_lut),
    )
    if result is None:
        log.debug("sharded device index scan did not converge; falling back")
        return None
    rgb, err = result
    if check_errors:
        _raise_on_segment_flags(err, header.n_mcus, "pseudo segment")
    return rgb[: header.height, : header.width].cpu().numpy()


def decode_image_device_sharded(
    parsed: ParsedJpeg,
    mesh,
    exact: bool = True,
    upsample: str = "nearest",
    check_errors: bool = True,
    specsync: Optional[bool] = None,
) -> np.ndarray:
    """One image decoded on the device, sharded over ``mesh``
    (``parallel/mesh.make_mesh``): restart-segment batches shard over the
    data axis (K2 on each data shard), the coefficients are gathered, and
    the pixel stage splits MCU rows over the space axis
    (``parallel/shard.decode_image_device_sharded``).  The inputs go up to
    the mesh's first device in one copy, and the result is gathered there.
    Returns the cropped RGB array.

    Streams without restart markers take the device index scan (K3) on the
    mesh unless ``specsync`` is False (None means True); if the scan cannot
    be used, the serial host scan's pseudo segments shard the same way.
    A flagged segment raises JpegFormatError naming it.
    """
    from jpeg_gpu_tpu_torch.engine import pipeline
    from jpeg_gpu_tpu_torch.parallel import shard
    from jpeg_gpu_tpu_torch.parallel.mesh import DATA_AXIS

    header = parsed.header
    check_scan_fits(parsed)
    if specsync is None:
        specsync = True
    if (
        specsync
        and not header.restart_interval
        and len(parsed.segments) == 1
        and header.n_mcus >= 2
    ):
        rgb = _spec_decode_sharded_try(parsed, mesh, exact, upsample, check_errors)
        if rgb is not None:
            return rgb
    plan = build_plan_auto(parsed)
    streams = plan.streams
    pad = (-streams.shape[0]) % mesh.shape[DATA_AXIS]
    if pad:   # filler batches decode 1-padding: flagged, and ignored
        streams = np.concatenate(
            [streams, np.full((pad,) + streams.shape[1:], -1, dtype=streams.dtype)])
    arrays = [streams, *plan.kernel_tables[:4]]
    if plan.dc_base is not None:
        # Pseudo segments of the serial scan: their DC bases shard with the
        # streams.
        dcb = np.zeros((streams.shape[0] * entropy_device.SLOTS, plan.dc_base.shape[1]),
                       dtype=np.int32)
        dcb[: plan.n_segments] = plan.dc_base
        arrays.append(dcb.reshape(streams.shape[0], entropy_device.SUBLANES,
                                  entropy_device.LANES, -1))
    first = mesh.first_device
    tensors = plan_tensors(arrays, first)
    tabs = device_tables(plan.cbase, plan.counts, plan.symbols, first, scan=False)
    qts = plan_tensors([header.quant_for(c).values for c in header.components], first)
    spec = pipeline.PipelineSpec.from_header(header, exact=exact, upsample=upsample)
    rgb, err = shard.decode_image_device_sharded(
        spec, mesh,
        (plan.n_segments, plan.mcus_per_segment, header.n_mcus, header.nhmb,
         header.nvmb, _scan_geometry(header), header.scan.comp_idx),
        tensors[0], (*tensors[1:5], tabs.cbase, tabs.counts, tabs.symbols), qts,
        dc_base=tensors[5] if plan.dc_base is not None else None, lut=tabs.k2_lut,
    )
    if check_errors:
        _raise_on_segment_flags(err, plan.n_segments, "restart segment")
    return rgb[: header.height, : header.width].cpu().numpy()


def decode_image_device(
    parsed: ParsedJpeg,
    stage="rgb",
    exact: bool = True,
    upsample: str = "nearest",
    on_error: str = "raise",
    device=None,
    stats: Optional[dict] = None,
):
    """Fully on-device decode: entropy bits -> pixels, with no intermediate
    copy back to the host.  Returns tensors on ``device`` (the RGB stage a
    (H, W, 3) uint8 tensor, the other stages tuples).  A ``stats`` dict
    receives the device index scan's ``specsync_stats`` (None when the scan
    did not run or fell back).  ``device=None`` means "cuda" and raises
    without a card."""
    from jpeg_gpu_tpu_torch.engine import pipeline
    from jpeg_gpu_tpu_torch.engine.stages import OutputStage

    device = resolve_device(device, "decode_image_device")
    header = parsed.header
    spec = pipeline.PipelineSpec.from_header(header, exact=exact, upsample=upsample)
    stage = stage if isinstance(stage, OutputStage) else OutputStage(stage)
    geom = pipeline.fused_rgb_geometry(spec)
    use_fused = stage == OutputStage.RGB and geom is not None
    result = entropy_decode_device(parsed, device=device, soa=use_fused, on_error=on_error)
    if stats is not None:
        stats["specsync_stats"] = result.specsync_stats
    if stage == OutputStage.QUANT:
        return result.coefs
    qts = plan_tensors(
        [header.quant_for(c).values for c in header.components], device
    )
    if use_fused:
        return pipeline.decode_rgb_soa(spec, geom, result.coefs, qts)
    return pipeline.run(spec, stage, result.coefs, qts)
