"""Engine glue: parsed JPEG -> entropy decode on the device -> coefficients.

The port of ``jpeg_gpu_tpu/engine/device_entropy.py``.  The host only
parses markers and destuffs and packs the entropy bits (host/segments.py);
the device runs the index scan for streams without restart markers (K3),
the Huffman decode (K2), the DC-base repair and the assembly into the
coefficient layouts the pixel pipeline consumes.
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
from jpeg_gpu_tpu_torch.utils.logging import get_logger

log = get_logger("engine")


@dataclasses.dataclass
class DeviceEntropyResult:
    coefs: Tuple[torch.Tensor, ...]  # per comp (vb, hb, 8, 8) int16, on the device
    err: torch.Tensor                # (B, 8, 128) int32 error flags
    # Runs through the device index scan only: (rounds, total_records,
    # overflowed) from the scan, for diagnostics.
    specsync_stats: Optional[np.ndarray] = None


def _spec_decode_kernel_out(inp: SpecScanInput, device):
    """Device index scan -> stream realignment on the device -> K2 ->
    derived DC bases.  Returns (kernel_out, err, ok, stats); the outputs
    are garbage unless ok (the caller then falls back)."""
    windows, = plan_tensors((inp.windows,), device)
    dcslot_c, acslot_c, cbase, counts, symbols = plan_tensors(
        (inp.dcslot_of_c, inp.acslot_of_c, inp.cbase, inp.counts, inp.symbols), device
    )
    bitpos, ok, stats = specsync_device.device_index_scan(
        windows, inp.n_bits, dcslot_c, acslot_c, cbase, counts, symbols,
        sb=inp.subseq_bytes, maxrec=inp.maxrec, n_mcus=inp.n_mcus,
    )
    # Row-width check: every pseudo segment, plus its worst-case one-word
    # refill overshoot, must fit the nw-word rows the gather builds, or the
    # decode would read zeros mid-segment.
    seg_bits = torch.diff(bitpos, append=bitpos.new_tensor([inp.n_bits]))
    ok = ok & (seg_bits.max() + 63 <= inp.nw * 32)
    streams = specsync_device.gather_entropy_streams(
        windows, bitpos, nw=inp.nw, spw=inp.spw, nws=inp.nws
    )
    comp_map, dcslot_map, acslot_map, seg_meta = plan_tensors(
        (inp.comp_of_step, inp.dc_slot_of_step, inp.ac_slot_of_step, inp.seg_meta), device
    )
    out, err = entropy_device.decode_segments_device(
        streams, comp_map, dcslot_map, acslot_map, seg_meta, cbase, counts, symbols,
    )
    dcb = specsync_device.dc_base_from_coefs(out, inp.t_last)
    out = entropy_device.apply_dc_base(out, dcb, comp_map)
    return out, err, ok, stats


def _spec_decode_try(parsed: ParsedJpeg, device):
    """Decode a stream without restart markers through the device index scan.

    Returns (kernel_out, err, stats) with the DC bases applied, or None
    when the scan did not converge, overflowed its records, misfit the row
    width, or the stream is out of range: the caller then falls back to
    the serial host scan (build_plan_auto)."""
    try:
        inp = build_spec_scan_input(parsed)
    except JpegUnsupportedError:
        return None
    out, err, ok, stats = _spec_decode_kernel_out(inp, device)
    stats = stats.cpu().numpy()
    if not bool(ok):
        log.debug(
            "device index scan did not converge (stats=%s); falling back "
            "to the serial index scan", stats,
        )
        return None
    return out, err, stats


def entropy_decode_device(
    parsed: ParsedJpeg,
    device="cpu",
    check_errors: bool = True,
    soa: bool = False,
    on_error: str = "raise",
    specsync: bool = True,
) -> DeviceEntropyResult:
    """Decode the scan's entropy bits on ``device`` (K2 on a CUDA device).

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
    device = torch.device(device)
    header = parsed.header
    comp_geometry = tuple(
        (header.components[i].hsamp, header.components[i].vsamp)
        for i in header.scan.comp_idx
    )
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
        tensors = plan_tensors((plan.streams,) + plan.kernel_tables, device)
        kernel_out, err = entropy_device.decode_segments_device(*tensors)
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
        comp_geometry=comp_geometry,
        soa=soa,
        frame_order=header.scan.comp_idx,
    )
    if check_errors and on_error == "raise":
        # Flags are exact for every segment (K2 suppresses the spurious
        # flags of a short last segment's padded tail).
        flags = err.reshape(-1)[:plan_nseg].cpu().numpy()
        if flags.any():
            bad = int(np.flatnonzero(flags)[0])
            kind = "pseudo segment" if spec_stats is not None else "restart segment"
            raise JpegFormatError(
                f"device entropy decode failed in {kind} {bad} "
                f"(flags={int(flags[bad])})"
            )
    return DeviceEntropyResult(coefs=coefs, err=err, specsync_stats=spec_stats)


def decode_image_device(
    parsed: ParsedJpeg,
    stage="rgb",
    exact: bool = True,
    upsample: str = "nearest",
    on_error: str = "raise",
    device="cpu",
    stats: Optional[dict] = None,
):
    """Fully on-device decode: entropy bits -> pixels, with no intermediate
    copy back to the host.  Returns tensors on ``device`` (the RGB stage a
    (H, W, 3) uint8 tensor, the other stages tuples).  A ``stats`` dict
    receives the device index scan's ``specsync_stats`` (None when the scan
    did not run or fell back)."""
    from jpeg_gpu_tpu_torch.engine import pipeline
    from jpeg_gpu_tpu_torch.engine.stages import OutputStage

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
