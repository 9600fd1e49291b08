"""Decoder backends behind one interface.

The port of ``jpeg_gpu_tpu/engine/decoder.py``: the same decode surface --
``decode_header`` / ``decode(out=stage)`` / ``reset`` -- over

* :class:`HostDecoder`  -- host entropy decode + the plain PyTorch ops on
  the CPU, cropping before fancy upsampling (an independent CPU path);
* :class:`PilDecoder`   -- the libjpeg-turbo oracle (Pillow for RGB, a
  ctypes shim over the system libjpeg for the QUANT/DCT and YUV cuts);
* :class:`TorchDecoder` -- entropy decode on the host, or on the device
  with ``entropy="device"`` (engine/device_entropy.py: K3 and K2), then the
  device pipeline (engine/pipeline.py) on a chosen torch device.  On a CUDA
  device the RGB decode of the fused geometries runs the K1 kernel; the
  YUV stage, grayscale and the other geometries run K5 (exact) or K6
  (``exact=False``), one launch for all components; ``upload="pack"``
  ships the packed (run, value) stream and expands it on the device (K4).

Every ``decode`` returns numpy arrays, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from jpeg_gpu_tpu_torch.engine.stages import OutputStage
from jpeg_gpu_tpu_torch.errors import JpegError, JpegUnsupportedError
from jpeg_gpu_tpu_torch.host import entropy as host_entropy
from jpeg_gpu_tpu_torch.host.parser import ParsedJpeg, parse
from jpeg_gpu_tpu_torch.info import JpegHeader
from jpeg_gpu_tpu_torch.ops import color as color_ops
from jpeg_gpu_tpu_torch.ops import idct_islow
from jpeg_gpu_tpu_torch.utils.device import resolve_device
from jpeg_gpu_tpu_torch.utils.logging import get_logger

log = get_logger("engine")

StageArg = Union[OutputStage, str]


def _stage(out: StageArg) -> OutputStage:
    return out if isinstance(out, OutputStage) else OutputStage.from_name(out)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().contiguous().numpy()


@dataclasses.dataclass
class YuvOutput:
    """YUV-stage result: per-component sample planes (true comp dims)."""

    planes: List[np.ndarray]


@dataclasses.dataclass
class CoefOutput:
    """QUANT/DCT-stage result: per-component (vb, hb, 8, 8) coefficients."""

    coefs: List[np.ndarray]


@dataclasses.dataclass
class PackOutput:
    """PACK-stage result: the packed (run, value) stream + per-block index."""

    pack: np.ndarray
    index: List[np.ndarray]


class Decoder:
    """Base decoder: owns the bitstream, parses lazily, decodes per stage.

    ``entropy`` selects the scan decoder: "native" (C++ restart-parallel,
    host/native/), "python" (reference implementation), "auto" (native
    when the shared object builds), or -- for :class:`TorchDecoder` --
    "device" (the Huffman decode runs on the device; the host only parses
    and packs the entropy bits).  Where a device decode falls back to the
    host, "device" uses the Python decoder, as the reference does.
    """

    name = "base"
    upload = "coefs"  # what a device decoder ships: "coefs" or "pack"

    def __init__(self, data: bytes, validate: bool = True, entropy: str = "auto"):
        self.data = data
        self.validate = validate
        self.entropy = entropy
        self._parsed: Optional[ParsedJpeg] = None
        self._scan: Optional[host_entropy.ScanResult] = None
        self._scan_soa = None
        self._scan_packed = False

    # -- header ------------------------------------------------------------
    def decode_header(self) -> JpegHeader:
        return self._parse().header

    def _parse(self) -> ParsedJpeg:
        if self._parsed is None:
            self._parsed = parse(self.data, validate=self.validate)
        return self._parsed

    # -- image -------------------------------------------------------------
    def decode(self, out: StageArg = OutputStage.RGB):
        raise NotImplementedError

    def reset(self) -> None:
        """Drop decoded state, keep the bitstream."""
        self._parsed = None
        self._scan = None
        self._scan_soa = None

    # -- shared host entropy stage ------------------------------------------
    def _use_native(self) -> bool:
        if self.entropy == "native":
            return True
        if self.entropy == "auto":
            from jpeg_gpu_tpu_torch.host import entropy_native

            return entropy_native.available()
        return False

    def _host_parse(self) -> ParsedJpeg:
        """The parsed stream for a host entropy decode, which sizes its
        coefficients by the frame: a stream too short for that frame raises
        first (device_entropy.check_scan_fits)."""
        from jpeg_gpu_tpu_torch.engine.device_entropy import check_scan_fits

        parsed = self._parse()
        check_scan_fits(parsed)
        return parsed

    def _entropy(self, want_pack: bool = False) -> host_entropy.ScanResult:
        if self._scan is None or (want_pack and not self._scan_packed):
            if self._use_native():
                from jpeg_gpu_tpu_torch.host import entropy_native

                self._scan = entropy_native.decode_scan(
                    self._host_parse(), want_pack=want_pack, validate=self.validate
                )
            else:
                self._scan = host_entropy.decode_scan(
                    self._host_parse(), want_pack=want_pack, validate=self.validate
                )
            self._scan_packed = want_pack
        return self._scan

    def _entropy_soa(self):
        """Native host entropy decode in the fused kernel's SoA layout
        (parity-split coefficient planes), or None if the native library is
        unavailable or the Python decoder was requested."""
        if not self._use_native():
            return None
        if self._scan_soa is None:
            from jpeg_gpu_tpu_torch.host import entropy_native

            self._scan_soa = entropy_native.decode_scan(
                self._host_parse(), soa=True, validate=self.validate
            ).coefs
        return self._scan_soa

    def io_bytes(self, out: StageArg = OutputStage.RGB) -> dict:
        """Host<->device payload bytes for decode(out) in the current mode.

        ``upload`` is the per-frame payload (coefficients, the packed
        stream with its block index for ``upload="pack"``, or the entropy
        bits for ``entropy="device"``), ``download`` the stage's output;
        Huffman and quant table tensors are reported apart as ``tables``.
        """
        stage = _stage(out)
        hdr = self._parse().header
        coef_b = sum(c.vblocks * c.hblocks * 64 * 2 for c in hdr.components)
        down = {
            OutputStage.RGB: hdr.height * hdr.width * 3,
            OutputStage.YUV: sum(c.height * c.width for c in hdr.components),
            OutputStage.QUANT: coef_b,
            OutputStage.DCT: coef_b * 2,  # int32
            OutputStage.PACK: 0,          # host-only stage
        }[stage]
        tables = 64 * 4 * hdr.ncomps  # dequant tables
        mode = "host"
        if stage == OutputStage.PACK:
            upload = 0
            tables = 0
        elif self.entropy == "device":
            mode, upload, entropy_tables = self._bits_payload(coef_b)
            tables += entropy_tables
        elif self.upload == "pack":
            mode = "pack"
            scan = self._entropy(want_pack=True)
            idx_b = sum(i.nbytes for i in (scan.pack_index or []))
            upload = (len(scan.pack) * 2 if scan.pack is not None else 0) + idx_b
        else:
            upload = coef_b
        return {
            "upload": int(upload),
            "download": int(down),
            "tables": int(tables),
            "payload": mode,
        }

    def _bits_payload(self, coef_b: int):
        """(mode, upload bytes, Huffman table bytes) of the plan that an
        ``entropy="device"`` decode ships: the window rows of the device
        index scan for a stream without restart markers, else the
        build_plan_auto segment rows (plus their DC bases).  The reference
        sizes the build_plan_auto plan in both cases.  A stream that no
        planner takes decodes on the host and uploads coefficients."""
        from jpeg_gpu_tpu_torch.host import segments

        parsed = self._parse()
        hdr = parsed.header
        if not hdr.restart_interval and len(parsed.segments) == 1 and hdr.n_mcus >= 2:
            try:
                inp = segments.build_spec_scan_input(parsed)
            except JpegUnsupportedError:
                pass
            else:
                tables = (inp.dcslot_of_c, inp.acslot_of_c, inp.comp_of_step,
                          inp.dc_slot_of_step, inp.ac_slot_of_step, inp.seg_meta,
                          inp.cbase, inp.counts, inp.symbols)
                return "bits", inp.windows.nbytes, sum(t.nbytes for t in tables)
        try:
            plan = segments.build_plan_auto(parsed)
        except JpegError:
            return "host", coef_b, 0
        upload = plan.streams.nbytes
        if plan.dc_base is not None:
            upload += plan.dc_base.nbytes
        return "bits", upload, sum(t.nbytes for t in plan.kernel_tables)

    def host_entropy(self, out: StageArg = "rgb"):
        """Run (and cache) the host entropy work that decode(out) will
        consume, for timing the host/device split without duplicating the
        decode.  Returns None when decode(out) does its entropy on the
        device."""
        stage = _stage(out)
        return self._entropy(want_pack=(stage == OutputStage.PACK))

    def _coef_stage(self, stage: OutputStage):
        parsed = self._parse()
        result = self._entropy(want_pack=(stage == OutputStage.PACK))
        if stage == OutputStage.PACK:
            return PackOutput(pack=result.pack, index=result.pack_index)
        if stage == OutputStage.QUANT:
            return CoefOutput(coefs=[np.asarray(c) for c in result.coefs])
        if stage == OutputStage.DCT:
            hdr = parsed.header
            out = []
            for ci, comp in enumerate(hdr.components):
                q = hdr.quant_for(comp).values.astype(np.int32)
                out.append(result.coefs[ci].astype(np.int32) * q)
            return CoefOutput(coefs=out)
        raise ValueError(stage)


class HostDecoder(Decoder):
    """Full CPU decode: host entropy + the plain PyTorch ops on the CPU."""

    name = "host"

    def io_bytes(self, out: StageArg = OutputStage.RGB) -> dict:
        return {"upload": 0, "download": 0, "tables": 0, "payload": "none"}

    def __init__(
        self,
        data: bytes,
        validate: bool = True,
        entropy: str = "auto",
        upsample: str = "nearest",
    ):
        super().__init__(data, validate=validate, entropy=entropy)
        self.upsample = upsample

    def decode(self, out: StageArg = OutputStage.RGB):
        stage = _stage(out)
        if stage in (OutputStage.PACK, OutputStage.QUANT, OutputStage.DCT):
            return self._coef_stage(stage)
        hdr = self._parse().header
        result = self._entropy()
        planes = []
        for ci, comp in enumerate(hdr.components):
            q = torch.from_numpy(hdr.quant_for(comp).values.astype(np.int32))
            coefs = torch.from_numpy(np.ascontiguousarray(result.coefs[ci]))
            plane = idct_islow.dequant_idct_islow_plane(coefs, q)
            planes.append(plane[: comp.height, : comp.width])
        if stage == OutputStage.YUV:
            return YuvOutput(planes=[_numpy(p) for p in planes])
        assert stage == OutputStage.RGB
        h, w = hdr.height, hdr.width
        if hdr.ncomps == 1:
            return np.repeat(_numpy(planes[0])[..., None], 3, axis=-1)
        up_fn = (
            color_ops.upsample_fancy
            if self.upsample == "fancy"
            else color_ops.upsample_nearest
        )
        up = [
            up_fn(p, c.xdec, c.ydec)[:h, :w]
            for p, c in zip(planes, hdr.components)
        ]
        return _numpy(color_ops.ycbcr_to_rgb_exact(*up))


class TorchDecoder(Decoder):
    """Entropy decode + the device pipeline on ``device``.

    ``device`` is any torch device; None means "cuda", and a machine
    without a card then raises: the CPU is used only when the caller asks
    for ``device="cpu"``.  ``entropy="device"`` runs the Huffman decode on
    the device too (K3 index scan for streams without restart markers, K2
    decode); the other entropy modes decode on the host and upload
    coefficients, or with ``upload="pack"`` the packed (run, value) stream,
    which the device expands (K4) before the unfused pipeline.
    ``exact=False`` takes the float IDCT (K6) and the float colour matrix
    instead of the bit-exact integer path.  ``on_error="zero"`` (device
    entropy only) turns flagged segments into flat gray blocks instead of
    raising.  On the CPU every kernel runs its plain version, on a CUDA
    device the kernel itself.
    """

    name = "torch"

    def __init__(
        self,
        data: bytes,
        device=None,
        validate: bool = True,
        entropy: str = "auto",
        exact: bool = True,
        upload: str = "coefs",
        upsample: str = "nearest",
        on_error: str = "raise",
    ):
        super().__init__(data, validate=validate, entropy=entropy)
        if entropy not in ("auto", "native", "python", "device"):
            raise ValueError(f"unknown entropy decoder {entropy!r}")
        if upload not in ("coefs", "pack"):
            raise ValueError(f"upload must be 'coefs' or 'pack', got {upload!r}")
        if on_error not in ("raise", "zero"):
            raise ValueError(f"on_error must be 'raise' or 'zero', got {on_error!r}")
        self.device = resolve_device(device, "TorchDecoder")
        self.exact = exact
        self.upload = upload
        self.upsample = upsample
        self.on_error = on_error
        # (rounds, records, overflowed) of the last device index scan, or
        # None when the last decode did not run it (or it fell back).
        self.specsync_stats = None

    def host_entropy(self, out: StageArg = OutputStage.RGB):
        from jpeg_gpu_tpu_torch.engine import pipeline

        stage = _stage(out)
        if self.entropy == "device" and stage != OutputStage.PACK:
            return None  # the Huffman decode runs on the device
        if stage == OutputStage.PACK or self.upload == "pack":
            return self._entropy(want_pack=True)
        if stage == OutputStage.RGB:
            spec = pipeline.PipelineSpec.from_header(
                self._parse().header, exact=self.exact, upsample=self.upsample
            )
            if pipeline.fused_rgb_geometry(spec) is not None:
                soa = self._entropy_soa()
                if soa is not None:
                    return soa
        return self._entropy()

    def _decode_tensors(self, stage: OutputStage):
        """decode(stage) without the copy back: tensors on ``self.device``
        (the RGB stage a (H, W, 3) uint8 tensor, the others tuples)."""
        from jpeg_gpu_tpu_torch.engine import pipeline

        if self.entropy == "device":
            from jpeg_gpu_tpu_torch.engine.device_entropy import decode_image_device

            stats = {}
            self.specsync_stats = None
            try:
                out = decode_image_device(
                    self._parse(), stage=stage, exact=self.exact,
                    upsample=self.upsample, on_error=self.on_error,
                    device=self.device, stats=stats,
                )
                self.specsync_stats = stats["specsync_stats"]
                return out
            except JpegUnsupportedError as e:
                # The reference's contract: inputs the device planner rejects
                # (e.g. a stream without restart markers whose one segment
                # exceeds the word budget) decode through host entropy, with
                # the same output.
                log.info("device entropy plan rejected (%s); host fallback", e)
        hdr = self._parse().header
        spec = pipeline.PipelineSpec.from_header(
            hdr, exact=self.exact, upsample=self.upsample
        )
        qtables = [hdr.quant_for(c).values.astype(np.int32) for c in hdr.components]
        if self.upload == "pack":
            # Minimal-upload path: ship the packed (run, value) stream,
            # expand it to dense coefficients on the device (K4), then the
            # unfused pipeline, as the reference does.
            from jpeg_gpu_tpu_torch.engine.device_entropy import expand_pack_device
            from jpeg_gpu_tpu_torch.ops.entropy_device import plan_tensors

            scan = self._entropy(want_pack=True)
            coefs = expand_pack_device(self._parse(), scan, self.device)
            return pipeline.run(spec, stage, coefs, plan_tensors(qtables, self.device))
        fgeom = pipeline.fused_rgb_geometry(spec) if stage == OutputStage.RGB else None
        if fgeom is not None:
            soa = self._entropy_soa()
            if soa is None:
                # Python entropy decoder: blocks -> SoA, so K1 still runs.
                sx, sy = fgeom
                blocks, qts = pipeline.to_torch_inputs(
                    self._entropy().coefs, qtables, self.device
                )
                from jpeg_gpu_tpu_torch.ops import pixel_fused

                comps = (
                    pixel_fused.blocks_to_soa_split(blocks[0], sx, sy),
                    pixel_fused.blocks_to_soa_split(blocks[1], 1, 1),
                    pixel_fused.blocks_to_soa_split(blocks[2], 1, 1),
                )
            else:
                comps, qts = pipeline.to_torch_inputs(soa, qtables, self.device)
            return pipeline.decode_rgb_soa(spec, fgeom, comps, qts)
        coefs, qts = pipeline.to_torch_inputs(
            self._entropy().coefs, qtables, self.device
        )
        return pipeline.run(spec, stage, coefs, qts)

    def decode(self, out: StageArg = OutputStage.RGB):
        stage = _stage(out)
        if stage == OutputStage.PACK:
            return self._coef_stage(stage)
        dev = self._decode_tensors(stage)
        if stage in (OutputStage.QUANT, OutputStage.DCT):
            return CoefOutput(coefs=[_numpy(c) for c in dev])
        if stage == OutputStage.YUV:
            return YuvOutput(planes=[_numpy(p) for p in dev])
        return _numpy(dev)


class PilDecoder(Decoder):
    """libjpeg-turbo oracle backend.

    RGB via Pillow; QUANT/DCT and YUV via the ctypes shim over the system
    libjpeg (host/oracle_native.py), mirroring the reference vtbl's
    ``jpeg_read_coefficients`` / ``jpeg_read_raw_data`` cuts.  PACK has no
    libjpeg analogue.  Where Pillow or the shim is missing (no system
    libjpeg headers), the stages they serve raise JpegUnsupportedError.
    """

    name = "pil"

    def io_bytes(self, out: StageArg = OutputStage.RGB) -> dict:
        return {"upload": 0, "download": 0, "tables": 0, "payload": "none"}

    def host_entropy(self, out: StageArg = "rgb"):
        return None  # libjpeg does its own entropy work inside decode()

    def decode(self, out: StageArg = OutputStage.RGB):
        from jpeg_gpu_tpu_torch.host import oracle_native
        from jpeg_gpu_tpu_torch.testing import oracle

        stage = _stage(out)
        if stage in (OutputStage.QUANT, OutputStage.DCT, OutputStage.YUV):
            if not oracle_native.available():
                raise JpegUnsupportedError(
                    "libjpeg oracle shim unavailable (no system libjpeg); "
                    f"PIL backend cannot serve the {stage.value} stage"
                )
            if stage == OutputStage.YUV:
                return YuvOutput(planes=oracle_native.libjpeg_raw_yuv(self.data))
            coefs, qts = oracle_native.libjpeg_coefficients(self.data)
            if stage == OutputStage.QUANT:
                return CoefOutput(coefs=coefs)
            # DCT = dequantized coefficients, int32 (same contract as
            # _coef_stage; libjpeg's own qtables do the dequant).
            dq = [
                c.astype(np.int32) * q.astype(np.int32).reshape(8, 8)
                for c, q in zip(coefs, qts)
            ]
            return CoefOutput(coefs=dq)
        if stage != OutputStage.RGB:
            raise JpegUnsupportedError(
                f"PIL oracle backend only provides rgb/yuv/quant/dct, "
                f"not {stage.value}"
            )
        try:
            import PIL  # noqa: F401
        except ImportError:
            raise JpegUnsupportedError(
                "Pillow is not installed; PIL backend cannot serve the rgb stage"
            ) from None
        hdr = self.decode_header()
        if hdr.ncomps == 1:
            y = oracle.pil_decode_gray(self.data)
            return np.repeat(y[..., None], 3, axis=-1)
        return oracle.pil_decode_rgb(self.data)


_BACKENDS = {
    "torch": TorchDecoder,
    "host": HostDecoder,
    "pil": PilDecoder,
    "libjpeg": PilDecoder,  # oracle alias, as in the reference (--impl libjpeg)
    "xjpeg": HostDecoder,   # alias, as in the reference (--impl xjpeg)
}


def get_decoder(data: bytes, impl: str = "torch", **kwargs) -> Decoder:
    try:
        cls = _BACKENDS[impl]
    except KeyError:
        raise ValueError(
            f"unknown decoder impl {impl!r}; choose from {sorted(_BACKENDS)}"
        )
    return cls(data, **kwargs)


def decode_header(data: bytes) -> JpegHeader:
    return parse(data, headers_only=True).header


def decode(
    data: bytes, out: StageArg = OutputStage.RGB, impl: str = "torch", **kwargs
):
    """One-shot decode convenience entry point (numpy result)."""
    return get_decoder(data, impl=impl, **kwargs).decode(out)
