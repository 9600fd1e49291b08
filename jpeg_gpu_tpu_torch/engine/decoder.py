"""Decoder backends behind one interface.

The port of ``jpeg_gpu_tpu/engine/decoder.py``: the same decode surface --
``decode_header`` / ``decode(out=stage)`` / ``reset`` -- over

* :class:`HostDecoder`  -- host entropy decode + the plain PyTorch ops on
  the CPU, cropping before fancy upsampling (an independent CPU path);
* :class:`TorchDecoder` -- host entropy decode + the device pipeline
  (engine/pipeline.py) on a chosen torch device.  On a CUDA device the RGB
  decode of the fused geometries runs the K1 kernel.

Every ``decode`` returns numpy arrays, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from jpeg_gpu_tpu_torch.engine.stages import OutputStage
from jpeg_gpu_tpu_torch.host import entropy as host_entropy
from jpeg_gpu_tpu_torch.host.parser import ParsedJpeg, parse
from jpeg_gpu_tpu_torch.info import JpegHeader
from jpeg_gpu_tpu_torch.ops import color as color_ops
from jpeg_gpu_tpu_torch.ops import idct_islow

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

    ``entropy`` selects the host scan decoder: "native" (C++
    restart-parallel, host/native/), "python" (reference implementation),
    or "auto" (native when the shared object builds).
    """

    name = "base"

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

    def _entropy(self, want_pack: bool = False) -> host_entropy.ScanResult:
        if self._scan is None or (want_pack and not self._scan_packed):
            if self._use_native():
                from jpeg_gpu_tpu_torch.host import entropy_native

                self._scan = entropy_native.decode_scan(
                    self._parse(), want_pack=want_pack, validate=self.validate
                )
            else:
                self._scan = host_entropy.decode_scan(
                    self._parse(), want_pack=want_pack, validate=self.validate
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
                self._parse(), soa=True, validate=self.validate
            ).coefs
        return self._scan_soa

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
    """Host entropy decode + the device pipeline on ``device``.

    ``device`` is any torch device; None picks "cuda" when a card is
    present, else "cpu".  On the CPU the fused RGB geometries run K1's
    plain version, on a CUDA device the kernel itself.
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
        if entropy == "device":
            raise NotImplementedError(
                "entropy='device' is not ported yet: see ROADMAP.md, port "
                "slices 2-3 (K2 device Huffman decode, K3 index scan)"
            )
        if entropy not in ("auto", "native", "python"):
            raise ValueError(f"unknown entropy decoder {entropy!r}")
        if upload == "pack":
            raise NotImplementedError(
                "upload='pack' is not ported yet: see ROADMAP.md, port "
                "slice 4 (K4 PACK expansion)"
            )
        if upload != "coefs":
            raise ValueError(f"upload must be 'coefs' or 'pack', got {upload!r}")
        if not exact:
            raise NotImplementedError(
                "exact=False is not ported yet: see ROADMAP.md, port "
                "slice 6 (K6 float IDCT fast path)"
            )
        if on_error != "raise":
            raise NotImplementedError(
                "on_error='zero' salvage belongs to device entropy: see "
                "ROADMAP.md, port slice 2 (K2 device Huffman decode)"
            )
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.exact = exact
        self.upload = upload
        self.upsample = upsample

    def _decode_tensors(self, stage: OutputStage):
        """decode(stage) without the copy back: tensors on ``self.device``
        (the RGB stage a (H, W, 3) uint8 tensor, the others tuples)."""
        from jpeg_gpu_tpu_torch.engine import pipeline

        hdr = self._parse().header
        spec = pipeline.PipelineSpec.from_header(
            hdr, exact=self.exact, upsample=self.upsample
        )
        qtables = [hdr.quant_for(c).values.astype(np.int32) for c in hdr.components]
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


_BACKENDS = {
    "torch": TorchDecoder,
    "host": HostDecoder,
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
