"""tpu-jpeg on PyTorch + CUDA: the port of ``jpeg_gpu_tpu`` to NVIDIA Hopper.

Baseline (SOF0) 8-bit JPEG decode: the host parses the stream and decodes
the entropy-coded scan into dense quantized DCT coefficients, and the device
does dequantization, the islow 8x8 inverse DCT, chroma upsampling and
YCbCr->RGB -- for the fused geometries in one hand-written CUDA kernel
(``csrc/pixel_fused.cu``, K1).  With ``entropy="device"`` the Huffman decode
runs on the device too (``csrc/specsync_scan.cu``, K3, finds the MCU offsets
of a stream without restart markers; ``csrc/entropy_decode.cu``, K2,
decodes).  The YUV stage, grayscale and the other geometries run the plane
IDCT ``csrc/idct_islow_plane.cu`` (K5), one launch for all components;
``exact=False`` takes the float IDCT ``csrc/idct_float.cu`` (K6), likewise;
``upload="pack"`` ships the
packed (run, value) stream and expands it with ``csrc/pack_expand.cu`` (K4).
``device=None`` means the GPU; the CPU runs only for ``device="cpu"``, with
each kernel's plain PyTorch version.  This package imports torch and numpy,
never jax.

    import jpeg_gpu_tpu_torch as jt
    rgb = jt.decode(data, device="cuda", upsample="fancy")  # (H, W, 3) uint8
    rgb = jt.decode(data, device="cuda", entropy="device")
    yuv = jt.decode(data, out="yuv", device="cuda")
    rgb = jt.decode(data, device="cuda", upload="pack")
    rgb = jt.decode(data, device="cuda", exact=False)
"""

from jpeg_gpu_tpu_torch.errors import JpegError, JpegFormatError, JpegUnsupportedError
from jpeg_gpu_tpu_torch.info import (
    JpegHeader,
    Component,
    QuantTable,
    HuffmanSpec,
    ScanHeader,
    Subsampling,
)
from jpeg_gpu_tpu_torch.engine.stages import OutputStage
from jpeg_gpu_tpu_torch.engine.decoder import (
    Decoder,
    HostDecoder,
    PilDecoder,
    TorchDecoder,
    get_decoder,
    decode,
    decode_header,
)
from jpeg_gpu_tpu_torch.engine.pipeline import to_torch_inputs

__version__ = "0.1.0"

__all__ = [
    "JpegError",
    "JpegFormatError",
    "JpegUnsupportedError",
    "JpegHeader",
    "Component",
    "QuantTable",
    "HuffmanSpec",
    "ScanHeader",
    "Subsampling",
    "OutputStage",
    "Decoder",
    "HostDecoder",
    "PilDecoder",
    "TorchDecoder",
    "get_decoder",
    "decode",
    "decode_header",
    "to_torch_inputs",
]
