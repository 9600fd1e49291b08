"""The five-stage pipeline cut (mirrors jpeg_decode_out, jpeg_wrap.h:24-31).

Each stage names *where the host hands off to the device*, the reference's
central experimental axis.  In the TPU engine the host side shrinks as the
stage moves earlier, exactly as the reference's PCIe upload shrinks:

| stage | host produces                     | device runs                      |
|-------|-----------------------------------|----------------------------------|
| rgb   | full decode                       | nothing (upload only)            |
| yuv   | entropy+dequant+IDCT              | upsample + color                 |
| dct   | entropy+dequant                   | IDCT + upsample + color          |
| quant | entropy                           | dequant + IDCT + upsample + color|
| pack  | entropy -> packed (run,value)     | unpack + everything              |
"""

from __future__ import annotations

import enum


class OutputStage(enum.Enum):
    PACK = "pack"
    QUANT = "quant"
    DCT = "dct"
    YUV = "yuv"
    RGB = "rgb"

    @classmethod
    def from_name(cls, name: str) -> "OutputStage":
        return cls(name.lower())
