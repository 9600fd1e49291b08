"""Canonical Huffman code construction + decode tables.

The reference builds an 8-bit-prefix lookup table with a maxcode/index
fallback walk for longer codes (xjpeg.c:311-336, decode at :163-187).  On
the host we can afford the full-width variant: one 65536-entry table that
resolves *any* code (JPEG codes are <= 16 bits) in a single lookup --
``lut_symbol[peek16]`` and ``lut_length[peek16]``.  The same flattened
(symbol, length) tables later feed the device entropy decoder, where each
lane resolves one code per step with one gather.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from jpeg_gpu_tpu_torch.errors import JpegFormatError
from jpeg_gpu_tpu_torch.info import HuffmanSpec


def canonical_codes(spec: HuffmanSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Assign canonical codes: returns (codes, lengths) per symbol.

    Standard JPEG canonical assignment (spec Annex C): codes of each length
    are consecutive, starting from double the previous length's end.
    """
    lengths = np.repeat(np.arange(1, 17), spec.counts).astype(np.int32)
    codes = np.zeros(len(lengths), dtype=np.int32)
    code = 0
    k = 0
    for length in range(1, 17):
        n = int(spec.counts[length - 1])
        for _ in range(n):
            codes[k] = code
            code += 1
            k += 1
        if code > (1 << length):
            raise JpegFormatError("Huffman code space over-subscribed")
        code <<= 1
    return codes, lengths


@dataclasses.dataclass(frozen=True)
class HuffmanLut:
    """Full-width decode table: index with the next 16 bits of the stream."""

    symbol: np.ndarray  # (65536,) uint8
    length: np.ndarray  # (65536,) uint8; 0 marks an invalid code

    @classmethod
    def build(cls, spec: HuffmanSpec) -> "HuffmanLut":
        codes, lengths = canonical_codes(spec)
        symbol = np.zeros(1 << 16, dtype=np.uint8)
        length = np.zeros(1 << 16, dtype=np.uint8)
        for sym, code, ln in zip(spec.symbols.tolist(), codes.tolist(), lengths.tolist()):
            lo = code << (16 - ln)
            hi = lo + (1 << (16 - ln))
            symbol[lo:hi] = sym
            length[lo:hi] = ln
        return cls(symbol=symbol, length=length)


def huff_extend(value: int, size: int) -> int:
    """Sign-extend a ``size``-bit JPEG amplitude (spec F.2.2.1 EXTEND).

    Cf. the branchless XJPEG_HUFF_EXTEND (xjpeg.c:189-191).
    """
    if size == 0:
        return 0
    return value if value >= (1 << (size - 1)) else value - (1 << size) + 1
