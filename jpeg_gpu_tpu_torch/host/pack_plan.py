"""Host-side layout of the PACK stream for the device expander.

Splits the scan-ordered packed stream (host/entropy.py, reference format
xjpeg.c:484-535) into 1024 per-lane substreams of K consecutive MCUs each.
Because the pack stream is written in scan order, each lane's substream is
one contiguous slice -- the split is pure numpy slicing, no re-encoding.
Unlike the device *entropy* path this needs no restart markers: the host
already did the Huffman work; pack mode only minimises upload bytes
(2 bytes per non-zero symbol vs dense coefficient tensors).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from jpeg_gpu_tpu_torch.host.entropy import ScanResult
from jpeg_gpu_tpu_torch.host.parser import ParsedJpeg
from jpeg_gpu_tpu_torch.host.segments import LANES, SEGMENTS_PER_BATCH, SUBLANES


@dataclasses.dataclass
class PackPlan:
    streams: np.ndarray       # (B, NW, 8, 128) int32: 2 u16 entries per word
    n_segments: int           # pseudo-segments (lanes in use)
    mcus_per_segment: int     # K
    blocks_per_segment: int   # T = K * blocks_per_mcu
    packed_entries: int       # total real entries (upload size metric)


def build_pack_plan(
    parsed: ParsedJpeg, scan: ScanResult, mcus_per_segment: int = 0
) -> PackPlan:
    """Lay out the pack stream for the device expander."""
    header = parsed.header
    assert scan.pack is not None and scan.pack_index is not None
    pack = scan.pack
    n_mcus = header.n_mcus
    comps = [header.components[i] for i in header.scan.comp_idx]
    bpm = sum(c.hsamp * c.vsamp for c in comps)

    k = mcus_per_segment or max(1, -(-n_mcus // SEGMENTS_PER_BATCH))
    nseg = -(-n_mcus // k)

    # Start offset of each MCU = index of its first block: the FIRST SCAN
    # component's (sub 0,0) block (pack_index is stored in frame order).
    c0 = comps[0]
    idx0 = scan.pack_index[header.scan.comp_idx[0]]
    mby, mbx = np.divmod(np.arange(n_mcus), header.nhmb)
    mcu_starts = idx0[mby * c0.vsamp, mbx * c0.hsamp].astype(np.int64)
    bounds = np.concatenate([mcu_starts, [len(pack)]])

    seg_lo = bounds[np.minimum(np.arange(nseg) * k, n_mcus)]
    seg_hi = bounds[np.minimum((np.arange(nseg) + 1) * k, n_mcus)]
    max_entries = int((seg_hi - seg_lo).max())
    nw = (max_entries + 1) // 2 + 1

    nbatch = -(-nseg // SEGMENTS_PER_BATCH)
    words = np.zeros((nbatch, nw, SEGMENTS_PER_BATCH), dtype=np.uint32)
    for i in range(nseg):
        seg = pack[seg_lo[i] : seg_hi[i]].astype(np.uint32)
        if len(seg) % 2:
            seg = np.append(seg, np.uint32(0))
        w = (seg[0::2] << 16) | seg[1::2]
        words[i // SEGMENTS_PER_BATCH, : len(w), i % SEGMENTS_PER_BATCH] = w
    streams = words.view(np.int32).reshape(nbatch, nw, SUBLANES, LANES)

    return PackPlan(
        streams=streams,
        n_segments=nseg,
        mcus_per_segment=k,
        blocks_per_segment=k * bpm,
        packed_entries=int(len(pack)),
    )
