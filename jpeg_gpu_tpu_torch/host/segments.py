"""Host-side preparation for the device entropy decoder.

The TPU kernel (ops/entropy_device.py) decodes 1024 restart segments in
lockstep -- one segment per (sublane, lane) position.  The host's only jobs
(all cheap, byte-level, vectorisable) are:

* destuff each segment (0xFF00 -> 0xFF) and pack it into big-endian u32
  words, 1-padded at the tail (the bit reader contract, spec F.2.2.5),
* lay the words out as (batches, NW, 8, 128): word w of segment
  (b*1024 + s*128 + l) at [b, w, s, l],
* flatten Huffman tables into the kernel's cbase/counts/entry tensors
  (canonical rank form -- see DeviceScanPlan).

This is the division of labour SURVEY.md section 7 prescribes: "byte
destuffing and marker scanning are best done host-side"; everything
bit-serial moves to the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from jpeg_gpu_tpu_torch.errors import JpegFormatError, JpegUnsupportedError
from jpeg_gpu_tpu_torch.host.parser import ParsedJpeg
from jpeg_gpu_tpu_torch.info import HuffmanSpec
from jpeg_gpu_tpu_torch.utils import trace

LANES = 128
SUBLANES = 8
SEGMENTS_PER_BATCH = SUBLANES * LANES  # 1024


@dataclasses.dataclass
class DeviceScanPlan:
    """Everything the device decoder consumes, shape-static."""

    streams: np.ndarray        # (B, NW, 8, 128) int32 big-endian words
    n_segments: int
    nw: int                    # words per segment slot
    mcus_per_segment: int      # R (uniform; last segment may be short)
    n_mcus: int
    # Per block-step tables (T = blocks per segment):
    comp_of_step: np.ndarray   # (T,) int32 frame-component index
    dc_slot_of_step: np.ndarray  # (T,) int32 -> row into table tensors
    ac_slot_of_step: np.ndarray  # (T,) int32
    # Huffman decode tensors, one row per distinct table slot (<= 8).
    # The kernel computes the symbol RANK as one sum of independent
    # per-length terms (the canonical-code rank identity:
    # rank(window) = sum_L clamp(topL(window) - mincode[L] + 1, 0, count[L]))
    # and then gathers a packed (symbol, code length) entry by rank -- the
    # code length is a property of the rank, so no threshold scan exists:
    cbase: np.ndarray          # (n_tables, 16) int32: mincode[L] - 1
    counts: np.ndarray         # (n_tables, 17) int32: codes of length L,
    #                            plus the invalid-window limit in slot 16:
    #                            the first 16-bit-scaled unassigned code,
    #                            XOR-biased for signed compare (a window is
    #                            an invalid codeword iff window32 >= limit,
    #                            since the per-length bounds are monotone)
    symbols: np.ndarray        # (n_tables, 8, 128) int32: 256 16-bit
    #                            entries (sym | len<<8; len=31 marks an
    #                            invalid rank), packed 2 per word (entry k
    #                            at half k%2 of lane k//2), replicated over
    #                            sublanes -- one lane-shuffle gather + a
    #                            16-bit extract decodes

    # Last-segment geometry: (batch, lane-within-batch, real block steps)
    # of the final (possibly short) restart segment, so the kernel can
    # suppress the spurious flags its padded tail steps raise -- error
    # flags are then exact for EVERY segment (corruption in the last
    # segment is detected; valid short tails are not blanked by salvage).
    seg_meta: np.ndarray  # (3,) int32

    # DRI-less streams only (build_plan_no_dri): per-PSEUDO-segment DC
    # predictor bases, (n_segments, ncomps) int32.  Unlike real restart
    # segments, DC prediction does not reset at pseudo boundaries; the
    # kernel decodes each from 0 and the device adds these back
    # (entropy_device.apply_dc_base).  None for real restart streams.
    dc_base: "np.ndarray | None" = None

    @property
    def kernel_tables(self) -> Tuple[np.ndarray, ...]:
        """Args for decode_segments_device after the streams tensor."""
        return (
            self.comp_of_step, self.dc_slot_of_step, self.ac_slot_of_step,
            self.seg_meta, self.cbase, self.counts, self.symbols,
        )


def _last_segment_meta(nseg: int, interval: int, n_mcus: int, bpm: int) -> np.ndarray:
    last = nseg - 1
    mcus_in_last = max(min(interval, n_mcus - last * interval), 0)
    return np.asarray(
        [last // SEGMENTS_PER_BATCH, last % SEGMENTS_PER_BATCH,
         mcus_in_last * bpm],
        dtype=np.int32,
    )


def _decode_tables(
    spec: HuffmanSpec,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cbase/counts/entry tensors for canonical rank decode.

    The kernel evaluates the spec's F.2.2.3 DECODE as one sum of
    independent per-length terms (see ops/entropy_device.py):

      rank(window) = sum_L clamp(topL(window) - (mincode[L]-1), 0, count[L])

    then gathers entry[rank-1] = sym | len<<8 -- the code length is a
    property of the rank in a canonical code, so it rides the symbol
    lookup instead of needing its own threshold scan.  Ranks past the
    last real code carry len=31, which the kernel flags as invalid.
    """
    counts = spec.counts.astype(np.int64)
    cbase = np.zeros(16, dtype=np.int32)
    cnt = np.zeros(17, dtype=np.int32)
    cnt[:16] = counts
    code = 0
    for length in range(1, 17):
        n = int(counts[length - 1])
        cbase[length - 1] = code - 1
        code += n
        unassigned_scaled = min(code << (32 - length), 0xFFFFFFFF)
        code <<= 1
    # Invalid-window limit (slot 16): any window whose 32-bit value is >=
    # the scaled first-unassigned code is beyond every codeword.  A
    # complete 16-bit code space scales to 2^32 and clamps to 0xFFFFFFFF,
    # which misclassifies only the all-1-bits window -- a code T.81
    # Annex C forbids, so flagging it is correct behaviour.
    cnt[16] = np.int32(
        np.uint32(unassigned_scaled) ^ np.uint32(0x80000000)
    )
    nsyms = len(spec.symbols)
    lengths = np.repeat(np.arange(1, 17), spec.counts.astype(np.int64))
    entries = np.full(256, 31 << 8, dtype=np.uint32)  # invalid marker
    entries[:nsyms] = spec.symbols.astype(np.uint32) | (
        lengths[:nsyms].astype(np.uint32) << 8
    )
    # Pack 2 entries per 32-bit word: entry k lives at half k%2 of lane
    # k//2.  One gather + a 16-bit extract decodes (sym, len) together.
    grouped = entries.reshape(LANES, 2)
    packed = grouped[:, 0] | (grouped[:, 1] << 16)
    tiled = np.broadcast_to(
        packed.astype(np.int64).astype(np.uint32).view(np.int32).reshape(1, LANES),
        (SUBLANES, LANES),
    )
    return cbase, cnt, np.ascontiguousarray(tiled)


def _check_nw(max_destuffed_bytes: int, max_words: int) -> int:
    """Words per segment row (+slack so refill never reads past a word)."""
    nw = (max_destuffed_bytes + 3) // 4 + 2
    if nw > max_words:
        raise JpegUnsupportedError(
            f"segment too large for device decode ({nw} words > {max_words}); "
            "re-encode with a smaller restart interval or use host entropy"
        )
    return nw


def _step_maps(header, scan, interval: int):
    """Per-block-step (comp, dc slot, ac slot) maps for one segment.

    Identical for every segment: the interleaved MCU order (components in
    scan order, sub-blocks row-major), repeated ``interval`` times.
    """
    comp_steps: List[int] = []
    dc_steps: List[int] = []
    ac_steps: List[int] = []
    comps = [header.components[i] for i in scan.comp_idx]
    per_mcu = []
    for ci, comp in enumerate(comps):
        per_mcu.extend(
            [(ci, scan.dc_tbl[ci], scan.ac_tbl[ci])] * (comp.hsamp * comp.vsamp)
        )
    for _ in range(interval):
        for ci, dc, ac in per_mcu:
            comp_steps.append(ci)
            dc_steps.append(dc)
            ac_steps.append(ac + 4)  # AC tables in slots 4..7
    return comp_steps, dc_steps, ac_steps, len(per_mcu)


def _table_tensors(header):
    """Canonical-rank decode tensors: slots 0..3 DC, 4..7 AC.

    Unused slots decode every window to rank 0 -> the invalid-marker
    entry (len=31) -> flagged; their counts slot 16 is INT32_MIN so every
    window flags as invalid.

    Content-memoized: a serving loop re-parses the same stream per frame
    and table derivation was ~20%% of plan build; the key hashes the raw
    (counts, symbols) spec bytes.  Cached arrays are shared read-only.
    """
    key = tuple(
        None if spec is None
        else (spec.counts.tobytes(), spec.symbols.tobytes())
        for spec in list(header.dc_tables) + list(header.ac_tables)
    )
    hit = _TABLE_MEMO.get(key)
    if hit is not None:
        return hit
    n_tables = 8
    cbase = np.zeros((n_tables, 16), dtype=np.int32)
    counts = np.zeros((n_tables, 17), dtype=np.int32)
    counts[:, 16] = np.iinfo(np.int32).min
    symbols = np.full(
        (n_tables, SUBLANES, LANES),
        np.int32((31 << 8) | (31 << 24)),
        dtype=np.int32,
    )
    for slot, spec in enumerate(list(header.dc_tables) + list(header.ac_tables)):
        if spec is None:
            continue
        b_, c_, s_ = _decode_tables(spec)
        cbase[slot] = b_
        counts[slot] = c_
        symbols[slot] = s_
    for a in (cbase, counts, symbols):
        a.setflags(write=False)
    # Capacity above the bench/serving bucket size (64 images with
    # per-image optimized tables would otherwise thrash the memo clear).
    if len(_TABLE_MEMO) >= 512:
        _TABLE_MEMO.clear()
    _TABLE_MEMO[key] = (cbase, counts, symbols)
    return cbase, counts, symbols


_TABLE_MEMO: dict = {}


def build_plan(
    parsed: ParsedJpeg, max_words: int = 1024, nw: Optional[int] = None
) -> DeviceScanPlan:
    """Pack a parsed JPEG into the device decoder's input layout.

    ``nw`` pins the words-per-segment row width, skipping the sizing
    pass over the entropy data (the native path then destuffs in ONE
    pass and verifies afterwards that no segment truncated).  A serving
    loop passes the previous plan's ``nw`` for the same stream class:
    one fewer pass per frame AND a stable device program geometry.
    Raises ``JpegUnsupportedError`` if a segment needs more than ``nw``
    words.
    """
    header = parsed.header
    scan = header.scan
    assert scan is not None
    # A restart interval longer than the frame leaves one segment of n_mcus
    # MCUs: the rows' block steps are sized by those, not by the interval
    # (a DRI of 65535 on a small frame would size K2's output at 51 GB).
    interval = min(header.restart_interval or header.n_mcus, header.n_mcus)
    nseg = len(parsed.segments)

    # Destuff + word-pack every segment.  The native C++ packer is a
    # single pass per segment (restart-parallel across host threads); the
    # numpy fallback vectorises across the whole scan.  Either way no
    # per-segment Python loop: that measured 65 ms for a 1080p frame --
    # twice the device's entire decode time.
    from jpeg_gpu_tpu_torch.host import entropy_native

    starts = np.ascontiguousarray(parsed.segments[:, 0])
    ends = np.ascontiguousarray(parsed.segments[:, 1])
    nbatch = -(-nseg // SEGMENTS_PER_BATCH)

    if entropy_native.available():
        if nw is None:
            max_len = entropy_native.max_destuffed_len(
                parsed.data, starts, ends
            )
            nw = _check_nw(max_len, max_words)
        # The native packer 0xFF-pads every row it writes; only the
        # batch-padding rows past nseg need host-side filling.
        mat = np.empty(
            (nbatch * SEGMENTS_PER_BATCH, nw * 4), dtype=np.uint8
        )
        mat[nseg:] = 0xFF
        got_max = entropy_native.pack_streams(
            parsed.data, starts, ends, mat[:nseg]
        )
        if (got_max + 3) // 4 + 2 > nw:
            raise JpegUnsupportedError(
                f"segment needs {(got_max + 3) // 4 + 2} words > pinned "
                f"nw={nw}; rebuild the plan without the nw hint"
            )
    else:
        # Stuffed zeros (0xFF 0x00 inside a segment) drop via one boolean
        # mask; surviving bytes scatter with one fancy assignment.
        arr = np.frombuffer(parsed.data, dtype=np.uint8)
        lens = ends - starts
        total = int(lens.sum())
        seg_id = np.repeat(np.arange(nseg, dtype=np.int64), lens)
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(lens) - lens, lens
        )
        gidx = starts[seg_id] + within
        byts = arr[gidx]
        # A stuffed zero follows 0xFF inside the same segment.  Pairs never
        # cross segment boundaries (0xFF before a non-zero byte is a marker,
        # which the parser ends the span at), so within>0 guards the lookback.
        stuffed = (byts == 0) & (within > 0)
        stuffed[stuffed] &= arr[gidx[stuffed] - 1] == 0xFF
        keep = ~stuffed
        kept = byts[keep]
        kseg = seg_id[keep]
        counts = np.bincount(kseg, minlength=nseg)
        kept_before = np.cumsum(counts) - counts
        offs = np.arange(kept.size, dtype=np.int64) - np.repeat(
            kept_before, counts
        )
        need = _check_nw(int(counts.max(initial=0)), max_words)
        if nw is None:
            nw = need
        elif need > nw:
            raise JpegUnsupportedError(
                f"segment needs {need} words > pinned nw={nw}; rebuild "
                "the plan without the nw hint"
            )
        mat = np.full(
            (nbatch * SEGMENTS_PER_BATCH, nw * 4), 0xFF, dtype=np.uint8
        )
        mat[kseg, offs] = kept

    # One strided pass does byteswap + (batch, seg, word)->(batch, word,
    # seg) relayout together (astype of a transposed big-endian view).
    streams = (
        mat.view(">u4")
        .reshape(nbatch, SEGMENTS_PER_BATCH, nw)
        .transpose(0, 2, 1)
        .astype(np.uint32)
        .view(np.int32)
        .reshape(nbatch, nw, SUBLANES, LANES)
    )

    comp_steps, dc_steps, ac_steps, bpm = _step_maps(header, scan, interval)
    cbase, counts, symbols = _table_tensors(header)
    return DeviceScanPlan(
        streams=streams,
        n_segments=nseg,
        nw=nw,
        mcus_per_segment=interval,
        n_mcus=header.n_mcus,
        comp_of_step=np.asarray(comp_steps, dtype=np.int32),
        dc_slot_of_step=np.asarray(dc_steps, dtype=np.int32),
        ac_slot_of_step=np.asarray(ac_steps, dtype=np.int32),
        seg_meta=_last_segment_meta(nseg, interval, header.n_mcus, bpm),
        cbase=cbase,
        counts=counts,
        symbols=symbols,
    )


def build_plan_no_dri(
    parsed: ParsedJpeg,
    mcus_per_segment: int = 1,
    max_words: int = 1024,
    nw: Optional[int] = None,
) -> DeviceScanPlan:
    """Device-decode plan for a DRI-less stream via the native index scan.

    The host Huffman-walks code LENGTHS only (one serial pass, no
    coefficient work -- xjpeg_host.cpp:xjpeg_index_scan) to find the bit
    offset and DC predictors at every ``mcus_per_segment``-th MCU, then
    packs those pseudo-segments bit-aligned.  The kernel decodes them
    exactly like real restart segments; ``dc_base`` carries the DC
    predictor continuation the device adds back after decode.

    ``nw`` pins the words-per-segment row width (the serving-loop hint,
    same contract as build_plan's): scan and pack then FUSE into one
    native call over one destuff pass (xjpeg_index_scan_pack) -- the
    split form destuffs the scan span twice per frame.  Raises
    ``JpegUnsupportedError`` if a segment needs more than ``nw`` words.

    Default one MCU per pseudo segment: maximal lane parallelism, minimal
    per-segment word count, and the R=1 no-relayout assembly fast path.
    """
    from jpeg_gpu_tpu_torch.host import entropy_native

    header = parsed.header
    scan = header.scan
    assert scan is not None
    if header.restart_interval or len(parsed.segments) != 1:
        raise ValueError("build_plan_no_dri is for single-segment streams")
    k = mcus_per_segment
    if nw is not None:
        nseg = -(-header.n_mcus // k)
        nbatch = -(-nseg // SEGMENTS_PER_BATCH)
        mat = np.full(
            (nbatch * SEGMENTS_PER_BATCH, nw * 4), 0xFF, dtype=np.uint8
        )
        try:
            bitpos, dc_base, end_bit = entropy_native.index_scan_pack(
                parsed, k, mat[:nseg]
            )
        except JpegFormatError as e:
            if "capacity overflow" not in str(e):
                raise
            raise JpegUnsupportedError(
                f"pseudo segment exceeds pinned nw={nw}; rebuild the "
                "plan without the nw hint"
            ) from e
    else:
        bitpos, dc_base, end_bit = entropy_native.index_scan(parsed, k)
        nseg = len(bitpos)
        nbatch = -(-nseg // SEGMENTS_PER_BATCH)

        # Longest pseudo segment in destuffed bytes, +1 for the shift tail.
        bounds = np.concatenate([bitpos, [end_bit]])
        lens_bits = np.diff(bounds)
        max_bytes = int(-(-(lens_bits.max(initial=0)) // 8) + 1)
        nw = _check_nw(max_bytes, max_words)
        mat = np.full(
            (nbatch * SEGMENTS_PER_BATCH, nw * 4), 0xFF, dtype=np.uint8
        )
        entropy_native.pack_streams_bits(parsed, bitpos, end_bit, mat[:nseg])

    words = mat.view(">u4").astype(np.uint32)
    streams = np.ascontiguousarray(
        words.reshape(nbatch, SEGMENTS_PER_BATCH, nw).transpose(0, 2, 1)
    ).view(np.int32)
    streams = streams.reshape(nbatch, nw, SUBLANES, LANES)

    comp_steps, dc_steps, ac_steps, bpm = _step_maps(header, scan, k)
    cbase, counts, symbols = _table_tensors(header)
    return DeviceScanPlan(
        streams=streams,
        n_segments=nseg,
        nw=nw,
        mcus_per_segment=k,
        n_mcus=header.n_mcus,
        comp_of_step=np.asarray(comp_steps, dtype=np.int32),
        dc_slot_of_step=np.asarray(dc_steps, dtype=np.int32),
        ac_slot_of_step=np.asarray(ac_steps, dtype=np.int32),
        seg_meta=_last_segment_meta(nseg, k, header.n_mcus, bpm),
        cbase=cbase,
        counts=counts,
        symbols=symbols,
        dc_base=dc_base,
    )


def build_plan_auto(
    parsed: ParsedJpeg, max_words: int = 1024, nw: Optional[int] = None
) -> DeviceScanPlan:
    """build_plan for restart streams; the index-scan pseudo-segment plan
    for DRI-less streams when the native library is available (most
    real-world JPEGs carry no DRI -- SURVEY hard part 1's gap, closed).
    ``nw`` is the serving-loop row-width pin, forwarded to either builder
    (for DRI-less streams it additionally fuses scan+pack into one native
    pass)."""
    header = parsed.header
    if (
        header.restart_interval
        or len(parsed.segments) != 1
        or header.n_mcus < 2
    ):
        return build_plan(parsed, max_words, nw=nw)
    from jpeg_gpu_tpu_torch.host import entropy_native

    if not entropy_native.available():
        return build_plan(parsed, max_words, nw=nw)  # single mega-segment
    return build_plan_no_dri(parsed, max_words=max_words, nw=nw)


@dataclasses.dataclass
class SpecScanInput:
    """Host-side input for the DEVICE parallel index scan of a DRI-less
    stream (ops/specsync_device.py) plus everything the downstream
    restart decode consumes.

    The host does NO Huffman work here: destuff and the window rows (one
    native pass, or numpy's), and the usual table tensors.  The windows
    tensor is the only per-frame upload (~1.05x the stream).
    """

    windows: np.ndarray        # (BS, NWS, 8, 128) int32 per-lane word rows
    n_bits: int                # real destuffed stream bits
    subseq_bytes: int          # SB: window stride (bytes)
    spw: int                   # SB // 4: non-overlap words per row
    nws: int                   # spw + 3: words per row (overlap for peek)
    maxrec: int                # record rows per lane (overflow -> fallback)
    nw: int                    # words per pseudo-segment row (restart decode)
    used_slots: Tuple[int, ...]
    bpm: int
    n_mcus: int
    t_last: Tuple[int, ...]    # last block step of each scan component
    # Restart-decoder tables (R=1 pseudo segments), as in DeviceScanPlan:
    comp_of_step: np.ndarray
    dc_slot_of_step: np.ndarray
    ac_slot_of_step: np.ndarray
    seg_meta: np.ndarray
    cbase: np.ndarray
    counts: np.ndarray
    symbols: np.ndarray
    dcslot_of_c: np.ndarray    # (bpm,) int32: scan-kernel per-phase slots
    acslot_of_c: np.ndarray    # (bpm,) int32


def build_spec_scan_input(
    parsed: ParsedJpeg,
    subseq_bytes: Optional[int] = None,
    nw: Optional[int] = None,
    sb_target: int = 512,
    max_words: int = 1024,
) -> SpecScanInput:
    """Pack a DRI-less stream for the device parallel index scan.

    ``subseq_bytes`` pins the window stride (serving-loop shape
    stability); by default it adapts so the subsequences fill whole
    1024-lane batches (minimal padding upload) at roughly ``sb_target``
    bytes each.  ``nw`` pins the restart rows' word width exactly like
    build_plan_no_dri's pin; unpinned, a 2.5x-average heuristic is used
    and the device flags streams whose max segment exceeds it (the
    caller then falls back to the serial scan path).

    The stride and sizes follow from the destuffed length, which the
    parse counted.  Where the host library is available, the window rows
    come from one native pass with the interpreter lock released, destuff
    and rows together (``entropy_native.scan_windows``; span
    ``host.destuff``, counter ``host.native_windows``); else from
    ``specsync.destuff`` and :func:`window_rows`.  Either way the same
    input, bit for bit.  The rest is span ``host.scan_windows``.
    """
    from jpeg_gpu_tpu_torch.host import entropy_native
    from jpeg_gpu_tpu_torch.host.specsync import destuff

    header = parsed.header
    assert header.scan is not None
    if header.restart_interval or len(parsed.segments) != 1:
        raise ValueError("build_spec_scan_input is for single-segment streams")
    args = (header.n_mcus, subseq_bytes, nw, sb_target, max_words)
    if entropy_native.available():
        geom = _scan_geometry(parsed.destuffed_bytes, *args)
        with trace.span("host.destuff", cpu=False):
            windows = entropy_native.scan_windows(parsed, geom.bs, geom.spw, geom.nws)
        trace.count("host.native_windows")
        with trace.span("host.scan_windows", cpu=False):
            return _spec_scan_input(parsed, windows, geom)
    data = destuff(parsed)
    with trace.span("host.scan_windows", cpu=False):
        geom = _scan_geometry(data.size, *args)
        return _spec_scan_input(parsed, window_rows(data, geom.bs, geom.spw, geom.nws), geom)


class _ScanGeometry(NamedTuple):
    """The shapes of a :class:`SpecScanInput`, from its stream's length."""

    n_bits: int
    sb: int
    spw: int
    nws: int
    bs: int
    maxrec: int
    nw: int


def _scan_geometry(n_bytes: int, n_mcus: int, subseq_bytes: Optional[int], nw: Optional[int],
                   sb_target: int, max_words: int) -> _ScanGeometry:
    """The window stride and the row and record sizes of a stream of
    ``n_bytes`` destuffed bytes (:func:`build_spec_scan_input`'s pins)."""
    n_bits = n_bytes * 8
    if n_bits >= 2**30:
        raise JpegUnsupportedError(
            "stream too large for int32 device bit offsets"
        )
    avg_bits = max(n_bits / max(n_mcus, 1), 16.0)
    if subseq_bytes is None:
        # Two constraints: (a) fill whole 1024-lane batches (padding lanes
        # are pure upload waste), (b) stay comfortably above the measured
        # self-sync distance per round -- rounds ~ sync_distance / SB, and
        # SPECSYNC_r03 puts sync at roughly 25-30 MCUs, so SB >= 2 average
        # MCUs keeps convergence well inside max_rounds with the serial
        # fallback as the safety net.
        bs = max(1, round(n_bytes / (SEGMENTS_PER_BATCH * sb_target)))
        sb_fill = -(-n_bytes // (bs * SEGMENTS_PER_BATCH))
        sb_density = int(2 * avg_bits / 8)
        sb = max(64, sb_fill, sb_density)
        sb = -(-sb // 4) * 4
    else:
        sb = subseq_bytes
        if sb % 4 or sb < 8:
            raise ValueError("subseq_bytes must be a multiple of 4, >= 8")
    spw = sb // 4
    s_real = max(1, -(-n_bytes // sb))
    bs = -(-s_real // SEGMENTS_PER_BATCH)
    maxrec = int(min(40, max(8, (4 * sb * 8) // int(avg_bits) + 2)))
    if nw is None:
        nw = _check_nw(int(avg_bits * 2.5 / 8) + 1, max_words)
    return _ScanGeometry(n_bits, sb, spw, spw + 3, bs, maxrec, nw)


def window_rows(data: np.ndarray, bs: int, spw: int, nws: int) -> np.ndarray:
    """The window rows of the destuffed bytes ``data`` in numpy passes:
    (bs, nws, 8, 128) int32, lane j = (b*8 + s)*128 + l holding the
    big-endian words j*spw .. j*spw + nws - 1 of ``data`` 0xFF-padded (so
    every lane's window row and the restart rows' word overshoot read
    1-bits, the bit reader contract)."""
    total_words = bs * SEGMENTS_PER_BATCH * spw + nws
    flat = np.full(total_words * 4, 0xFF, dtype=np.uint8)
    flat[: data.size] = data
    words = flat.view(">u4")
    win = np.lib.stride_tricks.sliding_window_view(words, nws)[::spw]
    win = win[: bs * SEGMENTS_PER_BATCH]
    return (
        win.reshape(bs, SEGMENTS_PER_BATCH, nws)
        .transpose(0, 2, 1)
        .astype(np.uint32)
        .view(np.int32)
        .reshape(bs, nws, SUBLANES, LANES)
    )


def _spec_scan_input(parsed: ParsedJpeg, windows: np.ndarray, geom: _ScanGeometry) -> SpecScanInput:
    """:func:`build_spec_scan_input` past the window rows (span
    ``host.scan_windows``): the step and slot maps and the table tensors."""
    header = parsed.header
    scan = header.scan
    n_mcus = header.n_mcus
    comp_steps, dc_steps, ac_steps, bpm = _step_maps(header, scan, 1)
    cbase, counts, symbols = _table_tensors(header)
    used = tuple(sorted(set(dc_steps) | set(ac_steps)))
    ncomp = len(scan.comp_idx)
    t_last = tuple(
        max(i for i, c in enumerate(comp_steps) if c == ci)
        for ci in range(ncomp)
    )
    # Per-phase slot maps for the scan kernel (phase c of the MCU).
    per_mcu_dc = dc_steps[:bpm]
    per_mcu_ac = ac_steps[:bpm]
    return SpecScanInput(
        windows=windows,
        n_bits=geom.n_bits,
        subseq_bytes=geom.sb,
        spw=geom.spw,
        nws=geom.nws,
        maxrec=geom.maxrec,
        nw=geom.nw,
        used_slots=used,
        bpm=bpm,
        n_mcus=n_mcus,
        t_last=t_last,
        comp_of_step=np.asarray(comp_steps, dtype=np.int32),
        dc_slot_of_step=np.asarray(dc_steps, dtype=np.int32),
        ac_slot_of_step=np.asarray(ac_steps, dtype=np.int32),
        seg_meta=_last_segment_meta(n_mcus, 1, n_mcus, bpm),
        cbase=cbase,
        counts=counts,
        symbols=symbols,
        dcslot_of_c=np.asarray(per_mcu_dc, dtype=np.int32),
        acslot_of_c=np.asarray(per_mcu_ac, dtype=np.int32),
    )


@dataclasses.dataclass
class CorpusScanPlan:
    """Device-decoder input for a bucket of same-geometry images.

    Every image's segment batches stack on the leading stream axis;
    ``img_of_batch`` routes each batch to its image's Huffman tables
    (images in a bucket share geometry and restart structure but may use
    different tables -- e.g. per-image optimized DHT segments).
    """

    streams: np.ndarray        # (NI*B1, NW, 8, 128) int32
    img_of_batch: np.ndarray   # (NI*B1,) int32
    n_images: int
    batches_per_image: int     # B1 (same for every image: same n_segments)
    n_segments: int
    mcus_per_segment: int
    n_mcus: int
    comp_of_step: np.ndarray   # (T,) shared across the bucket
    dc_slot_of_step: np.ndarray
    ac_slot_of_step: np.ndarray
    seg_meta: np.ndarray       # (NI, 3) int32: per image, the global batch
    #                            index / lane / real step count of its last
    #                            restart segment (tail-flag suppression)
    cbase: np.ndarray          # (NI, 8, 16) int32
    counts: np.ndarray         # (NI, 8, 17) int32 (slot 16: invalid limit)
    symbols: np.ndarray        # (NI, 8, 8, 128) int32

    @property
    def kernel_tables(self) -> Tuple[np.ndarray, ...]:
        """Args for decode_segments_device_multi after the streams tensor."""
        return (
            self.img_of_batch,
            self.comp_of_step, self.dc_slot_of_step, self.ac_slot_of_step,
            self.seg_meta, self.cbase, self.counts, self.symbols,
        )


def plan_bucket_key(plan: DeviceScanPlan) -> Tuple:
    """Hashable key: plans with equal keys can share one CorpusScanPlan."""
    return (
        plan.n_segments,
        plan.mcus_per_segment,
        plan.n_mcus,
        plan.comp_of_step.tobytes(),
        plan.dc_slot_of_step.tobytes(),
        plan.ac_slot_of_step.tobytes(),
    )


def build_corpus_plan(plans: Sequence[DeviceScanPlan]) -> CorpusScanPlan:
    """Stack per-image plans (same bucket key) into one kernel invocation.

    Streams are right-padded with all-ones words to the bucket's max word
    count (the bit reader's 1-padding contract, as in build_plan); tables
    stack on a new image axis.
    """
    p0 = plans[0]
    key0 = plan_bucket_key(p0)
    for p in plans[1:]:
        if plan_bucket_key(p) != key0:
            raise ValueError("corpus plans come from different buckets")
    nw = max(p.nw for p in plans)
    streams = []
    img_of_batch = []
    seg_meta = []
    base_b = 0
    for i, p in enumerate(plans):
        s = p.streams
        if p.nw < nw:
            pad = np.full(
                (s.shape[0], nw - p.nw, SUBLANES, LANES), -1, dtype=np.int32
            )
            s = np.concatenate([s, pad], axis=1)
        streams.append(s)
        img_of_batch.extend([i] * s.shape[0])
        m = p.seg_meta.copy()
        m[0] += base_b  # local batch index -> global stream batch index
        seg_meta.append(m)
        base_b += s.shape[0]
    return CorpusScanPlan(
        streams=np.concatenate(streams, axis=0),
        img_of_batch=np.asarray(img_of_batch, dtype=np.int32),
        n_images=len(plans),
        batches_per_image=p0.streams.shape[0],
        n_segments=p0.n_segments,
        mcus_per_segment=p0.mcus_per_segment,
        n_mcus=p0.n_mcus,
        comp_of_step=p0.comp_of_step,
        dc_slot_of_step=p0.dc_slot_of_step,
        ac_slot_of_step=p0.ac_slot_of_step,
        seg_meta=np.stack(seg_meta),
        cbase=np.stack([p.cbase for p in plans]),
        counts=np.stack([p.counts for p in plans]),
        symbols=np.stack([p.symbols for p in plans]),
    )
