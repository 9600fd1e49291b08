"""The metric arithmetic of the benchmark: what a traced run's profile says
of the card, and the least time each kernel's work could take.

Frozen here, so that a change to the program cannot change how it is
measured.  The profile is ``torch.profiler``'s (CUDA activity through
CUPTI); the harness's spans are taken on the host clock and moved onto the
profiler's by the window, which is also a ``record_function`` range,
``jpegbench.window``.

* :func:`read_profile` takes the card's operations (kernels, copies,
  memsets) from the profile and places the harness's spans beside them.
* :func:`busy` is the union of the card's operations over the traced
  window: the seconds in which something ran on the card.  The idle share
  is ``1 - busy / window``.
* :func:`idle_gaps` labels each stretch of the window with nothing on the
  card by the harness spans open at its middle, and sums them by label.
* :func:`kernel_time` is a kernel family's device seconds, scaled up where
  the profiler kept fewer records than the program's launch counters say
  were launched (on the H100 machines the profiler has dropped records in
  some windows), with a line on standard error that says so.
* :func:`least_seconds` and the ``*_work`` functions are the roofline: the
  larger of bytes over the card's memory bandwidth and operations over its
  operation rate, each counted from facts of the stream that the traffic
  generator knows, never from the program's buffers.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# NVIDIA's data sheet, H100 SXM: HBM3 bandwidth, and the float32 rate
# outside the tensor cores, which bounds integer work too.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# A Huffman symbol (a DC, AC, ZRL or EOB code) is taken as 10 operations:
# a peek, a table lookup, a shift, the amplitude's extraction and sign
# extension, a store and the bookkeeping of position and count.
OPS_PER_SYMBOL = 10
# jpeg_idct_islow (jidctint.c) on one 8x8 block: 64 multiplications to
# dequantize; 16 one-dimensional passes (8 columns, 8 rows), each 12
# multiplications and 32 additions in its butterfly and 8 rounding
# additions when it descales; 64 additions of the level shift.
ISLOW_OPS_PER_BLOCK = 64 + 16 * (12 + 32 + 8) + 64
COEF_BYTES_PER_BLOCK = 64 * 2       # int16 coefficients
BITPOS_BYTES_PER_MCU = 4            # one int32 bit offset written per MCU
RGB_BYTES_PER_PIXEL = 3

# Kernel families by the program's kernel names (csrc/*.cu) and the module
# whose ``launches`` counter counts their launches.
FAMILIES = {
    "k1": (("fused_rgb_kernel",), "jpeg_gpu_tpu_torch.ops.pixel_fused"),
    "k2": (("decode_kernel", "dc_base_kernel", "symbol_lut_kernel"),
           "jpeg_gpu_tpu_torch.ops.entropy_device"),
    "k3": (("index_scan_kernel", "scan_lut_kernel"), "jpeg_gpu_tpu_torch.ops.specsync_device"),
}
SPAN_PREFIX = "jpegbench."
_IDENT = re.compile(r"(?:void\s+)?([A-Za-z_][\w:]*)")


def short_name(name: str) -> str:
    """A device operation's name without its signature or namespaces
    (``void (anonymous namespace)::decode_kernel<2>(int const*, ...)`` ->
    ``decode_kernel``); a copy's or memset's first two words (``Memcpy
    HtoD``)."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    m = _IDENT.match(name)
    return (m.group(1).rsplit("::", 1)[-1] if m else name)[:64] or "unnamed"


@dataclasses.dataclass
class Profile:
    """A traced window: the card's operations and the harness's spans as
    (name, start s, end s), on the profiler's clock."""

    device: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]

    def window(self) -> Tuple[float, float]:
        """(start, end) of the ``jpegbench.window`` span."""
        for name, a, b in self.spans:
            if name == "window":
                return a, b
        raise RuntimeError("the profile holds no jpegbench.window span")


def _times(e) -> Tuple[float, float]:
    if hasattr(e, "start_ns"):
        a = e.start_ns() / 1e9
        return a, a + e.duration_ns() / 1e9
    a = e.start_us() / 1e6
    return a, a + e.duration_us() / 1e6


def read_profile(prof, spans: Sequence[Tuple[str, float, float]]) -> Profile:
    """The card's operations (every event of the CUDA device that is not one
    of the harness's annotations) of a stopped ``torch.profiler``, and the
    harness's ``spans`` ((name, start, end) on the host clock, the window
    among them), moved onto the profiler's clock by the window's
    ``jpegbench.window`` range."""
    device, anchor = [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        kind = str(e.device_type()).rsplit(".", 1)[-1]
        if name == SPAN_PREFIX + "window" and kind == "CPU":
            anchor = _times(e)[0]
        elif kind == "CUDA" and not name.startswith(SPAN_PREFIX):
            device.append((name, *_times(e)))
    if anchor is None:
        raise RuntimeError("the profile holds no jpegbench.window range")
    host_start = next(a for name, a, _ in spans if name == "window")
    shift = anchor - host_start
    return Profile(device, [(name, a + shift, b + shift) for name, a, b in spans])


def _merged(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[List[float]]:
    """Intervals clipped to [lo, hi], sorted and merged where they overlap."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy(p: Profile) -> Tuple[float, float]:
    """(busy seconds, window seconds): the length of the union of the card's
    operations inside the window, and the window's length."""
    lo, hi = p.window()
    return sum(b - a for a, b in _merged(((a, b) for _, a, b in p.device), lo, hi)), hi - lo


def idle_gaps(p: Profile, top: int = 10) -> List[List]:
    """The window's stretches with nothing on the card, summed by what the
    harness was doing at each one's middle: the names of the spans open then,
    one per thread (``consumer.decode_frame|producer.plan``), or ``none``.
    The ``top`` largest sums, as [label, seconds]."""
    lo, hi = p.window()
    ops = _merged(((a, b) for _, a, b in p.device), lo, hi)
    edges = [lo] + [x for ab in ops for x in ab] + [hi]
    by_thread: Dict[str, List[Tuple[float, float, str]]] = {}
    for name, a, b in p.spans:
        if name != "window":
            by_thread.setdefault(name.split(".", 1)[0], []).append((a, b, name))
    for spans in by_thread.values():
        spans.sort()
    starts = {t: [s[0] for s in spans] for t, spans in by_thread.items()}
    sums: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        open_ = []
        for t in sorted(by_thread):
            i = bisect.bisect_right(starts[t], mid) - 1
            if i >= 0 and by_thread[t][i][1] >= mid:
                open_.append(by_thread[t][i][2])
        label = "|".join(open_) or "none"
        sums[label] = sums.get(label, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(p: Profile, top: int = 10) -> List[List]:
    """The card's operations inside the window, seconds summed by short
    name, the ``top`` largest as [name, seconds]."""
    lo, hi = p.window()
    sums: Dict[str, float] = {}
    for name, a, b in p.device:
        if b > lo and a < hi:
            key = short_name(name)
            sums[key] = sums.get(key, 0.0) + min(b, hi) - max(a, lo)
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def kernel_records(p: Profile, family: str) -> Tuple[float, int]:
    """(seconds, records) of a kernel family's launches that started inside
    the window."""
    names = FAMILIES[family][0]
    lo, hi = p.window()
    seconds, n = 0.0, 0
    for name, a, b in p.device:
        if lo <= a < hi and short_name(name) in names:
            seconds += b - a
            n += 1
    return seconds, n


def kernel_time(p: Profile, family: str, launched: int) -> Optional[float]:
    """A kernel family's device seconds in the window: the recorded seconds,
    times launched / recorded where the profiler kept fewer records than
    ``launched`` (the program's counters over the window); None when none
    was recorded.  Says so on standard error when records are missing."""
    seconds, n = kernel_records(p, family)
    if n == 0:
        return None
    if n < launched:
        print(f"profile: {family} kept {n} of {launched} launches; its time is scaled by "
              f"{launched / n:.6g}", file=sys.stderr)
        return seconds * launched / n
    return seconds


def least_seconds(n_bytes: float, ops: float) -> float:
    """The least time the card could take for work that moves ``n_bytes``
    (each input byte read once, each output byte written once) and does
    ``ops`` operations: the larger of the two over the card's peaks."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / OPS_PER_S)


def k3_work(f) -> Tuple[int, int]:
    """(bytes, operations) of the index scan of a stream with facts ``f``:
    the scan's entropy-coded bytes read once, one 4-byte bit offset written
    per MCU; 10 operations a Huffman symbol."""
    return f.scan_bytes + BITPOS_BYTES_PER_MCU * f.mcus, OPS_PER_SYMBOL * f.symbols


def k2_work(f) -> Tuple[int, int]:
    """(bytes, operations) of the Huffman decode of a stream: the scan's
    bytes read once, 64 int16 coefficients written per block; 10 operations
    a Huffman symbol."""
    return f.scan_bytes + COEF_BYTES_PER_BLOCK * f.blocks, OPS_PER_SYMBOL * f.symbols


def k1_work(f) -> Tuple[int, int]:
    """(bytes, operations) of the pixel stage of a frame: its coefficients
    read once as int16, its quantization tables, 3 bytes of RGB written per
    pixel; the islow IDCT's operations per block (ISLOW_OPS_PER_BLOCK)."""
    return (COEF_BYTES_PER_BLOCK * f.blocks + f.quant_bytes + RGB_BYTES_PER_PIXEL * f.pixels,
            ISLOW_OPS_PER_BLOCK * f.blocks)


WORK = {"k1": k1_work, "k2": k2_work, "k3": k3_work}


def roofline_pct(p: Profile, family: str, facts: Sequence, launched: int) -> Optional[float]:
    """A kernel family's share of its roofline over the window, in percent:
    the least seconds of the work of every stream in ``facts`` (each one
    launch's, summed) over the family's device seconds (:func:`kernel_time`).
    None where the window recorded none of its launches or had no work."""
    seconds = kernel_time(p, family, launched)
    if not seconds or not facts:
        return None
    least = sum(least_seconds(*WORK[family](f)) for f in facts)
    return 100.0 * least / seconds
