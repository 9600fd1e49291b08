"""Timing on the card: CUDA events, and the kernels' own device time.

``cuda_ms`` times back-to-back calls with CUDA events, which includes the
wrapper's Python whenever the host is the slower of the two.  The profiler
functions read the kernels' own time from ``torch.profiler``'s device-side
events.  On the H100 machines tried, the profiler dropped the records of
some kernel launches in some windows (a whole decode lost its kernels), so
:func:`launch_device_ms` counts a window only when it recorded every launch
it was owed, and takes up to three.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch

# The port's kernels as the profiler names them (csrc/*.cu).  Each launch the
# wrappers count is one record of one of these.
KERNEL_NAMES = ("fused_rgb_kernel", "decode_kernel", "dc_base_kernel", "symbol_lut_kernel",
                "index_scan_kernel", "scan_lut_kernel", "pack_expand_kernel",
                "idct_islow_planes_kernel", "idct_float_planes_kernel")


def cuda_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean ms of fn() over ``iters`` back-to-back calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _windows(fn: Callable[[], object], iters: int, tries: int = 3) -> Iterator[list]:
    """After a warm-up call, up to ``tries`` profiler windows of ``iters``
    calls each: each window's device-side rows (name, records, self device
    time), taken again while the caller asks for another."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        yield [(e.key, e.count, e.self_device_time_total)
               for e in prof.key_averages() if e.self_device_time_total > 0]


def device_ms(fn: Callable[[], object], iters: int) -> Dict[str, float]:
    """Mean device ms a call of everything fn() runs on the card (kernels and
    copies), by name, over ``iters`` calls after a warm-up call; a window
    that saw no device event is taken again."""
    for rows in _windows(fn, iters):
        if rows:
            return {key[:72]: us / 1e3 / iters for key, _, us in rows}
    raise RuntimeError("torch.profiler recorded no device time")


def launch_device_ms(
    fn: Callable[[], object], names: Sequence[str], per_call: int, iters: int = 5,
) -> Tuple[Optional[float], int, Dict[str, Tuple[float, int]]]:
    """Device ms of the kernels of one fn() call whose names hold one of
    ``names`` (``per_call`` launches a call), over ``iters`` calls after a
    warm-up call.  A window counts only when it recorded every launch; up
    to three are taken.  Returns (ms a call, or None when no window
    recorded every launch; the launches recorded in the last window; by
    kernel, the last window's mean ms a recorded launch and its launches
    recorded)."""
    recorded, by_kernel = 0, {}
    for rows in _windows(fn, iters):
        mine = [(key, n, us) for key, n, us in rows if any(k in key for k in names)]
        recorded = sum(n for _, n, _ in mine)
        by_kernel = {key[:72]: (us / 1e3 / n, n) for key, n, us in mine}
        if recorded == iters * per_call:
            return sum(us for _, _, us in mine) / 1e3 / iters, recorded, by_kernel
    return None, recorded, by_kernel
