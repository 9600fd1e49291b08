"""The program's own spans and counters, as the readers of the per-layer
metrics that rest on them get them.

The program keeps them itself (``jpeg_gpu_tpu_torch.utils.trace``): its
tracer records while a ``torch.profiler`` records, so a traced run's window
is one session of it, read after the window with ``trace.snapshot()``.
Where the run has no profile (``--trace 0``, or no card), or the program has
no tracer (a checkout from before it), :func:`snapshot` gives None and each
reader returns None, so its metric is left out.

Spans carry their wall time, the thread's CPU time over them, and their
start and end on the profiler's clock, which is the clock of
``jpegbench.profile.Profile``; :func:`idle_share` places them beside the
card's operations.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from jpegbench.profile import _merged

PRODUCER = ("host.parse", "engine.plan_frame", "engine.upload_frame")
CONSUMER = ("engine.decode_frame", "pipeline.decode_rgb_soa")
VERDICT = "engine.scan_verdict"


def snapshot(o):
    """The session of the traced window (``trace.snapshot()``), or None."""
    if o.profile is None:
        return None
    try:
        from jpeg_gpu_tpu_torch.utils import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    return snap if snap.spans else None


def spans(snap, names: Iterable[str]) -> list:
    """The spans of ``snap`` (None: none) whose name is in ``names``."""
    names = set(names)
    return [s for s in snap.spans if s.name in names] if snap is not None else []


def wall_ns(spans_: Sequence) -> int:
    return sum(s.wall_ns for s in spans_)


def offcpu_ns(spans_: Sequence) -> int:
    """Wall time less the thread's CPU time, summed."""
    return sum(s.wall_ns - s.cpu_ns for s in spans_)


def _minus(base: List[List[float]], cut: List[List[float]]) -> List[List[float]]:
    """``base`` less ``cut``, both sorted and merged (``profile._merged``)."""
    out, j = [], 0
    for a, b in base:
        while j < len(cut) and cut[j][1] <= a:
            j += 1
        k = j
        while k < len(cut) and cut[k][0] < b:
            if cut[k][0] > a:
                out.append([a, cut[k][0]])
            a = max(a, cut[k][1])
            k += 1
        if a < b:
            out.append([a, b])
    return out


def _length(iv: List[List[float]]) -> float:
    return sum(b - a for a, b in iv)


def idle_share(profile, snap, inside: Sequence[str], outside: str) -> Optional[float]:
    """Of the seconds in the profile's window with nothing on the card, the
    share (0-1) in which a span named in ``inside`` was open and none named
    ``outside``, the spans on the profiler's clock.  None without idle time."""
    lo, hi = profile.window()
    idle = _minus([[lo, hi]], _merged(((a, b) for _, a, b in profile.device), lo, hi))
    total = _length(idle)
    if total <= 0:
        return None

    def union(names):
        return _merged(((s.clock_start_ns / 1e9, s.clock_end_ns / 1e9)
                        for s in spans(snap, names)), lo, hi)

    held = _minus(union(inside), union([outside]))
    return _length(_minus(idle, _minus(idle, held))) / total
