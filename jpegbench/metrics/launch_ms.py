"""launch_ms: the consumer's ms a frame inside the program less the wait for
K3's verdict, over the traced window: (the program's spans
engine.decode_frame + pipeline.decode_rgb_soa - engine.scan_verdict) /
the number of engine.decode_frame spans.  Python, launches and torch ops."""

from jpegbench import program_spans as ps


def read(o):
    snap = ps.snapshot(o)
    frames = ps.spans(snap, ["engine.decode_frame"])
    if not frames:
        return None
    inside = ps.wall_ns(ps.spans(snap, ps.CONSUMER)) - ps.wall_ns(ps.spans(snap, [ps.VERDICT]))
    return inside / len(frames) / 1e6
