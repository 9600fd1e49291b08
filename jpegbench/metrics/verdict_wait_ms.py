"""verdict_wait_ms: the program's span engine.scan_verdict (the consumer's
blocking read of K3's verdict in engine.device_entropy._scan_decode), ms a
decoded frame (engine.decode_frame) over the traced window.  A scanned frame
reads one verdict, so where every frame is scanned this is the mean wait a
verdict; frames with restart markers bypass K3 and add no wait."""

from jpegbench import program_spans as ps


def read(o):
    snap = ps.snapshot(o)
    frames = ps.spans(snap, ["engine.decode_frame"])
    if not frames:
        return None
    return ps.wall_ns(ps.spans(snap, [ps.VERDICT])) / len(frames) / 1e6
