"""consumer_offcpu_pct: of the wall time of the program's spans
engine.decode_frame and pipeline.decode_rgb_soa over the traced window, less
the wait for K3's verdict (engine.scan_verdict, its wall and CPU time taken
out of both), the share in which the consumer's thread was not running: waiting
for the interpreter lock or the OS, in percent."""

from jpegbench import program_spans as ps


def read(o):
    snap = ps.snapshot(o)
    spans, waits = ps.spans(snap, ps.CONSUMER), ps.spans(snap, [ps.VERDICT])
    wall = ps.wall_ns(spans) - ps.wall_ns(waits)
    if wall <= 0:
        return None
    return 100.0 * (ps.offcpu_ns(spans) - ps.offcpu_ns(waits)) / wall
