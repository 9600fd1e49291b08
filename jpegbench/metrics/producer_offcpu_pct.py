"""producer_offcpu_pct: of the wall time of the program's spans host.parse,
engine.plan_frame and engine.upload_frame over the traced window, the share
in which their thread was not running (wall less the thread's CPU time):
waiting for the interpreter lock or the OS, in percent."""

from jpegbench import program_spans as ps


def read(o):
    spans = ps.spans(ps.snapshot(o), ps.PRODUCER)
    wall = ps.wall_ns(spans)
    return 100.0 * ps.offcpu_ns(spans) / wall if wall > 0 else None
