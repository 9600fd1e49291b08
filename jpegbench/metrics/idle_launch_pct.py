"""idle_launch_pct: of the card's idle seconds in the traced window (the
profile's window less its kernels, copies and memsets), the share in which the
consumer was inside the program (the spans engine.decode_frame or
pipeline.decode_rgb_soa) and not waiting for K3's verdict
(engine.scan_verdict), the program's spans on the profiler's clock, in
percent."""

from jpegbench import program_spans as ps


def read(o):
    snap = ps.snapshot(o)
    if not ps.spans(snap, ps.CONSUMER):
        return None
    share = ps.idle_share(o.profile, snap, ps.CONSUMER, ps.VERDICT)
    return None if share is None else 100.0 * share
