"""k3_rounds_per_frame: the rounds of K3's index scan a decoded frame
(engine.decode_frame) over the traced window, from the program's counter
engine.scan_rounds (each verdict's rounds).  Where every frame is scanned this
is the mean rounds a scan; frames with restart markers bypass K3 and add none."""

from jpegbench import program_spans as ps


def read(o):
    snap = ps.snapshot(o)
    frames = ps.spans(snap, ["engine.decode_frame"])
    if not frames:
        return None
    return snap.counters.get("engine.scan_rounds", 0) / len(frames)
