"""device_ms_per_frame: the card's busy time over the profiled window (the
union of its kernels, copies and memsets, jpegbench.profile.busy) per frame
or image the window completed, in milliseconds: what decoding costs the
card, whatever the host's pace."""

from jpegbench.profile import busy


def read(o):
    if o.profile is None or not o.facts:
        return None
    return 1e3 * busy(o.profile)[0] / len(o.facts)
