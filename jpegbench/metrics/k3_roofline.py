"""k3_roofline: kernel K3's share of its roofline over the traced
window, in percent (jpegbench.profile.roofline_pct: the least time of the
window's work counted from the stream's facts, over the kernels' device
time)."""

from jpegbench.profile import roofline_pct


def read(o):
    if o.profile is None:
        return None
    return roofline_pct(o.profile, "k3", o.facts, o.launches.get("k3", 0))
