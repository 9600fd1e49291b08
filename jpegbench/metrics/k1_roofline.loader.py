"""k1_roofline.loader: kernel K1's share of its roofline over the traced
window, in percent (jpegbench.profile.roofline_pct: the least time of the
window's work counted from the images' facts, over the kernels' device
time), in the cells of the loader kind: one launch a batch."""

from jpegbench.profile import roofline_pct


def read(o):
    if o.profile is None or o.kind != "loader":
        return None
    return roofline_pct(o.profile, "k1", o.facts, o.launches.get("k1", 0))
