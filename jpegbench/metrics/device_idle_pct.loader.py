"""device_idle_pct.loader: the share of the traced window with no kernel,
copy or memset on the card, in percent (jpegbench.profile.busy), in the
cells of the loader kind."""

from jpegbench.profile import busy


def read(o):
    if o.profile is None or o.kind != "loader":
        return None
    busy_s, window_s = busy(o.profile)
    return 100.0 * (1.0 - busy_s / window_s)
