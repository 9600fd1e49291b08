"""device_idle_pct.stream: the share of the traced window with no kernel,
copy or memset on the card, in percent (jpegbench.profile.busy), in the
cells of the stream kind."""

from jpegbench.profile import busy


def read(o):
    if o.profile is None or o.kind != "stream":
        return None
    busy_s, window_s = busy(o.profile)
    return 100.0 * (1.0 - busy_s / window_s)
