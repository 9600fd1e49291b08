"""loader_d2h_ms: the card's device-to-host copies (the profile's
``Memcpy DtoH`` operations, jpegbench.profile.device_ops) inside the traced
window, device ms a batch completed, in the cells of the loader kind: the
RGB of each batch on its way to the host."""

from jpegbench.profile import device_ops


def read(o):
    if o.profile is None or o.kind != "loader" or not o.run.batches:
        return None
    seconds = dict(device_ops(o.profile, top=len(o.profile.device))).get("Memcpy DtoH")
    return seconds / o.run.batches * 1e3 if seconds else None
