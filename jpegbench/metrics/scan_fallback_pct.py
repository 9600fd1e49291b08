"""scan_fallback_pct: frames planned for the device index scan that it
handed to the serial host scan (the result's specsync_stats is None), as a
share of those frames, in percent."""


def read(o):
    if o.kind != "stream" or not o.run.scan_frames:
        return None
    return 100.0 * o.run.fallback_frames / o.run.scan_frames
