"""frame_p95_ms: the 95th percentile, over every frame of the window, of the
time from the hand-off of the frame's bytes to the producer to the CUDA
event after its last launch (numpy's linear interpolation)."""

import numpy as np


def read(o):
    if o.kind != "stream" or not o.run.latency_s:
        return None
    return float(np.percentile(np.asarray(o.run.latency_s), 95) * 1e3)
