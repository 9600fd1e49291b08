"""The one traffic generator: seeded JPEG frames of any size
(:func:`make_frame`), with the stream facts the roofline counts need.
Which frames a cell's pool holds is its driver's (``drivers/<kind>.py``,
``make_pool``), from the configuration, the traffic mix and ``--seed``.

Frame ``i`` of a pool is tiled by the hash of (seed, i): the same seed
gives the same bytes.
"""

from __future__ import annotations

from typing import List

import numpy as np

from jpegbench.traffic_gen.frames import SAMPLING, Facts, Frame, make_frame

__all__ = ["SAMPLING", "Facts", "Frame", "make_frame", "size_counts"]


def size_counts(sizes, n: int) -> List[int]:
    """Images of each size for shares ``sizes`` ([width, height, share], ...)
    of ``n`` images: floors of share x n, the rest to the largest remainders."""
    want = np.array([s[2] for s in sizes], dtype=np.float64) * n
    counts = np.floor(want).astype(np.int64)
    for i in np.argsort(-(want - counts), kind="stable")[: n - int(counts.sum())]:
        counts[i] += 1
    return counts.tolist()
