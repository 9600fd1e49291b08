"""How ``correct`` is decided: what the timed path produced, compared with
the plain reference, once the window has closed.

The reference (``reference.rgb``) works out each frame's RGB from the
coefficients and tables the traffic generator encoded into its bytes;
nothing the program made goes into it.  The configurations state an exact
decode (libjpeg's islow IDCT and integer colour conversion), so the
comparison is exact: the limit of the largest difference is 0.  Its
control, the program's own float path (``exact=False``, kernel K6; run
with ``python -m jpegbench.run --control``), reads 1 or more and fails.

Numbers compared, each with its limit:

* ``rgb_max_diff`` (at most 0): the largest absolute difference of any
  sample of any compared output from the reference's RGB of the pool
  frame that was sent in its place.
* ``wrong_shape`` (at most 0): compared outputs whose shape or type is
  not the frame's (H, W, 3) uint8.
* ``flagged`` (at most 0): stream frames whose error flags the device
  entropy decode raised.
* ``compared`` (at least 1): outputs compared.

Which outputs a window keeps for the comparison is its driver's
(``drivers/<kind>.py``, ``verdict``): a stream window a uniform sample of
``compare_frames`` frames, a loader window ``compare_per_batch`` outputs of
each batch, both drawn from the seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

from jpegbench import reference


@dataclasses.dataclass
class Verdict:
    correct: bool
    failed: int                     # outputs flagged or not equal to the reference
    checks: Dict[str, dict]


def _check(value, limit, rule: str) -> dict:
    return {"value": value, "limit": limit, "rule": rule}


def compare(outputs: Iterable[Tuple[int, np.ndarray]], pool: Sequence, upsample: str,
            flagged: int) -> Verdict:
    """``outputs`` ((pool index, RGB), ...) against the reference's RGB of
    each pool frame, with ``flagged`` outputs whose error flags were raised."""
    expected: Dict[int, np.ndarray] = {}
    worst, wrong_shape, differ, n = 0, 0, 0, 0
    for index, got in outputs:
        f = pool[index]
        if index not in expected:
            expected[index] = reference.rgb(f.coefs, f.qtables, f.sampling, f.height, f.width,
                                            upsample)
        want = expected[index]
        n += 1
        if got.shape != want.shape or got.dtype != want.dtype:
            wrong_shape += 1
            differ += 1
            continue
        d = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())
        worst = max(worst, d)
        differ += d > 0
    checks = {"rgb_max_diff": _check(worst, 0, "<="), "wrong_shape": _check(wrong_shape, 0, "<="),
              "flagged": _check(flagged, 0, "<="), "compared": _check(n, 1, ">=")}
    correct = worst <= 0 and wrong_shape <= 0 and flagged <= 0 and n >= 1
    return Verdict(correct, differ + flagged, checks)

