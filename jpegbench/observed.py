"""What a run observed, as the metric readers (``metrics/<metric>.py``) get
it: each reader is ``read(o: Observed) -> Optional[float]`` and returns
None where it finds nothing to read, so that its metric is left out."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from jpegbench.profile import Profile
from jpegbench.traffic_gen import Facts


@dataclasses.dataclass
class Observed:
    kind: str                          # the traffic's kind, its driver's name
    setup_s: float                     # process start -> the window's start
    facts: List[Facts]                 # every frame or image the window completed, in order
    spans: Dict[str, List[float]]      # the harness's span durations (s), traced runs only
    run: object                        # the driver's run (drivers/<kind>.py's window)
    profile: Optional[Profile] = None  # traced runs on a card
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)  # by family, in the window

    @property
    def wall_s(self) -> float:
        return self.run.wall_s
