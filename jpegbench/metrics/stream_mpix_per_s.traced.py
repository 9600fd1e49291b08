"""stream_mpix_per_s.traced: the pixels of every frame whose RGB completed
on the card in the traced window, in millions, over the window's wall time
(its start to the last frame's completion).  The stream's rate, read under
the profiler: the host's pace sets it, and the host's speed swings from run
to run by more than an end-to-end bound may allow."""


def read(o):
    if o.kind != "stream" or not o.facts:
        return None
    return sum(f.pixels for f in o.facts) / 1e6 / o.wall_s
