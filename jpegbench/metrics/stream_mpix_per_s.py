"""stream_mpix_per_s: the pixels of every frame whose RGB completed on the
card in the window, in millions, over the window's wall time (its start to
the last frame's completion)."""


def read(o):
    if o.kind != "stream" or not o.facts:
        return None
    return sum(f.pixels for f in o.facts) / 1e6 / o.wall_s
