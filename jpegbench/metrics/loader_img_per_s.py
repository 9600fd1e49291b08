"""loader_img_per_s: the images of the batches completed in the window,
RGB on the host as the entry returns it, over the window's wall time (its
start to the last batch's return)."""


def read(o):
    if o.kind != "loader" or not o.run.images:
        return None
    return o.run.images / o.wall_s
