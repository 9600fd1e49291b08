"""setup_s: process start to the window's start (imports, the CUDA context,
the kernels' load or build, the traffic's generation, the warm-up of the
cell's own shapes), host clock."""


def read(o):
    return o.setup_s
