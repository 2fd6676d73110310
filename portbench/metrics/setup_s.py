"""Process start to the window: imports, CUDA initialisation, the kernel
and octree library builds in a checkout's first run, the scene made from
the seed and written, and one warm-up job to the end of its first level."""


def read(rec):
    return rec["setup_s"]
