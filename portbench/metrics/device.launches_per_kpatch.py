"""CUDA kernel launches in the traced window (the profiler's device
activity, copies and fills left out) per 1,000 delivered patches."""


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["launches"] or not rec["delivered"]:
        return None
    return 1000.0 * tr["launches"] / rec["delivered"]
