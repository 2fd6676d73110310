"""Host time of the gates and depth layer per 1,000 refined patches: the
`depth.updates` spans (the deferred z-buffer updates) and `depth.gates`
spans (the collapse, pool and the three gate tests; hpmvs_tpu_torch/
trace.py) over the jobs' `patches_optimized`. A program without the
recorder reads nothing."""

NAMES = ("depth.updates", "depth.gates")


def install(rec):
    try:
        from hpmvs_tpu_torch import trace
    except ImportError:
        return
    trace.reset()
    trace.enable()


def spans():
    try:
        from hpmvs_tpu_torch import trace
    except ImportError:
        return []
    return trace.records()


def value(sp, rec):
    mine = [s for s in sp if s.name in NAMES]
    n = sum(j.stats.get("patches_optimized", 0) for j in rec["jobs"])
    if not mine or not n:
        return None
    return sum(s.end - s.start for s in mine) / 1e6 / (n / 1e3)


def read(rec):
    return value(spans(), rec)
