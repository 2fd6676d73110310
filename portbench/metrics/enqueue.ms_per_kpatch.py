"""Host time enqueueing device work per 1,000 refined patches: the
outermost `dispatch` spans (each section that adds to the engine's
t_device) less the `wait` spans inside them, where the host blocks on the
device (hpmvs_tpu_torch/trace.py), over the jobs' `patches_optimized`. A
program without the recorder reads nothing."""


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


def _under(sp, s, name):
    """Whether an ancestor of span `s` is named `name`."""
    p = s.parent
    while p >= 0:
        if sp[p].name == name:
            return True
        p = sp[p].parent
    return False


def value(sp, rec):
    ns, seen = 0, False
    for s in sp:
        if s.name == "dispatch" and not _under(sp, s, "dispatch"):
            ns += s.end - s.start
            seen = True
        elif (s.name == "wait" and _under(sp, s, "dispatch")
              and not _under(sp, s, "wait")):
            ns -= s.end - s.start
    n = sum(j.stats.get("patches_optimized", 0) for j in rec["jobs"])
    if not seen or not n:
        return None
    return ns / 1e6 / (n / 1e3)


def read(rec):
    return value(spans(), rec)
