"""Share of the priority steps' host time spent blocked on the device: the
`wait` spans inside `step` spans (synchronisations and copies back to the
host) over the `step` spans (hpmvs_tpu_torch/trace.py). A program without
the recorder reads nothing."""


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
    step = sum(s.end - s.start for s in sp if s.name == "step")
    wait = sum(s.end - s.start for s in sp
               if s.name == "wait" and _under(sp, s, "step")
               and not _under(sp, s, "wait"))
    return 100.0 * wait / step if step else None


def read(rec):
    return value(spans(), rec)
