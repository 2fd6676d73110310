"""The host scheduler's own time per 1,000 processed cells: the self time
of the five `cells.*` spans (filter, extend, regularize, remove, branch:
their duration less the `dispatch` spans directly under them, which enqueue
device work or wait on it; hpmvs_tpu_torch/trace.py) over the jobs'
`cells_processed`. A program without the recorder reads nothing."""


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


def _is_cells(s):
    return s.name.startswith("cells.")


def value(sp, rec):
    ns = sum(s.end - s.start for s in sp if _is_cells(s))
    for s in sp:
        if s.name != "dispatch":
            continue
        # the nearest cells or dispatch span above: a dispatch inside
        # another is in that one's time already
        p = s.parent
        while p >= 0 and not (_is_cells(sp[p]) or sp[p].name == "dispatch"):
            p = sp[p].parent
        if p >= 0 and _is_cells(sp[p]):
            ns -= s.end - s.start
    cells = sum(j.stats.get("cells_processed", 0) for j in rec["jobs"])
    if not cells or not any(_is_cells(s) for s in sp):
        return None
    return ns / 1e6 / (cells / 1e3)


def read(rec):
    return value(spans(), rec)
