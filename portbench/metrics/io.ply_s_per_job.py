"""Host time writing PLY files per job: the summed `io.save_ply` spans (the
per-level snapshots and the final cloud; hpmvs_tpu_torch/trace.py) over the
jobs in the window. A program without the recorder reads nothing."""


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
    ns = sum(s.end - s.start for s in sp if s.name == "io.save_ply")
    if not ns or not rec["jobs"]:
        return None
    return ns / 1e9 / len(rec["jobs"])


def read(rec):
    return value(spans(), rec)
