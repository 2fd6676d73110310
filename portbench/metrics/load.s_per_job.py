"""Host time of the load layer per job: the summed `load` spans (NVM read,
image load and undistortion, scene build, seeding; the program's span
recorder, hpmvs_tpu_torch/trace.py) over the jobs in the window. A program
without the recorder reads nothing."""


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
    ns = sum(s.end - s.start for s in sp if s.name == "load")
    if not ns or not rec["jobs"]:
        return None
    return ns / 1e9 / len(rec["jobs"])


def read(rec):
    return value(spans(), rec)
