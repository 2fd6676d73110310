"""Share of the priority loop's wall time in which the host was not
blocked on the device: 1 - t_device / proc_time, summed over the jobs
(engine stats; a cut job's proc_time from its first snapshot hook to the
cut)."""


def read(rec):
    dev = proc = 0.0
    for j in rec["jobs"]:
        st = j.stats
        if "proc_time" in st:
            p = st["proc_time"]
        elif j.snaps:
            p = j.t_end - j.snaps[0][1]
        else:
            continue
        dev += float(st.get("t_device", 0.0))
        proc += p
    return 100.0 * max(proc - dev, 0.0) / proc if proc > 0 else None
