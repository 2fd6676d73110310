"""The traced run's device activity: torch.profiler over the whole measured
window (CUDA activity only), reduced to kernel time by name, launches, the
busy time (the union of device intervals), and the breakdown the result
line carries: the device operations that took most time and the longest
idle gaps, each labelled by the job phase the hooks saw (`jobJ.load` before
the first priority step: image load, undistortion, scene build, seeding;
`jobJ.prioN` inside priority step N)."""

from __future__ import annotations

import bisect


def start(dev):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" \
        else [ProfilerActivity.CPU]
    prof = profile(activities=acts)
    prof.start()
    return prof


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type())


def _phases(jobs):
    """Sorted (time_ns, label) boundaries from the jobs' hook times."""
    marks = []
    for j, job in enumerate(jobs):
        marks.append((job.ns_call, f"job{j}.load"))
        for prio, _, ns, _ in job.snaps:
            # after step `prio` closes, step prio + 1 runs
            marks.append((ns, f"job{j}.prio{prio + 1}"))
    marks.sort()
    return marks


def stop(prof, ns0: int, ns1: int, jobs) -> dict:
    prof.stop()
    by_name, spans, launches = {}, [], 0
    for e in prof.profiler.kineto_results.events():
        if not _is_device(e):
            continue
        s = e.start_ns()
        t = s + e.duration_ns()
        s, t = max(s, ns0), min(t, ns1)
        if t <= s:
            continue
        name = e.name()
        tot = by_name.setdefault(name, [0, 0])
        tot[0] += t - s
        tot[1] += 1
        if not name.startswith(("Memcpy", "Memset")):
            launches += 1
        spans.append((s, t))
    spans.sort()
    busy, gaps, cur_s, cur_t = 0, [], None, ns0
    for s, t in spans:
        if cur_s is None or s > cur_t:
            if cur_s is not None:
                busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_s is not None:
        busy += cur_t - cur_s
    gaps.append((cur_t, ns1))
    marks = _phases(jobs)
    times = [m[0] for m in marks]

    def label(ns):
        # before the first job's call: the window's own start (its load)
        i = max(bisect.bisect_right(times, ns) - 1, 0)
        return marks[i][1] if marks else "window"

    gaps = sorted(((t - s, s) for s, t in gaps if t > s), reverse=True)[:10]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(
        busy_s=busy / 1e9, window_s=(ns1 - ns0) / 1e9, launches=launches,
        by_name=by_name,
        breakdown=dict(
            device_ops=[[n[:160], v[0] / 1e9] for n, v in ops],
            idle_gaps=[[label(s), d / 1e9] for d, s in gaps]))


def kernel_ns(trace: dict, fragment: str) -> int:
    """Summed device ns of the kernels whose name holds `fragment`."""
    return sum(v[0] for n, v in trace["by_name"].items() if fragment in n)
