"""Two times of a function on the card: device time alone and one call.

time_ms: the function's kernels alone on the device, from a run of
back-to-back calls behind a sleeping stream. call_ms: one call on an idle
stream, as the main path pays it, the host's work in the wrapper included.
Their difference is the wrapper's host cost. This module needs torch only,
so tools/compare_kernels.py can time another tree's kernels with it.
"""

from __future__ import annotations

import statistics
import time

import torch


class _Sleep:
    cycles_per_ms = None


def _sleep_cycles_per_ms() -> float:
    """Clock cycles of torch.cuda._sleep per millisecond on this card,
    measured once with CUDA events."""
    if _Sleep.cycles_per_ms is None:
        cycles = 20_000_000
        torch.cuda._sleep(cycles // 10)           # wake the clocks
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        _Sleep.cycles_per_ms = cycles / a.elapsed_time(b)
    return _Sleep.cycles_per_ms


def time_ms(fn, reps: int = 20, runs: int = 5, warmup: int = 2) -> float:
    """Device time of one fn() (all the launches it makes), in ms: the
    median over `runs` of (CUDA-event time of `reps` back-to-back calls) /
    reps, after `warmup` calls.

    Each run first enqueues torch.cuda._sleep long enough to cover the
    host's enqueue of the reps calls (twice the host time they took in
    warm-up, at least 0.1 ms a call), so the events see a backed-up stream
    and no host time: only the kernels' own time and the gaps between
    back-to-back launches. A run whose enqueue outlasted its sleep (the
    device waited on the host, or fn synchronised) is taken again with a
    longer sleep. The inputs are those the main path leaves: just written,
    and so warm in the H100's 50 MB L2, as every call after the first also
    finds them."""
    t = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t) / max(warmup, 1)
    sleep_ms = reps * max(2e3 * host_s, 0.1)
    times = []
    while len(times) < runs:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_ms * _sleep_cycles_per_ms()))
        a.record()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        b.record()
        enqueue_ms = 1e3 * (time.perf_counter() - t)
        b.synchronize()
        if enqueue_ms >= sleep_ms:
            if sleep_ms > 1e4:
                raise RuntimeError("time_ms: fn keeps the host behind the "
                                   "device (does it synchronise?)")
            sleep_ms *= 4
            continue
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def call_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Time of one call as the main path pays it, in ms: CUDA events around
    a single fn() on an idle stream, so the host's work before the first
    launch (argument checks, allocation, the ctypes call) is inside it.
    Median of reps after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
