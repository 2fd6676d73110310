"""Host spans: where a reconstruction's host time goes, layer by layer.

Off by default. `enable()` starts recording, `disable()` stops, `reset()`
forgets what was recorded, `records()` returns it: a list of `Span`s in
the order they opened, kept in memory and written nowhere.

    from hpmvs_tpu_torch import trace
    trace.enable()
    engine = pipeline.run_nvm_file(path, opt)
    for s in trace.records():
        print(s.name, s.arg, (s.end - s.start) / 1e6, "ms")

Each span holds its name, its start and end in ns on `time.time_ns()`
(the clock torch.profiler's kineto events carry, so a device idle gap can
be put down to the spans open during it), the index of its parent in
`records()` (-1 at the top; one stack per thread), the job it belongs to
(the index of the `job` span in force, -1 outside one) and an optional
integer `arg` (the priority of a `step`, the rows an `io.save_ply`
wrote), given to `span()` or set on the object it returns inside the
block. The names the port opens are listed in README.md's "Tracing".

With tracing off `span()` returns one shared no-op object: it reads no
clock, allocates nothing and takes no lock (on, each span takes one). `enable(annotate=True)` also
opens a `torch.profiler.record_function` per span, so a profiler's trace
shows the spans above the kernels (the CLI's --profile).

Counters are not kept here: they live in the engine's `stats`.
"""

from __future__ import annotations

import functools
import threading
import time

_on = False
_annotate = False
_records: list = []
_lock = threading.Lock()      # a span's index is its place in _records
_local = threading.local()


class _Noop:
    __slots__ = ()

    # a block may set the arg of the span it opened; the no-op drops it
    arg = property(lambda self: None, lambda self, value: None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """One recorded span, and the context manager that records it."""

    __slots__ = ("name", "arg", "start", "end", "parent", "job", "_rf")

    def __init__(self, name: str, arg=None):
        self.name, self.arg = name, arg
        self.start = self.end = None

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else -1
        with _lock:
            i = len(_records)
            _records.append(self)
        if self.name == "job":
            self.job = i
        else:
            self.job = _records[self.parent].job if st else -1
        st.append(i)
        self._rf = None
        if _annotate:
            import torch
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        st = _stack()
        if st:
            st.pop()
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, arg={self.arg}, start={self.start}, "
                f"end={self.end}, parent={self.parent}, job={self.job})")


def span(name: str, arg=None):
    """A context manager recording `name` while tracing is on; the shared
    no-op object while it is off."""
    if not _on:
        return NOOP
    return Span(name, arg)


def in_job(fn):
    """Run `fn` inside a `job` span unless a job is already in force on
    this thread (pipeline.run_nvm_file opens the job that its run() joins;
    run() called on its own opens one)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not _on:
            return fn(*args, **kwargs)
        st = _stack()
        if st and _records[st[-1]].job >= 0:
            return fn(*args, **kwargs)
        with Span("job"):
            return fn(*args, **kwargs)
    return wrapped


class clocked:
    """Times its block on the span clock whether tracing is on or off (`ns`
    once it has closed) and, while on, records it as the span `name`, from
    the same two clock readings."""

    __slots__ = ("name", "ns", "_span", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.ns = 0

    def __enter__(self):
        self._span = Span(self.name) if _on else None
        if self._span is not None:
            self._span.__enter__()
            self._t0 = self._span.start
        else:
            self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        s = self._span
        if s is not None:
            s.__exit__(*exc)
            self.ns = s.end - self._t0
        else:
            self.ns = time.time_ns() - self._t0
        return False


def enable(annotate: bool = False):
    """Record spans from now on; annotate: each also opens a
    torch.profiler.record_function (about 13 us a span on a CPU core)."""
    global _on, _annotate
    _annotate = bool(annotate)
    _on = True


def disable():
    """Stop recording; what was recorded stays until reset()."""
    global _on, _annotate
    _on = _annotate = False


def reset():
    """Forget every record (call it with no span open)."""
    with _lock:
        _records.clear()
    _stack().clear()


def records() -> list:
    """The spans recorded since the last reset(), in the order they
    opened (a span still open has end None)."""
    return list(_records)
