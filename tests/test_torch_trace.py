"""The port's span recorder (hpmvs_tpu_torch/trace.py) on the CPU, over a
small plane (4 cameras x 64 px, 30 points, MAX_TREE_LEVEL 4, two exact-J
iterations) run to its end through pipeline.run_nvm_file, once with
tracing off and once on: off records nothing and its span() is one shared
object that reads no clock; on records every span name the port opens,
each inside its parent, all under one job; the `dispatch` spans sum to the
engine's t_device; the alive cloud is the same bits either way; a torch op
inside a span lies inside it on torch.profiler's clock."""

import numpy as np
import pytest
import torch

from hpmvs_tpu_torch import trace
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.io import nvm as pnvm
from hpmvs_tpu_torch.runtime import pipeline
from hpmvs_tpu_torch.testing import make_plane_scene

from torch_parity import plane_options

torch.set_num_threads(1)

NAMES = {"job", "load", "load.nvm", "load.images", "load.scene", "load.seed",
         "step", "cells.filter", "cells.extend", "cells.regularize",
         "cells.remove", "cells.branch", "dispatch", "opt.pre", "opt.refine",
         "opt.post", "depth.updates", "depth.gates", "wait", "io.save_ply",
         "hook"}


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    ps = make_plane_scene(n_cams=4, imgsize=64, n_points=30, seed=2,
                          out_dir=str(d / "img"))
    nvm = str(d / "scene.nvm")
    pnvm.save_nvm(nvm, [ps.model])
    return ps, nvm, d


def _opt(folder, **kw):
    return plane_options(Options, OUTFOLDER=str(folder), MAX_TREE_LEVEL=4,
                         LM_ITERS_EXACT=2, **kw)


def _run(plane, name, on, **kw):
    _, nvm, d = plane
    trace.reset()
    if on:
        trace.enable()
    try:
        eng = pipeline.run_nvm_file(nvm, _opt(d / name), device="cpu",
                                    wave_hook=lambda e: None,
                                    snapshot_hook=lambda e, p: None, **kw)
    finally:
        trace.disable()
    recs = trace.records()
    trace.reset()
    return eng, recs


@pytest.fixture(scope="module")
def runs(plane):
    return _run(plane, "off", False), _run(plane, "on", True)


def test_off_span_is_one_shared_object_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(trace.time, "time_ns", no_clock)
    a, b = trace.span("step", 3), trace.span("wait")
    assert a is b is trace.NOOP
    with a:
        pass
    assert trace.records() == []


def test_off_run_records_nothing(runs):
    (_, recs), _ = runs
    assert recs == []


def test_on_run_records_every_name(runs):
    _, (_, recs) = runs
    assert {s.name for s in recs} == NAMES


def test_children_lie_inside_their_parents_in_one_job(runs):
    _, (_, recs) = runs
    jobs = [i for i, s in enumerate(recs) if s.name == "job"]
    assert len(jobs) == 1
    for s in recs:
        assert s.start <= s.end
        assert s.job == jobs[0]
        if s.parent >= 0:
            p = recs[s.parent]
            assert p.start <= s.start and s.end <= p.end, (p, s)
        else:
            assert s.name == "job"
    steps = [s.arg for s in recs if s.name == "step"]
    assert steps == list(range(len(steps)))
    top = {s.name for s in recs if s.parent == jobs[0]}
    assert top == {"load", "step", "io.save_ply", "hook"}


def test_dispatch_spans_sum_to_t_device(runs):
    _, (eng, recs) = runs
    ns = sum(s.end - s.start for s in recs if s.name == "dispatch")
    assert abs(ns / 1e9 - eng.stats["t_device"]) < 1e-6
    assert not [k for k in eng.stats if k.startswith("t_phase")]


def test_alive_cloud_is_the_same_bits_with_tracing_on(runs):
    (off, _), (on, _) = runs
    a, b = off.alive_arrays(), on.alive_arrays()
    assert len(a[0]) > 50
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_save_spans_carry_the_rows_written(runs):
    """Each io.save_ply span's arg is the rows its file holds; the last is
    the final cloud's."""
    _, (eng, recs) = runs
    saves = [s for s in recs if s.name == "io.save_ply"]
    assert len(saves) >= 2
    assert all(type(s.arg) is int and s.arg >= 0 for s in saves)
    assert saves[-1].arg == eng.n_alive() > 50


def test_two_runs_give_two_job_ids(plane):
    """run_nvm_file's job and run()'s own, each holding its spans."""
    ps, nvm, d = plane
    trace.reset()
    trace.enable()
    try:
        pipeline.run_nvm_file(nvm, _opt(d / "j1"), device="cpu", max_prio=1)
        pipeline.run(ps.model, _opt(d / "j2"), images=ps.images,
                     device="cpu", max_prio=1)
    finally:
        trace.disable()
    recs = trace.records()
    trace.reset()
    jobs = [i for i, s in enumerate(recs) if s.name == "job"]
    assert len(jobs) == 2
    assert {s.job for s in recs} == set(jobs)
    for j in jobs:
        names = {s.name for s in recs if s.job == j}
        assert {"load", "load.seed", "step", "io.save_ply"} <= names
    assert "load.nvm" in {s.name for s in recs if s.job == jobs[0]}
    assert "load.nvm" not in {s.name for s in recs if s.job == jobs[1]}


def test_a_torch_op_lies_inside_its_span_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(128, 128)
    trace.reset()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("outer"):
                a @ a
    finally:
        trace.disable()
    (s,) = trace.records()
    trace.reset()
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    e = mm[0]
    assert s.start <= e.start_ns()
    assert e.start_ns() + e.duration_ns() <= s.end


def test_spans_from_many_threads_keep_their_own_parents():
    """Each thread's spans nest under that thread's own spans, and no two
    spans share an index (more threads than cores, a short switch
    interval)."""
    import sys
    import threading

    def work(k):
        for _ in range(200):
            with trace.span(f"t{k}"):
                with trace.span(f"t{k}.child"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.reset()
    trace.enable()
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        trace.disable()
        sys.setswitchinterval(old)
    recs = trace.records()
    trace.reset()
    assert len(recs) == 16 * 200 * 2
    for s in recs:
        if s.name.endswith(".child"):
            assert recs[s.parent].name == s.name[:-len(".child")]
        else:
            assert s.parent == -1
