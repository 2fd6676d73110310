"""The six readers of the program's spans (portbench/metrics/: load,
io.ply, cells, enqueue, depth, host.wait) against hand-computed values on a
hand-built list of spans, and a traced run of the tiny CPU cell in which
every one of them reads a number."""

from types import SimpleNamespace

import pytest

from conftest import write_tiny_bench

READERS = ("load.s_per_job", "io.ply_s_per_job", "cells.host_ms_per_kcell",
           "enqueue.ms_per_kpatch", "depth.host_ms_per_kpatch",
           "host.wait_pct")

MS = 1_000_000


def _spans():
    """Two jobs; times in ms. (name, start, end, parent, arg)"""
    rows = [
        ("job", 0, 1000, -1, None),                  # 0
        ("load", 0, 100, 0, None),                   # 1
        ("load.nvm", 0, 10, 1, None),                # 2
        ("load.seed", 10, 100, 1, None),             # 3
        ("dispatch", 20, 60, 3, None),               # 4 (outside any step)
        ("wait", 50, 60, 4, None),                   # 5
        ("step", 100, 700, 0, 0),                    # 6
        ("cells.extend", 100, 500, 6, None),         # 7
        ("dispatch", 120, 320, 7, None),             # 8
        ("dispatch", 130, 150, 8, None),             # 9: a flush inside 8
        ("wait", 140, 150, 9, None),                 # 10
        ("opt.refine", 160, 200, 8, None),           # 11
        ("depth.gates", 200, 230, 8, None),          # 12
        ("depth.updates", 230, 240, 8, None),        # 13
        ("wait", 280, 320, 8, None),                 # 14
        ("cells.branch", 500, 690, 6, None),         # 15
        ("dispatch", 510, 530, 15, None),            # 16
        ("wait", 520, 530, 16, None),                # 17
        ("hook", 690, 695, 6, None),                 # 18
        ("io.save_ply", 700, 900, 0, None),          # 19
        ("job", 1000, 1500, -1, None),               # 20
        ("load", 1000, 1040, 20, None),              # 21
        ("step", 1040, 1440, 20, 0),                 # 22
        ("cells.regularize", 1040, 1140, 22, None),  # 23
        ("io.save_ply", 1440, 1500, 20, None),       # 24
    ]
    out = []
    for name, a, b, parent, arg in rows:
        job = len(out) if name == "job" else out[parent].job
        out.append(SimpleNamespace(name=name, start=a * MS, end=b * MS,
                                   parent=parent, job=job, arg=arg))
    return out


REC = {"jobs": [SimpleNamespace(stats={"cells_processed": 3000,
                                       "patches_optimized": 8000}),
                SimpleNamespace(stats={"cells_processed": 1000,
                                       "patches_optimized": 2000})]}

# load: (100 + 40) ms over 2 jobs; PLY: (200 + 60) ms over 2 jobs;
# cells: 400 + 190 + 100 ms less the dispatches right under them (200 +
# 20; 9 is inside 8) over 4 kcells; enqueue: the outermost dispatches 40 +
# 200 + 20 less their waits 10 + 10 + 40 + 10 (190 ms) over 10 kpatches;
# depth: 30 + 10 over 10 kpatches; wait: the waits inside steps 10 + 40 +
# 10 over the steps 600 + 400
EXPECTED = {"load.s_per_job": 0.07, "io.ply_s_per_job": 0.13,
            "cells.host_ms_per_kcell": 470 / 4, "enqueue.ms_per_kpatch": 19.0,
            "depth.host_ms_per_kpatch": 4.0, "host.wait_pct": 6.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_hand_built_spans(name):
    from portbench import harness
    mod = harness.load_metric(name)
    assert mod.value(_spans(), REC) == pytest.approx(EXPECTED[name],
                                                    rel=1e-12)
    assert mod.value([], REC) is None


def test_traced_tiny_cell_reads_all_six(tmp_path):
    import torch
    torch.set_num_threads(2)
    from hpmvs_tpu_torch import trace
    from portbench import harness
    bench = write_tiny_bench(tmp_path)
    try:
        out = harness.run_cell("tiny.one", 2 ** 31 + 12345, 600.0, True,
                               "cpu", bench_path=bench)
    finally:
        trace.disable()
        trace.reset()
    for name in READERS:
        assert out["metrics"][name]["value"] > 0, name
    assert out["metrics"]["host.wait_pct"]["value"] < 100
