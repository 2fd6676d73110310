"""On the card: the tiny cell's kernels run (no twin) and its traced run
reads every per-layer metric; the TF32 control turns `correct` false in
each cell of BENCHMARK.json at its own size (one job, ~1.5 min). Skips
without a GPU (decided inside each test)."""

import json

import pytest

from conftest import ROOT, write_tiny_bench

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_tiny_cell_traced_on_the_card(tmp_path):
    _card()
    from hpmvs_tpu_torch import kernels
    from portbench import harness
    bench = write_tiny_bench(tmp_path)
    kernels.reset_counts()
    out = harness.run_cell("tiny.one", 23, 600.0, True, "cuda",
                           bench_path=bench)
    assert out["correct"] is True
    assert kernels.STATS["gn"].launches > 0
    assert all(st.twin_calls == 0 for st in kernels.STATS.values())
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    for name in ("device.idle_pct", "device.launches_per_kpatch",
                 "kernels.copy_roofline_pct", "kernels.gn_ms_per_kpatch"):
        assert name in out["metrics"], name
    assert 0 < out["metrics"]["kernels.copy_roofline_pct"]["value"] <= 105


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_fails_at_the_cells_size(cell):
    _card()
    from portbench import faults, harness
    out = harness.run_cell(cell, 2001000002, 1.0, False, "cuda",
                           plant=lambda: faults.plant("tf32", 0.0))
    assert out["correct"] is False, out["checks"]
