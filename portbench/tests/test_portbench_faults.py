"""The comparison that decides `correct` fails every planted fault: a tiny
cell driven through the harness with the CPU twins (the look for a GPU is
run.py's and is skipped here). The TF32 control moves a projection by a
share of its pixel coordinate, too little to read at a tiny cell's 128 px:
it is held to failing at the cell's own size on the card
(test_portbench_cuda.py); here its rounding and its removal are checked."""

import pytest

from portbench import faults
from conftest import TINY_CONFIG


def _run(bench, **kw):
    from portbench import harness
    return harness.run_cell("tiny.one", 11, 600.0, False, "cpu",
                            bench_path=bench, **kw)


def test_sound_run_is_correct(tiny_bench):
    out = _run(tiny_bench)
    assert out["correct"] is True


def test_tf32_control_rounds_operands_and_comes_off():
    import torch
    from hpmvs_tpu_torch.ops import gn, score
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -3.14159265,
                      2048.5], dtype=torch.float32)
    assert faults.to_tf32(x).tolist() == [1.0, 1.0, 1 + 2 ** -9, -3.140625,
                                          2048.0]
    v = torch.randn(4096) * 100
    rel = (faults.to_tf32(v) - v).abs() / v.abs()
    assert float(rel.max()) <= 2 ** -11
    g0, s0 = gn.gn_refine, score.sample_windows
    undo = faults.plant("tf32", 0.0)
    try:
        assert gn.gn_refine is not g0 and score.sample_windows is not s0
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        undo()
    assert gn.gn_refine is g0 and score.sample_windows is s0
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_planted_fault_is_not_correct(tiny_bench, fault):
    shift = TINY_CONFIG["guarantees"]["fault_shift"]
    out = _run(tiny_bench, plant=lambda: faults.plant(fault, shift))
    assert out["correct"] is False, out["checks"]
