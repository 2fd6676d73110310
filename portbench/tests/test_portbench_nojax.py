"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole: hpmvs_tpu_torch is not hpmvs_tpu), and the reference loads nothing
of the program."""

import subprocess
import sys

from conftest import ROOT

CELL = """
import sys, torch
from pathlib import Path
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
torch.set_num_threads(2)
from conftest import write_tiny_bench
from portbench import harness
bench = write_tiny_bench(Path({tmp!r}))
out = harness.run_cell("tiny.one", 4, 600.0, False, "cpu", bench_path=bench)
assert out["attempted"] == 1
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import portbench.reference, portbench.scenes
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(code):
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    return set(eval(res.stdout.strip().splitlines()[-1]))


def test_a_cell_loads_no_jax(tmp_path):
    names = _top_level(CELL.format(root=str(ROOT), tmp=str(tmp_path),
                                   tests=str(ROOT / "portbench" / "tests")))
    assert "hpmvs_tpu_torch" in names          # the program did run
    assert not names & {"jax", "jaxlib", "flax", "hpmvs_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE.format(root=str(ROOT)))
    assert not names & {"jax", "jaxlib", "flax", "hpmvs_tpu",
                        "hpmvs_tpu_torch"}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "hpmvs_tpu_torch_x", sys)
    assert "hpmvs_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hpmvs_tpu.fake", sys)
    assert harness.forbidden_modules() == ["hpmvs_tpu"]
