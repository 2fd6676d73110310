"""hpmvs_tpu_torch/timing.py (device time and call time of a kernel) and the
tool that times two trees with it. The timing itself needs a CUDA device
(chip_smoke.py and tests/test_torch_kernels_cuda.py run it); here, on the
CPU, the property tools/compare_kernels.py relies on: timing.py needs torch
only, so the tool can load it by file path into a process that imports the
port from another tree."""

import ast
import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_timing_imports_torch_only():
    tree = ast.parse((ROOT / "hpmvs_tpu_torch" / "timing.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "statistics", "time", "torch"}, names


def test_compare_tool_loads_this_trees_timing():
    spec = importlib.util.spec_from_file_location(
        "compare_kernels", ROOT / "tools" / "compare_kernels.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    time_ms, call_ms = tool.timing_funcs()
    path = str(ROOT / "hpmvs_tpu_torch" / "timing.py")
    assert time_ms.__code__.co_filename == path
    assert call_ms.__code__.co_filename == path
    assert time_ms.__name__ == "time_ms" and call_ms.__name__ == "call_ms"
