"""Tests of the benchmark harness (CPU, tiny sizes, the program's plain
PyTorch twins): python -m pytest portbench/tests -q from the repo root.
Tests marked `cuda` need the GPU and skip without one:
python -m pytest portbench/tests -q -m cuda on the GPU host."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


TINY_CONFIG = {
    "name": "tiny",
    "generator": "facade",
    "generator_args": {"n_cams": 6, "imgsize": 128, "n_points": 80,
                       "arc_deg": 60.0},
    "options": {"MAXLEVEL": 2, "START_LEVEL": 1, "COVIS_MIN_POINTS": 5,
                "MAX_TREE_LEVEL": 7, "BATCH": 256},
    "mesh": None,
    "guarantees": {"min_images": 3, "ncc_min": 0.5, "max_angle_deg": 60.0,
                   "max_level": 1, "surface_tol": 0.03, "surface_scales": 0.0,
                   "colour_tol": 16.0,
                   "visibility_tol": 0.05, "zbuf_px": 4, "cell_margin": 1.5,
                   "fault_shift": 0.1},
}
# sound tiny.one runs read 0.018-0.023, the planted faults 0.09-0.41 (CPU,
# seeds 11, 22, 33)
TINY_LIMIT = 0.06


def write_tiny_bench(folder: Path, traffic=None, metric_files=None) -> Path:
    """A benchmark of one tiny cell made only of files in `folder`:
    BENCHMARK.json, configs/tiny.json, traffic/one.json (one whole job),
    limits/tiny.one.json, and metrics/ when `metric_files` are given
    ({name: source}). Returns the BENCHMARK.json path."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (folder / "configs").mkdir(parents=True, exist_ok=True)
    (folder / "traffic").mkdir(exist_ok=True)
    (folder / "limits").mkdir(exist_ok=True)
    (folder / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (folder / "traffic" / "one.json").write_text(json.dumps(
        traffic or {"jobs": 1}))
    (folder / "limits" / "tiny.one.json").write_text(
        json.dumps({"fault_share": TINY_LIMIT}))
    bench["configs"] = [{"name": "tiny", "source": "tests",
                         "file": "configs/tiny.json", "reduced": [],
                         "why": "tests"}]
    bench["workloads"] = [{"name": "tiny.one", "config": "tiny",
                           "traffic": "one", "chips": 1, "why": "tests"}]
    # every metric of the benchmark once, in the tiny cell
    for part in ("end_to_end", "per_layer"):
        bench[part] = [dict(m) for m in bench[part]]
        for m in bench[part]:
            m.pop("workloads", None)
    if metric_files:
        (folder / "metrics").mkdir(exist_ok=True)
        for name, src in metric_files.items():
            (folder / "metrics" / f"{name}.py").write_text(src)
        for part in ("end_to_end", "per_layer"):
            bench[part] = [m for m in bench[part]
                           if (folder / "metrics" / f"{m['name']}.py")
                           .exists()]
    path = folder / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture
def tiny_bench(tmp_path):
    import torch
    torch.set_num_threads(2)
    return write_tiny_bench(tmp_path)
