"""Cells as data: a cell made only of new files is found by name and runs;
BENCHMARK.json keeps to the contract's names, units and files."""

import json
import re

from conftest import ROOT, write_tiny_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

METRIC = '''
def read(rec):
    return float(len(rec["jobs"]))
'''


def test_a_cell_of_new_files_runs(tmp_path):
    import torch
    torch.set_num_threads(2)
    from portbench import harness
    bench = write_tiny_bench(tmp_path, metric_files={
        "jobs_in_window": METRIC,
        "cloud_patches_per_s": (ROOT / "portbench" / "metrics" /
                                "cloud_patches_per_s.py").read_text()})
    b = json.loads(bench.read_text())
    b["end_to_end"].append({"name": "jobs_in_window", "unit": "jobs",
                            "better": "higher", "bound": 0.01,
                            "source": "host_clock"})
    bench.write_text(json.dumps(b))
    out = harness.run_cell("tiny.one", 17, 600.0, False, "cpu",
                           bench_path=bench)
    assert out["metrics"]["jobs_in_window"]["value"] == 1.0
    assert out["metrics"]["cloud_patches_per_s"]["value"] > 0
    assert out["correct"] is True
    assert out["checks"]["fault_share"]["limit"] == 0.06


def test_benchmark_json_names_units_and_files():
    from portbench import harness
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]] + \
            [k for c in b["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        assert callable(harness.load_metric(m["name"]).read)
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in b["workloads"]}
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists()
        assert c["file"].startswith("portbench/")
    for w in b["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json") \
            .exists()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").exists()
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
