"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cells, metrics and bounds are in
BENCHMARK.json beside this folder; portbench/harness.py says what a run
does. Exits 1 without a result when CUDA is missing or the cell needs more
GPUs than are visible, when the JAX package or JAX is loaded once the
window has closed, or when the program is not there. The control and the
planted faults, which must turn `correct` false, are portbench/faults.py's.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the program inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"unknown workload {args.workload}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the GPU only",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} GPUs, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), "cuda", t_start=T_START)
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 1
    found = harness.forbidden_modules()
    if found:
        print("JAX or the JAX package is loaded: " + ", ".join(found),
              file=sys.stderr)
        return 1
    rec, verdict = out.pop("_rec"), out.pop("_verdict")
    jobs = rec["jobs"]
    gaps = sum(max(len(j.waves) - 1, 0) for j in jobs)
    print(f"jobs {len(jobs)} (last cut: {jobs[-1].cut}), delivered "
          f"{rec['delivered']} patches in {rec['window_s']} s, first level "
          f"{rec['first_level']}, update intervals {gaps}, card "
          f"{rec['power_limit']}", file=sys.stderr)
    for i, j in enumerate(jobs):
        first = None if j.t_first_cloud is None else j.t_first_cloud - j.t_call
        print(f"job {i}: first cloud {first}, end {j.t_end - j.t_call} s, "
              f"waves {len(j.waves)}, delivered {j.delivered}, cut {j.cut}",
              file=sys.stderr)
    print("reference: " + json.dumps(verdict), file=sys.stderr)
    checks = out.pop("checks")
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
