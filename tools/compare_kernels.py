"""Time the port's copy and sampling kernels (fetch, score, permute) of two
trees on one card, in turns: other, this, this, other.

    python3 tools/compare_kernels.py <root of the other tree>

Both trees run the same inputs: the main path's tensors for chip_smoke.py's
plane batch (B=2048, K=8, W=12), made once by this tree and saved under
build/compare/. Each run is a process of its own that imports the port
from its tree (and builds that tree's kernels into its build/), and times
every function with this tree's hpmvs_tpu_torch/timing.py, loaded by file
path: time_ms (device time, from a backed-up stream) and call_ms (one call,
host work included), so a tree that predates them is timed the same way.
Prints the card (nvidia-smi), one JSON line per run, then whether the two
trees' fetch, texture and colour outputs are torch.equal. Needs a CUDA
device.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
WORK = HERE / "build" / "compare"
INPUTS = WORK / "inputs.pt"


def timing_funcs():
    """time_ms and call_ms from this tree's timing.py (it needs torch only,
    whatever tree the process imports the port from)."""
    spec = importlib.util.spec_from_file_location(
        "compare_timing", HERE / "hpmvs_tpu_torch" / "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.time_ms, mod.call_ms


def make_inputs():
    import torch
    sys.path.insert(0, str(HERE))
    import chip_smoke
    from hpmvs_tpu_torch import kernel_check
    opt, _, scene, batch = chip_smoke.plane_setup("cuda")
    b1, b2, b3, _ = kernel_check.main_path_inputs(scene.ctx, opt, *batch)
    WORK.mkdir(parents=True, exist_ok=True)
    torch.save({"b1": b1, "b2": b2, "b3": b3}, INPUTS)


def run_tree(root: Path, tag: str):
    import torch
    sys.path.insert(0, str(root))
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.ops import fetch, score
    time_ms, call_ms = timing_funcs()
    kernels.lib()
    d = torch.load(INPUTS)
    b1, b2, b3 = d["b1"], d["b2"], d["b3"]
    fns = {"fetch": lambda: fetch.fetch_windows(**b1),
           "score": lambda: score.sample_windows(b2["geom"], b2["win"], True),
           "permute": lambda: score.permute_windows(**b3)}
    out = {name: {"device_ms": time_ms(fn, reps=20),
                  "call_ms": call_ms(fn, reps=10)}
           for name, fn in fns.items()}
    tex, col = fns["score"]()
    torch.save({"tex": tex, "col": col, "fetch": fns["fetch"]()},
               WORK / f"out_{tag}.pt")
    print("RESULT " + json.dumps(out), flush=True)


def main():
    if sys.argv[1] == "--tree":
        run_tree(Path(sys.argv[2]), sys.argv[3])
        return
    other = Path(sys.argv[1]).resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    make_inputs()
    order = ((other, "other"), (HERE, "this"), (HERE, "this"),
             (other, "other"))
    for i, (root, tag) in enumerate(order):
        r = subprocess.run([sys.executable, __file__, "--tree", str(root),
                            f"{tag}{i}"], capture_output=True, text=True,
                           cwd=str(root))
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
        if r.returncode or not line:
            raise SystemExit(f"{tag} run failed:\n{r.stdout[-2000:]}\n"
                             f"{r.stderr[-4000:]}")
        print(json.dumps({"run": i, "tree": tag, **json.loads(line[0][7:])}),
              flush=True)
    import torch
    a = torch.load(WORK / "out_other0.pt")
    b = torch.load(WORK / "out_this1.pt")
    print(json.dumps({k: torch.equal(a[k], b[k])
                      for k in ("fetch", "tex", "col")}), flush=True)


if __name__ == "__main__":
    main()
