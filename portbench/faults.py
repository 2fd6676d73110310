"""The control and the faults planted under the timed path, to show that
the comparison turns `correct` false when the program computes below the
precision its configuration states or is broken. Never used by the
benchmark's own runs.

  tf32      -- the control: the configuration states float32 with TF32 off,
               so the nearest precision below is TF32. Torch's TF32
               switches go on (the program's own, which it turns off at
               import), and the refine and score kernels take and give
               their floating-point operands at TF32's precision (10
               explicit mantissa bits, rounded to nearest even), as kernels
               moved onto TF32 tensor cores would: every floating-point
               input of the GN kernel (`ops.gn.gn_refine`) and of the
               score kernel (`ops.score.sample_windows`) is rounded before
               the launch and every output after it;
  unchanged -- the GN refinement returns its state unchanged: every lane's
               centre and normal come back as they went in, accepted;
  half      -- half of each refined batch left out: lanes in its second
               half come back unrefined, accepted;
  altered   -- an answer altered where it is produced: the optimizer moves
               every other lane's centre along its normal by `shift` and
               darkens its colour by 64 of 255.

    python3 portbench/faults.py --workload <cell> --seconds <s> \
        --runs sound:<seed>,tf32:<seed>,half:<seed>,... [--out <file>]

runs each (plant, seed) at the cell's own size in one process (one scene,
warm-up and window each; `sound` plants nothing) and prints one JSON line
per run with every number the reference computed, appended to --out too.
portbench/tests/test_portbench_faults.py drives a tiny cell with each.
"""

from __future__ import annotations

import sys


def to_tf32(t):
    """float32 `t` rounded to TF32's 10 explicit mantissa bits (nearest,
    ties to even); other tensors as they are."""
    import torch
    if not (torch.is_tensor(t) and t.dtype == torch.float32):
        return t
    b = t.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & -8192
    return b.view(torch.float32)


def _tf32_control():
    import torch
    from hpmvs_tpu_torch.ops import gn, score
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    g0, s0 = gn.gn_refine, score.sample_windows

    def gn_refine(st, **args):
        out = g0(st, **{k: to_tf32(v) for k, v in args.items()})
        return tuple(to_tf32(o) for o in out)

    def sample_windows(geom, win, with_color=False):
        out = s0(to_tf32(geom), to_tf32(win), with_color)
        return tuple(to_tf32(o) for o in out)

    gn.gn_refine, score.sample_windows = gn_refine, sample_windows

    def undo():
        gn.gn_refine, score.sample_windows = g0, s0
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return undo


def plant(name: str, shift: float):
    """Install the control or fault `name` in the program; returns a
    function that removes it."""
    import torch
    from hpmvs_tpu_torch.ops import gn, optimizer
    if name == "tf32":
        return _tf32_control()
    if name in ("unchanged", "half"):
        orig = gn.gn_refine_batch

        def refine(ctx, opt, center, normal, scale, views, ws):
            c, n, ok, f = orig(ctx, opt, center, normal, scale, views, ws)
            keep = torch.ones_like(ok) if name == "unchanged" else \
                torch.arange(len(ok), device=ok.device) >= (len(ok) + 1) // 2
            nv = torch.sum(views >= 0, dim=1) >= opt.MIN_IMAGES_PER_PATCH
            c = torch.where(keep[:, None], center, c)
            n = torch.where(keep[:, None], normal, n)
            ok = torch.where(keep, nv, ok)
            return c, n, ok, torch.where(keep, torch.zeros_like(f), f)

        gn.gn_refine_batch = refine
        return lambda: setattr(gn, "gn_refine_batch", orig)
    if name == "altered":
        orig = optimizer._optimize_all

        def optimize_all(ctx, opt, center, normal, scale, views):
            oc, on, os_, ov, ok, col, res = orig(ctx, opt, center, normal,
                                                 scale, views)
            odd = (torch.arange(len(ok), device=ok.device) % 2 == 1)[:, None]
            oc = torch.where(odd, oc + shift * on, oc)
            col = torch.where(odd, torch.clamp(col - 64.0, min=0.0), col)
            return oc, on, os_, ov, ok, col, res

        optimizer._optimize_all = optimize_all
        return lambda: setattr(optimizer, "_optimize_all", orig)
    raise ValueError(f"unknown fault {name}")


FAULTS = ("unchanged", "half", "altered")
PLANTS = ("tf32",) + FAULTS


def main(argv=None) -> int:
    import argparse
    import json
    import os
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / "build" / "torch_extensions"))
    sys.path.insert(0, str(root))
    from portbench import harness
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--runs", required=True,
                    help="comma-separated <plant>:<seed>, plant one of "
                         "sound, " + ", ".join(PLANTS))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload, False, root / "BENCHMARK.json")
    shift = cell.config["guarantees"]["fault_shift"]
    runs = [r.split(":") for r in args.runs.split(",")]
    for name, _ in runs:
        if name != "sound" and name not in PLANTS:
            ap.error(f"unknown plant {name}")
    for name, seed in runs:
        out = harness.run_cell(
            args.workload, int(seed), args.seconds, False, "cuda",
            plant=None if name == "sound" else
            (lambda n=name: plant(n, shift)))
        rec = out.pop("_rec")
        line = json.dumps(dict(
            plant=name, seed=int(seed), correct=out["correct"],
            checks=out["checks"], verdict=out.pop("_verdict"),
            delivered=rec["delivered"], window_s=rec["window_s"],
            setup_s=rec["setup_s"]))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
