"""Fault injection for chip_smoke.py's facade_ba_sharded check: does the
comparison of ba_solve_sharded with ba_solve see a wrong all-reduce sum?

Solves a noisy BA problem (chip_smoke.noisy_ba_problem) with ba_solve,
then over 8 shards three times: as it is, with parallel/mesh.psum dropping
the last shard's partial sum, and with psum counting shard 0's twice.
Prints one JSON line per sharded run with chip_smoke.ba_shard_agreement's
measures and tolerances, and exits 1 unless the healthy run agrees and
both faulty runs do not.

    python tools/ba_shard_faults.py           # CPU: tests/test_ba.py's problem
    python tools/ba_shard_faults.py --facade  # GPU: chip_smoke's facade problem

--facade builds the kernels and runs chip_smoke's facade phase first (its
cloud is the problem's points), as chip_smoke.py does before
facade_ba_sharded.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from hpmvs_tpu_torch.parallel import ba  # noqa: E402
from hpmvs_tpu_torch.parallel import mesh as pmesh  # noqa: E402


def cpu_problem():
    """tests/test_ba.py:28-34's problem: 6 cameras x 256 px, 120 points,
    every camera perturbed."""
    from hpmvs_tpu_torch.testing import make_plane_scene, perturb_model
    torch.set_num_threads(1)
    scene = make_plane_scene(n_cams=6, imgsize=256, n_points=120, seed=17)
    pert = perturb_model(scene.model, np.random.default_rng(3))
    return pert, ba.build_problem(pert, device="cpu"), "cpu"


def facade_problem():
    chip_smoke.build_phase()
    sc = chip_smoke.render_facade()
    eng = chip_smoke.facade_phase("cuda", sc, "facade", "default",
                                  chip_smoke.FACADE_MAX_TREE_LEVEL,
                                  chip_smoke.FACADE_BUDGET_S, keep=True)
    pert, prob = chip_smoke.facade_ba_problem("cuda", eng)
    return pert, prob, "cuda"


def main():
    pert, prob, dev = facade_problem() if sys.argv[1:] == ["--facade"] \
        else cpu_problem()
    prob = chip_smoke.noisy_ba_problem(prob, dev)
    n_cams, n_pts = len(pert.cameras), len(prob.pts0)
    kw = dict(iters=8, cg_iters=40, fix_count=2)
    ref = ba.ba_solve(prob, n_cams, n_pts, device=dev, **kw)
    mesh = pmesh.make_mesh([dev] * chip_smoke.BA_SHARDED_SHARDS)
    sp = ba.shard_problem(prob, mesh.size)
    psum = pmesh.psum
    faults = {
        "none": psum,
        "drop_last_shard": lambda parts: psum(
            list(parts[:-1]) + [torch.zeros_like(parts[-1])]),
        "shard_0_twice": lambda parts: psum([parts[0] * 2]
                                            + list(parts[1:])),
    }
    ok = True
    for name, fn in faults.items():
        pmesh.psum = fn
        try:
            out = ba.ba_solve_sharded(mesh, sp, n_cams, n_pts, **kw)
        finally:
            pmesh.psum = psum
        m = chip_smoke.ba_shard_agreement(ref, out)
        print(json.dumps({"fault": name, "device": dev,
                          "measurements": int(prob.m_cam.shape[0]), **m}),
              flush=True)
        ok &= m["agree"] == (name == "none")
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
