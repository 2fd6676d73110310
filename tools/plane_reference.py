"""Reference counts for chip_smoke.py's plane phases, measured on the CPU.

Runs the JAX package's engine (single device) on chip_smoke.py's plane
scene and Options -- bench.py's plane: 7 cameras x 512 px, 400 SfM points,
START_LEVEL=2, MAX_VIEWS=8, COVIS_MIN_POINTS=30 -- with the given Options
switches, and prints one JSON line: alive patches, the fraction within 0.02
of the plane, patches optimised, wall seconds, dispatches and the wave
counters. The wave switches default to the JAX package's defaults
(WAVE_DEPTH=4, WAVE_LOOKAHEAD=True); --wave_depth 1 --no_lookahead gives the
classic engine. With --port it runs hpmvs_tpu_torch on the CPU (its kernels'
twins) with the same switches too. --scene picks another scene: "small",
the small plane of the port's engine tests (tests/torch_parity.py: 4
cameras x 128 px, 30 points, START_LEVEL=1, MAXLEVEL=3, MAX_VIEWS=6,
COVIS_MIN_POINTS=10, LM_ITERS=6), whose JAX counts
tests/test_torch_deepwave.py pins; "facade", tests/test_facade.py's facade
(11 cameras x 256 px, 160 points, START_LEVEL=2, MAX_VIEWS=8,
COVIS_MIN_POINTS=10, MAX_TREE_LEVEL=8, PATCH_FINAL_MINLEVEL=4, images in
memory), its accuracy the fraction within 0.02 of the wedge.

    JAX_PLATFORMS=cpu python tools/plane_reference.py FAST_SETREF=False \\
        LM_EXACT_J=False [--wave_depth N] [--no_lookahead] [--port] [--kernel]
        [--scene plane|small|facade]

On the CPU the JAX engine refines with its plain XLA refiner
(optimizer._optimize_patch), not with its GN kernel: with LM_EXACT_J=False
that is the FD refiner without the kernel's early stop and FD-step shrink.
--kernel runs it instead on the path it takes on a TPU, with the GN kernel
in pallas interpret mode (as tests/test_torch_optimizer.py does); that is
the algorithm the port runs.
"""

import argparse
import ast
import dataclasses
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# scene -> (make_*_scene keywords, Options)
SCENES = {
    "plane": (dict(n_cams=7, imgsize=512, n_points=400, seed=0),
              dict(START_LEVEL=2, MAX_VIEWS=8, COVIS_MIN_POINTS=30)),
    "small": (dict(n_cams=4, imgsize=128, n_points=30, seed=2),
              dict(START_LEVEL=1, MAXLEVEL=3, MAX_VIEWS=6,
                   COVIS_MIN_POINTS=10, LM_ITERS=6)),
    "facade": (dict(n_cams=11, imgsize=256, n_points=160, seed=0),
               dict(START_LEVEL=2, MAX_VIEWS=8, COVIS_MIN_POINTS=10,
                    MAX_TREE_LEVEL=8, PATCH_FINAL_MINLEVEL=4)),
}
WAVE_STATS = ("dispatches", "lookahead_hits", "lookahead_misses",
              "disp_deep", "deep_gens_consumed", "deep_fallbacks",
              "spec_waste_lanes")


def _run(pipeline_mod, options_cls, ps, dist, base, switches, out, **kw):
    opt = dataclasses.replace(options_cls(), **base, **switches,
                              OUTFOLDER=out)
    t = time.time()
    eng = pipeline_mod.run(ps.model, opt, images=ps.images, **kw)
    wall = time.time() - t
    c = eng.alive_arrays()[0]
    st = eng.stats
    return dict(alive=int(eng.n_alive()),
                frac_within_002=float((dist(c) < 0.02).mean()),
                patches_optimized=int(st["patches_optimized"]),
                wall_s=wall, hist=[int(x) for x in eng.tree.histogram()],
                **{k: int(st[k]) for k in WAVE_STATS},
                deep_fb=[int(st[k]) for k in ("deep_fb_overflow",
                                              "deep_fb_mismatch",
                                              "deep_fb_dead")])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("switches", nargs="*", help="Options NAME=VALUE")
    ap.add_argument("--port", action="store_true",
                    help="also run hpmvs_tpu_torch on the CPU")
    ap.add_argument("--wave_depth", type=int, default=None,
                    help="WAVE_DEPTH (default: the JAX package's)")
    ap.add_argument("--no_lookahead", action="store_true",
                    help="WAVE_LOOKAHEAD=False (default: the JAX package's)")
    ap.add_argument("--kernel", action="store_true",
                    help="JAX engine on its TPU path: the GN kernel in "
                         "interpret mode")
    ap.add_argument("--scene", choices=sorted(SCENES), default="plane")
    args = ap.parse_args(argv)
    switches = {k: ast.literal_eval(v) for k, v in
                (s.split("=", 1) for s in args.switches)}
    import jax
    jax.config.update("jax_platforms", "cpu")
    from hpmvs_tpu.config import Options as JOptions
    from hpmvs_tpu.runtime import pipeline as jpipe
    if args.kernel:
        import functools
        from hpmvs_tpu.ops import optimizer as jopt
        from hpmvs_tpu.ops import pallas_gn
        jopt._use_pallas_gn = lambda opt: opt.USE_PALLAS_GN and opt.USE_WINDOWS
        pallas_gn.gn_refine_batch = functools.partial(
            pallas_gn.gn_refine_batch, interpret=True)
    import numpy as np
    from hpmvs_tpu import testing
    jdef = JOptions()
    switches["WAVE_DEPTH"] = (jdef.WAVE_DEPTH if args.wave_depth is None
                              else args.wave_depth)
    switches["WAVE_LOOKAHEAD"] = (jdef.WAVE_LOOKAHEAD
                                  and not args.no_lookahead)
    scene_kw, base = SCENES[args.scene]
    if args.scene == "facade":
        ps = testing.make_facade_scene(**scene_kw)

        def dist(c):
            return testing.facade_surface_dist(c, ps.slope)
    else:
        ps = testing.make_plane_scene(**scene_kw)

        def dist(c):
            return np.abs(c[:, 2] - ps.plane_z)
    tmp = tempfile.mkdtemp(prefix="plane_reference_")
    res = {"scene": args.scene, "switches": switches,
           "jax_kernel_interpret" if args.kernel else "jax_cpu": _run(
        jpipe, JOptions, ps, dist, base, switches, os.path.join(tmp, "jax"),
        mesh=None)}
    if args.port:
        from hpmvs_tpu_torch.config import Options as POptions
        from hpmvs_tpu_torch.runtime import pipeline as ppipe
        res["port_cpu"] = _run(ppipe, POptions, ps, dist, base, switches,
                               os.path.join(tmp, "port"), device="cpu")
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
