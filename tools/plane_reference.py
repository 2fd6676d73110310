"""Reference counts for chip_smoke.py's plane phases, measured on the CPU.

Runs the JAX package's engine (single device, WAVE_DEPTH=1, no lookahead)
on chip_smoke.py's plane scene and Options -- bench.py's plane: 7 cameras x
512 px, 400 SfM points, START_LEVEL=2, MAX_VIEWS=8, COVIS_MIN_POINTS=30 --
with the given Options switches, and prints one JSON line: alive patches,
the fraction within 0.02 of the plane, patches optimised, wall seconds.
With --port it runs hpmvs_tpu_torch on the CPU (its kernels' twins) too.

    JAX_PLATFORMS=cpu python tools/plane_reference.py FAST_SETREF=False \\
        LM_EXACT_J=False [--port] [--kernel]

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

PLANE = dict(START_LEVEL=2, MAX_VIEWS=8, COVIS_MIN_POINTS=30)


def _run(pipeline_mod, options_cls, ps, switches, out, **kw):
    opt = dataclasses.replace(options_cls(), **PLANE, **switches,
                              OUTFOLDER=out)
    t = time.time()
    eng = pipeline_mod.run(ps.model, opt, images=ps.images, **kw)
    wall = time.time() - t
    import numpy as np
    c = eng.alive_arrays()[0]
    return dict(alive=int(eng.n_alive()),
                frac_within_002=float((np.abs(c[:, 2] - ps.plane_z)
                                       < 0.02).mean()),
                patches_optimized=int(eng.stats["patches_optimized"]),
                wall_s=wall)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("switches", nargs="*", help="Options NAME=VALUE")
    ap.add_argument("--port", action="store_true",
                    help="also run hpmvs_tpu_torch on the CPU")
    ap.add_argument("--kernel", action="store_true",
                    help="JAX engine on its TPU path: the GN kernel in "
                         "interpret mode")
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
    from hpmvs_tpu.testing import make_plane_scene
    ps = make_plane_scene(n_cams=7, imgsize=512, n_points=400, seed=0)
    tmp = tempfile.mkdtemp(prefix="plane_reference_")
    res = {"switches": switches,
           "jax_kernel_interpret" if args.kernel else "jax_cpu": _run(
        jpipe, JOptions, ps, dict(switches, WAVE_DEPTH=1,
                                  WAVE_LOOKAHEAD=False),
        os.path.join(tmp, "jax"), mesh=None)}
    if args.port:
        from hpmvs_tpu_torch.config import Options as POptions
        from hpmvs_tpu_torch.runtime import pipeline as ppipe
        res["port_cpu"] = _run(ppipe, POptions, ps, switches,
                               os.path.join(tmp, "port"), device="cpu")
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
