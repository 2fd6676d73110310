"""Reference counts for chip_smoke.py's plane and ring phases, measured on the CPU.

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
memory), its accuracy the fraction within 0.02 of the wedge; "ring",
chip_smoke.py's ring_plane (make_ring_plane_scene at its defaults, 150
cameras x 128 px, 600 points, START_LEVEL=2, MAX_VIEWS=9,
COVIS_MIN_POINTS=8), its accuracy also the fraction within 4 ground sample
distances (the ring's level-0 GSD, 0.0228, is above 0.02); "ring30", the
same cut to 30 cameras and 120 points, the extent scaled by sqrt(30/150)
as bench/stress_study.py scales it; "plane200", tests/test_spatial.py's
plane (7 cameras x 512 px, 200 points, START_LEVEL=2, MAXLEVEL=4,
COVIS_MIN_POINTS=10, MAX_TREE_LEVEL=8, WAVE_LOOKAHEAD=False unless
--wave_depth or the switches say otherwise); "tiny", the completed run of
the multi-process tests (tests/test_multihost.py, tests/
test_torch_multihost.py: 4 cameras x 96 px, 24 points, START_LEVEL=1,
MAXLEVEL=3, MAX_VIEWS=6, COVIS_MIN_POINTS=10, LM_ITERS=4,
MAX_TREE_LEVEL=8).

--shards N runs both engines over an N-shard mesh: the JAX engine on N
virtual CPU devices (XLA's --xla_force_host_platform_device_count, set
before jax is imported), the port (--port) on N CPU shards
(hpmvs_tpu_torch.parallel.mesh.make_mesh(["cpu"] * N)). --spatial runs the
spatial engine (Morton blocks, halo migration) over that mesh and
--image_subsets its per-shard image slabs; the output then carries the
engine's migration, slab and host-collective counters (and always the
frontier generations, "waves"). --owned runs the owned engine
(runtime/owned.py's OwnedSpatialEngine) at one process instead of the
spatial engine: its root cube is pinned to the SfM points' cube, which a
run over several processes shares.

    JAX_PLATFORMS=cpu python tools/plane_reference.py FAST_SETREF=False \\
        LM_EXACT_J=False [--wave_depth N] [--no_lookahead] [--port] [--kernel]
        [--scene plane|small|facade|ring|ring30|plane200|tiny]
        [--shards N [--spatial [--image_subsets] [--owned]]]

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
    "ring": (dict(), dict(START_LEVEL=2, MAX_VIEWS=9, COVIS_MIN_POINTS=8)),
    "plane200": (dict(n_cams=7, imgsize=512, n_points=200, seed=0),
                 dict(START_LEVEL=2, MAXLEVEL=4, COVIS_MIN_POINTS=10,
                      MAX_TREE_LEVEL=8)),
    "tiny": (dict(n_cams=4, imgsize=96, n_points=24, seed=0),
             dict(START_LEVEL=1, MAXLEVEL=3, MAX_VIEWS=6,
                  COVIS_MIN_POINTS=10, LM_ITERS=4, MAX_TREE_LEVEL=8)),
    "ring30": (dict(n_cams=30, imgsize=128, n_points=120,
                    extent=8.0 * (30 / 150) ** 0.5, seed=0),
               dict(START_LEVEL=2, MAX_VIEWS=9, COVIS_MIN_POINTS=8)),
}
RING_GSD = 3.5 / (128 * 1.2)
WAVE_STATS = ("dispatches", "lookahead_hits", "lookahead_misses",
              "disp_deep", "deep_gens_consumed", "deep_fallbacks",
              "spec_waste_lanes")
# the spatial engine's counters (reported with --spatial)
SPATIAL_STATS = ("migrated", "halo_arrivals", "migrated_inserted",
                 "halo_hops", "halo_bytes_wire", "halo_bytes_logical",
                 "block_work_lanes", "block_balance_den", "rebalances",
                 "subset_rebuilds", "subset_rows_per_block",
                 "subset_rows_replicated", "subset_cams_max",
                 "subset_cams_mean", "slab_miss", "host_collectives")


def _run(pipeline_mod, options_cls, ps, dist, base, switches, out, gsd=None,
         owned=False, **kw):
    opt = dataclasses.replace(options_cls(), **base, **switches,
                              OUTFOLDER=out)
    t = time.time()
    if owned:
        # pipeline.run picks the owned engine only under several
        # processes: hand it the owned engine as its spatial one
        import importlib
        pkg = pipeline_mod.__name__.split(".")[0]
        sp = importlib.import_module(pkg + ".runtime.spatial")
        saved = sp.SpatialEngine
        sp.SpatialEngine = importlib.import_module(
            pkg + ".runtime.owned").OwnedSpatialEngine
    waves = [0]

    def count(engine):
        waves[0] += 1

    try:
        eng = pipeline_mod.run(ps.model, opt, images=ps.images,
                               wave_hook=count, **kw)
    finally:
        if owned:
            sp.SpatialEngine = saved
    wall = time.time() - t
    d = dist(eng.alive_arrays()[0])
    st = eng.stats
    extra = {} if gsd is None else {
        "frac_within_4gsd": float((d < 4 * gsd).mean())}
    if kw.get("spatial"):
        extra["spatial"] = {k: st[k] for k in SPATIAL_STATS if k in st}
    return dict(alive=int(eng.n_alive()),
                frac_within_002=float((d < 0.02).mean()), **extra,
                patches_optimized=int(st["patches_optimized"]),
                waves=waves[0], wall_s=wall,
                hist=[int(x) for x in eng.tree.histogram()],
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
    ap.add_argument("--shards", type=int, default=0,
                    help="run over a mesh of this many shards (virtual CPU "
                         "devices for the JAX engine)")
    ap.add_argument("--spatial", action="store_true",
                    help="the spatial engine over the --shards mesh")
    ap.add_argument("--image_subsets", action="store_true",
                    help="with --spatial: per-shard image slabs")
    ap.add_argument("--owned", action="store_true",
                    help="with --spatial: the owned engine at one process")
    args = ap.parse_args(argv)
    if args.spatial and args.shards < 1:
        ap.error("--spatial needs --shards")
    if args.owned and not args.spatial:
        ap.error("--owned needs --spatial")
    if args.shards:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.shards}")
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
    asked = set(switches)
    switches["WAVE_DEPTH"] = (jdef.WAVE_DEPTH if args.wave_depth is None
                              else args.wave_depth)
    switches["WAVE_LOOKAHEAD"] = (jdef.WAVE_LOOKAHEAD
                                  and not args.no_lookahead)
    if (args.scene == "plane200" and "WAVE_LOOKAHEAD" not in asked
            and not args.no_lookahead):
        # tests/test_spatial.py's Options switch the lookahead off
        switches["WAVE_LOOKAHEAD"] = False
    mesh_kw = {}
    if args.shards:
        from hpmvs_tpu.parallel import mesh as jmesh
        mesh_kw = dict(mesh=jmesh.make_mesh(args.shards),
                       spatial=args.spatial,
                       image_subsets=args.image_subsets, owned=args.owned)
    scene_kw, base = SCENES[args.scene]
    gsd = None
    if args.scene == "facade":
        ps = testing.make_facade_scene(**scene_kw)

        def dist(c):
            return testing.facade_surface_dist(c, ps.slope)
    else:
        if args.scene.startswith("ring"):
            ps = testing.make_ring_plane_scene(**scene_kw)
            gsd = RING_GSD
        else:
            ps = testing.make_plane_scene(**scene_kw)

        def dist(c):
            return np.abs(c[:, 2] - ps.plane_z)
    tmp = tempfile.mkdtemp(prefix="plane_reference_")
    res = {"scene": args.scene, "switches": switches, "shards": args.shards,
           "spatial": args.spatial, "image_subsets": args.image_subsets,
           "owned": args.owned,
           "jax_kernel_interpret" if args.kernel else "jax_cpu": _run(
        jpipe, JOptions, ps, dist, base, switches, os.path.join(tmp, "jax"),
        gsd=gsd, **(mesh_kw or dict(mesh=None)))}
    if args.port:
        from hpmvs_tpu_torch.config import Options as POptions
        from hpmvs_tpu_torch.runtime import pipeline as ppipe
        port_kw = {}
        if args.shards:
            from hpmvs_tpu_torch.parallel import mesh as pmesh
            port_kw = dict(mesh_kw, mesh=pmesh.make_mesh(["cpu"]
                                                         * args.shards))
        res["port_cpu"] = _run(ppipe, POptions, ps, dist, base, switches,
                               os.path.join(tmp, "port"), gsd=gsd,
                               device="cpu", **port_kw)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
