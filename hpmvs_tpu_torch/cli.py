"""Command-line driver, flag-compatible with the reference binary.

Equivalent of src/main.cpp:39-48,208-240: --nvm, --outdir, --subtrees (kept
for compatibility; batched wavefronts partition internally), --maxtreelevel,
--patch_level_final_min, --patch_level_init_max, --more_output,
--light_output, --only_sphere; plus --start_level, --max_views,
--covis_min_points and --device.

The JAX package's --ba, --ba_dense, --ba_dense_every, --checkpoint_every,
--resume, --spatial and --image_subsets are accepted and refused: they are
not ported yet.

Usage: python -m hpmvs_tpu_torch.cli --nvm=scene.nvm --outdir=/tmp/out
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys

from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.runtime import pipeline

NOT_PORTED = ("ba", "ba_dense", "ba_dense_every", "checkpoint_every",
              "resume", "spatial", "image_subsets")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="progressive prioritized "
                                 "multi-view stereo (PyTorch/CUDA)")
    ap.add_argument("--nvm", required=True, help="input nvm file")
    ap.add_argument("--outdir", default="/tmp/hpmvs_tpu",
                    help="output directory")
    ap.add_argument("--forcelogtostderr", action="store_true", default=True,
                    help="(compat) log to stderr")
    ap.add_argument("--subtrees", type=int, default=100,
                    help="(compat) min number of subtrees; batched wavefronts "
                         "partition internally")
    ap.add_argument("--maxtreelevel", type=int, default=20,
                    help="maximum level of the octree")
    ap.add_argument("--patch_level_final_min", type=int, default=9,
                    help="min level to keep lowres patches when branching "
                         "stops")
    ap.add_argument("--patch_level_init_max", type=int, default=9,
                    help="max tree level for patch initialization")
    ap.add_argument("--more_output", action="store_true",
                    help="save more intermediate pointclouds")
    ap.add_argument("--light_output", type=int, default=0,
                    help="also save a lightweight cloud at this priority")
    ap.add_argument("--only_sphere", action="store_true",
                    help="only reconstruct within the scene-center sphere")
    ap.add_argument("--start_level", type=int, default=None,
                    help="pyramid level for seed patches (default 4)")
    ap.add_argument("--max_views", type=int, default=None,
                    help="view slots per patch")
    ap.add_argument("--covis_min_points", type=int, default=None,
                    help="min shared SfM points for a covisible pair "
                         "(reference hardcodes 50, Scene.cpp:272)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; the run fails when no "
                         "GPU is visible; --device cpu runs on the CPU)")
    for flag in NOT_PORTED:
        ap.add_argument(f"--{flag}", nargs="?", const=True, default=None,
                        help="not yet ported")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    used = [f"--{f}" for f in NOT_PORTED if getattr(args, f) is not None]
    if used:
        ap.error(f"{', '.join(used)}: not yet ported to hpmvs_tpu_torch")
    if not os.path.isfile(args.nvm):
        ap.error(f"input file <{args.nvm}> not readable")

    repl = dict(OUTFOLDER=args.outdir, MAX_TREE_LEVEL=args.maxtreelevel,
                PATCH_FINAL_MINLEVEL=args.patch_level_final_min,
                PATCH_INIT_MAXLEVEL=args.patch_level_init_max,
                FILTER_SCENE_CENTER=args.only_sphere)
    if args.start_level is not None:
        repl["START_LEVEL"] = args.start_level
    if args.max_views is not None:
        repl["MAX_VIEWS"] = args.max_views
    if args.covis_min_points is not None:
        repl["COVIS_MIN_POINTS"] = args.covis_min_points
    opt = dataclasses.replace(Options(), **repl)

    engine = pipeline.run_nvm_file(args.nvm, opt,
                                   more_output=args.more_output,
                                   light_output=args.light_output,
                                   device=args.device)
    logging.info("final patches: %d", engine.n_alive())
    return 0


if __name__ == "__main__":
    sys.exit(main())
