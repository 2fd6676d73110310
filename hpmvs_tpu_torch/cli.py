"""Command-line driver, flag-compatible with the reference binary.

Equivalent of src/main.cpp:39-48,208-240: --nvm, --outdir, --subtrees (kept
for compatibility; batched wavefronts partition internally), --maxtreelevel,
--patch_level_final_min, --patch_level_init_max, --more_output,
--light_output, --only_sphere; plus --ba, --ba_dense, --ba_dense_every
(bundle adjustment), --checkpoint_every/--resume, --profile (a
torch.profiler trace), --start_level, --max_views, --covis_min_points,
--spatial, --image_subsets and --device.

With more than one visible GPU the run shards over all of them
(pipeline.run's mesh="auto"); --spatial then partitions the octree into
Morton blocks over that mesh, and fails as the JAX CLI does on one device.
A multi-process launch needs no flag, as in the JAX CLI: under torchrun
every process runs the CLI, and pipeline.run brings up the process group
and spans the mesh over all of them (--spatial then runs the owned engine;
process 0 writes the PLY files), e.g. in one command:
  torchrun --nproc_per_node=2 -m hpmvs_tpu_torch.cli --spatial
      --nvm=scene.nvm --outdir=/tmp/out
The JAX package's --platform is refused in favour of --device.

Usage: python -m hpmvs_tpu_torch.cli --nvm=scene.nvm --outdir=/tmp/out
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os
import sys

from hpmvs_tpu_torch import trace
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.runtime import pipeline

def _profile(folder: str):
    """torch.profiler over the main loop (CPU, and CUDA activity on a GPU),
    written to `folder` as a Chrome trace: the counterpart of the JAX CLI's
    jax.profiler trace. The port's spans (trace.py) show in it as
    record_function ranges above the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(folder, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)

    def write(prof):
        prof.export_chrome_trace(os.path.join(folder, "trace.json"))

    return profile(activities=acts, on_trace_ready=write)


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
    ap.add_argument("--ba", action="store_true",
                    help="bundle-adjust cameras+points before densification")
    ap.add_argument("--ba_dense", action="store_true",
                    help="bundle-adjust cameras+PATCHES after densification "
                         "(Schur point-block elimination over the dense "
                         "cloud; the depth buffer replays under the result)")
    ap.add_argument("--ba_dense_every", type=int, default=0,
                    help="run cameras+patches BA every N octree levels "
                         "inside the progressive loop (0 = off)")
    ap.add_argument("--checkpoint_every", type=int, default=0,
                    help="write a resumable checkpoint every N priority "
                         "steps (runtime/checkpoint.py; 0 = off)")
    ap.add_argument("--resume", default=None,
                    help="resume from a checkpoint .npz (rebuilds the "
                         "queues from the tree like initFromTree, "
                         "CellProcessor.cpp:422-455)")
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler trace of the main loop to "
                         "this directory (trace.json, Chrome trace format)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; the run fails when no "
                         "GPU is visible; --device cpu runs on the CPU)")
    ap.add_argument("--platform", default=None,
                    help="(JAX package only) refused: use --device")
    ap.add_argument("--spatial", action="store_true",
                    help="shard the octree into Morton blocks across the "
                         "device mesh with halo border migration (the "
                         "getSubTrees + border-queue analog); requires >1 "
                         "device")
    ap.add_argument("--image_subsets", action="store_true",
                    help="with --spatial: shard the packed image pyramids "
                         "by block so each device holds only the cameras "
                         "whose frusta see its blocks (the per-subtree "
                         "working set)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    if args.platform is not None:
        ap.error("--platform selects a JAX platform; hpmvs_tpu_torch takes "
                 "--device (cuda or cpu)")
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

    snapshot_hook = None
    if args.checkpoint_every > 0:
        from hpmvs_tpu_torch.runtime import checkpoint as ckpt

        def snapshot_hook(engine, prio, _every=args.checkpoint_every):
            if prio % _every == 0:
                ckpt.save_checkpoint(engine,
                                     os.path.join(args.outdir,
                                                  "checkpoint.npz"))

    prof = (_profile(args.profile) if args.profile
            else contextlib.nullcontext())
    if args.profile:
        trace.enable(annotate=True)
    try:
        with prof:
            engine = pipeline.run_nvm_file(
                args.nvm, opt, more_output=args.more_output,
                light_output=args.light_output, bundle_adjust=args.ba,
                snapshot_hook=snapshot_hook, resume=args.resume,
                ba_dense=args.ba_dense, ba_dense_every=args.ba_dense_every,
                spatial=args.spatial, image_subsets=args.image_subsets,
                device=args.device)
    finally:
        if args.profile:
            trace.disable()
            trace.reset()
    logging.info("final patches: %d", engine.n_alive())
    return 0


if __name__ == "__main__":
    sys.exit(main())
