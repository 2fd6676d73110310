"""End-to-end progressive reconstruction driver: the hp_pmvs() equivalent.

Behavioral equivalent of src/main.cpp:98-206: load NVM -> build scene ->
extract covisibility -> seed + optimize -> priority loop over
(MAX_TREE_LEVEL+1)*10 steps with progressive PLY snapshots every 10 steps
(one octree level) -> final PLY. The reference's subtree decomposition +
OpenMP fan-out collapses into the Engine's batched wavefronts, on one device
or sharded over a mesh of devices driven by this one process.

The run() of hpmvs_tpu/runtime/pipeline.py, its multi-process launch
included: under torchrun (or init_distributed's explicit arguments) every
process runs run() and mesh="auto" builds one mesh over all processes'
GPUs; spatial=True then runs the owned engine (runtime/owned.py), else the
replicated engine.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import torch

from hpmvs_tpu_torch import resolve_device, trace
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.io import nvm as nvm_io
from hpmvs_tpu_torch.runtime.wavefront import Engine

log = logging.getLogger("hpmvs_tpu_torch")


@trace.in_job
def run(model: nvm_io.NvmModel, opt: Options, images=None,
        more_output: bool = False, light_output: int = 0,
        snapshot_hook=None, wave_hook=None,
        max_prio: Optional[int] = None,
        bundle_adjust: bool = False, resume: Optional[str] = None,
        ba_dense: bool = False, ba_dense_every: int = 0,
        device="cuda", mesh="auto", spatial: bool = False,
        image_subsets: bool = False) -> Engine:
    """Progressive densification main loop (main.cpp:145-202) on `device`:
    the GPU unless device="cpu" (RuntimeError when no GPU is visible).

    snapshot_hook(engine, prio): called after every priority step.
    wave_hook(engine): called after every frontier generation
    (Engine.wave_hook).
    max_prio: stop after this many priority steps (default opt.max_prio).
    bundle_adjust: refine cameras + sparse points by Schur-complement BA
    (parallel/ba.py: 6 Gauss-Newton iterations, 40 CG) before seeding --
    capability beyond the reference.
    resume: a checkpoint .npz (runtime/checkpoint.py, written by either
    package) to continue from instead of seeding; the queues are rebuilt
    from its tree like initFromTree (CellProcessor.cpp:422-455).
    ba_dense: cameras+PATCHES BA over the final cloud before
    patches-final.ply; the depth buffer replays under the result.
    ba_dense_every: the same every N octree levels inside the loop, against
    the patches' creation-time observations (ba.DenseObsStore).
    mesh: a parallel.mesh.Mesh to shard the wavefront batches over, None
    for one device, or "auto" (default): a mesh over every visible GPU when
    `device` is a GPU and more than one is visible, else none (the
    OpenMP-over-subtrees analog, main.cpp:127-139). With a mesh the engine
    runs on its shards and `device` is this process's first shard.

    Multi-process: mesh="auto" first calls parallel.mesh.init_distributed()
    (a no-op without a launch; torchrun's variables or a failed bring-up
    raise rather than run once per process). With several processes the
    mesh spans them all, over each process's GPUs -- cuda:LOCAL_RANK when a
    host runs several processes, every visible GPU otherwise, the CPU with
    device="cpu" -- and the engine is the owned one for spatial=True
    (host state partitioned by Morton range; the reference's per-processor
    subtrees, CellProcessor.h:60-68), the replicated Engine otherwise.
    Process 0 writes the PLY files.
    spatial: partition the octree into Morton blocks on the mesh with halo
    border migration (the getSubTrees + border-queue analog, main.cpp:50-96,
    CellProcessor.cpp:487-540) instead of flat batch sharding; needs a mesh.
    image_subsets: with spatial, each shard holds only the image slab of
    the cameras whose frusta see its blocks (parallel/subsets.py).

    The JAX run's enable_compile_cache has no counterpart: PyTorch runs
    eagerly and the CUDA kernels build once into build/ (kernels.py).

    With tracing on (hpmvs_tpu_torch/trace.py) the run is one `job` span,
    unless run_nvm_file opened it."""
    from hpmvs_tpu_torch.parallel import mesh as pmesh
    if mesh is None or isinstance(mesh, str):
        device = resolve_device(device)
    if isinstance(mesh, str) and mesh == "auto":
        mesh = None
        if pmesh.init_distributed() > 1:
            mesh = pmesh.make_mesh(_local_devices(device))
        elif device.type == "cuda" and torch.cuda.device_count() > 1:
            mesh = pmesh.make_mesh()
        if mesh is not None:
            log.info("sharding wavefronts over %d devices %s in %d "
                     "processes", mesh.size,
                     dict(zip(mesh.axis_names, mesh.shape)), mesh.n_proc)
    if mesh is not None:
        device = mesh.first
    os.makedirs(opt.OUTFOLDER, exist_ok=True)
    with trace.span("load"):
        if bundle_adjust and model.n_points > 0:
            from hpmvs_tpu_torch.parallel import ba
            prob = ba.build_problem(model, device=device)
            if mesh is not None and mesh.n_proc > 1:
                # one solve over the process-spanning mesh: every process
                # adopts the same bits (separate solves may differ on CUDA)
                cam, pts, hist = ba.ba_solve_sharded(
                    mesh, ba.shard_problem(prob, mesh.size),
                    len(model.cameras), model.n_points, iters=6, cg_iters=40)
            else:
                cam, pts, hist = ba.ba_solve(prob, len(model.cameras),
                                             model.n_points, iters=6,
                                             cg_iters=40, device=device)
            hist = hist.cpu().numpy()
            log.info("bundle adjustment: reprojection RMS %.4f -> %.4f px",
                     float(hist[0]), float(hist[-1]))
            model = ba.apply_to_model(model, cam.cpu().numpy(),
                                      pts.cpu().numpy())
        # PMVS-style VISDATA debug dump, like the reference's always-written
        # /tmp/testvis.dat (Scene.cpp:243,279) but into the output folder
        cls, kw = Engine, {}
        if spatial:
            if mesh is None:
                raise ValueError("spatial=True requires a device mesh")
            if mesh.n_proc > 1:
                # per-process scheduler ownership: host state partitioned by
                # Morton range, patch records cross only as halo rows
                from hpmvs_tpu_torch.runtime.owned import OwnedSpatialEngine
                cls = OwnedSpatialEngine
            else:
                from hpmvs_tpu_torch.runtime.spatial import SpatialEngine
                cls = SpatialEngine
            kw = dict(image_subsets=image_subsets)
        if mesh is not None:
            kw["mesh"] = mesh
        else:
            kw["device"] = device
        # (process 0 writes it: every process computes the same file)
        vis = (os.path.join(opt.OUTFOLDER, "testvis.dat")
               if mesh is None or mesh.pid == 0 else None)
        engine = cls(model, opt, images=images, visdata_path=vis, **kw)
        engine.wave_hook = wave_hook
        if resume:
            from hpmvs_tpu_torch.runtime import checkpoint as ckpt
            ckpt.load_checkpoint(engine, resume, device=device)
            ckpt.requeue_from_tree(engine)
            log.info("resumed %d patches from <%s>", engine.n_alive(), resume)
        else:
            engine.seed()
    if more_output:
        engine.save_ply(os.path.join(opt.OUTFOLDER, "patches-init.ply"))

    t0 = time.time()
    top = opt.max_prio if max_prio is None else max_prio
    ba_obs = None
    for prio in range(top):
        changed = engine.process_priority_step(prio)

        if changed and prio % 10 < 3:
            if prio % 10 == 0 or more_output:
                engine.save_ply(os.path.join(opt.OUTFOLDER,
                                             f"patches-{prio}.ply"))
            if light_output > 0 and prio == light_output:
                engine.save_ply(os.path.join(opt.OUTFOLDER,
                                             "patches-light.ply"),
                                binary=True, normal=False, scale=False,
                                visibility=False)
            log.info("prio %d finished: %d patches alive", prio,
                     engine.n_alive())
        if snapshot_hook is not None:
            with trace.span("hook"):
                snapshot_hook(engine, prio)

        if (ba_dense_every > 0 and prio % 10 == 9
                and (prio // 10) % ba_dense_every == 0
                and engine.n_alive() > 0):
            # periodic cameras+patches refinement between octree levels:
            # patches created since the previous pass get their
            # observations stamped under the then-current cameras; cameras
            # + centers then re-solve jointly against all stamped
            # observations and the z-buffer replays under the refined
            # geometry, so later levels densify against better cameras
            from hpmvs_tpu_torch.parallel import ba
            if ba_obs is None:
                ba_obs = ba.DenseObsStore(opt.MAX_VIEWS)
            hist = ba.periodic_dense_ba(engine, ba_obs, device=device)
            if hist is not None:
                log.info("periodic dense BA at prio %d (%d patches): "
                         "reprojection RMS %.4f -> %.4f px", prio,
                         engine.n_alive(), float(hist[0]), float(hist[-1]))

        if not engine.have_work():
            break

    hist = engine.tree.histogram()
    log.info("Tree Cell Histogram: %s", {f"L{i}": int(v)
                                         for i, v in enumerate(hist) if v})
    proc_time = time.time() - t0
    n_opt = engine.stats["patches_optimized"]
    t_dev = float(engine.stats["t_device"])
    host_frac = max(proc_time - t_dev, 0.0) / max(proc_time, 1e-9)
    log.info("Done within %.1f seconds (%d patches optimized, %.1f/s; "
             "host scheduler fraction %.1f%%)",
             proc_time, n_opt, n_opt / max(proc_time, 1e-9),
             100.0 * host_frac)
    engine.stats["proc_time"] = proc_time
    engine.stats["host_fraction"] = host_frac
    st = engine.stats
    log.info("wave lookahead: %d hits, %d misses, %.2f s of host work "
             "overlapped; deep waves: %d dispatches, %d generations "
             "consumed, %d fallbacks (overflow %d, mismatch %d, dead %d), %d "
             "false-winner repairs; speculative waste %d lanes, %d dropped; "
             "octree queries %s", st["lookahead_hits"],
             st["lookahead_misses"], float(st["t_host_overlapped"]),
             st["disp_deep"], st["deep_gens_consumed"], st["deep_fallbacks"],
             st["deep_fb_overflow"], st["deep_fb_mismatch"],
             st["deep_fb_dead"], st["deep_false_winner_repairs"],
             st["spec_waste_lanes"], st["spec_dropped_lanes"],
             "native" if st["octree_native"] else "numpy")

    if ba_dense and engine.n_alive() > 0:
        # cameras+PATCHES bundle adjustment: the dense cloud is the
        # tie-point set; cameras + centers re-solve jointly by Schur
        # point-block elimination, then the depth buffer replays under the
        # refined geometry (parallel/ba.apply_dense_ba)
        from hpmvs_tpu_torch.parallel import ba
        hist = ba.apply_dense_ba(engine, device=device)
        if hist is not None:
            log.info("dense BA over %d patches: reprojection RMS "
                     "%.4f -> %.4f px", engine.n_alive(),
                     float(hist[0]), float(hist[-1]))

    engine.save_ply(os.path.join(opt.OUTFOLDER, "patches-final.ply"))
    if light_output > 0:
        engine.save_ply(os.path.join(opt.OUTFOLDER, "patches-final-light.ply"),
                        binary=True, normal=False, scale=False,
                        visibility=False)
    return engine


def _local_devices(device: torch.device) -> list:
    """This process's shards in a multi-process launch: the CPU for a CPU
    run; cuda:LOCAL_RANK when the launcher runs several processes on this
    host (torchrun's LOCAL_WORLD_SIZE); else every visible GPU."""
    if device.type != "cuda":
        return [device]
    if int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > 1:
        return [f"cuda:{int(os.environ['LOCAL_RANK'])}"]
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


@trace.in_job
def run_nvm_file(path: str, opt: Options, **kw) -> Engine:
    with trace.span("load"), trace.span("load.nvm"):
        models = nvm_io.read_nvm(path)
    if not models:
        raise ValueError(f"no models found in NVM file <{path}>")
    return run(models[0], opt, **kw)
