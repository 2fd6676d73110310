"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   -- the card (torch and nvidia-smi); no CUDA -> exit 1.
  2. build    -- nvcc builds hpmvs_tpu_torch/csrc into build/ (one nvcc per
                 source, in parallel); the ptxas report of every kernel
                 (registers, static shared memory, stack, spills); then g++
                 builds the native library (native/octree_core.cpp and
                 the PLY formatter native/ply_ascii.cpp).
  3. kernels  -- each kernel (fetch, score, permute, gn, gn_fd) and the GN
                 kernel's debug_j output against its plain PyTorch twin on
                 the card at the main path's shapes (B=2048, K=8 pre stage,
                 K=6 in the GN kernel, W=12; the three GN instantiations
                 bit-equal, with their launch shape and the time of one
                 wave of clusters), each with two times beside its bound
                 and, where one exists, one PyTorch call computing the
                 same function, timed alike:
                 device_ms, the kernel alone on the device (CUDA events
                 around 20 back-to-back calls behind a sleeping stream,
                 median of 5 runs), and call_ms, one call as the main path
                 pays it, host work included (median of 10); then one
                 optimize_batch of the 2048 patches on the default path,
                 with LM_EXACT_J=False, and with FAST_SETREF=False and
                 LM_EXACT_J=False (call time, median of 10).
  4. deep_dispatch -- one deepwave.optimize_and_gate_deep of WAVE_DEPTH=4
                 generations at B=2048 on the plane's seed extend batch,
                 enqueued under torch.cuda.set_sync_debug_mode("error"): no
                 generation may wait for the device; its generation 0
                 equal (torch.equal) to one classic optimize_and_gate call.
                 Its call time (the enqueue and one copy back) and its
                 device time and launches (torch.profiler) beside those of
                 4 classic optimize_and_gate calls, each copied back; every
                 call on its own copy of the z-buffer.
  5. plane    -- bench.py's plane scene and Options at the JAX package's
                 defaults (wave lookahead, deep waves, pooled depth gates,
                 native octree queries) through
                 hpmvs_tpu_torch.runtime.pipeline.run to completion: fetch,
                 score, permute and gn launched, no twin called, the native
                 octree answering, deep generations consumed, lookahead
                 hits > misses, >= 0.95 of the patches within 0.02 of the
                 plane, alive count within 10% of the JAX engine's on the
                 CPU at its defaults.
  6. plane_classic -- the same with WAVE_DEPTH=1, WAVE_LOOKAHEAD=False,
                 against the JAX engine's classic count.
  7. plane_exactref_fd -- the plane with FAST_SETREF=False, LM_EXACT_J=False
                 (the reference's setRefImage on the per-patch stages, the
                 GN kernel's FD/Broyden mode), wave switches at their
                 defaults: fetch and gn_fd launched, no twin called, >= 0.95
                 within 0.02, alive count within 10% of the JAX engine's on
                 the path it takes on a TPU (its GN kernel in interpret mode
                 on the CPU; the JAX engine's own CPU path refines with
                 another FD algorithm and is reported beside it).
  8. plane_resume -- the plane at the defaults run to prio RESUME_STOP,
                 checkpointed (save and load seconds, file size); a fresh
                 engine loads it with equal patch arrays, queue and tree and
                 a torch.equal depth buffer; pipeline.run(resume=...) to
                 completion: alive within 10% of the plane phase's, >= 0.95
                 within 0.02.
  9. plane_ba_dense_every -- tests/test_ba.py's periodic dense BA on the
                 card: its plane and Options, ba_dense_every=2, the cameras
                 drifted at prio 35 through snapshot_hook; the median camera
                 centre error must at least halve, RMS to the plane < 0.02.
 10. facade   -- an 11-camera 2048 px facade (Strecha fountain-P11 sized),
                 rendered once, under a wall budget, at the defaults: the
                 first octree level must finish with >= 0.85 of the patches
                 within 0.02 of the surface.
 11. facade_ba_dense -- on the facade phase's final cloud, every camera but
                 the two anchors perturbed, cameras+patches solved against
                 the true observations: ba_solve enqueued under
                 set_sync_debug_mode("error"), twice (the largest camera
                 difference between the runs), with its measurements,
                 iterations, solve ms (CUDA events), ms per CG step and peak
                 memory; apply_dense_ba: RMS falls > 5x, the centre error
                 >= 3x, the z-buffer replayed.
 12. facade_exactref_fd -- the same facade with FAST_SETREF=False and
                 LM_EXACT_J=False, one octree level shallower
                 (MAX_TREE_LEVEL=8), under its own wall budget, same
                 checks.
 13. facade_stream -- the facade through StreamingEngine in two chunks
                 (cameras 0-5 with the wedge's left face, one octree level,
                 then cameras 6-10 with the right face), then to completion
                 under a wall budget: the image pack grew, the old z-buffer
                 is a torch.equal prefix right after the extension, stream
                 seeds > 0, the first level >= 0.85 within 0.02; the
                 extension's seconds and peak memory.
 14. ring_plane -- make_ring_plane_scene's 150 cameras x 128 px at the
                 port's defaults under a wall budget: finished; alive within
                 10% of the JAX engine's on the CPU, the shares within 0.02
                 and within 4 ground sample distances of the plane at most
                 0.02 below its.
 The single-process multi-device system, its mesh shards all on the card
 (the counterpart of the JAX tests' virtual devices; no multi-GPU speed is
 measured or claimed), each held to the JAX engine on the same number of
 virtual CPU devices (tools/plane_reference.py --shards):
 15. facade_ba_sharded -- right after facade_ba_dense, on its problem
                 with BA_SHARDED_NOISE_PX of noise on the observations (the
                 optimum then depends on every measurement): shard_problem
                 + ba_solve_sharded over 8 shards against two unsharded
                 solves with the same two anchors, the RMS history within
                 BA_SHARDED_RMS_RTOL, cameras and points within
                 BA_SHARDED_CAM_TOL / BA_SHARDED_PTS_TOL; the unsharded
                 run-to-run spreads, solve ms and peak memory.
 16. plane_mesh -- bench.py's plane through pipeline.run over a 4-shard
                 mesh (lookahead on, no deep waves): alive within 10% of
                 the JAX mesh engine's, >= 0.95 within 0.02, the shards'
                 z-buffer replicas equal.
 17. plane_spatial -- tests/test_spatial.py's plane (7 x 512 px, 200
                 points) and Options on the spatial engine over 8 shards
                 (64 Morton blocks): alive within 10% of the JAX spatial
                 engine's, >= 0.95 within 0.02, migrated > 0 and every
                 migrated patch arrived; block balance, halo hops, wire
                 against logical bytes.
 18. ring_spatial_subsets -- the ring plane on the spatial engine over 8
                 shards with per-shard image slabs: slab_miss 0, fewer rows
                 per shard than the replicated pack, alive and shares held
                 as ring_plane's to the JAX engine in the same mode; the
                 fetch kernel on the busiest shard's committed slab
                 bit-equal to its twin; cameras per shard, rebuilds, the
                 slabs' bytes (their sum on one card can exceed the
                 replicated pack) and peak memory.
 19. plane_stream_spatial -- plane_spatial's plane streamed in two chunks
                 (cameras 0-3, then 4-6) into a 4-shard spatial engine with
                 image subsets: the old z-buffer prefix unchanged across the
                 extension, alive within 10% of plane_spatial's.
 The multi-process system: two processes (chip_smoke.py --mp-worker
 <rank> <port> <phase>, started by this script, each with its own
 timeout), one gloo process group (parallel/mesh.init_distributed, an
 explicit address on 127.0.0.1, world size 2), each process's shards on
 the one card; a worker that fails fails the phase:
 20. plane_mp_mesh -- plane_mesh's plane and Options through pipeline.run
                 over 2 processes x 2 shards: the replicated engine
                 (every dispatch's outputs allgathered); alive on both
                 processes EQUAL to plane_mesh's, the z-buffers the same
                 bits on both; the loop wall beside plane_mesh's and the
                 bytes gathered per dispatch.
 21. plane_mp_owned -- plane_spatial's plane and Options through
                 pipeline.run over 2 processes x 4 shards with image
                 subsets: the owned engine to completion; alive within 10%
                 of the JAX owned engine's at one process (its root cube
                 is the SfM points', not the seeds', so its count differs
                 from plane_spatial's, printed beside it), each
                 process's share > 10%, every
                 local patch owned, migrations summed equal to arrivals
                 summed, slab_miss 0, the fetch kernel on each process's
                 busiest committed slab bit-equal to its twin; a
                 per-process checkpoint at the end of the first level
                 with work, loaded into fresh owned engines (state equal)
                 and resumed by pipeline.run(resume=...) to within 10%;
                 owned dense BA on the final cloud with
                 tests/multihost_worker.py's drift: RMS falls > 3x, the
                 camera error > 2x, the cameras the same bits on both
                 processes.
 22. ring_mp_owned -- the ring plane on the owned engine with image
                 subsets, 2 processes x 4 shards, under a wall budget the
                 processes agree on: the shares within 0.02 and within 4
                 GSD at most 0.02 below the JAX owned engine's at one
                 process, alive within 10% of its when the run completes
                 (ring_spatial_subsets' beside: the owned engine's cube,
                 1.2x the SfM points' extent, is about twice the seeds'
                 here, so its reconstruction is coarser); host
                 collectives per wave and the bytes that cross processes.
Phases 8-10, 13, 14 and 16-22 launch the default path's kernels and no
twin (each prints its launches per kernel and its twin calls; phases 20-22
summed over both processes); phases 11 and 15 solve and replay the
z-buffer only.
Any failed check raises (exit code 1). The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists the kernels (ms is
device_ms; call_ms beside it; launches from the plane at the defaults, gn_fd
from plane_exactref_fd; launches_by_phase from phases 16-22).

python3 chip_smoke.py --profile instead builds the kernels and runs the
plane at the defaults and on the classic engine in turns (default, classic,
classic, default; loop wall, dispatches, wave counters, peak memory), then
each under torch.profiler (device activity only): busy time by kernel, the
GN kernel's share, the advanced-indexing gathers' device time, and the idle
share of the unprofiled runs' mean wall; the classic plane once more with
the depth gates' 9-gather path (no pooled gates) for the gathers' time
before the pooled gates; then the exactref_fd plane. For each profiled run,
every hand-written kernel's device time and launches.

Then the ring plane (ring_plane below) unprofiled and profiled: its
patches/s, device busy time and idle share.

python3 chip_smoke.py --facade-waves builds the kernels and runs the facade
on the classic engine, then at the defaults (the facade phase's checks).

python3 chip_smoke.py --mp builds the kernels and runs plane_mesh once (its
run-to-run spread beside the next run), then phases 16-18 and 20-22.
"""

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

T0 = time.time()
TIME_LIMIT_S = 1200.0
# hpmvs_tpu (JAX engine on the CPU) on bench.py's plane scene and Options,
# measured by tools/plane_reference.py. At its defaults (WAVE_DEPTH=4,
# WAVE_LOOKAHEAD=True): 15761 alive patches, all at octree level 7, 1.000
# within 0.02, 51116 patches optimized.
PLANE_JAX_CPU_ALIVE = 15761
# the classic engine (WAVE_DEPTH=1, WAVE_LOOKAHEAD=False): 16186 alive, all
# at octree level 7, 49516 patches optimized.
CLASSIC = dict(WAVE_DEPTH=1, WAVE_LOOKAHEAD=False)
PLANE_CLASSIC_JAX_CPU_ALIVE = 16186
EXACTREF_FD = dict(FAST_SETREF=False, LM_EXACT_J=False)
# EXACTREF_FD at the wave defaults: on the path the JAX engine takes on a
# TPU (its GN kernel's FD mode, run on the CPU in interpret mode, --kernel)
# 18261 alive patches, all at octree level 7, 0.9990 within 0.02 -- the
# algorithm the port runs. On the CPU the JAX engine refines with its
# plain FD refiner instead (no early stop, no FD-step shrink): 15727 alive,
# 0.9994 within 0.02.
PLANE_EXACTREF_FD_ALIVE = 18261
PLANE_EXACTREF_FD_JAX_CPU_ALIVE = 15727
FACADE_MAX_TREE_LEVEL = 9          # of the default-path facade
FACADE_BUDGET_S = 420.0
FACADE_EXACTREF_FD_BUDGET_S = 420.0
# one level shallower than the default-path facade: level 9 held 98% of
# its patches and most of its 104-113 s loop (NVIDIA H100 80GB HBM3,
# 700.00 W), and the multi-process phases need the time (the checks read
# the first level and the kernels' launches)
FACADE_EXACTREF_FD_MAX_TREE_LEVEL = 8
# plane_resume: the plane's seeds sit at octree levels 5 and 6 (prios 50,
# 60), so the first run stops after level 5's steps and resumes level 6 on
RESUME_STOP = 60
STREAM_BUDGET_S = 240.0
RING_BUDGET_S = 120.0
OUT_DIR = "chiprun_out"
# which kernels each driven path must launch
PATH_KERNELS = {"default": ("fetch", "score", "permute", "gn", "add_views",
                            "sort_views"),
                "classic": ("fetch", "score", "permute", "gn", "add_views",
                            "sort_views"),
                "exactref_fd": ("fetch", "gn_fd", "add_views")}
PATH_SWITCHES = {"default": {}, "classic": CLASSIC,
                 "exactref_fd": EXACTREF_FD}
# the engine's counters each plane and facade phase reports
WAVE_STATS = ("dispatches", "lookahead_hits", "lookahead_misses",
              "spec_waste_lanes", "spec_dropped_lanes", "disp_deep",
              "deep_gens_consumed", "deep_fallbacks", "deep_fb_overflow",
              "deep_fb_mismatch", "deep_fb_dead", "deep_false_winner_repairs")


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def device_phase():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return torch.cuda.get_device_name(0), smi


def build_phase():
    from hpmvs_tpu_torch import kernels
    t = time.time()
    path = kernels.build(verbose=True)
    kernels.lib()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as fh:
        fh.write(kernels._Lib.build_log)
    emit("build", seconds=round(time.time() - t, 3), library=str(path),
         ptxas=ptxas_report(kernels._Lib.build_log))
    from hpmvs_tpu_torch.core import native
    t = time.time()
    native.lib()
    emit("build_native", seconds=round(time.time() - t, 3),
         library=str(native._Lib.path))


MODES = {"0": "exact", "1": "fd", "2": "debug_j"}


def ptxas_report(log):
    """{kernel: "R registers, M B smem, S B stack, X B spill stores, Y B
    spill loads"} from nvcc's -Xptxas=-v output (the GN kernel's
    instantiations by mode)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for \S*?\d((?:[a-z]+_)+kernel)"
                      r"(?:ILNS_4ModeE(\d)E)?", ln)
        if m:
            name = m.group(1) + (f"<{MODES[m.group(2)]}>" if m.group(2)
                                 else "")
            out[name] = ""
        elif name and "stack frame" in ln:
            st = re.findall(r"(\d+) bytes", ln)
            out[name] = (f"{st[0]} B stack, {st[1]} B spill stores, "
                         f"{st[2]} B spill loads")
        elif name and "registers" in ln:
            r = re.search(r"Used (\d+) registers", ln).group(1)
            sm = re.search(r"(\d+) bytes smem", ln)
            out[name] = (f"{r} registers, {sm.group(1) if sm else 0} B smem, "
                         + out[name])
    return out


def plane_setup(device):
    import numpy as np
    import torch
    from hpmvs_tpu_torch.config import Options
    from hpmvs_tpu_torch.core import scene as scene_mod
    from hpmvs_tpu_torch.testing import make_plane_scene
    opt = dataclasses.replace(Options(), START_LEVEL=2, MAX_VIEWS=8,
                              COVIS_MIN_POINTS=30,
                              OUTFOLDER=os.path.join(OUT_DIR, "plane"))
    ps = make_plane_scene(n_cams=7, imgsize=512, n_points=400, seed=0)
    scene = scene_mod.build_scene(ps.model, opt, images=ps.images,
                                  device=device)
    c, n, s, v, _ = scene_mod.make_seed_patches(ps.model, scene, opt)
    B = 2048
    idx = np.tile(np.arange(len(c)), -(-B // len(c)))[:B]
    rng = np.random.default_rng(0)
    cc = c[idx] + rng.normal(0, 0.002, (B, 3)).astype(np.float32)
    batch = tuple(torch.as_tensor(a, device=device)
                  for a in (cc, n[idx], s[idx], v[idx]))
    return opt, ps, scene, batch


def kernels_phase(device):
    from hpmvs_tpu_torch import kernel_check
    from hpmvs_tpu_torch.ops import optimizer as popt
    opt, ps, scene, batch = plane_setup(device)
    res = kernel_check.check_kernels(scene.ctx, opt, *batch, reps=10)
    for r in res:
        emit("kernel", **dataclasses.asdict(r), bound_ms=r.bound_ms,
             bound_by=r.bound_by)
    bad = [r.name for r in res if not r.ok]
    check(not bad, f"kernel disagrees with its twin: {bad}")
    # one optimize_batch of the whole B=2048 batch (bench.py's timed call),
    # on the default path and on the two paths with the FD/Broyden mode
    for name, sw in (("default", {}), ("fd", dict(LM_EXACT_J=False)),
                     ("exactref_fd", EXACTREF_FD)):
        o = dataclasses.replace(opt, **sw)
        ms = kernel_check.call_ms(
            lambda: popt.optimize_batch(scene.ctx, o, *batch), reps=10)
        emit("optimize_batch", path=name, B=len(batch[0]), ms=ms,
             patches_per_s=len(batch[0]) / (ms / 1e3))
    return res


def profiled(fn):
    """One fn() under torch.profiler with device activity only: (its
    result, {kernel: device us}, {kernel: launches}). The device times sum
    to the busy time (one stream)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    us, calls = {}, {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            us[e.key] = us.get(e.key, 0.0) + t
            calls[e.key] = calls.get(e.key, 0) + e.count
    return res, us, calls


def deep_phase(device):
    """One deep dispatch on the plane's seed extend batch (the extend
    candidates of every seed cell, cut or padded to B=2048 as
    Engine._deep_dispatch pads): enqueued with no host sync, its generation
    0 equal to one classic optimize_and_gate call, then timed against
    WAVE_DEPTH classic calls. Every call gets its own copy of the z-buffer
    (made before the timed region), since a deep call adds its generation
    0's winners to it."""
    import numpy as np
    import torch
    from hpmvs_tpu_torch import kernel_check
    from hpmvs_tpu_torch.core import depth as depth_mod
    from hpmvs_tpu_torch.ops import deepwave
    from hpmvs_tpu_torch.ops import optimizer as popt
    from hpmvs_tpu_torch.runtime.wavefront import Engine
    opt, ps, _, _ = plane_setup(device)
    eng = Engine(ps.model, opt, images=ps.images, device=device)
    eng.seed()
    cids = np.concatenate([eng._pop_live(p) for p in sorted(eng.queue)])
    pids = eng.cell_head[cids]
    _, widths = eng.tree.cell_center_width(cids)
    lanes = eng._extend_candidates(
        eng.patches.center[pids], eng.patches.normal[pids],
        eng.patches.views[pids], eng.patches.prio_red[pids], widths,
        eng.tree.node_level(cids))[:6]
    B = 2048
    n = min(len(lanes[0]), B)
    gin = deepwave.GateIn(*(torch.as_tensor(a, device=device) for a in
                            deepwave.pad_lanes([a[:n] for a in lanes], B)))
    root_c = torch.as_tensor(np.asarray(eng.tree.center, np.float32),
                             device=device)
    root_w = torch.full((), eng.tree.width, dtype=torch.float32,
                        device=device)
    ctx, n_img, lay = eng.scene.ctx, eng.scene.n_cameras, eng._pack_layout
    base = eng.pack
    depth_mod.apply_phased_updates(base, ctx.cams, *eng._take_pending(),
                                   subsample=opt.DEPTH_SUBSAMPLE)
    gens = int(opt.WAVE_DEPTH)

    def fresh(k=1):
        """k copies of the z-buffer as the wave finds it."""
        packs = [dataclasses.replace(base, depth=base.depth.clone())
                 for _ in range(k)]
        torch.cuda.synchronize()
        return packs

    def deep(pack):
        return deepwave.optimize_and_gate_deep(
            ctx, pack, opt, n_img, gin, root_c, root_w, n_gens=gens,
            pack_layout=lay)

    def classic(pack):
        for _ in range(gens):
            for a in popt.optimize_and_gate(ctx, pack, opt, n_img, *gin,
                                            pack_layout=lay):
                a.cpu()

    def call(fn, reps=5, warmup=2):
        packs = fresh(reps + warmup)
        return kernel_check.call_ms(lambda: fn(packs.pop()), reps=reps,
                                    warmup=warmup)

    deep(*fresh())                          # warm-up: lazy library set-up
    pack0, pack_ref = fresh(2)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = time.perf_counter()
        out = deep(pack0)
        enqueue_ms = 1e3 * (time.perf_counter() - t)
    except RuntimeError as e:
        check(False, f"deep_dispatch: the enqueue waited for the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # generation 0 is one classic call on the same z-buffer, bit for bit
    ref = popt.optimize_and_gate(ctx, pack_ref, opt, n_img, *gin,
                                 pack_layout=lay)
    gen0_diff = {name: float((a[0].float() - b.float()).abs().max())
                 for name, a, b in zip(deepwave.DeepOut._fields, out, ref)
                 if not torch.equal(a[0], b)}
    host = deepwave.to_host(out)
    ok = [int(host.ok[g].sum()) for g in range(gens)]
    win = [int(host.win[g].sum()) for g in range(gens)]
    call_deep = call(lambda p: deepwave.to_host(deep(p)))
    call_classic = call(classic)
    # device time and launches of one call from the profiler: a deep call
    # launches more kernels than the launch queue holds, so time_ms cannot
    # back the stream up behind it
    dev = {}
    for name, fn in (("deep", deep), ("classic", classic)):
        p = fresh()[0]
        _, us, calls = profiled(lambda: fn(p))
        dev[name] = (sum(us.values()) / 1e3, sum(calls.values()))
    emit("deep_dispatch", B=B, lanes=n, n_gens=gens, syncs=0,
         enqueue_ms=enqueue_ms, call_ms=call_deep, device_ms=dev["deep"][0],
         device_launches=dev["deep"][1], classic_calls=gens,
         classic_call_ms=call_classic, classic_device_ms=dev["classic"][0],
         classic_device_launches=dev["classic"][1],
         gen0_equals_classic=not gen0_diff, gen0_max_abs_diff=gen0_diff,
         ok_per_gen=ok, winners_per_gen=win)
    check(not gen0_diff, f"deep_dispatch: generation 0 differs from one "
                         f"classic call: {gen0_diff}")
    check(ok[0] > 0 and win[0] > 0 and ok[1] > 0,
          f"deep_dispatch: no work past generation 0: ok {ok}, winners {win}")
    del eng


def launch_counts():
    from hpmvs_tpu_torch import kernels
    return ({k: st.launches for k, st in kernels.STATS.items()},
            {k: st.twin_calls for k, st in kernels.STATS.items()})


def check_path(name, path, launches, twins):
    """The driven path went through its kernels, and no twin ran."""
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    check(not missing, f"{name}: kernels never launched: {missing} "
                       f"({launches})")
    check(not any(twins.values()), f"{name}: a twin ran: {twins}")


def wave_stats(eng):
    st = eng.stats
    return dict({k: int(st[k]) for k in WAVE_STATS},
                t_host_overlapped=float(st["t_host_overlapped"]),
                octree_native=bool(st["octree_native"]))


def plane_phase(device, name, path, ref_alive, jax_cpu_alive):
    import numpy as np
    import torch
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.runtime import pipeline
    opt, ps, _, _ = plane_setup(device)
    switches = PATH_SWITCHES[path]
    opt = dataclasses.replace(opt, **switches,
                              OUTFOLDER=os.path.join(OUT_DIR, name))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t = time.time()
    eng = pipeline.run(ps.model, opt, images=ps.images, device=device)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches, twins = launch_counts()
    c = eng.alive_arrays()[0]
    frac = float((np.abs(c[:, 2] - ps.plane_z) < 0.02).mean())
    n_opt = int(eng.stats["patches_optimized"])
    ws = wave_stats(eng)
    emit(name, switches=switches, wall_s=wall, alive=eng.n_alive(),
         reference_alive=ref_alive, jax_cpu_alive=jax_cpu_alive,
         frac_within_002=frac,
         patches_optimized=n_opt, patches_per_s=n_opt / wall,
         loop_s=float(eng.stats["proc_time"]),
         loop_patches_per_s=n_opt / max(float(eng.stats["proc_time"]), 1e-9),
         hist=[int(x) for x in eng.tree.histogram()],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, twin_calls=twins, **ws)
    check_path(name, path, launches, twins)
    check(ws["octree_native"], f"{name}: the octree queries ran in numpy")
    if eng.opt.WAVE_LOOKAHEAD:
        check(ws["lookahead_hits"] > ws["lookahead_misses"],
              f"{name}: lookahead hits {ws['lookahead_hits']} <= misses "
              f"{ws['lookahead_misses']}")
    if eng.opt.WAVE_LOOKAHEAD and eng.opt.WAVE_DEPTH > 1:
        check(ws["disp_deep"] > 0 and ws["deep_gens_consumed"] > 0,
              f"{name}: deep waves did not engage: {ws}")
    check(frac >= 0.95, f"{name}: {frac} of patches within 0.02")
    check(abs(eng.n_alive() - ref_alive) <= 0.1 * ref_alive,
          f"{name}: {eng.n_alive()} alive vs {ref_alive} (JAX)")
    return launches, eng.n_alive()


def render_facade():
    from hpmvs_tpu_torch.testing import make_facade_scene
    t = time.time()
    sc = make_facade_scene(n_cams=11, imgsize=2048, n_points=300, seed=0)
    emit("facade_render", render_s=time.time() - t)
    return sc


def facade_phase(device, sc, name, path, max_tree_level, budget,
                 keep=False):
    """The facade through the engine under a wall budget; returns the
    engine when keep (facade_ba_dense solves on its cloud)."""
    import numpy as np
    import torch
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.config import Options
    from hpmvs_tpu_torch.runtime.wavefront import Engine
    from hpmvs_tpu_torch.testing import facade_surface_dist
    switches = PATH_SWITCHES[path]
    opt = dataclasses.replace(Options(), MAXLEVEL=6, START_LEVEL=4,
                              COVIS_MIN_POINTS=10,
                              MAX_TREE_LEVEL=max_tree_level, **switches)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t = time.time()
    eng = Engine(sc.model, opt, images=sc.images, device=device)
    t_scene = time.time() - t
    image_pack_mb = eng.scene.ctx.imgs.tex.numel() * 4 / 2 ** 20
    # leave room for the rest of the script and process exit
    budget = min(budget, TIME_LIMIT_S - 120.0 - (time.time() - T0))
    check(budget > 60.0, f"{name}: only {budget:.0f} s left for the loop")
    t = time.time()
    eng.seed()
    first_prio = min(eng.queue) if eng.queue else None
    last = -1
    for prio in range(opt.max_prio):
        if eng.process_priority_step(prio):
            last = prio
        if not eng.have_work() or time.time() - t > budget:
            break
    torch.cuda.synchronize()
    wall = time.time() - t
    done_prio = prio
    c = eng.alive_arrays()[0]
    d = facade_surface_dist(c, sc.slope) if len(c) else np.zeros(0)
    frac = float((d < 0.02).mean()) if len(d) else 0.0
    first_level_done = (first_prio is not None
                        and (done_prio >= (first_prio // 10 + 1) * 10 - 1
                             or not eng.have_work()))
    launches, twins = launch_counts()
    n_opt = int(eng.stats["patches_optimized"])
    emit(name, switches=switches, max_tree_level=max_tree_level,
         scene_s=t_scene, loop_wall_s=wall, budget_s=budget,
         alive=eng.n_alive(), first_prio=first_prio,
         last_prio_with_work=last, loop_stopped_at_prio=done_prio,
         finished=not eng.have_work(), frac_within_002=frac,
         patches_optimized=n_opt, patches_per_s=n_opt / max(wall, 1e-9),
         hist=[int(x) for x in eng.tree.histogram()],
         image_pack_mb=image_pack_mb,
         depth_pack_mb=eng.pack.depth.numel() * 4 / 2 ** 20,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, twin_calls=twins, **wave_stats(eng))
    check(first_level_done, f"{name}: the first octree level did not finish")
    check(frac >= 0.85, f"{name}: {frac} of patches within 0.02")
    check_path(name, path, launches, twins)
    return eng if keep else None


def budget_left(want):
    """A phase's wall budget: `want`, cut to what the time limit leaves
    (after 120 s kept for the phases behind it and process exit)."""
    return min(want, TIME_LIMIT_S - 120.0 - (time.time() - T0))


def alive_state(eng):
    """Patch arrays, queue and tree histogram (host) of an engine."""
    import numpy as np
    p = eng.patches
    return ({f: getattr(p, f)[:p.n].copy() for f in p.FIELDS if f != "nxt"},
            {pr: np.concatenate(c).tolist()
             for pr, c in eng.queue.items() if c},
            eng.tree.histogram().tolist())


def plane_resume_phase(device, plane_alive):
    """bench.py's plane at the defaults: run to RESUME_STOP, checkpoint,
    load the file into a fresh engine (patch arrays, queue and tree equal,
    the depth buffer torch.equal), then pipeline.run(resume=...) to
    completion, held to the plane phase's alive count."""
    import numpy as np
    import torch
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.runtime import checkpoint as ckpt
    from hpmvs_tpu_torch.runtime import pipeline
    from hpmvs_tpu_torch.runtime.wavefront import Engine
    opt, ps, _, _ = plane_setup(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t = time.time()
    eng = pipeline.run(ps.model, dataclasses.replace(
        opt, OUTFOLDER=os.path.join(OUT_DIR, "plane_resume_a")),
        images=ps.images, max_prio=RESUME_STOP, device=device)
    first_s = time.time() - t
    path = os.path.join(OUT_DIR, "plane_resume.npz")
    t = time.time()
    ckpt.save_checkpoint(eng, path)
    save_s = time.time() - t
    saved, depth = alive_state(eng), eng.pack.depth.clone()
    alive_at_stop = eng.n_alive()
    del eng
    fresh = Engine(ps.model, opt, images=ps.images, device=device)
    t = time.time()
    ckpt.load_checkpoint(fresh, path, device=device)
    torch.cuda.synchronize()
    load_s = time.time() - t
    got = alive_state(fresh)
    arrays_equal = all(np.array_equal(got[0][f], saved[0][f])
                       for f in saved[0])
    depth_equal = torch.equal(fresh.pack.depth, depth)
    del fresh
    t = time.time()
    eng = pipeline.run(ps.model, dataclasses.replace(
        opt, OUTFOLDER=os.path.join(OUT_DIR, "plane_resume_b")),
        images=ps.images, resume=path, device=device)
    torch.cuda.synchronize()
    resume_s = time.time() - t
    launches, twins = launch_counts()
    c = eng.alive_arrays()[0]
    frac = float((np.abs(c[:, 2] - ps.plane_z) < 0.02).mean())
    emit("plane_resume", stop_prio=RESUME_STOP, alive_at_stop=alive_at_stop,
         hist_at_stop=saved[2], first_run_s=first_s, save_s=save_s,
         load_s=load_s, file_bytes=os.path.getsize(path),
         arrays_equal=arrays_equal, queue_equal=got[1] == saved[1],
         tree_equal=got[2] == saved[2], depth_equal=depth_equal,
         resume_run_s=resume_s, alive=eng.n_alive(),
         plane_alive=plane_alive, frac_within_002=frac,
         hist=[int(x) for x in eng.tree.histogram()],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, twin_calls=twins, **wave_stats(eng))
    check(arrays_equal and got[1] == saved[1] and got[2] == saved[2],
          "plane_resume: the loaded patch arrays, queue or tree differ")
    check(depth_equal, "plane_resume: the loaded depth buffer differs")
    check_path("plane_resume", "default", launches, twins)
    check(frac >= 0.95, f"plane_resume: {frac} of patches within 0.02")
    check(abs(eng.n_alive() - plane_alive) <= 0.1 * plane_alive,
          f"plane_resume: {eng.n_alive()} alive vs the plane's "
          f"{plane_alive}")


def plane_ba_dense_every_phase(device):
    """tests/test_ba.py:95-150 on the card: its plane and Options,
    ba_dense_every=2, every camera but the two anchors drifted at prio 35
    (after the prio-29 pass stamped the seeds under the true cameras)."""
    import numpy as np
    import torch
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.config import Options
    from hpmvs_tpu_torch.runtime import pipeline
    from hpmvs_tpu_torch.testing import make_plane_scene, perturb_model
    ps = make_plane_scene(n_cams=7, imgsize=512, n_points=200, seed=0)
    opt = dataclasses.replace(Options(), START_LEVEL=2, MAXLEVEL=4,
                              COVIS_MIN_POINTS=10, MAX_TREE_LEVEL=6,
                              OUTFOLDER=os.path.join(OUT_DIR,
                                                     "plane_ba_dense_every"))
    true_c = np.asarray([c.c for c in ps.model.cameras])
    state = {}

    def drift(engine, prio):
        if prio != 35 or state:
            return
        pert = perturb_model(engine.model, np.random.default_rng(21),
                             rot=0.002, trans=0.005, pts=0.0, keep=2)
        pert.points_xyz = engine.model.points_xyz
        engine.set_cameras(pert)
        state["pre"] = np.linalg.norm(
            np.asarray([c.c for c in pert.cameras]) - true_c, axis=1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t = time.time()
    eng = pipeline.run(ps.model, opt, images=ps.images, ba_dense_every=2,
                       snapshot_hook=drift, device=device)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches, twins = launch_counts()
    check("pre" in state, "plane_ba_dense_every: the drift never fired")
    post = np.linalg.norm(np.asarray([c.c for c in eng.model.cameras])
                          - true_c, axis=1)
    z = eng.alive_arrays()[0][:, 2] - ps.plane_z
    rms = float(np.sqrt((z ** 2).mean()))
    pre_m, post_m = float(np.median(state["pre"][2:])), \
        float(np.median(post[2:]))
    emit("plane_ba_dense_every", wall_s=wall, alive=eng.n_alive(),
         centre_err_median_pre=pre_m, centre_err_median_post=post_m,
         rms_to_plane=rms,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, twin_calls=twins)
    check_path("plane_ba_dense_every", "default", launches, twins)
    check(post_m <= pre_m / 2.0, f"plane_ba_dense_every: centre error "
                                 f"{pre_m} -> {post_m}")
    check(rms < 0.02, f"plane_ba_dense_every: RMS {rms} to the plane")


def facade_ba_problem(device, eng):
    """The dense BA problem of the engine's cloud: every camera but the two
    anchors perturbed (tests/test_ba.py:182-186), the observations those
    of the true cameras. Returns (perturbed model, problem)."""
    import numpy as np
    from hpmvs_tpu_torch.parallel import ba
    from hpmvs_tpu_torch.testing import perturb_model
    p = eng.patches
    pids = np.nonzero(p.alive[:p.n])[0]
    c, v = p.center[pids], p.views[pids]
    obs = ba.build_dense_problem(eng.model, c, v, device=device)
    pert = perturb_model(eng.model, np.random.default_rng(5), rot=0.004,
                         trans=0.01, pts=0.0, keep=2)
    return pert, ba.build_dense_problem(pert, c, v, device=device)._replace(
        m_uv=obs.m_uv)


def facade_ba_dense_phase(device, eng):
    """Cameras+patches BA on the facade phase's final cloud: every camera
    but the two anchors perturbed (tests/test_ba.py:182-186), the solve
    against the observations under the true cameras. ba_solve is enqueued
    under set_sync_debug_mode("error") and timed with CUDA events, twice
    (the largest camera-parameter difference between the runs: index_add_
    is atomic), then once with twice the CG steps (the time of one CG
    step); then apply_dense_ba folds the result back and replays the
    z-buffer."""
    import numpy as np
    import torch
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.parallel import ba
    kernels.reset_counts()
    true_c = np.asarray([c.c for c in eng.model.cameras])
    t = time.time()
    pert, prob = facade_ba_problem(device, eng)
    build_s = time.time() - t
    n_cams, n_pts, iters, cg = (len(pert.cameras), len(prob.pts0), 8, 40)
    pre = np.linalg.norm(np.asarray([x.c for x in pert.cameras]) - true_c,
                         axis=1)

    def solve(cg_iters, strict=False):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.set_sync_debug_mode("error" if strict else 0)
        try:
            a.record()
            out = ba.ba_solve(prob, n_cams, n_pts, iters=iters,
                              cg_iters=cg_iters, fix_count=2, device=device)
            b.record()
        except RuntimeError as e:
            check(False, f"facade_ba_dense: ba_solve waited for the "
                         f"device: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    solve(1)                                 # warm-up: lazy library set-up
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (cam1, _, hist1), ms1 = solve(cg, strict=True)
    peak = torch.cuda.max_memory_allocated() - base
    (cam2, _, _), ms2 = solve(cg, strict=True)
    _, ms_2cg = solve(2 * cg)
    spread = float((cam1 - cam2).abs().max())
    eng.model = pert
    t = time.time()
    hist = ba.apply_dense_ba(eng, problem=prob, device=device)
    torch.cuda.synchronize()
    apply_s = time.time() - t
    post = np.linalg.norm(np.asarray([x.c for x in eng.model.cameras])
                          - true_c, axis=1)
    launches, twins = launch_counts()
    filled = int((eng.pack.depth < 999.0).sum())
    emit("facade_ba_dense", patches=n_pts, measurements=len(prob.m_cam),
         cameras=n_cams, gn_iters=iters, cg_iters=cg, build_s=build_s,
         solve_ms=[ms1, ms2], solve_ms_2x_cg=ms_2cg,
         # one CG step: its matvec and vector updates
         cg_step_ms=(ms_2cg - ms1) / (iters * cg),
         solve_peak_bytes=peak, spread_max_abs=spread,
         rms_hist=[float(x) for x in hist1.cpu()],
         apply_rms_hist=[float(x) for x in hist], apply_s=apply_s,
         centre_err_median_pre=float(np.median(pre[2:])),
         centre_err_median_post=float(np.median(post[2:])),
         depth_cells_filled=filled, launches=launches, twin_calls=twins)
    check(not any(twins.values()), f"facade_ba_dense: a twin ran: {twins}")
    check(hist[-1] < hist[0] / 5.0, f"facade_ba_dense: RMS {hist}")
    check(np.median(post[2:]) <= np.median(pre[2:]) / 3.0,
          f"facade_ba_dense: centre error {np.median(pre[2:])} -> "
          f"{np.median(post[2:])}")
    check(filled > 0, "facade_ba_dense: the z-buffer was not replayed")
    return prob, n_cams, n_pts, iters, cg


def facade_stream_phase(device, sc):
    """The facade streamed in two chunks: cameras 0-5 with the wedge's left
    face, one octree level, then cameras 6-10 with the right face; then on
    to completion under a wall budget."""
    import numpy as np
    import torch
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.config import Options
    from hpmvs_tpu_torch.runtime.streaming import StreamingEngine
    from hpmvs_tpu_torch.testing import facade_surface_dist, split_model
    opt = dataclasses.replace(Options(), MAXLEVEL=6, START_LEVEL=4,
                              COVIS_MIN_POINTS=10,
                              MAX_TREE_LEVEL=FACADE_MAX_TREE_LEVEL)
    # every camera of the arc sees most of the wedge: chunk 1 holds the
    # points of its left face (x < 0) that cameras 0-5 see at least twice,
    # with their measurements in those cameras; chunk 2 the right face
    m = sc.model
    lo = np.asarray([(m.meas_img[m.meas_start[i]:m.meas_start[i + 1]]
                      < 6).sum() for i in range(m.n_points)])
    first, second = split_model(m, 6, (m.points_xyz[:, 0] < 0) & (lo >= 2))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    budget = budget_left(STREAM_BUDGET_S)
    check(budget > 60.0, f"facade_stream: only {budget:.0f} s left")
    t0 = time.time()
    st = StreamingEngine(opt, device=device)
    n1 = st.add_chunk(first, images=sc.images[:6])
    eng = st.engine
    first_prio = min(eng.queue)
    st.run_to((first_prio // 10 + 1) * 10 - 1)
    eng._flush_depths()
    old_depth = eng.pack.depth.clone()
    old_rows = int(eng.scene.ctx.imgs.tex.shape[0])
    alive_mid = eng.n_alive()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    n2 = st.add_chunk(second, images=sc.images[6:])
    torch.cuda.synchronize()
    extend_s = time.time() - t
    extend_peak = torch.cuda.max_memory_allocated()
    prefix_equal = torch.equal(eng.pack.depth[:len(old_depth)], old_depth)
    new_rows = int(eng.scene.ctx.imgs.tex.shape[0])
    del old_depth
    for prio in range(opt.max_prio):
        eng.process_priority_step(prio)
        if not eng.have_work() or time.time() - t0 > budget:
            break
    torch.cuda.synchronize()
    wall = time.time() - t0
    c = eng.alive_arrays()[0]
    frac = float((facade_surface_dist(c, sc.slope) < 0.02).mean())
    # a reroot deepens every cell a level, so cells may wait past max_prio
    finished = not eng.queue or min(eng.queue) >= opt.max_prio
    first_level_done = prio >= (first_prio // 10 + 1) * 10 - 1 or finished
    launches, twins = launch_counts()
    emit("facade_stream", chunk_cameras=[6, 5],
         chunk_points=[first.n_points, second.n_points], seeds=[n1, n2],
         stream_seeds=int(eng.stats["stream_seeds"]),
         reroots=int(eng.stats["reroots"]), alive_mid=alive_mid,
         image_rows=[old_rows, new_rows], prefix_equal=prefix_equal,
         extend_s=extend_s, extend_peak_bytes=extend_peak, wall_s=wall,
         budget_s=budget, finished=finished,
         loop_stopped_at_prio=prio, alive=eng.n_alive(),
         frac_within_002=frac, hist=[int(x) for x in eng.tree.histogram()],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, twin_calls=twins, **wave_stats(eng))
    check(new_rows > old_rows, "facade_stream: the image pack did not grow")
    check(prefix_equal, "facade_stream: the old z-buffer prefix changed")
    check(eng.stats["stream_seeds"] > 0, "facade_stream: no stream seeds")
    check(first_level_done, "facade_stream: the first level did not finish")
    check(frac >= 0.85, f"facade_stream: {frac} of patches within 0.02")
    check_path("facade_stream", "default", launches, twins)


RING_OPT = dict(START_LEVEL=2, MAX_VIEWS=9, COVIS_MIN_POINTS=8)
# the ring's ground sample distance at level 0 (camera height 3.5, f = 1.2
# x 128 px): 0.0228, above the 0.02 that the plane phases hold
RING_GSD = 3.5 / (128 * 1.2)
# hpmvs_tpu (JAX engine on the CPU, its defaults) on the ring_plane scene
# and Options, measured by tools/plane_reference.py --scene ring: 59470
# alive patches, 0.7647 within 0.02 of the plane, 0.9339 within 4 GSD
RING_JAX_CPU_ALIVE = 59470
RING_JAX_CPU_WITHIN_002 = 0.7647
RING_JAX_CPU_WITHIN_4GSD = 0.9339


def ring_run(device, sc, budget):
    """The ring plane through the engine at the port's wave defaults with
    bench/profile_gates.py's Options for its image size; returns (engine,
    scene build s, loop wall s, last prio)."""
    import torch
    from hpmvs_tpu_torch.config import Options
    from hpmvs_tpu_torch.runtime.wavefront import Engine
    opt = dataclasses.replace(Options(), **RING_OPT)
    torch.cuda.synchronize()
    t = time.time()
    eng = Engine(sc.model, opt, images=sc.images, device=device)
    scene_s = time.time() - t
    t = time.time()
    eng.seed()
    for prio in range(opt.max_prio):
        eng.process_priority_step(prio)
        if not eng.have_work() or time.time() - t > budget:
            break
    torch.cuda.synchronize()
    return eng, scene_s, time.time() - t, prio


def ring_plane_phase(device):
    """make_ring_plane_scene at its defaults (150 cameras x 128 px, 600
    points) under a wall budget: the port's first run past 11 cameras. Held
    to the JAX engine on the same scene and Options: alive within 10%, and
    the shares of patches within 0.02 and within 4 ground sample distances
    of the plane (bench/stress_study.py's ring bar) no more than 0.02 below
    its. 0.02 is under one GSD here, so neither engine reaches 0.95
    within it."""
    import numpy as np
    import torch
    from hpmvs_tpu_torch import eval as peval
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.testing import make_ring_plane_scene
    t = time.time()
    sc = make_ring_plane_scene()
    render_s = time.time() - t
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    budget = budget_left(RING_BUDGET_S)
    check(budget > 30.0, f"ring_plane: only {budget:.0f} s left")
    eng, scene_s, wall, prio = ring_run(device, sc, budget)
    launches, twins = launch_counts()
    c = eng.alive_arrays()[0]
    d = np.abs(c[:, 2] - sc.plane_z)
    frac, frac_4gsd = float((d < 0.02).mean()), float((d < 4 * RING_GSD).mean())
    metrics = peval.plane_metrics(c.astype(np.float64), sc.plane_z,
                                  sc.extent, 0.02)
    n_opt = int(eng.stats["patches_optimized"])
    emit("ring_plane", cameras=len(sc.model.cameras), imgsize=sc.imgsize,
         jax_cpu_alive=RING_JAX_CPU_ALIVE,
         jax_cpu_within_002=RING_JAX_CPU_WITHIN_002,
         jax_cpu_within_4gsd=RING_JAX_CPU_WITHIN_4GSD,
         points=sc.model.n_points, options=RING_OPT, render_s=render_s,
         scene_s=scene_s, loop_wall_s=wall, budget_s=budget,
         finished=not eng.have_work(), loop_stopped_at_prio=prio,
         alive=eng.n_alive(), frac_within_002=frac, gsd=RING_GSD,
         frac_within_4gsd=frac_4gsd, plane_metrics=metrics,
         patches_optimized=n_opt, patches_per_s=n_opt / max(wall, 1e-9),
         hist=[int(x) for x in eng.tree.histogram()],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, twin_calls=twins, **wave_stats(eng))
    check_path("ring_plane", "default", launches, twins)
    check(not eng.have_work(), "ring_plane: the run did not finish")
    check(abs(eng.n_alive() - RING_JAX_CPU_ALIVE) <= 0.1 * RING_JAX_CPU_ALIVE,
          f"ring_plane: {eng.n_alive()} alive vs {RING_JAX_CPU_ALIVE} (JAX)")
    check(frac >= RING_JAX_CPU_WITHIN_002 - 0.02,
          f"ring_plane: {frac} within 0.02 vs {RING_JAX_CPU_WITHIN_002} "
          f"(JAX)")
    check(frac_4gsd >= RING_JAX_CPU_WITHIN_4GSD - 0.02,
          f"ring_plane: {frac_4gsd} within 4 GSD vs "
          f"{RING_JAX_CPU_WITHIN_4GSD} (JAX)")


# ----------------------------------------------------------------------
# the single-process multi-device system: several mesh shards on the card
# ----------------------------------------------------------------------
# hpmvs_tpu on the CPU over virtual devices, measured by
# tools/plane_reference.py (Options as the phases below):
#   --shards 4: bench.py's plane on a 4-device mesh engine (lookahead on,
#   no deep waves under a mesh) -- 15743 alive, 1.000 within 0.02;
#   --scene plane200 --shards 8 --spatial: tests/test_spatial.py's plane
#   and Options on the 8-shard spatial engine -- 19973 alive, 1.000 within
#   0.02, 6296 migrated (all arrived);
#   --scene ring --shards 8 --spatial --image_subsets: the ring plane on
#   the 8-shard spatial engine with image subsets -- 62175 alive, 0.7530
#   within 0.02, 0.9271 within 4 GSD, slab_miss 0.
PLANE_MESH_SHARDS = 4
PLANE_MESH_JAX_CPU_ALIVE = 15743
SPATIAL_SHARDS = 8
SPATIAL_OPT = dict(START_LEVEL=2, MAXLEVEL=4, COVIS_MIN_POINTS=10,
                   MAX_TREE_LEVEL=8, WAVE_LOOKAHEAD=False)
PLANE_SPATIAL_JAX_CPU_ALIVE = 19973
RING_SUBSETS_JAX_CPU_ALIVE = 62175
RING_SUBSETS_JAX_CPU_WITHIN_002 = 0.7530
RING_SUBSETS_JAX_CPU_WITHIN_4GSD = 0.9271
RING_SUBSETS_BUDGET_S = 150.0
PLANE_SPATIAL_BUDGET_S = 120.0
STREAM_SPATIAL_SHARDS = 4
STREAM_SPATIAL_BUDGET_S = 120.0
BA_SHARDED_SHARDS = 8
# ba_solve_sharded against ba_solve on the same noisy problem and anchors:
# the noise (pixels, per coordinate); the largest relative difference of
# the first RMS entry (the same sums in another order) and of any entry;
# the largest camera-parameter and point differences. The last three are
# ~10x what two ba_solve runs differ by on the facade (the order of the
# atomic sums: 1.8e-4, 9.8e-7 and 2.2e-6 on an NVIDIA H100 80GB HBM3,
# 700.00 W)
BA_SHARDED_NOISE_PX = 0.5
BA_SHARDED_RMS0_RTOL = 1e-6
BA_SHARDED_RMS_RTOL = 2e-3
BA_SHARDED_CAM_TOL = 1e-5
BA_SHARDED_PTS_TOL = 3e-5
SPATIAL_STATS = ("dispatches", "migrated", "halo_arrivals",
                 "migrated_inserted", "halo_rounds", "halo_hops",
                 "halo_bytes_wire", "halo_bytes_logical", "block_work_lanes",
                 "block_pad_lanes", "block_balance_den", "rebalances",
                 "subset_rebuilds", "subset_rows_per_block",
                 "subset_rows_replicated", "subset_cams_max",
                 "subset_cams_mean", "subset_block_cams_mean", "slab_miss",
                 "subset_pending_overrides", "subset_bound_overrides")


def shard_mesh(device, n):
    """n mesh shards on one device (the counterpart of the JAX tests'
    virtual devices)."""
    from hpmvs_tpu_torch.parallel import mesh as pmesh
    return pmesh.make_mesh([device] * n)


def spatial_stats(eng):
    st = eng.stats
    out = {k: (float(st[k]) if isinstance(st[k], float) else int(st[k]))
           for k in SPATIAL_STATS if k in st}
    # the ideal equal split's lanes over the busiest shard's, summed over
    # the dispatch rounds: the spatial decomposition's efficiency
    out["block_balance"] = (st["block_work_lanes"]
                            / max(st["block_balance_den"], 1))
    return out


def run_loop(eng, opt, budget):
    """Seed and drain the priority steps under a wall budget; returns
    (loop seconds, last priority)."""
    import torch
    t = time.time()
    eng.seed()
    for prio in range(opt.max_prio):
        eng.process_priority_step(prio)
        if not eng.have_work() or time.time() - t > budget:
            break
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return time.time() - t, prio


def plane_mesh_phase(device):
    """bench.py's plane through pipeline.run over a 4-shard mesh on the
    card: every extend chunk split over the shards, one z-buffer replica
    each; lookahead on, no deep waves (as in the JAX mesh engine)."""
    import numpy as np
    import torch
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.runtime import pipeline
    opt, ps, _, _ = plane_setup(device)
    opt = dataclasses.replace(opt, OUTFOLDER=os.path.join(OUT_DIR,
                                                          "plane_mesh"))
    mesh = shard_mesh(device, PLANE_MESH_SHARDS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t = time.time()
    eng = pipeline.run(ps.model, opt, images=ps.images, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches, twins = launch_counts()
    c = eng.alive_arrays()[0]
    frac = float((np.abs(c[:, 2] - ps.plane_z) < 0.02).mean())
    reps_equal = all(torch.equal(r, eng.pack.depth)
                     for r in eng._replicas())
    n_opt = int(eng.stats["patches_optimized"])
    emit("plane_mesh", shards=mesh.size, mesh_shape=list(mesh.shape),
         wall_s=wall, loop_s=float(eng.stats["proc_time"]),
         alive=eng.n_alive(), jax_cpu_alive=PLANE_MESH_JAX_CPU_ALIVE,
         frac_within_002=frac, patches_optimized=n_opt,
         patches_per_s=n_opt / wall, replicas_equal=reps_equal,
         hist=[int(x) for x in eng.tree.histogram()],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, twin_calls=twins, **wave_stats(eng))
    check_path("plane_mesh", "default", launches, twins)
    check(ws_ok(eng), f"plane_mesh: lookahead {wave_stats(eng)}")
    check(reps_equal, "plane_mesh: the shards' z-buffer replicas differ")
    check(frac >= 0.95, f"plane_mesh: {frac} of patches within 0.02")
    check(abs(eng.n_alive() - PLANE_MESH_JAX_CPU_ALIVE)
          <= 0.1 * PLANE_MESH_JAX_CPU_ALIVE,
          f"plane_mesh: {eng.n_alive()} alive vs "
          f"{PLANE_MESH_JAX_CPU_ALIVE} (JAX)")
    return launches, eng.n_alive(), float(eng.stats["proc_time"])


def ws_ok(eng):
    """Under a mesh: no deep dispatch, the lookahead hitting."""
    ws = wave_stats(eng)
    return ws["disp_deep"] == 0 and ws["lookahead_hits"] > \
        ws["lookahead_misses"]


def plane_spatial_phase(device):
    """tests/test_spatial.py's plane (7 cameras x 512 px, 200 points) and
    Options on the spatial engine over 8 shards: Morton blocks re-binned
    onto shards every round, border patches migrated by ragged halo
    hops."""
    import numpy as np
    import torch
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.config import Options
    from hpmvs_tpu_torch.runtime.spatial import SpatialEngine
    from hpmvs_tpu_torch.testing import make_plane_scene
    ps = make_plane_scene(n_cams=7, imgsize=512, n_points=200, seed=0)
    opt = dataclasses.replace(Options(), **SPATIAL_OPT)
    mesh = shard_mesh(device, SPATIAL_SHARDS)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    budget = budget_left(PLANE_SPATIAL_BUDGET_S)
    check(budget > 30.0, f"plane_spatial: only {budget:.0f} s left")
    eng = SpatialEngine(ps.model, opt, images=ps.images, mesh=mesh)
    wall, prio = run_loop(eng, opt, budget)
    launches, twins = launch_counts()
    c = eng.alive_arrays()[0]
    frac = float((np.abs(c[:, 2] - ps.plane_z) < 0.02).mean())
    sp = spatial_stats(eng)
    n_opt = int(eng.stats["patches_optimized"])
    emit("plane_spatial", shards=mesh.size, blocks=eng.n_blocks,
         block_level=eng.block_level, loop_wall_s=wall, budget_s=budget,
         finished=not eng.have_work(), loop_stopped_at_prio=prio,
         alive=eng.n_alive(), jax_cpu_alive=PLANE_SPATIAL_JAX_CPU_ALIVE,
         frac_within_002=frac, patches_optimized=n_opt,
         patches_per_s=n_opt / max(wall, 1e-9),
         hist=[int(x) for x in eng.tree.histogram()],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, twin_calls=twins, **sp)
    check_path("plane_spatial", "default", launches, twins)
    check(not eng.have_work(), "plane_spatial: the run did not finish")
    check(sp["migrated"] > 0, "plane_spatial: no patch migrated")
    check(sp["halo_arrivals"] == sp["migrated"],
          f"plane_spatial: {sp['halo_arrivals']} arrivals of "
          f"{sp['migrated']} migrated")
    check(frac >= 0.95, f"plane_spatial: {frac} of patches within 0.02")
    check(abs(eng.n_alive() - PLANE_SPATIAL_JAX_CPU_ALIVE)
          <= 0.1 * PLANE_SPATIAL_JAX_CPU_ALIVE,
          f"plane_spatial: {eng.n_alive()} alive vs "
          f"{PLANE_SPATIAL_JAX_CPU_ALIVE} (JAX)")
    return launches, eng.n_alive()


def ring_spatial_subsets_phase(device):
    """make_ring_plane_scene at its defaults (150 cameras x 128 px) with
    RING_OPT on the spatial engine over 8 shards with image subsets: each
    shard's fetch kernel reads its own slab. Then the fetch kernel on the
    busiest shard's committed slab, at the windows its resident patches
    cut there, against its twin (bit-equal) and the full pack's windows.
    One card holds every shard's slab: their sum can exceed the replicated
    pack (a mesh of several cards divides it)."""
    import numpy as np
    import torch
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.config import Options
    from hpmvs_tpu_torch.runtime.spatial import SpatialEngine
    from hpmvs_tpu_torch.testing import make_ring_plane_scene
    sc = make_ring_plane_scene()
    opt = dataclasses.replace(Options(), **RING_OPT)
    mesh = shard_mesh(device, SPATIAL_SHARDS)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    budget = budget_left(RING_SUBSETS_BUDGET_S)
    check(budget > 30.0, f"ring_spatial_subsets: only {budget:.0f} s left")
    eng = SpatialEngine(sc.model, opt, images=sc.images, mesh=mesh,
                        image_subsets=True)
    wall, prio = run_loop(eng, opt, budget)
    peak = torch.cuda.max_memory_allocated()
    launches, twins = launch_counts()
    c = eng.alive_arrays()[0]
    d = np.abs(c[:, 2] - sc.plane_z)
    frac, frac_4gsd = float((d < 0.02).mean()), float((d < 4 * RING_GSD)
                                                      .mean())
    sp = spatial_stats(eng)
    check(eng._bpack_dev is not None and eng.n_alive() > 0,
          "ring_spatial_subsets: no slab was committed")
    slab_bytes = [int(s.tex.numel() * 4) for s in eng._bpack_dev]
    full_bytes = int(eng.scene.ctx.imgs.tex.numel() * 4)
    slab_check = slab_fetch(eng, opt)
    n_opt = int(eng.stats["patches_optimized"])
    emit("ring_spatial_subsets", shards=mesh.size, blocks=eng.n_blocks,
         cameras=len(sc.model.cameras), imgsize=sc.imgsize,
         options=RING_OPT, loop_wall_s=wall, budget_s=budget,
         finished=not eng.have_work(), loop_stopped_at_prio=prio,
         alive=eng.n_alive(), jax_cpu_alive=RING_SUBSETS_JAX_CPU_ALIVE,
         frac_within_002=frac, frac_within_4gsd=frac_4gsd,
         jax_cpu_within_002=RING_SUBSETS_JAX_CPU_WITHIN_002,
         jax_cpu_within_4gsd=RING_SUBSETS_JAX_CPU_WITHIN_4GSD,
         patches_optimized=n_opt, patches_per_s=n_opt / max(wall, 1e-9),
         cams_per_shard=[int(x) for x in eng._committed_mask.sum(1)],
         slab_bytes=slab_bytes, slabs_sum_bytes=sum(slab_bytes),
         replicated_pack_bytes=full_bytes, max_memory_allocated=peak,
         slab_fetch=slab_check,
         hist=[int(x) for x in eng.tree.histogram()],
         launches=launches, twin_calls=twins, **sp)
    check_path("ring_spatial_subsets", "default", launches, twins)
    check(not eng.have_work(), "ring_spatial_subsets: the run did not "
                               "finish")
    check(sp["slab_miss"] == 0,
          f"ring_spatial_subsets: slab_miss {sp['slab_miss']}")
    check(sp["subset_rows_per_block"] < sp["subset_rows_replicated"],
          f"ring_spatial_subsets: {sp['subset_rows_per_block']} rows per "
          f"shard vs {sp['subset_rows_replicated']} replicated")
    check(slab_check["equal_twin"] and slab_check["equal_full"],
          f"ring_spatial_subsets: the fetch kernel on a slab: {slab_check}")
    check(abs(eng.n_alive() - RING_SUBSETS_JAX_CPU_ALIVE)
          <= 0.1 * RING_SUBSETS_JAX_CPU_ALIVE,
          f"ring_spatial_subsets: {eng.n_alive()} alive vs "
          f"{RING_SUBSETS_JAX_CPU_ALIVE} (JAX)")
    check(frac >= RING_SUBSETS_JAX_CPU_WITHIN_002 - 0.02,
          f"ring_spatial_subsets: {frac} within 0.02")
    check(frac_4gsd >= RING_SUBSETS_JAX_CPU_WITHIN_4GSD - 0.02,
          f"ring_spatial_subsets: {frac_4gsd} within 4 GSD")
    return launches, eng.n_alive(), frac, frac_4gsd


def noisy_ba_problem(prob, device):
    """prob with BA_SHARDED_NOISE_PX of Gaussian noise (seed 7) on every
    observation: the optimum then depends on every measurement, so a
    sharded solve that loses or repeats a shard's partial sums moves it."""
    import torch
    gen = torch.Generator(device=device).manual_seed(7)
    return prob._replace(m_uv=prob.m_uv + BA_SHARDED_NOISE_PX * torch.randn(
        prob.m_uv.shape, generator=gen, device=device))


def ba_shard_agreement(ref, out):
    """A sharded solve `out` against the unsharded `ref` (both (cameras,
    points, RMS history)): the relative difference of the first RMS entry
    (the RMS over every shard's measurements at the start, the same sums
    in another order) and of the whole history, the largest camera and
    point differences, and whether all four are inside their tolerances."""
    h1 = ref[2][:len(out[2])]
    rel = ((out[2] - h1).abs() / h1).cpu()
    m = dict(rms0_rel_diff=float(rel[0]), rms_max_rel_diff=float(rel.max()),
             cam_max_abs_diff=float((out[0] - ref[0]).abs().max()),
             pts_max_abs_diff=float((out[1] - ref[1]).abs().max()))
    m["agree"] = (len(out[2]) == len(ref[2]) - 1
                  and m["rms0_rel_diff"] <= BA_SHARDED_RMS0_RTOL
                  and m["rms_max_rel_diff"] <= BA_SHARDED_RMS_RTOL
                  and m["cam_max_abs_diff"] <= BA_SHARDED_CAM_TOL
                  and m["pts_max_abs_diff"] <= BA_SHARDED_PTS_TOL)
    return m


def facade_ba_sharded_phase(device, solved):
    """facade_ba_dense's problem (its perturbed cameras, two anchors) made
    noisy (noisy_ba_problem), solved twice by ba_solve (the run-to-run
    spread of the atomic sums) and by shard_problem + ba_solve_sharded over
    8 shards, where every per-camera and per-point sum is a sum of the
    shards' partial sums: the RMS history, the cameras and the points must
    agree with the first unsharded solve (ba_shard_agreement).
    tools/ba_shard_faults.py shows that the check fails when mesh.psum
    drops a shard or counts one twice."""
    import torch
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.parallel import ba
    prob, n_cams, n_pts, iters, cg = solved
    kernels.reset_counts()
    prob = noisy_ba_problem(prob, device)
    mesh = shard_mesh(device, BA_SHARDED_SHARDS)
    t = time.time()
    sp = ba.shard_problem(prob, mesh.size)
    shard_s = time.time() - t

    def timed(fn):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    def unsharded():
        return ba.ba_solve(prob, n_cams, n_pts, iters=iters, cg_iters=cg,
                           fix_count=2, device=device)

    def sharded():
        return ba.ba_solve_sharded(mesh, sp, n_cams, n_pts, iters=iters,
                                   cg_iters=cg, fix_count=2)

    ref, ms1 = timed(unsharded)
    again, _ = timed(unsharded)
    timed(sharded)                           # warm-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, ms = timed(sharded)
    peak = torch.cuda.max_memory_allocated() - base
    spread = ba_shard_agreement(ref, (again[0], again[1], again[2][:-1]))
    agree = ba_shard_agreement(ref, out)
    hs = [float(x) for x in out[2].cpu()]
    launches, twins = launch_counts()
    emit("facade_ba_sharded", shards=mesh.size, patches=n_pts,
         measurements=int(prob.m_cam.shape[0]),
         padded_measurements=int(sp.m_cam.shape[0]), gn_iters=iters,
         cg_iters=cg, noise_px=BA_SHARDED_NOISE_PX, shard_problem_s=shard_s,
         solve_ms=ms, unsharded_solve_ms=ms1, solve_peak_bytes=peak,
         rms_hist=hs, unsharded_rms_hist=[float(x) for x in ref[2].cpu()],
         **agree, unsharded_spread=spread,
         tolerances=dict(rms0_rel=BA_SHARDED_RMS0_RTOL,
                         rms_rel=BA_SHARDED_RMS_RTOL,
                         cam_abs=BA_SHARDED_CAM_TOL,
                         pts_abs=BA_SHARDED_PTS_TOL),
         launches=launches, twin_calls=twins)
    check(not any(twins.values()), f"facade_ba_sharded: a twin ran: {twins}")
    check(agree["agree"], f"facade_ba_sharded: the sharded solve differs "
                          f"from the unsharded one: {agree}")
    check(hs[-1] < hs[0] / 5.0, f"facade_ba_sharded: RMS {hs}")


def plane_stream_spatial_phase(device, spatial_alive):
    """plane_spatial's plane and Options streamed in two chunks into a
    4-shard spatial engine with image subsets: cameras 0-3 with the points
    they see at least twice, less every other point of the plane's central
    region, one octree level, then cameras 4-6 with the rest, then to
    completion: the old z-buffer is an unchanged prefix right after the
    extension, and the alive count within 10% of the one-shot
    plane_spatial run's. The second chunk's seeds lie inside the first
    chunk's root cube, which holds the plane's outer points as the one-shot
    run's does: the final density is resolution-bound at a cell size, so
    another cube (a reroot doubles it) would change the count by its width
    ratio squared (facade_stream exercises the reroot)."""
    import numpy as np
    import torch
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.config import Options
    from hpmvs_tpu_torch.runtime.streaming import StreamingEngine
    from hpmvs_tpu_torch.testing import make_plane_scene, split_model
    ps = make_plane_scene(n_cams=7, imgsize=512, n_points=200, seed=0)
    opt = dataclasses.replace(Options(), **SPATIAL_OPT)
    m = ps.model
    lo = np.asarray([(m.meas_img[m.meas_start[i]:m.meas_start[i + 1]]
                      < 4).sum() for i in range(m.n_points)])
    xy = m.points_xyz[:, :2] - m.points_xyz[:, :2].mean(0)
    central = (np.abs(xy) < 0.5 * np.abs(xy).max(0)).all(1)
    later = central & (np.cumsum(central) % 2 == 0)
    first, second = split_model(m, 4, ~later & (lo >= 2))
    mesh = shard_mesh(device, STREAM_SPATIAL_SHARDS)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    budget = budget_left(STREAM_SPATIAL_BUDGET_S)
    check(budget > 30.0, f"plane_stream_spatial: only {budget:.0f} s left")
    t0 = time.time()
    st = StreamingEngine(opt, mesh=mesh, spatial=True, image_subsets=True)
    n1 = st.add_chunk(first, images=ps.images[:4])
    eng = st.engine
    first_prio = min(eng.queue)
    st.run_to((first_prio // 10 + 1) * 10 - 1)
    eng._flush_depths()
    old_depth = eng.pack.depth.clone()
    alive_mid = eng.n_alive()
    t = time.time()
    n2 = st.add_chunk(second, images=ps.images[4:])
    torch.cuda.synchronize()
    extend_s = time.time() - t
    prefix_equal = torch.equal(eng.pack.depth[:len(old_depth)], old_depth)
    del old_depth
    for prio in range(opt.max_prio):
        eng.process_priority_step(prio)
        if not eng.have_work() or time.time() - t0 > budget:
            break
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, twins = launch_counts()
    c = eng.alive_arrays()[0]
    frac = float((np.abs(c[:, 2] - ps.plane_z) < 0.02).mean())
    finished = not eng.queue or min(eng.queue) >= opt.max_prio
    emit("plane_stream_spatial", shards=mesh.size,
         chunk_cameras=[4, 3], chunk_points=[first.n_points,
                                             second.n_points],
         seeds=[n1, n2], stream_seeds=int(eng.stats["stream_seeds"]),
         reroots=int(eng.stats["reroots"]), alive_mid=alive_mid,
         prefix_equal=prefix_equal, extend_s=extend_s, wall_s=wall,
         budget_s=budget, finished=finished, alive=eng.n_alive(),
         one_shot_spatial_alive=spatial_alive, frac_within_002=frac,
         hist=[int(x) for x in eng.tree.histogram()],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, twin_calls=twins, **spatial_stats(eng))
    check_path("plane_stream_spatial", "default", launches, twins)
    check(prefix_equal, "plane_stream_spatial: the old z-buffer prefix "
                        "changed")
    check(eng.stats["stream_seeds"] > 0,
          "plane_stream_spatial: no stream seeds")
    check(finished, "plane_stream_spatial: the run did not finish")
    check(eng.stats["slab_miss"] == 0, "plane_stream_spatial: slab_miss")
    check(frac >= 0.95, f"plane_stream_spatial: {frac} within 0.02")
    check(abs(eng.n_alive() - spatial_alive) <= 0.1 * spatial_alive,
          f"plane_stream_spatial: {eng.n_alive()} alive vs the one-shot "
          f"spatial plane's {spatial_alive}")
    return launches


# ----------------------------------------------------------------------
# the multi-process system: two processes on the one card, one gloo group
# ----------------------------------------------------------------------
MP_PROCESSES = 2
MP_MESH_SHARDS = 2             # per process: plane_mp_mesh's 4 shards
MP_OWNED_SHARDS = 4            # per process: the owned phases' 8 shards
MP_GROUP_TIMEOUT_S = 300.0     # a collective one process skips fails
MP_START_S = 120.0             # a worker's start-up, scene and exit
PLANE_MP_OWNED_BUDGET_S = 240.0
# the owned engine's count is held to the JAX owned engine's, not to the
# spatial engine's: its root cube is pinned to the SfM points' cube (the
# seeds' cube in the spatial engine), and the final density is
# resolution-bound at a cell size. tools/plane_reference.py --scene
# plane200 --shards 8 --spatial --owned --port: JAX 21181 alive at one
# process over 8 virtual CPU devices (the spatial engine: 19973), the port
# 21415 on 8 CPU shards; 1.000 within 0.02 for both.
PLANE_OWNED_JAX_CPU_ALIVE = 21181
RING_MP_BUDGET_S = 240.0
# the same for the ring (--scene ring --shards 8 --spatial --image_subsets
# --owned): the JAX owned engine at one process keeps 18479 patches, 0.0796
# within 0.02 and 0.2699 within 4 GSD -- the ring's SfM points span about
# twice its seeds' extent, so the pinned cube's cells are twice as coarse
# as the spatial engine's (ring_spatial_subsets: ~59000, 0.77 / 0.94)
RING_OWNED_JAX_CPU_ALIVE = 18479
RING_OWNED_JAX_CPU_WITHIN_002 = 0.0796
RING_OWNED_JAX_CPU_WITHIN_4GSD = 0.2699
MP_SHARE_FLOOR = 0.10          # each process's share of the patches


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def mp_run(phase, budget, *args):
    """Start MP_PROCESSES workers (`chip_smoke.py --mp-worker <rank> <port>
    <phase> [args]`, one gloo group on 127.0.0.1 with an explicit address
    and world size) and return each one's result. A worker that fails or
    outlives its timeout fails the phase; every worker is stopped."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), "--mp-worker",
         str(r), str(port), phase] + [str(a) for a in args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MP_PROCESSES)]
    outs = [None] * MP_PROCESSES
    deadline = time.time() + budget + MP_START_S
    try:
        for r, p in enumerate(procs):
            try:
                outs[r] = p.communicate(
                    timeout=max(deadline - time.time(), 10.0))[0]
            except subprocess.TimeoutExpired:
                check(False, f"{phase}: worker {r} outlived its "
                             f"{budget + MP_START_S:.0f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    os.makedirs(OUT_DIR, exist_ok=True)
    res = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        with open(os.path.join(OUT_DIR, f"{phase}_worker{r}.log"), "w") as fh:
            fh.write(out)
        check(p.returncode == 0, f"{phase}: worker {r} exit "
                                 f"{p.returncode}:\n{out[-3000:]}")
        line = [ln for ln in out.splitlines() if ln.startswith("MP_RESULT ")]
        check(bool(line), f"{phase}: worker {r} printed no result")
        res.append(json.loads(line[-1].split(" ", 1)[1]))
    return res


def mp_sum(res, key):
    """A per-worker {kernel: count} summed over the workers."""
    return {k: sum(r[key][k] for r in res) for k in res[0][key]}


def mp_same(x):
    """True on every process when x (a host array) is the same bits on
    all of them."""
    import numpy as np
    from hpmvs_tpu_torch.parallel import mesh as pmesh
    g = pmesh.allgather(np.ascontiguousarray(x))
    return bool(all(np.array_equal(g[0], gi) for gi in g[1:]))


def mp_worker(rank, port, phase, *args):
    """One process of a multi-process phase: brings up the group, drives
    the phase's path and prints its result as `MP_RESULT {...}`."""
    import torch
    from hpmvs_tpu_torch.parallel import mesh as pmesh
    check(pmesh.init_distributed(f"tcp://127.0.0.1:{port}", MP_PROCESSES,
                                 rank, timeout_s=MP_GROUP_TIMEOUT_S)
          == MP_PROCESSES, "the process group did not come up")
    fn = {"plane_mp_mesh": plane_mp_mesh_worker,
          "plane_mp_owned": plane_mp_owned_worker,
          "ring_mp_owned": ring_mp_owned_worker}[phase]
    res = fn(rank, *args)
    print("MP_RESULT " + json.dumps(res), flush=True)
    torch.distributed.destroy_process_group()


def plane_mp_mesh_worker(rank):
    """plane_mesh's plane and Options through pipeline.run over a mesh of
    MP_PROCESSES x MP_MESH_SHARDS shards: the replicated engine, each
    process computing its own shards' lanes, every dispatch's outputs
    allgathered."""
    import numpy as np
    import torch
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.parallel import mesh as pmesh
    from hpmvs_tpu_torch.runtime import pipeline
    opt, ps, _, _ = plane_setup("cuda")
    opt = dataclasses.replace(opt, OUTFOLDER=os.path.join(
        OUT_DIR, "plane_mp_mesh"))
    mesh = pmesh.make_mesh(["cuda"] * MP_MESH_SHARDS)
    torch.cuda.synchronize()
    wire0 = dict(pmesh.WIRE)
    kernels.reset_counts()
    t = time.time()
    eng = pipeline.run(ps.model, opt, images=ps.images, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches, twins = launch_counts()
    c = eng.alive_arrays()[0]
    st = eng.stats
    return dict(
        rank=rank, engine=type(eng).__name__, shards=mesh.size,
        mesh_shape=list(mesh.shape), local_shards=mesh.local_ids.tolist(),
        wall_s=wall, loop_s=float(st["proc_time"]), alive=eng.n_alive(),
        frac_within_002=float((np.abs(c[:, 2] - ps.plane_z) < 0.02).mean()),
        disp_extend=int(st["disp_extend"]),
        host_collectives=int(st["host_collectives"]),
        gather_bytes=int(st["mp_gather_bytes"]),
        wire_calls=pmesh.WIRE["calls"] - wire0["calls"],
        wire_bytes=pmesh.WIRE["bytes"] - wire0["bytes"],
        replicas_equal=all(torch.equal(r, eng.pack.depth)
                           for r in eng._replicas() if r is not None),
        zbuffer_same_across=mp_same(eng.pack.depth.cpu().numpy()),
        launches=launches, twin_calls=twins, **wave_stats(eng))


def plane_mp_mesh_phase(mesh_alive, mesh_loop_s):
    """The replicated multi-process engine: alive equal to plane_mesh's
    (the same 4-shard mesh in one process, the same scheduler)."""
    budget = budget_left(120.0)
    check(budget > 30.0, f"plane_mp_mesh: only {budget:.0f} s left")
    res = mp_run("plane_mp_mesh", budget)
    launches, twins = mp_sum(res, "launches"), mp_sum(res, "twin_calls")
    emit("plane_mp_mesh", processes=MP_PROCESSES,
         shards_per_process=MP_MESH_SHARDS, shards=res[0]["shards"],
         mesh_shape=res[0]["mesh_shape"],
         alive=[r["alive"] for r in res], plane_mesh_alive=mesh_alive,
         loop_s=[r["loop_s"] for r in res], plane_mesh_loop_s=mesh_loop_s,
         wall_s=[r["wall_s"] for r in res],
         frac_within_002=res[0]["frac_within_002"],
         dispatches=res[0]["dispatches"],
         gather_bytes_per_dispatch=[r["gather_bytes"]
                                    / max(r["disp_extend"], 1) for r in res],
         host_collectives=[r["host_collectives"] for r in res],
         wire_bytes=[r["wire_bytes"] for r in res],
         lookahead_hits=res[0]["lookahead_hits"],
         lookahead_misses=res[0]["lookahead_misses"],
         launches=launches, twin_calls=twins)
    check_path("plane_mp_mesh", "default", launches, twins)
    for r in res:
        check(r["engine"] == "Engine", f"plane_mp_mesh: {r['engine']}")
        check(r["alive"] == mesh_alive,
              f"plane_mp_mesh: rank {r['rank']} {r['alive']} alive vs "
              f"plane_mesh's {mesh_alive}")
        check(r["replicas_equal"] and r["zbuffer_same_across"],
              "plane_mp_mesh: the z-buffer replicas differ")
        check(r["frac_within_002"] >= 0.95,
              f"plane_mp_mesh: {r['frac_within_002']} within 0.02")
    return launches


def mp_owned_state(eng, rank):
    """The owned checks every process can make: its share, the ownership
    invariant, migrations against arrivals (summed over processes),
    slab_miss."""
    import numpy as np
    from hpmvs_tpu_torch.parallel import mesh as pmesh
    p = eng.patches
    live = np.nonzero(p.alive[:p.n])[0]
    own = eng.block_proc[eng.block_of_points(p.center[live])]
    st = eng.stats
    mig = pmesh.allgather(np.asarray([st["migrated"], st["halo_arrivals"],
                                      len(live)], np.int64))
    return dict(local_alive=int(len(live)),
                shares=(mig[:, 2] / max(mig[:, 2].sum(), 1)).tolist(),
                owned_invariant=bool((own == rank).all()),
                migrated_sum=int(mig[:, 0].sum()),
                arrivals_sum=int(mig[:, 1].sum()),
                slab_miss=int(st["slab_miss"]),
                host_collectives=int(st["host_collectives"]),
                halo_bytes_xproc=int(st["halo_bytes_xproc"]),
                pend_gathered_rows=int(st["pend_gathered_rows"]),
                subset_rebuilds=int(st["subset_rebuilds"]),
                cams_per_shard=[int(x) for x in eng._committed_mask[
                    eng.mesh.local].sum(1)]
                if eng._committed_mask is not None else None)


def slab_fetch(eng, opt):
    """The fetch kernel on this process's busiest committed slab, at the
    windows its resident patches cut there, against its twin and the full
    pack's windows."""
    import numpy as np
    import torch
    from hpmvs_tpu_torch import kernel_check
    from hpmvs_tpu_torch.image.pyramid import ImagePack
    loc = eng.mesh.local_ids
    s = int(loc[np.argmax(eng._committed_mask[loc].sum(1))])
    p = eng.patches
    pids = np.nonzero(p.alive[:p.n])[0]
    pids = pids[eng.block_shard[eng.block_of_points(p.center[pids])] == s]
    pids = pids[:2048]
    dev = eng.device
    imgs = eng.scene.ctx.imgs
    full = ImagePack(tex=imgs.tex.to(dev), row0=imgs.row0, width=imgs.width,
                     height=imgs.height)
    ci = torch.as_tensor(p.views[pids], device=dev)
    cen = torch.as_tensor(p.center[pids], device=dev)[:, None].expand(
        ci.shape + (3,))
    scl = torch.as_tensor(p.scale[pids], device=dev)[:, None].expand(
        ci.shape)
    out = kernel_check.check_fetch_slab(
        eng.scene.ctx.cams, eng._bpack_dev[s], full, ci, cen, scl,
        opt.MAXLEVEL - 1, opt.WINDOW_SIZE)
    return dict(shard=s, patches=len(pids), **out)


def mp_dense_ba(eng):
    """tests/multihost_worker.py's owned dense BA (:222-253): observations
    under the true cameras, every camera but the two anchors drifted (one
    seed: the same drift on every process), cameras + patches re-solved
    over the process-spanning mesh."""
    import copy
    import numpy as np
    from hpmvs_tpu_torch.parallel import ba
    from hpmvs_tpu_torch.testing import _quatR, _rot_to_quat
    cg, _, _, _, vg, _ = eng.alive_arrays()
    true_model = eng.model
    true_c = np.asarray([c.c for c in true_model.cameras])
    prob_true = ba.build_dense_problem(true_model, cg, vg, device=eng.device)
    rng = np.random.default_rng(11)
    pert = copy.deepcopy(true_model)
    for cam in pert.cameras[2:]:
        w = rng.normal(0, 0.004, 3)
        th = np.linalg.norm(w) + 1e-12
        Km = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                       [-w[1], w[0], 0]]) / th
        dR = np.eye(3) + np.sin(th) * Km + (1 - np.cos(th)) * (Km @ Km)
        cam.rq = _rot_to_quat(_quatR(cam.rq) @ dR)
        cam.c = cam.c + rng.normal(0, 0.01, 3)
    pre = np.linalg.norm(np.asarray([c.c for c in pert.cameras]) - true_c,
                         axis=1)
    eng.model = pert
    prob = ba.build_dense_problem(pert, cg, vg, device=eng.device)._replace(
        m_uv=prob_true.m_uv)
    t = time.time()
    hist = np.asarray(ba.apply_dense_ba(eng, problem=prob))
    solve_s = time.time() - t
    cams = np.asarray([np.concatenate([c.rq, c.c])
                       for c in eng.model.cameras])
    post = np.linalg.norm(cams[:, 4:] - true_c, axis=1)
    return dict(patches=len(cg), rms=[float(hist[0]), float(hist[-1])],
                cam_err_median=[float(np.median(pre[2:])),
                                float(np.median(post[2:]))],
                solve_s=solve_s, cams_same_across=mp_same(cams))


def plane_mp_owned_worker(rank):
    """plane_spatial's plane and Options through pipeline.run over
    MP_PROCESSES x MP_OWNED_SHARDS shards with image subsets: the owned
    engine, to completion. Its state is checkpointed per process at the
    end of the first octree level that had work; the shares load into
    fresh owned engines (state equal) and pipeline.run(resume=...) runs
    them to completion. Then owned dense BA on the completed cloud."""
    import numpy as np
    import torch
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.config import Options
    from hpmvs_tpu_torch.parallel import mesh as pmesh
    from hpmvs_tpu_torch.runtime import checkpoint as ckpt
    from hpmvs_tpu_torch.runtime import pipeline
    from hpmvs_tpu_torch.runtime.owned import OwnedSpatialEngine
    from hpmvs_tpu_torch.testing import make_plane_scene
    ps = make_plane_scene(n_cams=7, imgsize=512, n_points=200, seed=0)
    out_dir = os.path.join(OUT_DIR, "plane_mp_owned")
    opt = dataclasses.replace(Options(), **SPATIAL_OPT, OUTFOLDER=out_dir)
    mesh = pmesh.make_mesh(["cuda"] * MP_OWNED_SHARDS)
    path = os.path.join(out_dir, "checkpoint.npz")
    saved = {}

    def save_once(engine, prio):
        if "prio" in saved or prio % 10 != 9 or not engine._count_global(
                int(engine.stats["cells_processed"])):
            return
        t = time.time()
        ckpt.save_checkpoint(engine, path)
        saved.update(prio=prio, save_s=time.time() - t,
                     state=alive_state(engine),
                     depth=engine.pack.depth.clone(),
                     alive=engine.n_alive())

    torch.cuda.synchronize()
    wire0 = dict(pmesh.WIRE)
    kernels.reset_counts()
    t = time.time()
    eng = pipeline.run(ps.model, opt, images=ps.images, mesh=mesh,
                       spatial=True, image_subsets=True,
                       snapshot_hook=save_once)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches, twins = launch_counts()
    wire = pmesh.WIRE["bytes"] - wire0["bytes"]
    c = eng.alive_arrays()[0]
    res = dict(rank=rank, engine=type(eng).__name__, shards=mesh.size,
               wall_s=wall, loop_s=float(eng.stats["proc_time"]),
               alive=eng.n_alive(), finished=not eng.have_work(),
               frac_within_002=float((np.abs(c[:, 2] - ps.plane_z)
                                      < 0.02).mean()),
               wire_bytes=wire, launches=launches, twin_calls=twins,
               **mp_owned_state(eng, rank))
    res["slab_fetch"] = slab_fetch(eng, opt)
    # the per-process checkpoint: load into a fresh owned engine
    check("prio" in saved, "plane_mp_owned: no checkpoint was written")
    t = time.time()
    fresh = OwnedSpatialEngine(ps.model, opt, images=ps.images, mesh=mesh,
                               image_subsets=True)
    ckpt.load_checkpoint(fresh, path, device=fresh.device)
    load_s = time.time() - t
    st_f, st_s = alive_state(fresh), saved["state"]
    state_equal = (all(np.array_equal(st_f[0][k], st_s[0][k])
                       for k in st_s[0]) and st_f[1:] == st_s[1:]
                   and torch.equal(fresh.pack.depth, saved["depth"]))
    del fresh
    opt_r = dataclasses.replace(opt, OUTFOLDER=out_dir + "_resumed")
    resumed = pipeline.run(ps.model, opt_r, images=ps.images, mesh=mesh,
                           spatial=True, image_subsets=True, resume=path)
    res["checkpoint"] = dict(
        prio=saved["prio"], alive_at_save=saved["alive"],
        save_s=saved["save_s"], load_s=load_s,
        file_bytes=os.path.getsize(f"{path}.proc{rank}of{MP_PROCESSES}.npz"),
        state_equal=bool(state_equal), resumed_alive=resumed.n_alive(),
        resumed_finished=not resumed.have_work())
    del resumed
    res["dense_ba"] = mp_dense_ba(eng)
    return res


def plane_mp_owned_phase(spatial_alive):
    """The owned engine with image subsets on plane_spatial's plane: alive
    within 10% of the JAX owned engine's (PLANE_OWNED_JAX_CPU_ALIVE),
    plane_spatial's count and the ratio beside it."""
    budget = budget_left(PLANE_MP_OWNED_BUDGET_S)
    check(budget > 30.0, f"plane_mp_owned: only {budget:.0f} s left")
    res = mp_run("plane_mp_owned", budget)
    launches, twins = mp_sum(res, "launches"), mp_sum(res, "twin_calls")
    r0 = res[0]
    emit("plane_mp_owned", processes=MP_PROCESSES,
         shards_per_process=MP_OWNED_SHARDS, shards=r0["shards"],
         alive=r0["alive"], jax_cpu_owned_alive=PLANE_OWNED_JAX_CPU_ALIVE,
         plane_spatial_alive=spatial_alive,
         over_plane_spatial=r0["alive"] / max(spatial_alive, 1),
         finished=r0["finished"], shares=r0["shares"],
         frac_within_002=r0["frac_within_002"],
         loop_s=[r["loop_s"] for r in res], wall_s=[r["wall_s"] for r in res],
         migrated_sum=r0["migrated_sum"], arrivals_sum=r0["arrivals_sum"],
         host_collectives=[r["host_collectives"] for r in res],
         halo_bytes_xproc=[r["halo_bytes_xproc"] for r in res],
         wire_bytes=[r["wire_bytes"] for r in res],
         cams_per_shard=[r["cams_per_shard"] for r in res],
         slab_fetch=[r["slab_fetch"] for r in res],
         checkpoint=[r["checkpoint"] for r in res],
         dense_ba=[r["dense_ba"] for r in res],
         launches=launches, twin_calls=twins)
    check_path("plane_mp_owned", "default", launches, twins)
    check(all(r["engine"] == "OwnedSpatialEngine" for r in res),
          "plane_mp_owned: not the owned engine")
    check(r0["finished"], "plane_mp_owned: the run did not finish")
    check(abs(r0["alive"] - PLANE_OWNED_JAX_CPU_ALIVE)
          <= 0.1 * PLANE_OWNED_JAX_CPU_ALIVE,
          f"plane_mp_owned: {r0['alive']} alive vs the JAX owned "
          f"engine's {PLANE_OWNED_JAX_CPU_ALIVE}")
    check(min(r0["shares"]) > MP_SHARE_FLOOR,
          f"plane_mp_owned: shares {r0['shares']}")
    check(r0["migrated_sum"] == r0["arrivals_sum"] > 0,
          f"plane_mp_owned: {r0['arrivals_sum']} arrivals of "
          f"{r0['migrated_sum']} migrated")
    check(r0["frac_within_002"] >= 0.95,
          f"plane_mp_owned: {r0['frac_within_002']} within 0.02")
    for r in res:
        k = r["checkpoint"]
        b = r["dense_ba"]
        check(r["owned_invariant"], f"plane_mp_owned: rank {r['rank']} "
                                    "holds a foreign patch")
        check(r["slab_miss"] == 0, f"plane_mp_owned: slab_miss "
                                   f"{r['slab_miss']}")
        check(r["slab_fetch"]["equal_twin"] and r["slab_fetch"]["equal_full"],
              f"plane_mp_owned: the fetch kernel on a slab: "
              f"{r['slab_fetch']}")
        check(k["state_equal"], "plane_mp_owned: the loaded checkpoint "
                                "differs from the saved state")
        check(k["resumed_finished"] and abs(k["resumed_alive"] - r["alive"])
              <= 0.1 * r["alive"],
              f"plane_mp_owned: resumed {k['resumed_alive']} vs "
              f"{r['alive']}")
        check(b["rms"][1] < b["rms"][0] / 3.0,
              f"plane_mp_owned: dense BA RMS {b['rms']}")
        check(b["cam_err_median"][1] < b["cam_err_median"][0] / 2.0,
              f"plane_mp_owned: camera error {b['cam_err_median']}")
        check(b["cams_same_across"], "plane_mp_owned: the BA's cameras "
                                     "differ across processes")
    return launches


def ring_mp_owned_worker(rank, budget):
    """make_ring_plane_scene() with RING_OPT on the owned engine with image
    subsets over MP_PROCESSES x MP_OWNED_SHARDS shards, under a wall
    budget that the processes agree on."""
    import numpy as np
    import torch
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.config import Options
    from hpmvs_tpu_torch.parallel import mesh as pmesh
    from hpmvs_tpu_torch.runtime.owned import OwnedSpatialEngine
    from hpmvs_tpu_torch.testing import make_ring_plane_scene
    budget = float(budget)
    sc = make_ring_plane_scene()
    opt = dataclasses.replace(Options(), **RING_OPT)
    mesh = pmesh.make_mesh(["cuda"] * MP_OWNED_SHARDS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wire0 = dict(pmesh.WIRE)
    kernels.reset_counts()
    waves = [0]

    def count(engine):
        waves[0] += 1

    t = time.time()
    eng = OwnedSpatialEngine(sc.model, opt, images=sc.images, mesh=mesh,
                             image_subsets=True)
    eng.wave_hook = count
    eng.seed()
    prio = 0
    for prio in range(opt.max_prio):
        eng.process_priority_step(prio)
        # the stop is agreed: every process leaves the loop together
        if not eng.have_work() or eng._count_global(
                int(time.time() - t > budget)):
            break
    torch.cuda.synchronize()
    wall = time.time() - t
    launches, twins = launch_counts()
    wire = dict(calls=pmesh.WIRE["calls"] - wire0["calls"],
                bytes=pmesh.WIRE["bytes"] - wire0["bytes"])
    c = eng.alive_arrays()[0]
    d = np.abs(c[:, 2] - sc.plane_z)
    st = eng.stats
    return dict(rank=rank, wall_s=wall, budget_s=budget,
                finished=not eng.have_work(), loop_stopped_at_prio=prio,
                alive=eng.n_alive(),
                frac_within_002=float((d < 0.02).mean()),
                frac_within_4gsd=float((d < 4 * RING_GSD).mean()),
                waves=waves[0], dispatches=int(st["dispatches"]),
                patches_optimized=int(st["patches_optimized"]),
                wire_calls=wire["calls"], wire_bytes=wire["bytes"],
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                launches=launches, twin_calls=twins,
                **mp_owned_state(eng, rank))


def ring_mp_owned_phase(ring_alive, ring_frac, ring_frac_4gsd):
    """The 150-camera ring on the owned engine with slabs, held to the JAX
    owned engine at one process as ring_spatial_subsets is held to the
    JAX spatial engine (its shares at most 0.02 below, alive within 10%
    when the run completes); ring_spatial_subsets' numbers beside."""
    budget = budget_left(RING_MP_BUDGET_S) - MP_START_S
    check(budget > 30.0, f"ring_mp_owned: only {budget:.0f} s left")
    res = mp_run("ring_mp_owned", budget, budget)
    launches, twins = mp_sum(res, "launches"), mp_sum(res, "twin_calls")
    r0 = res[0]
    emit("ring_mp_owned", processes=MP_PROCESSES,
         shards_per_process=MP_OWNED_SHARDS, budget_s=budget,
         finished=r0["finished"], loop_stopped_at_prio=r0[
             "loop_stopped_at_prio"],
         alive=r0["alive"], jax_cpu_owned_alive=RING_OWNED_JAX_CPU_ALIVE,
         ring_spatial_subsets_alive=ring_alive,
         frac_within_002=r0["frac_within_002"],
         frac_within_4gsd=r0["frac_within_4gsd"],
         jax_cpu_owned_within=[RING_OWNED_JAX_CPU_WITHIN_002,
                               RING_OWNED_JAX_CPU_WITHIN_4GSD],
         ring_spatial_subsets_within=[ring_frac, ring_frac_4gsd],
         shares=r0["shares"], wall_s=[r["wall_s"] for r in res],
         waves=r0["waves"],
         host_collectives=[r["host_collectives"] for r in res],
         host_collectives_per_wave=[r["host_collectives"]
                                    / max(r["waves"], 1) for r in res],
         wire_bytes=[r["wire_bytes"] for r in res],
         halo_bytes_xproc=[r["halo_bytes_xproc"] for r in res],
         migrated_sum=r0["migrated_sum"], arrivals_sum=r0["arrivals_sum"],
         pend_gathered_rows=[r["pend_gathered_rows"] for r in res],
         subset_rebuilds=[r["subset_rebuilds"] for r in res],
         cams_per_shard=[r["cams_per_shard"] for r in res],
         patches_optimized=[r["patches_optimized"] for r in res],
         max_memory_allocated=[r["max_memory_allocated"] for r in res],
         launches=launches, twin_calls=twins)
    check_path("ring_mp_owned", "default", launches, twins)
    check(r0["migrated_sum"] == r0["arrivals_sum"],
          f"ring_mp_owned: {r0['arrivals_sum']} arrivals of "
          f"{r0['migrated_sum']} migrated")
    for r in res:
        check(r["owned_invariant"] and r["slab_miss"] == 0,
              f"ring_mp_owned: rank {r['rank']}: invariant "
              f"{r['owned_invariant']}, slab_miss {r['slab_miss']}")
    check(r0["frac_within_002"] >= RING_OWNED_JAX_CPU_WITHIN_002 - 0.02
          and r0["frac_within_4gsd"] >= RING_OWNED_JAX_CPU_WITHIN_4GSD
          - 0.02, f"ring_mp_owned: {r0['frac_within_002']} / "
                  f"{r0['frac_within_4gsd']} against the JAX owned "
                  f"engine's {RING_OWNED_JAX_CPU_WITHIN_002} / "
                  f"{RING_OWNED_JAX_CPU_WITHIN_4GSD}")
    if r0["finished"]:
        check(abs(r0["alive"] - RING_OWNED_JAX_CPU_ALIVE)
              <= 0.1 * RING_OWNED_JAX_CPU_ALIVE,
              f"ring_mp_owned: {r0['alive']} alive vs the JAX owned "
              f"engine's {RING_OWNED_JAX_CPU_ALIVE}")
    return launches


def ring_profile_phase(device):
    """The ring plane once unprofiled, then once under torch.profiler with
    device activity only: patches/s, device busy time, idle share of the
    unprofiled wall, the GN kernel's and the gathers' device time."""
    from hpmvs_tpu_torch.testing import make_ring_plane_scene
    sc = make_ring_plane_scene()
    eng, _, wall, _ = ring_run(device, sc, RING_BUDGET_S)
    n_opt = int(eng.stats["patches_optimized"])
    del eng
    (_, _, wall_prof, _), us, calls = profiled(
        lambda: ring_run(device, sc, RING_BUDGET_S))
    busy = sum(us.values()) / 1e6
    gn_s = sum(v for k, v in us.items() if "gn_refine_kernel" in k) / 1e6
    gk = [k for k in us if any(g in k for g in GATHER_KERNELS)]
    top = sorted(us.items(), key=lambda kv: -kv[1])[:10]
    emit("ring_profile", loop_wall_s=wall, patches_optimized=n_opt,
         patches_per_s=n_opt / max(wall, 1e-9), profiled_wall_s=wall_prof,
         device_busy_s=busy, idle_share=1.0 - busy / wall, gn_s=gn_s,
         gathers_s=sum(us[k] for k in gk) / 1e6,
         gather_launches=sum(calls[k] for k in gk),
         top=[{"kernel": k[:90], "s": v / 1e6} for k, v in top])


# csrc kernel function -> kernel name (gn_refine_kernel is the exact mode on
# the default paths and the FD/Broyden mode on exactref_fd)
PROFILE_KERNELS = {"fetch_windows_kernel": "fetch",
                   "sample_views_kernel": "score",
                   "permute_windows_kernel": "permute",
                   "gn_refine_kernel": {"exactref_fd": "gn_fd"},
                   "add_views_kernel": "add_views",
                   "sort_views_kernel": "sort_views"}
# torch's advanced-indexing gathers (t[idx]) as the profiler names them
GATHER_KERNELS = ("index_elementwise_kernel", "vectorized_gather_kernel")


def profile_phase(device):
    """The plane at the defaults and on the classic engine, unprofiled in
    turns (default, classic, classic, default), then each under
    torch.profiler with device activity only: device busy time (the sum of
    kernel times; one stream), the GN kernel's share of it, the gathers'
    device time, the top kernels, and the idle share of the path's mean
    unprofiled wall. Then the classic plane with the 9-gather depth gates
    (pool_full_depth switched off) and the exactref_fd plane, profiled. For
    each profiled run, every hand-written kernel's device time and launches
    in the run (profiler) beside its wrapper's launch count."""
    from unittest import mock
    import torch
    from hpmvs_tpu_torch import kernels
    from hpmvs_tpu_torch.core import depth as depth_mod
    from hpmvs_tpu_torch.runtime import pipeline
    opt, ps, _, _ = plane_setup(device)

    def run(path):
        o = dataclasses.replace(opt, **PATH_SWITCHES[path],
                                OUTFOLDER=os.path.join(OUT_DIR,
                                                       f"profile_{path}"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        t = time.time()
        eng = pipeline.run(ps.model, o, images=ps.images, device=device)
        torch.cuda.synchronize()
        return time.time() - t, eng

    walls = {"default": [], "classic": []}
    for path in ("default", "classic", "classic", "default"):
        wall, eng = run(path)
        walls[path].append(wall)
        n_opt = int(eng.stats["patches_optimized"])
        loop = float(eng.stats["proc_time"])
        emit("plane_run", path=path, wall_s=wall, loop_s=loop,
             alive=eng.n_alive(), patches_optimized=n_opt,
             loop_patches_per_s=n_opt / max(loop, 1e-9),
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             **wave_stats(eng))
    runs = (("default", "default", contextlib.nullcontext()),
            ("classic", "classic", contextlib.nullcontext()),
            ("classic_nine_gathers", "classic",
             mock.patch.object(depth_mod, "pool_full_depth",
                               lambda full0: None)),
            ("exactref_fd", "exactref_fd", contextlib.nullcontext()))
    for label, path, patch in runs:
        with patch:
            (wall_prof, _), us, calls = profiled(lambda: run(path))
        launches, _ = launch_counts()
        busy = sum(us.values()) / 1e6
        gn_s = sum(v for k, v in us.items() if "gn_refine_kernel" in k) / 1e6
        gk = [k for k in us if any(g in k for g in GATHER_KERNELS)]
        top = sorted(us.items(), key=lambda kv: -kv[1])[:10]
        hand = {}
        for fn, name in PROFILE_KERNELS.items():
            if isinstance(name, dict):
                name = name.get(path, "gn")
            keys = [k for k in us if fn in k]
            hand[name] = {"device_ms": sum(us[k] for k in keys) / 1e3,
                          "kernel_launches": sum(calls[k] for k in keys),
                          "wrapper_launches": launches[name]}
        extra = {}
        if label in walls:
            wall = sum(walls[label]) / len(walls[label])
            extra = dict(mean_unprofiled_wall_s=wall,
                         idle_share=(1.0 - busy / wall) if busy else None)
        emit("profile", path=label, switches=PATH_SWITCHES[path],
             profiled_wall_s=wall_prof, device_busy_s=busy, gn_s=gn_s,
             gn_share=gn_s / busy if busy else None,
             gathers_s=sum(us[k] for k in gk) / 1e6,
             gather_launches=sum(calls[k] for k in gk), hand_written=hand,
             top=[{"kernel": k[:90], "s": v / 1e6} for k, v in top], **extra)


def facade_waves_phase(device):
    """The facade on the classic engine, then at the defaults (the wave
    defaults' study: loop wall, alive, accuracy, wave counters)."""
    sc = render_facade()
    facade_phase(device, sc, "facade_classic", "classic",
                 FACADE_MAX_TREE_LEVEL, FACADE_BUDGET_S)
    facade_phase(device, sc, "facade", "default", FACADE_MAX_TREE_LEVEL,
                 FACADE_BUDGET_S)


def multi_device_phases(device, stream=True):
    """The single-process multi-device phases, then the multi-process ones
    (two processes on the card) held to them; {phase: launches}."""
    out = {}
    out["plane_mesh"], mesh_alive, mesh_loop = plane_mesh_phase(device)
    out["plane_spatial"], spatial_alive = plane_spatial_phase(device)
    (out["ring_spatial_subsets"], ring_alive, ring_frac,
     ring_frac_4gsd) = ring_spatial_subsets_phase(device)
    if stream:
        out["plane_stream_spatial"] = plane_stream_spatial_phase(
            device, spatial_alive)
    out["plane_mp_mesh"] = plane_mp_mesh_phase(mesh_alive, mesh_loop)
    out["plane_mp_owned"] = plane_mp_owned_phase(spatial_alive)
    out["ring_mp_owned"] = ring_mp_owned_phase(ring_alive, ring_frac,
                                               ring_frac_4gsd)
    return out


def main():
    kind, smi = device_phase()
    import torch
    from hpmvs_tpu_torch import kernel_check
    device = "cuda"
    build_phase()
    res = kernels_phase(device)
    deep_phase(device)
    planes = {
        "default": plane_phase(device, "plane", "default",
                               PLANE_JAX_CPU_ALIVE, PLANE_JAX_CPU_ALIVE),
        "classic": plane_phase(device, "plane_classic", "classic",
                               PLANE_CLASSIC_JAX_CPU_ALIVE,
                               PLANE_CLASSIC_JAX_CPU_ALIVE),
        "exactref_fd": plane_phase(device, "plane_exactref_fd", "exactref_fd",
                                   PLANE_EXACTREF_FD_ALIVE,
                                   PLANE_EXACTREF_FD_JAX_CPU_ALIVE)}
    path_launches = {k: v[0] for k, v in planes.items()}
    plane_resume_phase(device, planes["default"][1])
    plane_ba_dense_every_phase(device)
    sc = render_facade()
    eng = facade_phase(device, sc, "facade", "default",
                       FACADE_MAX_TREE_LEVEL, FACADE_BUDGET_S, keep=True)
    solved = facade_ba_dense_phase(device, eng)
    del eng
    facade_ba_sharded_phase(device, solved)
    del solved
    facade_phase(device, sc, "facade_exactref_fd", "exactref_fd",
                 FACADE_EXACTREF_FD_MAX_TREE_LEVEL,
                 FACADE_EXACTREF_FD_BUDGET_S)
    facade_stream_phase(device, sc)
    del sc
    ring_plane_phase(device)
    # the single-process multi-device paths, several shards on the card,
    # then the multi-process paths held to them
    mesh_launches = multi_device_phases(device)
    emit("smoke", elapsed_s=time.time() - T0, time_limit_s=TIME_LIMIT_S)
    # each kernel's launches on the first plane path that runs it, and
    # beside them its launches on each multi-device path
    runs = {}
    for path, ks in PATH_KERNELS.items():
        for k in ks:
            runs.setdefault(k, path)
    recs = []
    for r in res:
        if r.name not in kernel_check.KERNELS:
            continue
        rec = r.record(path_launches[runs[r.name]][r.name])
        rec["launches_by_phase"] = {ph: int(ln[r.name])
                                    for ph, ln in mesh_launches.items()}
        recs.append(rec)
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        import torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: FAILED: {e}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAILED: torch.cuda.is_available() is "
                         "false; this script needs an NVIDIA GPU")
    try:
        import hpmvs_tpu_torch  # noqa: F401  (the port, from this checkout)
    except ImportError as e:
        raise SystemExit(f"chip_smoke: FAILED: run from the repository "
                         f"root: {e}")
    if sys.argv[1:2] == ["--mp-worker"]:
        mp_worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:])
    elif sys.argv[1:] == ["--mp"]:
        device_phase()
        build_phase()
        plane_mesh_phase("cuda")
        multi_device_phases("cuda", stream=False)
        emit("smoke_mp", elapsed_s=time.time() - T0)
    elif sys.argv[1:] == ["--profile"]:
        device_phase()
        build_phase()
        profile_phase("cuda")
        ring_profile_phase("cuda")
    elif sys.argv[1:] == ["--facade-waves"]:
        device_phase()
        build_phase()
        facade_waves_phase("cuda")
    else:
        main()
