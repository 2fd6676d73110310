"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   -- the card (torch and nvidia-smi); no CUDA -> exit 1.
  2. build    -- nvcc builds hpmvs_tpu_torch/csrc into build/ (one nvcc per
                 source, in parallel); the ptxas report of every kernel
                 (registers, static shared memory, stack, spills); then g++
                 builds the native octree library (native/octree_core.cpp).
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
  8. facade   -- an 11-camera 2048 px facade (Strecha fountain-P11 sized),
                 rendered once, under a wall budget, at the defaults: the
                 first octree level must finish with >= 0.85 of the patches
                 within 0.02 of the surface.
  9. facade_exactref_fd -- the same facade with FAST_SETREF=False and
                 LM_EXACT_J=False, under its own wall budget, same checks.
Any failed check raises (exit code 1). The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists the kernels (ms is
device_ms; call_ms beside it; launches from the plane at the defaults, gn_fd
from plane_exactref_fd).

python3 chip_smoke.py --profile instead builds the kernels and runs the
plane at the defaults and on the classic engine in turns (default, classic,
classic, default; loop wall, dispatches, wave counters, peak memory), then
each under torch.profiler (device activity only): busy time by kernel, the
GN kernel's share, the advanced-indexing gathers' device time, and the idle
share of the unprofiled runs' mean wall; the classic plane once more with
the depth gates' 9-gather path (no pooled gates) for the gathers' time
before the pooled gates; then the exactref_fd plane. For each profiled run,
every hand-written kernel's device time and launches.

python3 chip_smoke.py --facade-waves builds the kernels and runs the facade
on the classic engine, then at the defaults (the facade phase's checks).
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
OUT_DIR = "chiprun_out"
# which kernels each driven path must launch
PATH_KERNELS = {"default": ("fetch", "score", "permute", "gn"),
                "classic": ("fetch", "score", "permute", "gn"),
                "exactref_fd": ("fetch", "gn_fd")}
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
    return launches


def render_facade():
    from hpmvs_tpu_torch.testing import make_facade_scene
    t = time.time()
    sc = make_facade_scene(n_cams=11, imgsize=2048, n_points=300, seed=0)
    emit("facade_render", render_s=time.time() - t)
    return sc


def facade_phase(device, sc, name, path, max_tree_level, budget):
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
    del eng


# csrc kernel function -> kernel name (gn_refine_kernel is the exact mode on
# the default paths and the FD/Broyden mode on exactref_fd)
PROFILE_KERNELS = {"fetch_windows_kernel": "fetch",
                   "sample_views_kernel": "score",
                   "permute_windows_kernel": "permute",
                   "gn_refine_kernel": {"exactref_fd": "gn_fd"}}
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


def main():
    kind, smi = device_phase()
    import torch
    from hpmvs_tpu_torch import kernel_check
    device = "cuda"
    build_phase()
    res = kernels_phase(device)
    deep_phase(device)
    path_launches = {
        "default": plane_phase(device, "plane", "default",
                               PLANE_JAX_CPU_ALIVE, PLANE_JAX_CPU_ALIVE),
        "classic": plane_phase(device, "plane_classic", "classic",
                               PLANE_CLASSIC_JAX_CPU_ALIVE,
                               PLANE_CLASSIC_JAX_CPU_ALIVE),
        "exactref_fd": plane_phase(device, "plane_exactref_fd", "exactref_fd",
                                   PLANE_EXACTREF_FD_ALIVE,
                                   PLANE_EXACTREF_FD_JAX_CPU_ALIVE)}
    sc = render_facade()
    facade_phase(device, sc, "facade", "default", FACADE_MAX_TREE_LEVEL,
                 FACADE_BUDGET_S)
    facade_phase(device, sc, "facade_exactref_fd", "exactref_fd", 9,
                 FACADE_EXACTREF_FD_BUDGET_S)
    # each kernel's launches on the first plane path that runs it
    runs = {}
    for path, ks in PATH_KERNELS.items():
        for k in ks:
            runs.setdefault(k, path)
    print(json.dumps({"kernels": [
        r.record(path_launches[runs[r.name]][r.name])
        for r in res if r.name in kernel_check.KERNELS]}), flush=True)
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
    if sys.argv[1:] == ["--profile"]:
        device_phase()
        build_phase()
        profile_phase("cuda")
    elif sys.argv[1:] == ["--facade-waves"]:
        device_phase()
        build_phase()
        facade_waves_phase("cuda")
    else:
        main()
