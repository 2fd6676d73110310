"""End-to-end progressive reconstruction driver: the hp_pmvs() equivalent.

Behavioral equivalent of src/main.cpp:98-206: load NVM -> build scene ->
extract covisibility -> seed + optimize -> priority loop over
(MAX_TREE_LEVEL+1)*10 steps with progressive PLY snapshots every 10 steps
(one octree level) -> final PLY. The reference's subtree decomposition +
OpenMP fan-out collapses into the Engine's batched wavefronts on one device.
"""

from __future__ import annotations

import logging
import os
import time

from hpmvs_tpu_torch import resolve_device
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.io import nvm as nvm_io
from hpmvs_tpu_torch.runtime.wavefront import Engine

log = logging.getLogger("hpmvs_tpu_torch")


def run(model: nvm_io.NvmModel, opt: Options, images=None,
        more_output: bool = False, light_output: int = 0,
        device="cuda") -> Engine:
    """Progressive densification main loop (main.cpp:145-202) on `device`:
    the GPU unless device="cpu" (RuntimeError when no GPU is visible)."""
    device = resolve_device(device)
    os.makedirs(opt.OUTFOLDER, exist_ok=True)
    engine = Engine(model, opt, images=images,
                    visdata_path=os.path.join(opt.OUTFOLDER, "testvis.dat"),
                    device=device)
    engine.seed()
    if more_output:
        engine.save_ply(os.path.join(opt.OUTFOLDER, "patches-init.ply"))

    t0 = time.time()
    for prio in range(opt.max_prio):
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

    engine.save_ply(os.path.join(opt.OUTFOLDER, "patches-final.ply"))
    if light_output > 0:
        engine.save_ply(os.path.join(opt.OUTFOLDER, "patches-final-light.ply"),
                        binary=True, normal=False, scale=False,
                        visibility=False)
    return engine


def run_nvm_file(path: str, opt: Options, **kw) -> Engine:
    models = nvm_io.read_nvm(path)
    if not models:
        raise ValueError(f"no models found in NVM file <{path}>")
    return run(models[0], opt, **kw)
