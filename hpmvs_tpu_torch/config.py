"""Configuration for the PyTorch/CUDA progressive multi-view stereo engine.

Mirrors every tunable of the reference HPMVS (include/hpmvs/HpmvsOptions.h:29-58)
plus the constants that are hard-coded throughout the reference
(covisibility >= 50 shared points Scene.cpp:272, flatness thresholds 2.4/2.5/2.6
CellProcessor.cpp:347-352,407, extend N=6 / branch N=4 with 0.9/0.45 scale
factors CellProcessor.cpp:104-117,233-247, sort constants 5deg/10deg
PatchOptimizer.cpp:184, optimizer parameterization PatchOptimizer.cpp:322-399).

Engine knobs (batch shapes, view-slot count, LM iterations) are new: the
reference optimizes one patch at a time with nlopt BOBYQA; we optimize
thousands per step with a batched damped-Newton refiner.

Same fields and defaults as hpmvs_tpu.config.Options (tests/test_torch_host.py
holds them equal), wave lookahead and deep waves included.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Options:
    # ---- image pyramid (HpmvsOptions.h:32-34) ----
    MAXLEVEL: int = 5          # number of pyramid levels is MAXLEVEL+1
    MINLEVEL: int = 0
    START_LEVEL: int = 4       # level at which seed patches are created

    # ---- angles (HpmvsOptions.h:36-37), radians ----
    MAX_ANGLE: float = 60.0 * math.pi / 180.0
    MIN_ANGLE: float = 10.0 * math.pi / 180.0

    # ---- octree (HpmvsOptions.h:40-43) ----
    FILTER_SCENE_CENTER: bool = False
    PATCH_INIT_MAXLEVEL: int = 9
    MAX_TREE_LEVEL: int = 20
    PATCH_FINAL_MINLEVEL: int = 8

    # ---- optimization (HpmvsOptions.h:46-50) ----
    MAX_IMAGES_PER_PATCH: int = 6
    MIN_IMAGES_PER_PATCH: int = 3
    NCC_ALPHA_1: float = 0.4
    NCC_ALPHA_2: float = 0.5

    # ---- tests (HpmvsOptions.h:53) ----
    DEPTH_TEST_FACTOR: float = 1.0

    # ---- output ----
    OUTFOLDER: str = "/tmp/hpmvs_tpu"

    # ---- constants hard-coded in the reference ----
    COVIS_MIN_POINTS: int = 50         # Scene.cpp:272
    DEPTH_SUBSAMPLE: int = 2           # Scene.h:74
    MAX_DEPTH: float = 1000.0          # Scene.cpp:33
    PATCH_SIZE: int = 7                # Patch2d.hpp:88 (7x7x3 NCC window)
    SAMPLE_MARGIN: int = 3             # PatchOptimizer.cpp:503 safety margin
    EXTEND_DIRS: int = 6               # CellProcessor.cpp:104
    BRANCH_DIRS: int = 4               # CellProcessor.cpp:233
    EXTEND_SCALE: float = 0.9          # CellProcessor.cpp:117 (x cell width / 2)
    BRANCH_SCALE: float = 0.45         # CellProcessor.cpp:247
    EXTEND_DRIFT: float = 1.5          # CellProcessor.cpp:132 (x cell width)
    FLATNESS_REMOVE: float = 2.4       # CellProcessor.cpp:407
    FLATNESS_FEW_NEIGH: float = 2.5    # CellProcessor.cpp:350
    FLATNESS_NO_NEIGH: float = 2.6     # CellProcessor.cpp:347
    REGULARIZE_HWIN: int = 2           # CellProcessor.cpp:327 (5x5 window)
    SORT_SUPPRESS_DEG: float = 10.0    # PatchOptimizer.cpp:184 (threshold angle)
    ANGLE_SCALE: float = math.pi / 48.0  # PatchOptimizer.cpp:398
    ANGLE_BOUND: float = 23.99999      # PatchOptimizer.cpp:326-327
    SEED_PROJ_MARGIN: int = 2          # Scene.cpp:91 (cSize)
    SEED_DRIFT: float = 2.0            # Scene.cpp:171 (x scale)

    # ---- engine knobs (no reference equivalent) ----
    # Same meaning as in hpmvs_tpu.config.Options (ops/optimizer.py selects
    # the stage pipeline and the refiner from them).
    USE_WINDOWS: bool = True   # cached-window sampling (ops/windows.py);
                               # False samples the full images and refines
                               # with the plain _optimize_patch
    USE_PALLAS_GN: bool = True  # refine with the GN kernel (ops/gn.py);
                               # False selects the plain refiner
                               # ops/optimizer._optimize_patch
    USE_BATCHED_STAGES: bool = True  # batch-level stage pipeline (kernels
                               # B2/B3); False runs the per-patch stages
    REUSE_POST_WINDOWS: bool = True  # post stage keeps pre-stage windows for
                               # surviving view slots; only new views are
                               # fetched (see _run_post_b docstring)
    WINDOW_SIZE: int = 12      # pixels per cached window side (the 7x7 grid
                               # spans ~7 px at the sampling level, leaving
                               # ~2.5 px drift margin)
    FAST_SETREF: bool = True   # setRefImage with shared slot-0 tangent frame
                               # (one sampling pass instead of K; the
                               # reference re-derives the frame per candidate
                               # ref -- documented divergence). False runs
                               # the reference's semantics on the per-patch
                               # stages.
    MAX_VIEWS: int = 16        # view slots per patch (reference: unbounded list)
    MAX_COVIS: int = 32        # covisible candidates considered per ref image
    LM_ITERS: int = 12         # FD/Broyden mode iterations
    LM_INNER: int = 3          # FD/Broyden trial steps per Jacobian refresh
    LM_LAMBDA0: float = 1e-2   # initial Levenberg damping
    LM_EXACT_J: bool = True    # analytic-Jacobian Levenberg loop; False
                               # runs the FD/Broyden mode
    LM_ITERS_EXACT: int = 8    # iterations of the exact-J loop
    LM_STEP_CLAMP: float = 4.0  # exact-J trust region: |step| <= clamp * h
                               # per iteration (h = natural param scales);
                               # the sqrt-residual GN Hessian is near-flat
                               # along weak directions and unclamped steps
                               # blow up there
    LM_H_SHRINK: float = 0.5   # FD step decay per Jacobian-refresh round
    LM_FTOL: float = 1e-4      # early-exit: stop once no patch of a
                               # 128-patch block improves f by more than
                               # this for two rounds (batched analog of
                               # BOBYQA xtol_rel, PatchOptimizer.cpp:352)
    BATCH: int = 2048          # wavefront batch size (chunk cap)
    EXTEND_SUBROUNDS: int = 1  # split each level's extend batch into R
                               # sequential sub-rounds with depth-buffer
                               # updates between them; 1 = one batch
    WAVE_LOOKAHEAD: bool = True  # dispatch wave N+1's extend batch (a
                               # deterministic function of wave N's fetched
                               # gate output and the current tree) BEFORE
                               # routing wave N, so host routing overlaps
                               # the device; removal-phase subtracts lag
                               # one dispatch (runtime/wavefront.py)
    WAVE_DEPTH: int = 4        # extend waves per deep dispatch
                               # (ops/deepwave.py): the device simulates the
                               # router between them, so the host waits for
                               # the device once per WAVE_DEPTH dependent
                               # waves; 1 = one wave per dispatch. Waves
                               # larger than BATCH take the chunked path
    DTYPE: str = "float32"
    BLOCK_OVERSUB: int = 8     # spatial mode: Morton blocks per shard,
                               # re-binned onto shards every dispatch round
                               # (runtime/spatial.py)
    REBALANCE_BELOW: float = 0.75  # image subsets: re-bin blocks (and
                                   # rebuild the shard slabs) only below
                                   # this balance

    @property
    def n_levels(self) -> int:
        return self.MAXLEVEL + 1

    @property
    def max_prio(self) -> int:
        # main.cpp:145: maxPrio = (MAX_TREE_LEVEL + 1) * 10
        return (self.MAX_TREE_LEVEL + 1) * 10


DEFAULT = Options()
