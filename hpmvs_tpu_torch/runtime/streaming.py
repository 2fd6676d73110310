"""Progressive streaming input: grow the scene while reconstruction runs.

Capability beyond the reference (BASELINE.json internet-scale config:
"progressive streaming input"); hpmvs loads one NVM up front. Here camera +
point chunks arrive incrementally: images append to the packed pyramid,
covisibility accumulates, the depth buffer extends (the old buffer is a
prefix of the new packing), and new SfM points seed into the EXISTING octree
-- joining occupied cells as multi-patch entries that the wavefront engine's
filter pass resolves, exactly like colliding seeds in the reference's
add() (doctree.h:378-394).

The octree root cube grows on demand: seeds outside the current cube
trigger a linear-octree reroot (every Morton key gains one level; queue
priorities shift +10), so a scene growing spatially keeps reconstructing --
capability beyond the reference, which drops outside-root patches
(CellProcessor.cpp:147). Each reroot deepens all levels by one, trading
one step of the finest resolution against the doubled extent.

The StreamingEngine of hpmvs_tpu/runtime/streaming.py. It composes with
every single-process engine mode: `mesh` for sharded wavefronts, `spatial`
for Morton-block ownership + halo migration, `image_subsets` for per-shard
image slabs. Scene rebuilds on chunk arrival go through
Engine.refresh_host_caches, which also drops the mesh closures and the
spatial engine's slabs; a reroot changes the root cube, so the slabs
rebuild at the next dispatch. Streaming over the owned multi-process
engine (runtime/owned.py) is in neither package.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from hpmvs_tpu_torch import resolve_device
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.core import depth as depth_mod
from hpmvs_tpu_torch.core import scene as scene_mod
from hpmvs_tpu_torch.io import nvm as nvm_io
from hpmvs_tpu_torch.runtime.wavefront import Engine

log = logging.getLogger("hpmvs_tpu_torch")


def merge_models(base: Optional[nvm_io.NvmModel],
                 chunk: nvm_io.NvmModel) -> nvm_io.NvmModel:
    """Concatenate cameras and points; chunk measurement camera indices are
    LOCAL to the chunk and get offset by the existing camera count."""
    if base is None:
        return chunk
    off = len(base.cameras)
    return nvm_io.NvmModel(
        cameras=list(base.cameras) + list(chunk.cameras),
        points_xyz=np.concatenate([base.points_xyz, chunk.points_xyz]),
        points_rgb=np.concatenate([base.points_rgb, chunk.points_rgb]),
        meas_start=np.concatenate(
            [base.meas_start,
             base.meas_start[-1] + chunk.meas_start[1:]]),
        meas_img=np.concatenate([base.meas_img, chunk.meas_img + off]),
        meas_feat=np.concatenate([base.meas_feat, chunk.meas_feat]),
        meas_xy=np.concatenate([base.meas_xy, chunk.meas_xy]),
    )


class StreamingEngine:
    """Incremental wrapper around the wavefront Engine, on one device (the
    GPU unless device="cpu") or over a mesh (parallel.mesh.Mesh: the
    engine runs on its shards and `device` is unused)."""

    def __init__(self, opt: Options, device="cuda", mesh=None,
                 spatial: bool = False, image_subsets: bool = False):
        if spatial and mesh is None:
            raise ValueError("spatial streaming requires a device mesh")
        self.opt = opt
        self.mesh = mesh
        self.spatial = spatial
        self.image_subsets = image_subsets
        self.device = resolve_device(device) if mesh is None \
            else mesh.devices[0]
        self.model: Optional[nvm_io.NvmModel] = None
        self.images: Optional[List[np.ndarray]] = None
        self.engine: Optional[Engine] = None

    def add_chunk(self, chunk: nvm_io.NvmModel, images=None) -> int:
        """Add cameras + points; returns the number of new seed patches."""
        first = self.model is None
        if images is not None:
            self.images = (list(images) if self.images is None
                           else self.images + list(images))
        self.model = merge_models(self.model, chunk)

        if first:
            self.engine = self._make_engine()
            return self.engine.seed()
        return self._extend(chunk)

    def _make_engine(self) -> Engine:
        if self.spatial:
            from hpmvs_tpu_torch.runtime.spatial import SpatialEngine
            return SpatialEngine(self.model, self.opt, images=self.images,
                                 mesh=self.mesh,
                                 image_subsets=self.image_subsets)
        if self.mesh is not None:
            return Engine(self.model, self.opt, images=self.images,
                          mesh=self.mesh)
        return Engine(self.model, self.opt, images=self.images,
                      device=self.device)

    def _extend(self, chunk: nvm_io.NvmModel) -> int:
        eng = self.engine
        opt = self.opt
        eng.drop_speculation()
        eng._flush_depths()  # pending adds must land before the repack
        n_old_cams = eng.scene.n_cameras
        old_pack = eng.pack
        # under a mesh the other shards' replicas equal shard 0's (the
        # window just flushed into every one): they are copied anew from the
        # grown pack at the next dispatch
        eng._depth_replicas = None

        # rebuild the scene over the grown camera set. Images append, and a
        # plane's row offset counts only the rows above it, so every
        # existing (image, level) keeps its offsets even when a new image is
        # wider than the packed buffer was. The pyramids are packed on the
        # host, so the old device pack goes first: both never sit on the
        # card at once.
        eng.scene = None
        eng.scene = scene_mod.build_scene(self.model, opt, images=self.images,
                                          device=eng.device,
                                          host_pack=eng._host_images)
        eng.model = self.model
        new_pack = depth_mod.build_depth_pack(
            eng.scene.width_np, eng.scene.height_np, opt.DEPTH_SUBSAMPLE,
            device=eng.device)
        if not torch.equal(new_pack.offset[:n_old_cams], old_pack.offset):
            raise RuntimeError("streaming: the grown depth pack moved an old "
                               "camera's buffers")
        old_total = old_pack.depth.shape[0]
        new_pack.depth[:old_total].copy_(old_pack.depth)
        eng.pack = new_pack
        del old_pack
        eng.refresh_host_caches()

        # seed only the new points (global camera indices already)
        n_old_pts = self.model.n_points - chunk.n_points
        m0 = self.model.meas_start[n_old_pts]
        sub = nvm_io.NvmModel(
            cameras=self.model.cameras,
            points_xyz=self.model.points_xyz[n_old_pts:],
            points_rgb=self.model.points_rgb[n_old_pts:],
            meas_start=self.model.meas_start[n_old_pts:] - m0,
            meas_img=self.model.meas_img[m0:],
            meas_feat=self.model.meas_feat[m0:],
            meas_xy=self.model.meas_xy[m0:],
        )
        c, n, s, v, orig = scene_mod.make_seed_patches(sub, eng.scene, opt)
        if c.shape[0] == 0:
            return 0
        oc, on, os_, ov, ok, col, _ = eng._optimize(c, n, s, v)
        with np.errstate(invalid="ignore"):
            drift = np.linalg.norm(oc - orig, axis=1) <= os_ * opt.SEED_DRIFT
        keep = ok & drift
        # grow the root cube toward seeds outside it (linear-octree reroot:
        # keys shift one level, queue priorities shift +10; the reference
        # would drop them, CellProcessor.cpp:147)
        for _ in range(12):
            outside = keep & ~eng.tree.contains(oc)
            if not outside.any():
                break
            delta = oc[outside] - eng.tree.center
            direction = np.sign(np.sum(np.sign(delta), axis=0))
            eng.reroot_tree(direction)
            log.info("streaming: rerooted tree to width %.3f for %d "
                     "outside seeds", eng.tree.width, int(outside.sum()))
        still_out = keep & ~eng.tree.contains(oc)
        if still_out.any():
            log.warning("streaming: dropped %d seeds still outside after "
                        "rerooting", int(still_out.sum()))
            keep &= ~still_out
        if keep.sum() == 0:
            return 0
        c, n, s, v, col = oc[keep], on[keep], os_[keep], ov[keep], col[keep]
        s = np.maximum(s, eng.tree.width
                       / (1 << (opt.PATCH_INIT_MAXLEVEL + 1)))

        # insertion into the live tree: join an occupied containing cell as a
        # multi-patch entry (filtered later), else create a cell at
        # max(width-formula level, structure level). Fully grouped, the same
        # vectorized path as Engine.seed (add semantics, doctree.h:378-394).
        owner = eng.tree.containing_cell(c)
        lv = eng.tree.level_for_width(s)
        sl = eng.tree.structure_level(c)
        lv = np.maximum(lv, sl)

        pids = eng.patches.alloc(len(c))
        eng.patches.center[pids] = c
        eng.patches.normal[pids] = n
        eng.patches.scale[pids] = s
        eng.patches.views[pids] = v
        eng.patches.color[pids] = col

        cid_all = np.empty(len(c), np.int64)
        has_owner = owner >= 0
        cid_all[has_owner] = owner[has_owner]
        idx = np.nonzero(~has_owner)[0]
        if len(idx):
            lvs = lv[idx]
            keys = eng.tree.keys_at_levels(c[idx], lvs)
            # several seeds may target the same missing cell: alloc each
            # distinct (level, key) once, join the rest as multi-patch
            pair = np.stack([lvs.astype(np.uint64), keys])
            uniq, inv = np.unique(pair, axis=1, return_inverse=True)
            inv = inv.reshape(-1)
            existing = eng.tree.lookup(uniq[0].astype(np.int64),
                                       uniq[1].astype(np.uint64))
            new_mask = existing < 0
            fresh = eng.tree.alloc_cells(uniq[0][new_mask].astype(np.int8),
                                         uniq[1][new_mask].astype(np.uint64))
            cell_ids = existing.copy()
            cell_ids[new_mask] = fresh
            cid_all[idx] = cell_ids[inv]
        eng.insert_patches(pids, cid_all)
        eng._push_many(eng.tree.level[cid_all].astype(np.int64) * 10, cid_all)
        eng._set_depths(pids)
        eng.stats["stream_seeds"] += len(pids)
        return len(pids)

    def run_to(self, prio: int):
        """Process wavefronts up to `prio` (call between chunks)."""
        for p in range(prio + 1):
            self.engine.process_priority_step(p)
        return self.engine
