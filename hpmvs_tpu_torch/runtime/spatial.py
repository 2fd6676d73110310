"""Spatially-sharded wavefront engine: octree blocks on mesh shards + halo
border migration.

The equivalent of the reference's runtime skeleton -- the subtree
decomposition of main.cpp:50-96 (getSubTrees splits the octree into >=
--subtrees subtree views, one CellProcessor each) combined with the
border-patch queues of CellProcessor.cpp:487-540 (insertBorderCell /
processBorderCellQueue / distributeBorderCell), the reference's only
cross-shard communication channel.

Design (hpmvs_tpu/runtime/spatial.py's):

  - The root cube is partitioned into n_blocks = BLOCK_OVERSUB x n_shards
    contiguous Morton-key ranges at `block_level` (8^block_level >=
    n_blocks): block = key * n_blocks / 8^L. Every octree cell at level >=
    block_level belongs to exactly one block (its level-L ancestor octant),
    like a subtree view owns a branch's descendants. Blocks are re-binned
    onto shards every dispatch round (LPT; with image subsets, quantile
    cuts along the blocks' xy Morton order with hysteresis).
  - Device batches are laid out shard-major: each shard runs its blocks'
    lanes. Without the JAX engine's shape buckets each shard takes its
    exact lane count, in rounds of at most BATCH // n_shards lanes; every
    round is enqueued before the first copy back.
  - Extend candidates whose *optimized* center lands on another shard than
    their source cell's do not insert locally: they are packed into
    per-offset payloads and migrated through ragged halo hops
    (parallel/mesh.make_pairwise_halo). Arrivals re-check addConditional
    against the owner's tree, get `flatness_ = 0` (skip regularization --
    CellProcessor.cpp:513-514) and `dirty_ = true` (re-queued on resume
    even when expanded, CellProcessor.cpp:443), and queue at the sender's
    priority (level+prio_red)*10, matching insertBorderCell.
  - image_subsets: each shard holds only the image slab of its blocks'
    cameras (parallel/subsets.py), rebuilt when the per-shard camera unions
    grow or shrink materially.

Semantics: the host octree and patch store are global (the reference's
subtree views likewise share one tree); ownership is expressed through the
batch layout and the migration path. The agree hooks are the identity here.
Over a mesh that spans processes this engine runs replicated (every process
holds the whole scheduler, as the JAX engine's multi-controller mode): a
process computes its own shards' lanes and ships its own shards' halo rows,
the dispatch outputs and the halo arrivals are allgathered (Engine._fetch),
and every process inserts every arrival. runtime/owned.py partitions the
host state by process instead.
"""

from __future__ import annotations

import numpy as np

from hpmvs_tpu_torch import trace
from hpmvs_tpu_torch.core.octree import LinearOctree, morton_ancestor, \
    morton_encode
from hpmvs_tpu_torch.parallel import mesh as pmesh
from hpmvs_tpu_torch.parallel import subsets
from hpmvs_tpu_torch.runtime.wavefront import Engine, log


class SpatialEngine(Engine):
    """Engine whose wavefront batches are sharded by octree block with halo
    migration of border patches (reference: one CellProcessor per subtree +
    border queues, main.cpp:127-139)."""

    # payload layout: center(3) normal(3) scale(1) color(3) level(1)
    # prio_red(1) + views(K)
    _HDR = 12

    def __init__(self, model, opt, images=None, visdata_path=None,
                 mesh=None, image_subsets: bool = False,
                 native_octree: bool = True):
        if mesh is None:
            raise ValueError("SpatialEngine requires a device mesh "
                             "(parallel.mesh.make_mesh)")
        # with image subsets the replicated pack may exceed one device's
        # memory: its texture stays on the host, only the per-shard slabs
        # go to the devices
        super().__init__(model, opt, images=images,
                         visdata_path=visdata_path,
                         native_octree=native_octree, mesh=mesh,
                         host_images=image_subsets)
        self.n_shards = int(mesh.size)
        # oversubscribed fine Morton blocks, dynamically bin-packed onto
        # shards each dispatch round -- the analog of the reference's
        # >= 100 subtrees over ~8 threads with schedule(dynamic)
        # (main.cpp:50-96,150)
        self.n_blocks = max(1, int(opt.BLOCK_OVERSUB)) * self.n_shards
        L = 0
        while 8 ** L < self.n_blocks:
            L += 1
        self.block_level = max(L, 1)
        # block -> shard assignment; initially contiguous ranges (locality)
        self.block_shard = ((np.arange(self.n_blocks) * self.n_shards)
                            // self.n_blocks).astype(np.int64)
        # provisional partition cube from the SfM points: seeding runs
        # block-major BEFORE the real tree exists (required for subsets --
        # the global pack never goes to the devices -- and keeps one
        # dispatch layout for all phases)
        self._provisional = None
        if model.n_points > 0:
            pts = np.asarray(model.points_xyz)
            mn, mx = pts.min(0), pts.max(0)
            width = max(float((mx - mn).max()) * 1.2, 1e-6)
            self._provisional = LinearOctree((mn + mx) / 2.0, width,
                                             native=self._native)
        # per-block image subsets (parallel/subsets.py): shard the packed
        # pyramid buffer so shard b holds only its blocks' cameras
        self.image_subsets = image_subsets
        self._bpack_dev = None
        self._bpack_key = None
        self._subset_gate_fn = None
        self._pending_view_mask = None
        self._pending_slot_counts = None
        self._committed_mask = None
        self._xy_order_cache = None

    def refresh_host_caches(self):
        """Engine.refresh_host_caches + drop the subset closures and slabs:
        they capture the scene tables (stale after a rebuild) and the root
        cube key alone does not track scene growth."""
        super().refresh_host_caches()
        # __init__ calls the base constructor (which refreshes) before
        # these exist
        self._bpack_dev = None
        self._bpack_key = None
        self._subset_gate_fn = None
        self._bmask_key = None
        self._bmask_cache = None
        self._depth_bounds = None
        self._committed_mask = None
        self._covis_reach = None

    # ------------------------------------------------------------------
    # per-block image subsets
    # ------------------------------------------------------------------
    @property
    def _oct_level(self) -> int:
        """Octant grid for the occupancy x frustum intersection: finer than
        the block grid (a ground capture occupies a thin z-slab; at block
        granularity the one-octant dilation marks everything occupied and
        every camera cone grazing a block's EMPTY volume still charges its
        slab). +2 levels = 64x finer cells; capped so the host test stays
        ~10^4 octants."""
        return min(self.block_level + 2, 4)

    def _occupied_octants(self, L: int = None) -> np.ndarray:
        """(8^L,) bool: level-L octants occupied by cells (or SfM points
        pre-tree), dilated by one octant in every direction -- extends can
        step one cell width beyond the occupied frontier. Cameras of
        unoccupied blocks never serve a resident patch, so they are dropped
        from the slabs."""
        L = self.block_level if L is None else L
        g = 1 << L
        t = self._btree()
        if self.tree is not None and self.tree.n:
            cids = np.nonzero(self.tree.alive[:self.tree.n])[0]
            pts, _ = self.tree.cell_center_width(cids) if len(cids) else \
                (np.zeros((0, 3)), None)
        else:
            pts = np.asarray(self.model.points_xyz)
        occ3 = np.zeros((g, g, g), bool)
        if len(pts):
            lo = np.asarray(t.center) - t.width / 2.0
            ijk = np.clip(((pts - lo) / (t.width / g)).astype(np.int64),
                          0, g - 1)
            occ3[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True
            # dilate one octant: successive non-wrapping axis dilations
            # compose to the full 3x3x3 box
            for ax in range(3):
                d = occ3.copy()
                fwd = [slice(None)] * 3
                bwd = [slice(None)] * 3
                fwd[ax] = slice(1, None)
                bwd[ax] = slice(None, -1)
                d[tuple(fwd)] |= occ3[tuple(bwd)]
                d[tuple(bwd)] |= occ3[tuple(fwd)]
                occ3 = d
        idx = np.arange(g)
        ii, jj, kk = np.meshgrid(idx, idx, idx, indexing="ij")
        keys = morton_encode(ii.ravel().astype(np.uint64),
                             jj.ravel().astype(np.uint64),
                             kk.ravel().astype(np.uint64))
        out = np.zeros(8 ** L, bool)
        out[keys.astype(np.int64)] = occ3.ravel()
        return out

    def _btree(self):
        """The partition cube: the real octree once seeded, else the
        provisional SfM-point cube (block-major seeding)."""
        return self.tree if self.tree is not None else self._provisional

    def _agree_rebuild(self, needed: bool) -> bool:
        """Agree the slab-rebuild decision. The identity, here and in the
        owned engine: the JAX engine ORs it across processes because its
        rebuild runs a collective (_agree_dim) that agrees the SPMD slab
        shape; a port process places its own shards' slabs at their own
        height, with no collective, so each rebuilds when its own slabs
        need it."""
        return bool(needed)

    def _covis_reach_mat(self) -> np.ndarray:
        """(ncam, ncam) bool: cameras an optimize lane can touch starting
        from a view of camera c. The view pipeline grows the list twice with
        one covis hop from the CURRENT reference image (PatchOptimizer.cpp:
        225-258 runs before and after optimizePatch, and sortImages may
        promote any grown view to the ref slot in between), so the
        touchable set is the 2-hop covis closure of the dispatched views:
        I | A | A@A."""
        if self._covis_reach is not None:
            return self._covis_reach
        cv = self.scene.covis_np                         # (ncam, C), -1 pad
        ncam = cv.shape[0]
        adj = np.zeros((ncam, ncam + 1), bool)           # col ncam <- pad -1
        adj[np.repeat(np.arange(ncam), cv.shape[1]), cv.ravel()] = True
        adj = adj[:, :ncam]
        adj |= np.eye(ncam, dtype=bool)
        self._covis_reach = adj @ adj                    # I | A | A@A
        return self._covis_reach

    def _stage_pending_views(self, blocks: np.ndarray, views: np.ndarray):
        """Exact slab coverage for the dispatch being built: record, per
        shard, (a) the cameras this dispatch's lanes can touch --
        dispatched views dilated through the covis reach -- which
        _ensure_subsets unions into the slab assignment BEFORE the dispatch
        runs, and (b) the raw dispatched view-slot counts per (shard, cam),
        which _blockwise checks against the committed slabs afterwards
        (stats['slab_miss'], must stay 0: a nonzero count means a lane
        sampled a zeroed camera and silently diverged from the replicated
        run)."""
        ncam = self.scene.n_cameras
        sh = self._lane_shards(blocks)
        need = np.zeros((self.n_shards, ncam), bool)
        slots = np.zeros((self.n_shards, ncam), np.int64)
        v = views.ravel()
        b = np.repeat(sh, views.shape[1])
        m = v >= 0
        np.add.at(slots, (b[m], v[m]), 1)
        need[b[m], v[m]] = True
        self._pending_view_mask = need @ self._covis_reach_mat()
        self._pending_slot_counts = slots

    def _count_slab_misses(self):
        """stats['slab_miss'] += dispatched view slots whose camera is
        absent from the committed shard slab (local shards only)."""
        if self._pending_slot_counts is None or self._committed_mask is None:
            return
        lm = self._shard_local_mask()
        miss = int(self._pending_slot_counts[lm][~self._committed_mask[lm]]
                   .sum())
        self.stats["slab_miss"] += miss
        if miss:
            log.warning("slab_miss: %d dispatched view slots lacked their "
                        "camera in the committed slab", miss)
        self._pending_slot_counts = None
        self._pending_view_mask = None

    def _resident_view_mask(self) -> np.ndarray:
        """(n_blocks, ncam) bool: cameras actually referenced by resident
        patches, per block. Unioned into the slab assignment so the
        slab-coverage invariant holds for EVERY resident patch's view list:
        the geometric depth-bound truncation (camera_depth_bounds) can drop
        a camera whose patches drifted outside its SfM depth range."""
        ncam = self.scene.n_cameras
        out = np.zeros((self.n_blocks, ncam), bool)
        p = self.patches
        ids = np.nonzero(p.alive[:p.n])[0]
        if len(ids) == 0 or self._btree() is None:
            return out
        blk = self.block_of_points(p.center[ids])
        views = p.views[ids]
        v = views.ravel()
        b = np.repeat(blk, views.shape[1])
        m = v >= 0
        out[b[m], v[m]] = True
        return out

    def _ensure_subsets(self):
        """Build (or rebuild after a re-root / rebalance) the per-SHARD
        image slabs -- the union of the cameras seeing each shard's assigned
        blocks -- and place them on the shards.

        The rebuild triggers on a change of the per-shard CAMERA UNIONS (or
        the slab height), not of the raw occupancy bitmap: occupancy churns
        nearly every wavefront while the camera unions are stable, and each
        rebuild is an O(shards x rows) host copy + upload."""
        t = self._btree()
        occ_oct = self._occupied_octants(self._oct_level)
        imgs = self.scene.ctx.imgs
        # the fine-grid frustum x occupancy test is the expensive host part
        # (8^oct_level octants x ncam projective tests) and _ensure_subsets
        # runs per dispatch: cache it on (cube geometry, occupancy bitmap)
        bm_key = (tuple(t.center), t.width, occ_oct.tobytes())
        if self._bmask_key != bm_key:
            w0 = self.scene.width_np[:, 0]
            h0 = self.scene.height_np[:, 0]
            if self._depth_bounds is None:
                self._depth_bounds = subsets.camera_depth_bounds(
                    self.scene.ctx.cams, self.model)
            near, far = self._depth_bounds
            # frustum x occupancy intersected at the FINE octant grid: a
            # block only charges a camera if the camera sees an octant that
            # actually holds reconstruction
            self._bmask_cache = subsets.assign_images_to_blocks(
                self.scene.ctx.cams, w0, h0, np.asarray(t.center),
                t.width, self.n_blocks, self.block_level, near=near,
                far=far, oct_level=self._oct_level, occ_oct=occ_oct)
            self._bmask_key = bm_key
        bmask = self._bmask_cache.copy()
        # coverage invariant: every resident patch's views stay in its
        # block's slab even when the depth bounds would truncate them
        resident = self._resident_view_mask()
        self.stats["subset_bound_overrides"] = int((resident & ~bmask).sum())
        bmask |= resident
        # shard slab = union over its assigned blocks (main.cpp:50-96: a
        # thread's working set is the subtrees it currently processes)
        mask = np.zeros((self.n_shards, bmask.shape[1]), bool)
        for b in range(self.n_blocks):
            mask[self.block_shard[b]] |= bmask[b]
        # exact coverage of the dispatch about to run (covis-dilated view
        # lists of its lanes, _stage_pending_views): the geometric mask is
        # NOT conservative once camera_depth_bounds / occupancy truncation
        # prune it, and extend candidates inherit the parent's views into
        # a block whose residents never listed them
        if self._pending_view_mask is not None:
            self.stats["subset_pending_overrides"] = int(
                (self._pending_view_mask & ~mask).sum())
            mask |= self._pending_view_mask
        lm = self._shard_local_mask() & self.mesh.local
        local_rows = subsets.slab_rows(self.scene.height_np, mask[lm])
        key = (tuple(t.center), t.width, mask[lm].tobytes(), local_rows)
        if self._bpack_dev is None or self._bpack_key is None:
            needed = True
        elif self._bpack_key == key:
            needed = False
        else:
            # the committed slabs may serve a DIFFERENT (superset) mask:
            # rebuild only when correctness demands it (a camera the mask
            # now needs is missing from the committed slab, or the cube
            # moved) or when the economy is material (>=20% rows saved);
            # otherwise keep serving from the superset
            same_geom = (self._bpack_key[0] == tuple(t.center)
                         and self._bpack_key[1] == t.width)
            committed = np.frombuffer(self._bpack_key[2], bool).reshape(
                mask[lm].shape)
            grew = bool((mask[lm] & ~committed).any())
            rows_committed = int(self._bpack_key[3])
            needed = ((not same_geom) or grew
                      or local_rows < 0.8 * rows_committed)
        if not self._agree_rebuild(needed):
            return
        # only this process's shards' slabs are cut (the others' rows stay
        # empty)
        host = subsets.build_block_packs(imgs, mask & lm[:, None],
                                         rows_b=self._agree_dim(local_rows))
        self._bpack_dev = None    # the old slabs go before the new ones
        self._bpack_dev = subsets.place_block_pack(self.mesh, host)
        self._bpack_key = key
        self._committed_mask = mask.copy()
        total_rows = int(imgs.tex.shape[0])
        self.stats["subset_cams_max"] = int(mask[lm].sum(1).max())
        self.stats["subset_cams_mean"] = float(mask[lm].sum(1).mean())
        # per-BLOCK exclusion (before the shard union): the saving a larger
        # mesh realizes, since shard working sets shrink toward one block's
        # as devices grow
        occ_rows = bmask.any(1)
        if occ_rows.any():
            self.stats["subset_block_cams_mean"] = float(
                bmask[occ_rows].sum(1).mean())
        self.stats["subset_rows_per_block"] = int(host.tex.shape[1])
        self.stats["subset_rows_replicated"] = total_rows
        self.stats["subset_rebuilds"] += 1
        log.info(
            "image subsets: %d cams -> %.1f mean / %d max per shard; "
            "%d rows/shard vs %d replicated (%.0f%%)",
            mask.shape[1], float(mask[lm].sum(1).mean()),
            int(mask[lm].sum(1).max()),
            host.tex.shape[1], total_rows,
            100.0 * host.tex.shape[1] / max(total_rows, 1))

    def _sharded_gate_call(self, lanes, pend, gates: bool):
        if not self.image_subsets or self._btree() is None:
            return super()._sharded_gate_call(lanes, pend, gates)
        self._ensure_subsets()
        if self._subset_gate_fn is None:
            self._subset_gate_fn, _ = pmesh.sharded_optimize_and_gate(
                self.mesh, self.scene.ctx, self.opt, self.pack,
                self.scene.n_cameras, pack_layout=self._pack_layout,
                image_subsets=True)
        return self._subset_gate_fn(lanes, self._replicas(), pend,
                                    with_gates=gates, slabs=self._bpack_dev)

    # ------------------------------------------------------------------
    # block partition + dynamic assignment.
    #
    # The partition is BLOCK_OVERSUB * n_shards equal contiguous Morton-key
    # ranges; balance comes from re-binning the *active* blocks onto shards
    # every dispatch round (largest-first greedy, LPT), not from moving the
    # split boundaries: the active wavefront is spatially clustered, so only
    # oversubscription + dynamic assignment can track a moving front, which
    # is how the reference gets its balance (~100 subtrees over ~8 threads
    # with schedule(dynamic), main.cpp:50-96,150).
    # ------------------------------------------------------------------
    def _agree_shard_counts(self, counts: np.ndarray) -> np.ndarray:
        """Global per-shard lane counts, which fix a dispatch's rounds
        (identity here: every process holds every lane; the owned engine
        sums across processes, since every process must join every round,
        each carrying the deferred-window gather)."""
        return counts

    def _agree_dim(self, n: int) -> int:
        """The slab height (identity, here and in the owned engine: the JAX
        engine agrees the global max because its slabs are one SPMD array;
        a port process places its own shards' slabs at their own height)."""
        return int(n)

    def _shard_local_mask(self) -> np.ndarray:
        """(n_shards,) bool: which shards this process reads arrivals and
        slab coverage from (all of them here, the other processes' shards
        through the allgather; the owned engine: its own)."""
        return np.ones(self.n_shards, bool)

    def _agree_pair(self, pair: np.ndarray) -> np.ndarray:
        """Per-(src, dst) halo pair counts (identity, here and in the owned
        engine: the JAX engine agrees them because its hops are SPMD
        collectives of one shape; a port process sizes the hops between
        its own shards itself and ships the rows for other processes in one
        allgather of their exact rows)."""
        return pair

    def _lane_shards(self, blocks: np.ndarray) -> np.ndarray:
        """The shard that computes each lane, from its block (the owned
        engine keeps every lane on its own shards)."""
        return self.block_shard[blocks]

    @staticmethod
    def _lpt_assign(counts: np.ndarray, n_shards: int) -> np.ndarray:
        """Largest-first greedy bin packing of per-block work onto shards."""
        order = np.argsort(-counts, kind="stable")
        load = np.zeros(n_shards, np.int64)
        assign = np.zeros(len(counts), np.int64)
        for b in order:
            s = int(np.argmin(load))
            assign[b] = s
            load[s] += int(counts[b])
        return assign

    @staticmethod
    def _quantile_assign(counts: np.ndarray, n_shards: int) -> np.ndarray:
        """Contiguous Morton-order segments with ~equal work."""
        cum = np.cumsum(counts)
        total = max(int(cum[-1]), 1)
        return np.minimum((cum - counts / 2.0) * n_shards // total,
                          n_shards - 1).astype(np.int64)

    def _xy_order(self) -> np.ndarray:
        """Blocks ordered by the 2D Morton key of their centroid ground
        (xy) position. Contiguous quantile cuts along this order give each
        shard an xy-compact COLUMN of blocks: surface captures occupy a
        thin z-slab, so 3D-Morton-contiguous cuts spend shard locality on
        the z dimension and the per-shard camera unions span most of the
        ground plane."""
        if self._xy_order_cache is not None:
            return self._xy_order_cache
        L = self.block_level
        g = 1 << L
        idx = np.arange(g)
        ii, jj, kk = np.meshgrid(idx, idx, idx, indexing="ij")
        keys = morton_encode(ii.ravel().astype(np.uint64),
                             jj.ravel().astype(np.uint64),
                             kk.ravel().astype(np.uint64)).astype(np.int64)
        blk = (keys * self.n_blocks) >> (3 * L)
        cx = np.zeros(self.n_blocks)
        cy = np.zeros(self.n_blocks)
        cnt = np.bincount(blk, minlength=self.n_blocks).astype(np.float64)
        np.add.at(cx, blk, ii.ravel())
        np.add.at(cy, blk, jj.ravel())
        cx = (cx / np.maximum(cnt, 1)).astype(np.uint64)
        cy = (cy / np.maximum(cnt, 1)).astype(np.uint64)
        k2 = morton_encode(cx, cy, np.zeros(self.n_blocks, np.uint64))
        self._xy_order_cache = np.argsort(k2, kind="stable")
        return self._xy_order_cache

    def _update_assignment(self, counts: np.ndarray):
        """Re-bin blocks onto shards for this round's work distribution.

        Without image subsets the assignment is free to change every round.
        With subsets, the per-shard image slabs depend on the assignment,
        so it only changes when the current one's balance drops below
        Options.REBALANCE_BELOW (hysteresis), paying one slab rebuild per
        rebalance."""
        total = int(counts.sum())
        if total == 0:
            return
        cur_bal = 0.0
        if self.image_subsets and self._bpack_dev is not None:
            cur = np.bincount(self.block_shard, weights=counts,
                              minlength=self.n_shards)
            cur_bal = total / max(self.n_shards * cur.max(), 1)
            if cur_bal >= self.opt.REBALANCE_BELOW:
                return
        if self.image_subsets:
            # contiguous quantile cuts along the 2D-xy Morton order:
            # balances the load while keeping each shard's blocks an
            # xy-compact column -- an LPT scatter would union far-apart
            # blocks' cameras and erase the slab saving
            order = self._xy_order()
            sub = self._quantile_assign(counts[order], self.n_shards)
            new = np.empty_like(self.block_shard)
            new[order] = sub
        else:
            new = self._lpt_assign(counts, self.n_shards)
        if np.array_equal(new, self.block_shard):
            return
        if self.image_subsets and self._bpack_dev is not None:
            # churn guard: a rebalance invalidates the committed slabs; when
            # the wavefront sits chronically below REBALANCE_BELOW, only pay
            # for a MATERIAL improvement, not for oscillation
            new_load = np.bincount(new, weights=counts,
                                   minlength=self.n_shards)
            new_bal = total / max(self.n_shards * new_load.max(), 1)
            if new_bal < cur_bal + 0.05:
                return
        self.block_shard = new
        self.stats["rebalances"] += 1
        if self.image_subsets:
            self._bpack_key = None   # per-shard unions changed

    def block_of_points(self, pts: np.ndarray) -> np.ndarray:
        """Contiguous Morton-range partition of the root cube: block =
        level-L key * n_blocks / 8^L. Points outside the root clamp to the
        nearest boundary cell (they are dropped by the insertion gates
        anyway, like the reference's outside-root border patches)."""
        t = self._btree()
        key = t.key_at(pts, self.block_level).astype(np.int64)
        return (key * self.n_blocks) >> (3 * self.block_level)

    def block_of_cells(self, cids: np.ndarray) -> np.ndarray:
        """Block of each occupied cell: its level-L Morton ancestor octant.
        Cells coarser than block_level (possible only in degenerate tiny
        trees) fall back to the block of their center point."""
        lv = self.tree.level[cids].astype(np.int64)
        key = self.tree.key[cids]
        anc = morton_ancestor(key, np.maximum(lv, self.block_level),
                              self.block_level).astype(np.int64)
        blk = (anc * self.n_blocks) >> (3 * self.block_level)
        coarse = lv < self.block_level
        if coarse.any():
            centers, _ = self.tree.cell_center_width(cids[coarse])
            blk[coarse] = self.block_of_points(centers)
        return blk

    # ------------------------------------------------------------------
    # shard-major device layout
    # ------------------------------------------------------------------
    def _blockwise(self, blocks: np.ndarray, arrays):
        """Dispatch the 6 lane arrays (leading dim N) shard-major: the
        active blocks are binned onto shards (one assignment per dispatch
        round), then each shard runs its own lanes, in rounds of at most
        BATCH // n_shards lanes (exact counts: no padding lanes). Every
        round is enqueued before the first copy back (rounds have no host
        dependency: the z-buffer replicas thread on the devices). Outputs
        return in the original item order."""
        N = len(blocks)
        bcounts = np.bincount(blocks, minlength=self.n_blocks)
        self._update_assignment(bcounts)
        if self.image_subsets:
            # arrays[3] is the per-lane view list
            self._stage_pending_views(blocks, arrays[3])
        shards = self._lane_shards(blocks)
        order = np.argsort(shards, kind="stable")
        counts_l = np.bincount(shards, minlength=self.n_shards)
        counts_g = self._agree_shard_counts(counts_l)
        maxc = int(counts_g.max()) if counts_g.sum() else 1
        cap = max(self.opt.BATCH // self.n_shards, 16)
        lseg = min(max(maxc, 1), cap)
        rounds = -(-maxc // lseg)
        starts = np.zeros(self.n_shards + 1, np.int64)
        starts[1:] = np.cumsum(counts_l)
        gates = bool((arrays[5] > 0).any())

        with self._device_time():
            devs = []
            for r in range(rounds):
                parts, idxs = [], [None] * self.n_shards
                for s in range(self.n_shards):
                    a = starts[s] + r * lseg
                    b = min(starts[s] + (r + 1) * lseg, starts[s + 1])
                    if a >= b:
                        parts.append(None)
                        continue
                    idx = order[a:b]
                    idxs[s] = idx
                    parts.append(tuple(x[idx] for x in arrays))
                devs.append((self._mesh_dispatch(parts, gates), idxs))
                self.stats["dispatches"] += 1
                self.stats["disp_extend"] += 1
            # (an owned process may hold no lane of a dispatch it joins)
            K = arrays[3].shape[1]
            outs = [np.zeros((N, 3), np.float32),
                    np.zeros((N, 3), np.float32), np.zeros(N, np.float32),
                    np.full((N, K), -1, np.int32), np.zeros(N, bool),
                    np.zeros((N, 3), np.float32)]
            for dev, idxs in devs:
                for idx, got in zip(idxs, self._fetch(dev)):
                    if idx is None:
                        continue
                    for j in range(6):
                        outs[j][idx] = got[j]
        if self.image_subsets:
            self._count_slab_misses()
        self.stats["block_work_lanes"] += N
        # lanes the shards would idle in lockstep on a mesh of devices
        self.stats["block_pad_lanes"] += self.n_shards * lseg * rounds - N
        # post-assignment balance: ideal equal-split lanes vs the busiest
        # shard's lanes -- the spatial-decomposition efficiency
        self.stats["block_balance_den"] += self.n_shards * maxc
        return tuple(outs)

    def _optimize(self, centers, normals, scales, views):
        if self._btree() is None:
            # degenerate: no partition cube at all (pointless model)
            return super()._optimize(centers, normals, scales, views)
        # bare optimize (branch / streamed seeds) in shard-major layout via
        # the SAME dispatch as extend, gates off per lane (widths < 0)
        blocks = self.block_of_points(centers)
        n = centers.shape[0]
        res = self._blockwise(
            blocks, (centers, normals, scales, views,
                     np.ascontiguousarray(centers, np.float32),
                     np.full(n, -1.0, np.float32)))
        self.stats["patches_optimized"] += n
        return res + (np.zeros(n, np.float32),)

    def _extend_compute(self, centers, normals, scales, views, parent_c,
                        widths):
        if self._btree() is None:
            return super()._extend_compute(centers, normals, scales, views,
                                           parent_c, widths)
        blocks = self.block_of_points(centers)
        res = self._blockwise(
            blocks, (centers, normals, scales, views, parent_c, widths))
        self.stats["patches_optimized"] += centers.shape[0]
        return res

    def _lookahead_ok(self) -> bool:
        """No wave lookahead in spatial mode: the shard-major rounds make
        next-wave membership non-local, and _blockwise already pipelines
        its per-round dispatches."""
        return False

    def _extend_stream(self, centers, normals, scales, views, parent_c,
                       widths):
        """The shard-major layout needs all rounds gathered before the
        original order is restored, so the spatial engine routes
        whole-batch (the rounds themselves still pipeline inside
        _blockwise)."""
        yield 0, centers.shape[0], self._extend_compute(
            centers, normals, scales, views, parent_c, widths)

    # ------------------------------------------------------------------
    # border migration (insertBorderCell / distributeBorderCell analog)
    # ------------------------------------------------------------------
    def _route_extend(self, oc, on, os_, ov, ok, col, lv_t, prio_red,
                      src_cids) -> int:
        # migration is keyed on the OWNING SHARD, not the block id: a
        # candidate crossing into a sibling block on the same shard needs
        # no wire traffic -- like the reference, where only patches leaving
        # a processor's subtree take the border queue
        # (CellProcessor.cpp:147-153)
        src_sh = self.block_shard[self.block_of_cells(src_cids)]
        dst_sh = self.block_shard[self.block_of_points(oc)]
        remote = ok & (dst_sh != src_sh) & self.tree.contains(oc)
        local = ok & ~remote
        n = self._insert_new_patches(oc, on, os_, ov, local, col, lv_t,
                                     prio_red)
        if self._count_global(int(remote.sum())):
            n += self._halo_migrate(oc, on, os_, ov, col, lv_t, prio_red,
                                    remote, src_sh, dst_sh)
        return n

    def _halo_migrate(self, oc, on, os_, ov, col, lv_t, prio_red, remote,
                      src_sh, dst_sh) -> int:
        """Ship remote extend candidates through ragged halo hops, then
        insert the arrivals owner-side with flatness 0 and the dirty flag
        (CellProcessor.cpp:500-531).

        Ragged composition: migrations are grouped by shard offset
        k = (dst - src) mod n_shards; only offsets that actually carry
        patches issue a hop, each sized to its own max per-source count.
        Every hop is enqueued before the first copy back, and nothing can
        be dropped -- every row has a dedicated slot by construction.

        Over several processes each process ships its own shards' rows:
        rows for its own shards stay device copies (the hops), rows for
        another process's shards cross in ONE host allgather per round,
        exactly the rows (halo_bytes_xproc). Arrivals are read from
        _shard_local_mask's shards: the owned engine its own; the
        replicated engine all of them (a second allgather). Every process
        enters here together (_route_extend's agreed count) and runs both
        collectives before its first local return."""
        K = ov.shape[1]
        D = self._HDR + K
        n = self.n_shards
        idx_all = np.nonzero(remote)[0]

        payload_all = np.zeros((len(idx_all), D), np.float32)
        payload_all[:, 0:3] = oc[idx_all]
        payload_all[:, 3:6] = on[idx_all]
        payload_all[:, 6] = os_[idx_all]
        payload_all[:, 7:10] = col[idx_all]
        payload_all[:, 10] = lv_t[idx_all]
        payload_all[:, 11] = prio_red[idx_all]
        payload_all[:, self._HDR:] = ov[idx_all].astype(np.float32)

        koff = (dst_sh[idx_all] - src_sh[idx_all]) % n
        # per-(src, dst) pair counts: the hop list and each hop's slots
        pair_l = np.zeros((n, n), np.int64)
        np.add.at(pair_l, (src_sh[idx_all], dst_sh[idx_all]), 1)
        pair = self._agree_pair(pair_l)
        mine = self.mesh.local
        devs, cross = [], {}
        with self._device_time():
            src_ids = np.arange(n)
            for k in range(1, n):
                dst_ids = (src_ids + k) % n
                diag = np.where(mine, pair[src_ids, dst_ids], 0)
                if diag.max() == 0:
                    continue
                slots = int(diag.max())
                # this process ships its own shards' rows
                rows = np.nonzero((koff == k) & mine[src_sh[idx_all]])[0]
                sb = src_sh[idx_all[rows]]
                counts = np.bincount(sb, minlength=n)
                starts = np.zeros(n + 1, np.int64)
                starts[1:] = np.cumsum(counts)
                order = np.argsort(sb, kind="stable")
                lane = sb[order] * slots + (np.arange(len(rows))
                                            - starts[sb[order]])
                pay = np.zeros((n * slots, D), np.float32)
                val = np.zeros((n * slots,), bool)
                pay[lane] = payload_all[rows[order]]
                val[lane] = True
                # shard s ships rows [s*slots, (s+1)*slots): to a shard of this
                # process by a device hop, to another process's in `cross`
                hop = mine & mine[dst_ids]
                for s_ in np.nonzero(mine & ~mine[dst_ids] & (diag > 0))[0]:
                    blk = slice(s_ * slots, (s_ + 1) * slots)
                    cross[(k, int(dst_ids[s_]))] = pay[blk][val[blk]]
                if not hop.any():
                    continue
                pay_s = [self._dev(pay[s_ * slots:(s_ + 1) * slots], d)
                         if hop[s_] else None
                         for s_, d in enumerate(self.mesh.devices)]
                val_s = [self._dev(val[s_ * slots:(s_ + 1) * slots], d)
                         if hop[s_] else None
                         for s_, d in enumerate(self.mesh.devices)]
                fn = pmesh.make_pairwise_halo(self.mesh, int(k))
                devs.append((int(k), fn(pay_s, val_s)))
                self.stats["halo_bytes_wire"] += int(hop.sum()) * slots * (
                    D * 4 + 1)
            # arrivals per (hop, destination shard): host rows already valid
            got = {}
            with trace.span("wait"):
                for k, (p_out, v_out) in devs:
                    for d, (pp, vv) in enumerate(zip(p_out, v_out)):
                        if pp is not None:
                            got[(k, d)] = pp.cpu().numpy()[vv.cpu().numpy()]
            if self.mesh.n_proc > 1:
                xbytes = sum(int(r.nbytes) for r in cross.values())
                self.stats["halo_bytes_xproc"] += xbytes
                self.stats["halo_bytes_wire"] += xbytes
                for p, g in enumerate(pmesh.allgather_object(cross)):
                    if p != self.mesh.pid:
                        got.update((kd, r) for kd, r in g.items()
                                   if mine[kd[1]])
                self.stats["host_collectives"] += 1
            lmask = self._shard_local_mask()
            if (lmask & ~mine).any():
                # the replicated engine inserts every shard's arrivals
                for p, g in enumerate(pmesh.allgather_object(got)):
                    if p != self.mesh.pid:
                        got.update(g)
                self.stats["host_collectives"] += 1
        self.stats["halo_rounds"] += 1
        self.stats["halo_hops"] += len(devs)
        self.stats["migrated"] += len(idx_all)
        # wire accounting: logical patch payload vs the ragged hop buffers
        # and cross-process rows actually moved
        self.stats["halo_bytes_logical"] += len(idx_all) * D * 4

        # hop-major, then destination-shard order
        parts = [got[kd] for kd in sorted(got) if lmask[kd[1]]]
        r = np.concatenate(parts) if parts else np.zeros((0, D), np.float32)
        # wire-delivery invariant: every migrated patch has a dedicated slot
        # (no drops by construction), so arrivals == migrations
        self.stats["halo_arrivals"] += len(r)
        if len(r) == 0:
            return 0
        # reference semantics: border arrivals skip regularization
        # (flatness_=0, CellProcessor.cpp:513-514) and are marked dirty so
        # initFromTree re-queues them (CellProcessor.cpp:443)
        n_ins = self._insert_new_patches(
            r[:, 0:3], r[:, 3:6], r[:, 6], r[:, self._HDR:].astype(np.int32),
            np.ones(len(r), bool), r[:, 7:10],
            r[:, 10].astype(np.int64), r[:, 11].astype(np.int32),
            flatness=0.0, dirty=True)
        self.stats["migrated_inserted"] += n_ins
        return n_ins
