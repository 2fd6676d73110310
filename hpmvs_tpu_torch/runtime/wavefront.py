"""Level-synchronous wavefront engine: the replacement for CellProcessor.

Behavioral equivalent of the reference scheduler
(src/hpmvs/CellProcessor.cpp:43-544 + the priority loop main.cpp:145-181):
a priority queue of octree cells, priority = (level + priorityReduction)*10 +
phase, with the per-cell state machine

    filter (multi-patch cell) -> extend (6 lateral candidates, phase +0) ->
    regularize (5x5 flatness test, phase +1) -> remove-or-branch (4 diagonal
    children, phase +2)

Instead of popping one cell at a time and running one nlopt solve per
candidate, the engine drains *all* cells of the current priority as one
batch, generates all their candidates, and refines them with one
optimize_and_gate call per chunk; all depth/visibility gates run as batched
device ops. Collision resolution on octree insertion (addConditional,
doctree.h:396-419) becomes a deterministic first-wins dedup by target cell
key within the batch (documented divergence: the reference resolves by
thread-interleaved arrival order).

The octree bookkeeping (key sets, queues) stays on host numpy. This is the
single-device engine of hpmvs_tpu/runtime/wavefront.py without wave
lookahead, deep waves and the mesh paths.

Shape policy: PyTorch runs eagerly and compiles nothing per shape, so the
JAX engine's coarse shape buckets (_bucket), its flush chunking
(FLUSH_CHUNK) and its deep-batch cap (DEEP_BATCH_CAP) -- all there for XLA
recompiles and TPU memory limits -- are gone. Batches go to the device at
their exact size, chunked at Options.BATCH to bound device memory; the GN
kernel's wrapper pads each chunk to its 128-patch block. The deferred depth
window always rides the next dispatch whole.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from hpmvs_tpu_torch import resolve_device
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.core import depth as depth_mod
from hpmvs_tpu_torch.core import scene as scene_mod
from hpmvs_tpu_torch.core.octree import LinearOctree, PatchStore
from hpmvs_tpu_torch.io import ply as ply_io
from hpmvs_tpu_torch.ops import optimizer as popt

log = logging.getLogger("hpmvs_tpu_torch")


class Engine:
    """Owns the whole reconstruction state: device scene context + depth
    buffers, host patch store + linear octree + priority queues."""

    def __init__(self, model, opt: Options, images=None,
                 visdata_path: Optional[str] = None, device="cuda"):
        if opt.WAVE_DEPTH != 1 or opt.WAVE_LOOKAHEAD:
            raise NotImplementedError(
                "not yet ported to hpmvs_tpu_torch: WAVE_DEPTH > 1 (deep "
                "waves) and WAVE_LOOKAHEAD=True")
        self.opt = opt
        self.model = model
        self.device = resolve_device(device)
        self.scene = scene_mod.build_scene(model, opt, images=images,
                                           visdata_path=visdata_path,
                                           device=self.device)
        self.pack = depth_mod.build_depth_pack(
            self.scene.width_np, self.scene.height_np, opt.DEPTH_SUBSAMPLE,
            device=self.device)
        cams = self.scene.ctx.cams
        self.cam_center_np = cams.center.cpu().numpy()
        self.cam_xaxis_np = cams.xaxis.cpu().numpy()
        self.cam_fsum_np = cams.fsum.cpu().numpy()
        # per-level pack dims for the collapsed full-depth buffer
        # (depth.collapse_full_depth): valid only when every camera shares
        # them; None makes the gates read the pyramid level by level
        pw = self.pack.width.cpu().numpy()
        ph = self.pack.height.cpu().numpy()
        if (pw == pw[:1]).all() and (ph == ph[:1]).all():
            self._pack_layout = tuple(
                (int(ph[0, lv]), int(pw[0, lv])) for lv in range(pw.shape[1]))
        else:
            self._pack_layout = None
        self.patches = PatchStore(opt.MAX_VIEWS)
        self.tree: Optional[LinearOctree] = None
        # cell -> patch membership as intrusive linked arrays (head + nxt)
        self.cell_head = np.full(1024, -1, np.int64)
        # queue[prio] = list of int64 cid chunks (flattened at pop)
        self.queue: Dict[int, List[np.ndarray]] = defaultdict(list)
        # deferred setDepths updates, applied by the next dispatch
        self._pend: List[tuple] = []  # (c, s, views, is_subtract) windows
        self.stats = defaultdict(int)

    # ------------------------------------------------------------------
    # plumbing: cell membership as head/next chains, batched queue pushes
    # ------------------------------------------------------------------
    def _ensure_heads(self):
        need = self.tree.n
        if len(self.cell_head) < need:
            cap = len(self.cell_head)
            while cap < need:
                cap *= 2
            b = np.full(cap, -1, np.int64)
            b[:len(self.cell_head)] = self.cell_head
            self.cell_head = b

    def insert_patches(self, pids: np.ndarray, cids: np.ndarray):
        """Batch cell-membership insert. Duplicate target cells chain
        (multi-patch cells, resolved later by filter); each dedup round
        links one patch per distinct cell, so rounds = max multiplicity."""
        pids = np.asarray(pids, np.int64)
        cids = np.asarray(cids, np.int64)
        self._ensure_heads()
        self.patches.cell[pids] = cids
        while len(pids):
            u, first = np.unique(cids, return_index=True)
            p = pids[first]
            self.patches.nxt[p] = self.cell_head[u]
            self.cell_head[u] = p
            if len(first) == len(pids):
                break
            mask = np.ones(len(pids), bool)
            mask[first] = False
            pids, cids = pids[mask], cids[mask]

    def _members(self, cids: np.ndarray):
        """Padded (C, M) member-pid matrix + validity mask (M = deepest
        chain among the cells)."""
        cols = [self.cell_head[cids]]
        while True:
            cur = cols[-1]
            nxt = np.where(cur >= 0, self.patches.nxt[np.maximum(cur, 0)], -1)
            if not (nxt >= 0).any():
                break
            cols.append(nxt)
        m = np.stack(cols, 1)
        return m, m >= 0

    def _clear_cell_patches(self, cids: np.ndarray) -> np.ndarray:
        """Free every patch of the given cells; returns the freed pids."""
        m, mask = self._members(cids)
        pids = m[mask]
        if len(pids):
            self.patches.free(pids)
        self.cell_head[cids] = -1
        return pids

    def _free_cells(self, cids: np.ndarray):
        self.tree.free_cells(np.asarray(cids))
        self._ensure_heads()
        self.cell_head[np.asarray(cids)] = -1

    def _push_many(self, prios: np.ndarray, cids: np.ndarray):
        """Grouped queue append: one chunk per distinct priority."""
        if len(cids) == 0:
            return
        prios = np.asarray(prios, np.int64)
        cids = np.asarray(cids, np.int64)
        for pr in np.unique(prios):
            self.queue[int(pr)].append(cids[prios == pr])

    def _optimize(self, centers, normals, scales, views):
        """Bare batched optimize (seed / branch candidates), through the
        same optimize+gates+setDepths dispatch as extend with the per-lane
        gates disabled (widths < 0): the reference likewise has one
        optimizer for all phases (PatchOptimizer.cpp:78). Returns the
        7-tuple (center, normal, scale, views, ok, color, resid
        placeholder)."""
        n = centers.shape[0]
        res = self._extend_compute(
            centers, normals, scales, views,
            np.ascontiguousarray(centers, np.float32),
            np.full(n, -1.0, np.float32))
        return res + (np.zeros(n, np.float32),)

    # ------------------------------------------------------------------
    # deferred z-buffer updates
    # ------------------------------------------------------------------
    def _set_depths(self, pids: np.ndarray, subtract: bool = False):
        """Scene::setDepths. Adds and subtracts are DEFERRED: they ride the
        next dispatch in their original order (phase tags add*/sub*/add*).
        A second subtract run after an add-after-sub run would need a 4th
        phase -- flush first (rare)."""
        if len(pids) == 0:
            return
        if subtract and any(e[3] for e in self._pend) \
                and not self._pend[-1][3]:
            self._flush_depths()
        # SNAPSHOT the projection inputs now: subtracted patches are freed
        # (and their store slots reused) before the window flushes
        self._pend.append((self.patches.center[pids].copy(),
                           self.patches.scale[pids].copy(),
                           self.patches.views[pids].copy(), subtract))

    def _pend_arrays(self):
        """Concatenate the deferred window into (c, s, v, phase)."""
        c = np.concatenate([e[0] for e in self._pend])
        s = np.concatenate([e[1] for e in self._pend])
        v = np.concatenate([e[2] for e in self._pend])
        seen_sub = False
        phs = []
        for e in self._pend:
            if e[3]:
                seen_sub = True
                ph = 1
            else:
                ph = 2 if seen_sub else 0
            phs.append(np.full(len(e[1]), ph, np.int32))
        return c, s, v, np.concatenate(phs)

    def _take_pending(self):
        """The deferred window as device tensors (c, s, v, phase), or None
        when nothing is pending; the window is cleared."""
        if not self._pend:
            return None
        arrs = self._pend_arrays()
        self._pend = []
        return tuple(self._dev(a) for a in arrs)

    def _flush_depths(self):
        """Apply the deferred depth window on its own (before a fourth
        phase would be needed, and for external pack readers)."""
        pend = self._take_pending()
        if pend is None:
            return
        t0 = time.time()
        depth_mod.apply_depth_updates(self.pack, self.scene.ctx.cams, *pend,
                                      subsample=self.opt.DEPTH_SUBSAMPLE)
        self._sync()
        self.stats["t_device"] += time.time() - t0
        self.stats["dispatches"] += 1
        self.stats["disp_flush"] += 1

    # ------------------------------------------------------------------
    # device dispatch
    # ------------------------------------------------------------------
    def _dev(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _extend_compute(self, centers, normals, scales, views, parent_c,
                        widths):
        """Optimize + extend gates over the whole batch (chunked at BATCH);
        returns 6 host arrays."""
        n = centers.shape[0]
        outs = [o for _, _, o in self._extend_stream(
            centers, normals, scales, views, parent_c, widths)]
        return tuple(np.concatenate([o[j] for o in outs])[:n]
                     for j in range(6))

    def _dispatch_extend(self, centers, normals, scales, views, parent_c,
                         widths):
        """Enqueue the optimize+gate work of one chunk on the device;
        returns device tensors (oc, on, os, ov, ok, col). Deferred depth
        updates ride along and the z-buffer is updated in place."""
        pend = self._take_pending()
        # all-bare batches (branch / seed dispatches) skip the geometric
        # gates, whose per-lane results those lanes discard anyway
        gates = bool((widths > 0).any())
        d = self._dev
        out = popt.optimize_and_gate(
            self.scene.ctx, self.pack, self.opt, self.scene.n_cameras,
            d(np.asarray(centers, np.float32)), d(np.asarray(normals, np.float32)),
            d(np.asarray(scales, np.float32)), d(np.asarray(views, np.int32)),
            d(np.asarray(parent_c, np.float32)),
            d(np.asarray(widths, np.float32)), pend=pend, with_gates=gates,
            pack_layout=self._pack_layout)
        self.stats["dispatches"] += 1
        self.stats["disp_extend"] += 1
        return out

    @staticmethod
    def _tangent_axes(normals: np.ndarray, cam_x: np.ndarray):
        """extend/branch/regularize tangent frame (CellProcessor.cpp:98-101):
        yaxis = normalize(n x imgX), xaxis = yaxis x n."""
        y = np.cross(normals, cam_x)
        y /= np.maximum(np.linalg.norm(y, axis=1, keepdims=True), 1e-12)
        x = np.cross(y, normals)
        return x, y

    # ------------------------------------------------------------------
    # seeding (Scene::initPatches + main.cpp:127-139)
    # ------------------------------------------------------------------
    def seed(self):
        opt = self.opt
        c, n, s, v, orig = scene_mod.make_seed_patches(self.model, self.scene,
                                                       opt)
        if c.shape[0] == 0:
            self.tree = LinearOctree(np.zeros(3), 2.0)
            return 0
        t0 = time.time()
        out_c, out_n, out_s, out_v, ok, col, _ = self._optimize(c, n, s, v)
        with np.errstate(invalid="ignore"):
            drift = (np.linalg.norm(out_c - orig, axis=1)
                     <= out_s * opt.SEED_DRIFT)
        keep = ok & drift
        self.stats["seed_ok"] = int(ok.sum())
        self.stats["seed_drift_pass"] = int((ok & drift).sum())
        log.info("created %d initPatches out of %d points (%.1fs)",
                 int(keep.sum()), self.model.n_points, time.time() - t0)

        c, n, s, v, col = (out_c[keep], out_n[keep], out_s[keep], out_v[keep],
                           col[keep])
        if c.shape[0] == 0:
            self.tree = LinearOctree(np.zeros(3), 2.0)
            return 0
        # bounding cube root (Scene.cpp:186-193)
        mn, mx = c.min(0), c.max(0)
        width = max(float(np.max(mx - mn)), 1e-6)
        self.tree = LinearOctree((mn + mx) / 2.0, width,
                                 max_level=min(opt.MAX_TREE_LEVEL + 2, 20))
        # seed scale floor (Scene.cpp:196)
        s = np.maximum(s, width / (1 << (opt.PATCH_INIT_MAXLEVEL + 1)))

        # add(p, scale): level from width formula, then conflict pushdown --
        # finer structure created by co-located finer patches forces coarser
        # patches down (doctree.h:378-394 split-with-buffer semantics)
        lv = self.tree.level_for_width(s)
        for _ in range(self.tree.max_level):
            keys = self._keys_at_levels(c, lv)
            tmp = LinearOctree(self.tree.center, self.tree.width,
                               self.tree.max_level)
            tmp.alloc_cells(lv.astype(np.int8), keys)
            new_lv = np.maximum(lv, tmp.structure_level(c))
            if (new_lv == lv).all():
                break
            lv = new_lv
        keys = self._keys_at_levels(c, lv)

        pair = np.stack([lv.astype(np.uint64), keys])
        uniq, inv = np.unique(pair, axis=1, return_inverse=True)
        inv = inv.reshape(-1)
        cids = self.tree.alloc_cells(uniq[0].astype(np.int8),
                                     uniq[1].astype(np.uint64))

        pids = self.patches.alloc(len(c))
        self.patches.center[pids] = c
        self.patches.normal[pids] = n
        self.patches.scale[pids] = s
        self.patches.views[pids] = v
        self.patches.color[pids] = col
        self.insert_patches(pids, cids[inv])
        self._set_depths(pids)

        # initFromTree (CellProcessor.cpp:422-455): queue at level*10
        self._push_many(uniq[0].astype(np.int64) * 10, cids)
        self.stats["seeds"] = len(c)
        return len(c)

    def _keys_at_levels(self, pts, lv):
        keys = np.zeros(len(pts), np.uint64)
        for L in np.unique(lv):
            m = lv == L
            keys[m] = self.tree.key_at(pts[m], int(L))
        return keys

    # ------------------------------------------------------------------
    # the cell state machine, batched (CellProcessor::processCell)
    # ------------------------------------------------------------------
    def process_priority_step(self, prio: int) -> bool:
        """Drain every queue entry with priority <= prio
        (one OMP-parallel processQueue sweep in the reference,
        main.cpp:150-154)."""
        changed = False
        while self.queue:
            pmin = min(self.queue)
            if pmin > prio:
                break
            live = self._pop_live(pmin)
            if len(live) == 0:
                continue
            changed = True
            t0 = time.time()
            self._process_cells(live, pmin)
            self.stats[f"t_phase{pmin % 10}"] += time.time() - t0
            self.stats["cells_processed"] += len(live)
        return changed

    def _pop_live(self, pmin) -> np.ndarray:
        """Pop + dedup the queue entries at priority pmin."""
        chunks = self.queue.pop(int(pmin), [])
        if not chunks:
            return np.zeros((0,), np.int64)
        cells = (np.concatenate(chunks) if len(chunks) > 1
                 else np.asarray(chunks[0], np.int64))
        # dedup keeping first occurrence + drop dead/empty cells (the
        # reference dangles pointers here)
        _, first = np.unique(cells, return_index=True)
        cells = cells[np.sort(first)]
        self._ensure_heads()
        return cells[self.tree.alive[cells] & (self.cell_head[cells] >= 0)]

    def _process_cells(self, cids: np.ndarray, prio: int):
        opt = self.opt
        if prio >= opt.max_prio:
            return
        # filter multi-patch cells first (CellProcessor.cpp:377-378)
        heads = self.cell_head[cids]
        multi = cids[self.patches.nxt[heads] >= 0]
        if len(multi):
            self._filter_cells(multi)

        first_pid = self.cell_head[cids]
        expanded = self.patches.expanded[first_pid]
        flat = self.patches.flatness[first_pid]

        ext = cids[~expanded]
        if len(ext):
            self._extend_cells(ext)
        reg = cids[expanded & (flat < 0)]
        if len(reg):
            self._regularize_cells(reg)
        rem = cids[expanded & (flat > opt.FLATNESS_REMOVE)]
        if len(rem):
            self._remove_cells(rem)
        bra = cids[expanded & (flat >= 0) & (flat <= opt.FLATNESS_REMOVE)]
        if len(bra):
            self._branch_cells(bra)

    # -- filter (CellProcessor::filter, :43-82) -------------------------
    def _filter_keepers(self, cids: np.ndarray):
        """The filter's deterministic keeper decision (best mean signed
        plane support). Returns (keeper_pid_per_cell, losers)."""
        m, mask = self._members(cids)                   # (C, M)
        C, M = m.shape
        if M <= 1:
            return m[:, 0], np.zeros((0,), np.int64)
        cs = self.patches.center[np.maximum(m, 0)]      # (C, M, 3)
        ns = self.patches.normal[np.maximum(m, 0)]
        ns = ns / np.maximum(np.linalg.norm(ns, axis=2, keepdims=True),
                             1e-12)
        # mean *signed* plane distance of the others (reference quirk)
        diff = cs[:, None, :, :] - cs[:, :, None, :]    # (C, i, j, 3)
        d = np.einsum("cik,cijk->cij", ns, diff)
        pair = mask[:, None, :] & mask[:, :, None] \
            & ~np.eye(M, dtype=bool)[None]
        d = np.where(pair, d, 0.0)
        cnt = mask.sum(1)
        dist = d.sum(2) / np.maximum(cnt - 1, 1)[:, None]
        dist = np.where(mask, dist, np.inf)
        best = np.argmin(dist, axis=1)
        keeper = m[np.arange(C), best]
        losers = m[mask & (np.arange(M)[None] != best[:, None])]
        return keeper, losers

    def _filter_cells(self, cids: np.ndarray):
        """Keep the best-plane-support patch per multi-patch cell."""
        keeper, losers = self._filter_keepers(cids)
        self.cell_head[cids] = keeper
        self.patches.nxt[keeper] = -1
        self.patches.cell[keeper] = cids
        if len(losers):
            self._set_depths(losers, subtract=True)
            self.patches.free(losers)
            self.stats["filtered"] += len(losers)

    # -- extend (CellProcessor::extend, :84-178) ------------------------
    def _extend_cells(self, cids: np.ndarray):
        """Optionally in EXTEND_SUBROUNDS sequential sub-rounds so later
        candidates depth-test against surfaces accepted earlier in the same
        level (freshness knob; the reference interleaves per cell)."""
        r = max(1, int(self.opt.EXTEND_SUBROUNDS))
        if r > 1 and len(cids) > 1:
            for part in np.array_split(cids, min(r, len(cids))):
                if len(part):
                    self._extend_cells_batch(part)
            return
        self._extend_cells_batch(cids)

    def _extend_cells_batch(self, cids: np.ndarray):
        pids = self.cell_head[cids]
        centers = self.patches.center[pids]
        normals = self.patches.normal[pids]
        views = self.patches.views[pids]
        prio_red = self.patches.prio_red[pids]
        _, widths = self.tree.cell_center_width(cids)
        levels = self.tree.node_level(cids)

        (c_in, n_in, s_in, v_in, p_in, w_in, _, lv_lanes,
         pr_lanes) = self._extend_candidates(centers, normals, views,
                                             prio_red, widths, levels)
        self.stats["extend_candidates"] += len(c_in)
        n_ins = 0
        if len(c_in):
            for a, b, (oc, on, os_, ov, okk, col) in self._extend_stream(
                    c_in, n_in, s_in, v_in, p_in, w_in):
                # routing chunk i overlaps chunks i+1..'s device compute; the
                # insert-time occupancy re-check keeps first-wins order
                # identical to whole-batch routing
                n_ins += self._insert_new_patches(oc, on, os_, ov, okk, col,
                                                  lv_lanes[a:b], pr_lanes[a:b])
        self.stats["extended"] += n_ins
        self._finish_extend(cids, pids, levels, prio_red)

    def _extend_candidates(self, centers, normals, views, prio_red, widths,
                           levels):
        """Tangent-disc extend candidates for a batch of parent patches with
        the occupancy/level economy pre-check (CellProcessor.cpp:98-133:
        skip occupied/finer targets; outside-root candidates are dropped).
        Returns per-lane dispatch inputs + the parent index of each lane."""
        opt = self.opt
        N = opt.EXTEND_DIRS
        cam_x = self.cam_xaxis_np[np.maximum(views[:, 0], 0)]
        xax, yax = self._tangent_axes(normals, cam_x)

        ang = 2.0 * np.pi / N * np.arange(N)
        dx, dy = np.cos(ang), np.sin(ang)
        # candidate centers (B, N, 3)
        cand_c = (centers[:, None, :]
                  + (dx[None, :, None] * xax[:, None, :]
                     + dy[None, :, None] * yax[:, None, :])
                  * widths[:, None, None])
        B = len(centers)
        cand_c = cand_c.reshape(B * N, 3).astype(np.float32)
        src = np.repeat(np.arange(B), N)

        inside = self.tree.contains(cand_c)
        occupied = self.tree.containing_cell(cand_c) >= 0
        finer = self.tree.structure_level(cand_c) > levels[src]
        todo = inside & ~occupied & ~finer
        sel = np.nonzero(todo)[0]
        seg = src[sel]
        return (cand_c[sel], normals[seg],
                (widths[seg] * opt.EXTEND_SCALE / 2.0).astype(np.float32),
                views[seg], centers[seg].astype(np.float32),
                widths[seg].astype(np.float32), seg, levels[seg],
                prio_red[seg])

    def _extend_stream(self, centers, normals, scales, views, parent_c,
                       widths):
        """Yield (start, stop, host results) per BATCH-sized chunk: every
        chunk is enqueued on the device before the first copy back, so the
        host routing of chunk i overlaps chunk i+1..'s device work."""
        n = centers.shape[0]
        cap = max(self.opt.BATCH, 16)
        t0 = time.time()
        devs, spans = [], []
        for i in range(0, n, cap):
            j = min(i + cap, n)
            devs.append(self._dispatch_extend(
                centers[i:j], normals[i:j], scales[i:j], views[i:j],
                parent_c[i:j], widths[i:j]))
            spans.append((i, j))
        self.stats["patches_optimized"] += n
        self.stats["t_device"] += time.time() - t0
        for dev, (a, b) in zip(devs, spans):
            t1 = time.time()
            got = tuple(t.cpu().numpy() for t in dev)
            self.stats["t_device"] += time.time() - t1
            yield a, b, got

    def _insert_winners(self, oc, ok, lv_t):
        """The deterministic insertability decision of _insert_new_patches
        (addConditional re-checks + first-wins in-batch dedup).
        Returns (ok_mask, keys)."""
        ok = ok & self.tree.contains(oc)
        ok = ok & (self.tree.containing_cell(oc) < 0)
        ok = ok & (self.tree.structure_level(oc) <= lv_t)
        keys = np.zeros(len(oc), np.uint64)
        idx_ok = np.nonzero(ok)[0]
        if len(idx_ok):
            for L in np.unique(lv_t[idx_ok]):
                m = ok & (lv_t == L)
                keys[m] = self.tree.key_at(oc[m], int(L))
            pair = np.stack([lv_t[idx_ok].astype(np.uint64), keys[idx_ok]])
            _, first_idx = np.unique(pair, axis=1, return_index=True)
            winner = np.zeros(len(oc), bool)
            winner[idx_ok[first_idx]] = True
            ok = ok & winner
        return ok, keys

    def _insert_new_patches(self, oc, on, os_, ov, ok, col, lv_t,
                            prio_red) -> int:
        """addConditional + insertion of new gated extend results: the
        target leaf must be inside the root, empty and not finer
        (doctree.h:396-419), with a deterministic first-wins dedup within
        the batch standing in for the reference's sequential arrival order.
        Accepted patches alloc a cell + patch row, scatter into the depth
        buffers and queue at (level+prio_red)*10."""
        # addConditional at the *optimized* position (CellProcessor.cpp:154)
        ok, keys = self._insert_winners(oc, ok, lv_t)
        acc = np.nonzero(ok)[0]
        if len(acc) == 0:
            return 0
        lv_a = lv_t[acc]
        pr_a = prio_red[acc]
        new_cids = self.tree.alloc_cells(lv_a.astype(np.int8), keys[acc])
        new_pids = self.patches.alloc(len(acc))
        self.patches.center[new_pids] = oc[acc]
        self.patches.normal[new_pids] = on[acc]
        self.patches.scale[new_pids] = os_[acc]
        self.patches.views[new_pids] = ov[acc]
        self.patches.color[new_pids] = col[acc]
        self.patches.flatness[new_pids] = -1.0
        self.patches.expanded[new_pids] = False
        self.patches.prio_red[new_pids] = pr_a
        self.patches.dirty[new_pids] = False
        self.insert_patches(new_pids, new_cids)
        self._set_depths(new_pids)
        self._push_many((lv_a.astype(np.int64) + pr_a) * 10, new_cids)
        return len(acc)

    def _finish_extend(self, cids, pids, levels, prio_red):
        """Mark expanded + requeue at phase 1 (CellProcessor.cpp:380-387)."""
        self.patches.expanded[pids] = True
        self.patches.dirty[pids] = False
        self._push_many((levels + prio_red) * 10 + 1, cids)

    # -- regularize (CellProcessor::regularize, :309-367) ---------------
    def _regularize_cells(self, cids: np.ndarray):
        opt = self.opt
        hw = opt.REGULARIZE_HWIN
        pids = self.cell_head[cids]
        centers = self.patches.center[pids]
        normals = self.patches.normal[pids]
        views = self.patches.views[pids]
        _, widths = self.tree.cell_center_width(cids)
        levels = self.tree.node_level(cids)

        cam_x = self.cam_xaxis_np[np.maximum(views[:, 0], 0)]
        xax, yax = self._tangent_axes(normals, cam_x)

        offs = [(xx, yy) for yy in range(-hw, hw + 1)
                for xx in range(-hw, hw + 1) if not (xx == 0 and yy == 0)]
        M = len(offs)
        oo = np.asarray(offs, np.float64)               # (M, 2)
        pts = (centers[:, None, :]
               + (oo[None, :, 0, None] * xax[:, None, :]
                  + oo[None, :, 1, None] * yax[:, None, :])
               * widths[:, None, None])
        B = len(cids)
        flat_pts = pts.reshape(B * M, 3)
        owner = self.tree.containing_cell(flat_pts).reshape(B, M)

        # vectorized: distinct neighbor cells per row (sorted-row dedup),
        # first-patch centers straight from the cell-head array
        uniq_cells = np.unique(owner[owner >= 0])
        self._ensure_heads()
        first_pid = self.cell_head[uniq_cells] if len(uniq_cells) \
            else np.zeros((0,), np.int64)
        # owner -> index into uniq_cells (-1 stays -1)
        oidx = np.searchsorted(uniq_cells, np.maximum(owner, 0))
        oidx = np.where(owner >= 0, oidx, -1)

        imax = np.iinfo(np.int64).max
        srt = np.sort(np.where(oidx >= 0, oidx, imax), axis=1)
        distinct = np.concatenate(
            [srt[:, :1] < imax,
             (srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] < imax)], axis=1)
        n_neigh = distinct.sum(1)

        pid_nb = np.where(distinct, first_pid[np.minimum(
            srt, len(uniq_cells) - 1)], -1)
        has_patch = pid_nb >= 0
        pb = self.patches.center[np.maximum(pid_nb, 0)]        # (B, M, 3)
        n_unit = normals / np.maximum(
            np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
        e = np.einsum("bj,bmj->bm", n_unit, pb - centers[:, None, :])
        sq = np.where(has_patch, e * e, 0.0)
        cnt = has_patch.sum(1)
        rms = np.sqrt(sq.sum(1) / np.maximum(cnt, 1)) / widths

        flat = np.where(n_neigh < 1, opt.FLATNESS_NO_NEIGH,
                        np.where(n_neigh < 4, opt.FLATNESS_FEW_NEIGH,
                                 np.where(cnt < 1, opt.FLATNESS_NO_NEIGH,
                                          rms))).astype(np.float32)

        self.patches.flatness[pids] = flat
        self.patches.prio_red[pids] = 0  # CellProcessor.cpp:399
        self._push_many(levels * 10 + 2, cids)
        self.stats["regularized"] += B

    # -- removal (processCell flatness > 2.4 branch, :407-412) ----------
    def _remove_cells(self, cids: np.ndarray):
        pids = self.cell_head[cids]
        self._set_depths(pids, subtract=True)
        self._clear_cell_patches(cids)
        self._free_cells(cids)
        self.stats["removed"] += len(cids)

    # -- branch (CellProcessor::branch, :210-307) -----------------------
    def _branch_cells(self, cids: np.ndarray):
        opt = self.opt
        N = opt.BRANCH_DIRS
        pids = self.cell_head[cids]
        centers = self.patches.center[pids]
        normals = self.patches.normal[pids]
        scales = self.patches.scale[pids]
        views = self.patches.views[pids]
        _, widths = self.tree.cell_center_width(cids)
        levels = self.tree.node_level(cids)

        # getLevelSupport (Scene.cpp:335-344): images with resolution left
        ci = np.maximum(views, 0)
        fz = np.linalg.norm(centers[:, None, :] - self.cam_center_np[ci],
                            axis=-1)
        lvl = np.round(np.log2(np.maximum(
            scales[:, None] * self.cam_fsum_np[ci] / (2.0 * fz), 1e-20)))
        support = ((lvl > opt.MINLEVEL) & (views >= 0)).sum(1)
        exhausted = support < 1
        work = np.nonzero(~exhausted)[0]
        self.stats["exhausted"] += int(exhausted.sum())
        if len(work) == 0:
            return

        cam_x = self.cam_xaxis_np[np.maximum(views[work, 0], 0)]
        xax, yax = self._tangent_axes(normals[work], cam_x)
        ang = 2.0 * np.pi / N * np.arange(N) + np.pi / 4.0
        dx, dy = np.cos(ang), np.sin(ang)
        ext = widths[work] / 4.0
        cand_c = (centers[work][:, None, :]
                  + (dx[None, :, None] * xax[:, None, :]
                     + dy[None, :, None] * yax[:, None, :])
                  * ext[:, None, None])
        Bw = len(work)
        cand_c = cand_c.reshape(Bw * N, 3).astype(np.float32)
        src = np.repeat(np.arange(Bw), N)

        # candidates must stay within the parent cell (pre-gate, :252)
        lv_par = levels[work][src]
        key_par = self.tree.key[cids[work]][src]
        in_cell = self._keys_at_levels(cand_c, lv_par) == key_par

        sel = np.nonzero(in_cell)[0]
        accepted = np.zeros(len(cand_c), bool)
        if len(sel):
            c_in = cand_c[sel]
            n_in = normals[work][src[sel]]
            s_in = (widths[work][src[sel]] * opt.BRANCH_SCALE / 2.0
                    ).astype(np.float32)
            v_in = views[work][src[sel]]
            oc, on, os_, ov, ok, col, _ = self._optimize(c_in, n_in, s_in, v_in)
            # still inside the parent cell after optimization (:262)
            ok &= self._keys_at_levels(oc, lv_par[sel]) == key_par[sel]
            accepted[sel] = ok

        n_acc_per_cell = np.bincount(src[accepted], minlength=Bw)
        # no survivor && level >= PATCH_FINAL_MINLEVEL -> keep lowres (:269)
        keep_lowres = (n_acc_per_cell == 0) \
            & (levels[work] >= opt.PATCH_FINAL_MINLEVEL)
        split_mask = ~keep_lowres
        self.stats["kept_lowres"] += int(keep_lowres.sum())

        # split: remove the old patch + cell (:274-288)
        old_idx = work[split_mask]
        if len(old_idx):
            self._set_depths(pids[old_idx], subtract=True)
            self._clear_cell_patches(cids[old_idx])
            self._free_cells(cids[old_idx])

        if not accepted.any():
            return
        acc = np.nonzero(accepted)[0]
        # drop children of cells that kept their lowres patch
        acc = acc[split_mask[src[acc]]]
        if len(acc) == 0:
            return

        # sel is sorted (np.nonzero), so row lookup is a binary search
        rows = np.searchsorted(sel, acc)
        child_c = oc[rows]
        child_lv = (lv_par[acc] + 1).astype(np.int64)
        child_key = self._keys_at_levels(child_c, child_lv)

        # multiple children may share a child octant -> same cell
        # (multi-patch cells are filtered later, like the reference :291-299)
        pair = np.stack([child_lv.astype(np.uint64), child_key])
        uniq, inv = np.unique(pair, axis=1, return_inverse=True)
        inv = inv.reshape(-1)
        # existing cells at those coords (possible when a neighbor already
        # branched here): reuse
        existing = self.tree.lookup(uniq[0].astype(np.int64),
                                    uniq[1].astype(np.uint64))
        new_mask = existing < 0
        fresh = self.tree.alloc_cells(uniq[0][new_mask].astype(np.int8),
                                      uniq[1][new_mask].astype(np.uint64))
        cell_ids = existing.copy()
        cell_ids[new_mask] = fresh

        new_pids = self.patches.alloc(len(acc))
        self.patches.center[new_pids] = child_c
        self.patches.normal[new_pids] = on[rows]
        self.patches.scale[new_pids] = os_[rows]
        self.patches.views[new_pids] = ov[rows]
        self.patches.color[new_pids] = col[rows]
        self.patches.flatness[new_pids] = -1.0
        self.patches.expanded[new_pids] = False
        par_prio_red = self.patches.prio_red[pids[work][src[acc]]]
        self.patches.prio_red[new_pids] = par_prio_red
        self.insert_patches(new_pids, cell_ids[inv])
        self._set_depths(new_pids)
        # queue each distinct child cell once, at its first child's priority
        _, first_of = np.unique(inv, return_index=True)
        prs = (child_lv[first_of] + par_prio_red[first_of]) * 10
        self._push_many(prs, cell_ids)
        self.stats["branched"] += len(acc)

    # ------------------------------------------------------------------
    def have_work(self) -> bool:
        return bool(self.queue)

    def n_alive(self) -> int:
        return int(self.patches.alive[:self.patches.n].sum())

    def alive_arrays(self):
        ids = np.nonzero(self.patches.alive[:self.patches.n])[0]
        p = self.patches
        return (p.center[ids], p.normal[ids], p.color[ids], p.scale[ids],
                p.views[ids], (p.views[ids] >= 0).sum(1))

    def save_ply(self, path: str, binary=False, normal=True, scale=True,
                 visibility=True):
        c, n, col, s, v, nv = self.alive_arrays()
        ply_io.write_ext_ply(path, c, n, col, s, v, nv, binary=binary,
                             normal=normal, scale=scale, visibility=visibility)
