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

The octree bookkeeping (key sets, queues) stays on the host, its large
queries in the native octree library (core/native.py). This is the
single-device engine of hpmvs_tpu/runtime/wavefront.py, with its two wave
modes:

  - wave lookahead (WAVE_LOOKAHEAD): wave N+1's extend batch is dispatched
    before wave N is routed (_speculate_next, _speculate_after_branch), so
    the host's routing overlaps the device's work;
  - deep waves (WAVE_DEPTH > 1, ops/deepwave.py): one dispatch enqueues
    WAVE_DEPTH generations of extend waves, the device simulating the
    router between them, and the host consumes them one wave at a time
    (_deep_consume), falling back to a fresh dispatch when the device's
    guess no longer covers the host's winners.

Shape policy: PyTorch runs eagerly and compiles nothing per shape, so the
JAX engine's coarse shape buckets (_bucket), its flush chunking
(FLUSH_CHUNK) and its deep-batch cap (DEEP_BATCH_CAP, a TPU SMEM limit) are
gone. Classic batches go to the device at their exact size, chunked at
Options.BATCH to bound device memory; the GN kernel's wrapper pads each
chunk to its 128-patch block. A deep dispatch keeps the JAX engine's
512-doubling width ladder, capped at BATCH: generation g+1 holds
width // EXTEND_DIRS parents, so the width is part of the algorithm. A wave
goes deep only while it fits one BATCH chunk. The deferred depth window
always rides the next dispatch whole. Uploads to the GPU go through pinned
memory without blocking, so enqueueing a dispatch never waits for the
device; the host waits only when it copies results back.

Mesh (parallel/mesh.py): Engine(mesh=...) splits every extend chunk over
the mesh's shards, one optimize_and_gate per shard on its own device with
its own z-buffer replica (the first shard's is self.pack.depth); the
deferred depth window applies to every replica once. Without shape
buckets each shard takes its exact lane count: a BATCH chunk gives each
shard at most BATCH // n_shards lanes. Deep waves are off under a mesh (as
in the JAX engine); the lookahead stays on.

Several processes (a mesh that spans them, parallel/mesh.init_distributed):
this engine is the JAX engine's replicated multi-controller mode (its _mp,
hpmvs_tpu/runtime/wavefront.py:98-142). Every process runs the whole host
scheduler; a dispatch computes only this process's shards' lanes, and its
six outputs are allgathered across the processes in shard order before the
host reads them (_fetch), so every process applies identical bookkeeping.
Every process applies the same deferred depth window to its own replicas,
so they stay equal without a device collective. Unlike the JAX engine,
which turns the lookahead off here, the lookahead stays on: each process
speculates identically and fetches at the same points. The coordination
hooks (_count_global, _agree_pmin, ...) are the identity in this engine;
the owned engine (runtime/owned.py) overrides them with host collectives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from hpmvs_tpu_torch import resolve_device, trace
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.core import depth as depth_mod
from hpmvs_tpu_torch.core import native
from hpmvs_tpu_torch.core import scene as scene_mod
from hpmvs_tpu_torch.core.octree import LinearOctree, PatchStore
from hpmvs_tpu_torch.geom import camera as cam_ops
from hpmvs_tpu_torch.io import ply as ply_io
from hpmvs_tpu_torch.ops import deepwave
from hpmvs_tpu_torch.ops import optimizer as popt
from hpmvs_tpu_torch.parallel import mesh as pmesh

log = logging.getLogger("hpmvs_tpu_torch")


class Engine:
    """Owns the whole reconstruction state: device scene context + depth
    buffers, host patch store + linear octree + priority queues.

    _REPLICATED: every process holds the whole scheduler state (False in
    the owned engine, runtime/owned.py).

    native_octree: answer the octree's large queries with the native
    library, else with its numpy twin. stats["octree_native"] records
    which. The engine needs the native library whatever this says: its PLY
    formatter writes save_ply's text, so it is built (or loaded) here,
    never inside a run, and a failed build raises.

    device: the GPU unless "cpu" is asked for. mesh: a parallel.mesh.Mesh
    to shard the wavefront batches over; the engine's device is then the
    mesh's first shard (a different `device` raises). host_images: keep
    the packed pyramid's texture on the host (per-block image subsets
    place only their per-shard slabs on the devices)."""

    _REPLICATED = True

    def __init__(self, model, opt: Options, images=None,
                 visdata_path: Optional[str] = None, device=None,
                 native_octree: bool = True, mesh=None,
                 host_images: bool = False):
        self.opt = opt
        self.model = model
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device("cuda" if device is None
                                         else device)
        else:
            self.device = mesh.first
            if device is not None and pmesh._resolve(device) != self.device:
                raise ValueError(f"Engine: device {device} is not the "
                                 f"mesh's first shard ({self.device})")
        self._host_images = host_images
        # a mesh spanning several processes: the replicated
        # multi-controller mode (outputs allgathered at _fetch)
        self._mp = mesh is not None and mesh.n_proc > 1
        self._sharded_gate_fn = None
        self._flush_fn = None
        self._depth_replicas = None
        self.scene = scene_mod.build_scene(model, opt, images=images,
                                           visdata_path=visdata_path,
                                           device=self.device,
                                           host_pack=host_images)
        with trace.span("load.scene"):
            self.pack = depth_mod.build_depth_pack(
                self.scene.width_np, self.scene.height_np,
                opt.DEPTH_SUBSAMPLE, device=self.device)
            self.refresh_host_caches()
        self.patches = PatchStore(opt.MAX_VIEWS)
        self.tree: Optional[LinearOctree] = None
        # cell -> patch membership as intrusive linked arrays (head + nxt)
        self.cell_head = np.full(1024, -1, np.int64)
        # queue[prio] = list of int64 cid chunks (flattened at pop)
        self.queue: Dict[int, List[np.ndarray]] = defaultdict(list)
        # deferred setDepths updates, applied by the next dispatch
        self._pend: List[tuple] = []  # (c, s, views, is_subtract) windows
        # outstanding wave-lookahead speculation (_speculate_next)
        self._spec = None
        # one-shot routing flags of the lookahead (_insert_new_patches)
        self._last_inserted = None
        self._depths_pre_added = False
        self.stats = defaultdict(int)
        # called as wave_hook(self) after every frontier generation
        # (process_priority_step's inner loop): time-budget snapshots
        self.wave_hook: Optional[Callable] = None
        self._native = bool(native_octree)
        native.lib()
        self.stats["octree_native"] = self._native

    # -- coordination hooks: the identity in this single-process engine;
    # -- a multi-process engine overrides them --------------------------
    def _count_global(self, n: int) -> int:
        """Sum a small host counter across processes (identity here)."""
        return int(n)

    def _agree_pmin(self, prio: int):
        """Next queue priority to drain, or None (global min when owned)."""
        if not self.queue:
            return None
        pmin = min(self.queue)
        return None if pmin > prio else pmin

    def _filter_owned(self, keep: np.ndarray, pts: np.ndarray) -> np.ndarray:
        """Mask a seed keep-vector down to locally-owned lanes (identity)."""
        return keep

    def _agree_bbox(self, pts: np.ndarray):
        """Bounding box of the GLOBAL seed cloud (local = identity)."""
        return pts.min(0), pts.max(0)

    def _remote_neighbor_counts(self, pts: np.ndarray) -> np.ndarray:
        """(N,) 0/1: neighbor-probe positions owned by another process
        (always 0 in single-process engines)."""
        return np.zeros(len(pts), np.int64)

    def _gather_pend(self, c, s, v, ph):
        """Merge deferred depth windows across processes (identity): the
        z-buffer is the one globally-shared mutable state, like the
        reference's shared depth pyramid across all processors
        (Scene.h:75-76)."""
        return c, s, v, ph

    def refresh_host_caches(self):
        """Host copies of the camera SoA (the scheduler's hot loop reads
        them without device copies) and the depth pack's per-level layout.
        Re-call after the scene, its cameras or the pack change (streaming,
        dense bundle adjustment). Nothing else in the engine, ops/deepwave.py
        or ops/optimizer.py caches from `scene` or `pack`, except the mesh
        closures, which replicate the scene's tables and are dropped here."""
        self._sharded_gate_fn = None
        self._flush_fn = None
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
        The projection inputs are snapshot now: subtracted patches are freed
        (and their store slots reused) before the window flushes."""
        self._pend_raw(self.patches.center[pids], self.patches.scale[pids],
                       self.patches.views[pids], subtract)

    def _pend_raw(self, c, s, v, subtract: bool):
        """Stage raw depth windows (also the deep waves' add and subtract
        repairs)."""
        if len(s) == 0:
            return
        self._pend.append((np.array(c, np.float32), np.array(s, np.float32),
                           np.array(v, np.int32), subtract))

    def _pend_arrays(self):
        """Concatenate the deferred updates into (c, s, v, phase). One
        window holds the phases add*/sub*/add* (0, 1, 2); a subtract after
        an add-after-sub run opens the next window, whose phases are tagged
        3 higher."""
        if not self._pend:       # an owned process joins a gather empty
            K = self.opt.MAX_VIEWS
            return (np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
                    np.full((0, K), -1, np.int32), np.zeros(0, np.int32))
        c = np.concatenate([e[0] for e in self._pend])
        s = np.concatenate([e[1] for e in self._pend])
        v = np.concatenate([e[2] for e in self._pend])
        base, seen_sub, prev = 0, False, None
        phs = []
        for e in self._pend:
            if e[3]:
                if seen_sub and prev == 2:
                    base, seen_sub = base + 3, False
                seen_sub = True
                ph = 1
            else:
                ph = 2 if seen_sub else 0
            prev = ph
            phs.append(np.full(len(e[1]), base + ph, np.int32))
        return c, s, v, np.concatenate(phs)

    def _take_pending_host(self):
        """The deferred updates' last window as host arrays (c, s, v,
        phase), or None when nothing is pending; everything pending is
        cleared. Earlier windows (a fourth phase was needed) apply on their
        own first, in order. Nothing flushes at staging time: the windows
        are taken where every process takes them (a dispatch, a flush), so
        a multi-process engine's gather stays in lockstep."""
        if self._count_global(len(self._pend)) == 0:
            return None
        c, s, v, ph = self._gather_pend(*self._pend_arrays())
        self._pend = []
        win = ph // 3
        last = int(win.max())
        for w in range(last):
            m = win == w
            if m.any():
                self._apply_window((c[m], s[m], v[m], ph[m] - 3 * w))
        m = win == last
        return c[m], s[m], v[m], ph[m] - 3 * last

    def _take_pending(self):
        """The deferred window as device tensors (c, s, v, phase), or None
        when nothing is pending; the window is cleared."""
        arrs = self._take_pending_host()
        if arrs is None:
            return None
        return tuple(self._dev(a) for a in arrs)

    def _flush_depths(self):
        """Apply the deferred depth windows on their own (for external
        pack readers: checkpoints, dense BA); under a mesh to every local
        shard's replica."""
        pend = self._take_pending_host()
        if pend is not None:
            self._apply_window(pend)

    def _apply_window(self, pend):
        """Apply one phased depth window (host arrays) on its own; under a
        mesh to every local shard's replica."""
        with self._device_time():
            if self.mesh is not None:
                if self._flush_fn is None:
                    self._flush_fn = pmesh.sharded_apply_depth_updates(
                        self.mesh, self.scene.ctx.cams, self.pack,
                        self.opt.DEPTH_SUBSAMPLE)
                self._flush_fn(self._replicas(), *pend)
            else:
                depth_mod.apply_depth_updates(
                    self.pack, self.scene.ctx.cams,
                    *(self._dev(a) for a in pend),
                    subsample=self.opt.DEPTH_SUBSAMPLE)
            self._sync()
        self.stats["dispatches"] += 1
        self.stats["disp_flush"] += 1

    # ------------------------------------------------------------------
    # device dispatch
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _device_time(self):
        """Host time spent enqueueing device work or blocked on the device:
        added to stats["t_device"] and recorded as a `dispatch` span, both
        from the same two clock readings (its `wait` spans tell the
        blocking apart)."""
        c = trace.clocked("dispatch")
        with c:
            yield
        self.stats["t_device"] += c.ns / 1e9

    def _dev(self, a, device=None):
        """Host array -> tensor on `device` (the engine's by default). To
        the GPU through pinned memory without blocking: a pageable copy
        would make the host wait for everything enqueued before it (the
        caching host allocator keeps the pinned block until its copy has
        run)."""
        device = self.device if device is None else device
        t = torch.as_tensor(np.ascontiguousarray(a))
        if device.type != "cuda":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    def _sync(self):
        devs = [self.device] if self.mesh is None else self.mesh.distinct
        with trace.span("wait"):
            for d in devs:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

    # -- mesh plumbing -----------------------------------------------------
    def _replicas(self) -> list:
        """The per-shard z-buffer replicas (None for other processes'
        shards); this process's first shard's is self.pack.depth.
        When the pack was replaced (checkpoint load, stream extension,
        dense BA) the other shards' replicas are copied from it anew."""
        r = self._depth_replicas
        d = self.pack.depth
        i0 = int(self.mesh.local_ids[0])
        if r is None or r[i0] is not d:
            r = [None if dev is None else d.to(dev, copy=True)
                 for dev in self.mesh.devices]
            r[i0] = d
            self._depth_replicas = r
        return r

    def _dev_shards(self, arrays) -> list:
        """Host arrays -> per-shard tuples of device tensors, uploaded once
        per distinct device (read-only: shards on one device share them);
        None for other processes' shards."""
        per = {d: tuple(self._dev(a, d) for a in arrays)
               for d in self.mesh.distinct}
        return [None if d is None else per[d] for d in self.mesh.devices]

    def _mesh_dispatch(self, parts, gates: bool):
        """Enqueue one sharded optimize+gate dispatch: parts[i] is shard
        i's 6 host lane arrays, or None. The deferred window rides along
        to every replica. Returns per-shard device outputs (None where a
        shard had no lanes or belongs to another process: only this
        process's shards are computed here)."""
        pend = self._take_pending_host()
        if pend is not None:
            pend = self._dev_shards(pend)
        lanes = [None if p is None else tuple(
            self._dev(a, d) for a in (np.asarray(p[0], np.float32),
                                      np.asarray(p[1], np.float32),
                                      np.asarray(p[2], np.float32),
                                      np.asarray(p[3], np.int32),
                                      np.asarray(p[4], np.float32),
                                      np.asarray(p[5], np.float32)))
            if d is not None else None
            for p, d in zip(parts, self.mesh.devices)]
        return self._sharded_gate_call(lanes, pend, gates)

    def _sharded_gate_call(self, lanes, pend, gates: bool):
        """Mesh-path optimize+gate over per-shard device lanes (the spatial
        engine overrides it with the per-block image-subset variant)."""
        if self._sharded_gate_fn is None:
            self._sharded_gate_fn, _ = pmesh.sharded_optimize_and_gate(
                self.mesh, self.scene.ctx, self.opt, self.pack,
                self.scene.n_cameras, pack_layout=self._pack_layout)
        return self._sharded_gate_fn(lanes, self._replicas(), pend,
                                     with_gates=gates)

    def _host_out(self, out):
        """A dispatch's device outputs -> its 6 host arrays; a mesh
        dispatch's per-shard outputs concatenate in shard order."""
        if isinstance(out, list):
            parts = [p for p in self._fetch(out) if p is not None]
            return tuple(np.concatenate([p[j] for p in parts])
                         for j in range(6))
        with trace.span("wait"):
            return tuple(t.cpu().numpy() for t in out)

    def _fetch(self, out: list) -> list:
        """Blocking fetch of a mesh dispatch's per-shard outputs as host
        tuples (None where a shard had no lanes). Over several processes
        (the replicated mode) the other processes' shards are allgathered
        in shard order, so every process reads the full results
        (hpmvs_tpu/runtime/wavefront.py:100-113). The owned engine reads
        its own shards only (_REPLICATED False)."""
        with trace.span("wait"):
            host = [None if o is None else tuple(t.cpu().numpy() for t in o)
                    for o in out]
        if not (self._mp and self._REPLICATED):
            return host
        b0 = pmesh.WIRE["bytes"]
        host = pmesh._merge_shards(self.mesh, host)
        self.stats["host_collectives"] += 1
        self.stats["mp_gather_bytes"] += pmesh.WIRE["bytes"] - b0
        return host

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
        returns device tensors (oc, on, os, ov, ok, col), under a mesh a
        list of them per shard (the chunk split into contiguous equal
        segments). Deferred depth updates ride along and the z-buffer is
        updated in place."""
        # all-bare batches (branch / seed dispatches) skip the geometric
        # gates, whose per-lane results those lanes discard anyway
        gates = bool((widths > 0).any())
        if self.mesh is not None:
            n, ns = len(scales), self.mesh.size
            per = -(-n // ns)
            parts = []
            for i in range(ns):
                a, b = min(i * per, n), min((i + 1) * per, n)
                parts.append(None if a == b else tuple(
                    x[a:b] for x in (centers, normals, scales, views,
                                     parent_c, widths)))
            out = self._mesh_dispatch(parts, gates)
            self.stats["dispatches"] += 1
            self.stats["disp_extend"] += 1
            return out
        pend = self._take_pending()
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
        with trace.span("load.seed"):
            return self._seed()

    def _seed(self):
        opt = self.opt
        c, n, s, v, orig = scene_mod.make_seed_patches(self.model, self.scene,
                                                       opt)
        if self._count_global(c.shape[0]) == 0:
            self.tree = LinearOctree(np.zeros(3), 2.0, native=self._native)
            return 0
        t0 = time.time()
        out_c, out_n, out_s, out_v, ok, col, _ = self._optimize(c, n, s, v)
        with np.errstate(invalid="ignore"):
            drift = (np.linalg.norm(out_c - orig, axis=1)
                     <= out_s * opt.SEED_DRIFT)
        keep = ok & drift
        self.stats["seed_ok"] = int(ok.sum())
        self.stats["seed_drift_pass"] = int((ok & drift).sum())
        keep = self._filter_owned(keep, out_c)
        log.info("created %d initPatches out of %d points (%.1fs)",
                 int(keep.sum()), self.model.n_points, time.time() - t0)

        c, n, s, v, col = (out_c[keep], out_n[keep], out_s[keep], out_v[keep],
                           col[keep])
        if self._count_global(c.shape[0]) == 0:
            self.tree = LinearOctree(np.zeros(3), 2.0, native=self._native)
            return 0
        # bounding cube root (Scene.cpp:186-193); global across processes
        mn, mx = self._agree_bbox(c)
        width = max(float(np.max(mx - mn)), 1e-6)
        self.tree = LinearOctree((mn + mx) / 2.0, width,
                                 max_level=min(opt.MAX_TREE_LEVEL + 2, 20),
                                 native=self._native)
        # seed scale floor (Scene.cpp:196)
        s = np.maximum(s, width / (1 << (opt.PATCH_INIT_MAXLEVEL + 1)))

        # add(p, scale): level from width formula, then conflict pushdown --
        # finer structure created by co-located finer patches forces coarser
        # patches down (doctree.h:378-394 split-with-buffer semantics)
        lv, keys = self.tree.seed_pushdown(c, self.tree.level_for_width(s))
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

    # ------------------------------------------------------------------
    # the cell state machine, batched (CellProcessor::processCell)
    # ------------------------------------------------------------------
    def process_priority_step(self, prio: int) -> bool:
        """Drain every queue entry with priority <= prio
        (one OMP-parallel processQueue sweep in the reference,
        main.cpp:150-154)."""
        with trace.span("step", prio):
            return self._priority_step(prio)

    def _priority_step(self, prio: int) -> bool:
        changed = False
        while True:
            pmin = self._agree_pmin(prio)
            if pmin is None:
                break
            live = self._pop_live(pmin)
            if self._count_global(len(live)) == 0:
                continue
            changed = True
            self._process_cells(live, pmin)
            self.stats["cells_processed"] += len(live)
            # each inner iteration drains one frontier generation (a classic
            # wave or a consumed deep generation), so this fires every few
            # seconds even inside a long priority step
            if self.wave_hook is not None:
                with trace.span("hook"):
                    self.wave_hook(self)
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
            with trace.span("cells.filter"):
                self._filter_cells(multi)

        first_pid = self.cell_head[cids]
        expanded = self.patches.expanded[first_pid]
        flat = self.patches.flatness[first_pid]

        # extend and branch dispatch device work: a multi-process engine
        # agrees their participation (empty local batches still join);
        # filter, regularize and remove are host-only
        ext = cids[~expanded]
        if self._count_global(len(ext)):
            with trace.span("cells.extend"):
                self._extend_cells(ext)
        reg = cids[expanded & (flat < 0)]
        if len(reg):
            with trace.span("cells.regularize"):
                self._regularize_cells(reg)
        rem = cids[expanded & (flat > opt.FLATNESS_REMOVE)]
        if len(rem):
            with trace.span("cells.remove"):
                self._remove_cells(rem)
        bra = cids[expanded & (flat >= 0) & (flat <= opt.FLATNESS_REMOVE)]
        if self._count_global(len(bra)):
            with trace.span("cells.branch"):
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
        opt = self.opt
        pids = self.cell_head[cids]
        spec = self._spec
        self._spec = None
        if spec is not None:
            if self._spec_matches(spec, pids):
                self.stats["lookahead_hits"] += 1
                if spec.get("deep"):
                    self._deep_consume(spec, cids, pids)
                else:
                    self._extend_finish_from(spec, cids, pids)
                return
            # speculation missed: its depth side effects were real and are
            # already in the z-buffer (always correct); only the gate output
            # is dropped. Its lanes never counted into patches_optimized
            # (count=False at dispatch); they count as speculative waste.
            self.stats["lookahead_misses"] += 1
            self.stats["spec_dropped_lanes"] += len(spec["cand_c"])
        centers = self.patches.center[pids]
        normals = self.patches.normal[pids]
        views = self.patches.views[pids]
        prio_red = self.patches.prio_red[pids]
        _, widths = self.tree.cell_center_width(cids)
        levels = self.tree.node_level(cids)

        (c_in, n_in, s_in, v_in, p_in, w_in, src_sel, lv_lanes,
         pr_lanes) = self._extend_candidates(centers, normals, views,
                                             prio_red, widths, levels)
        self.stats["extend_candidates"] += len(c_in)
        if self._count_global(len(c_in)) == 0:
            self._finish_extend(cids, pids, levels, prio_red)
            return
        if self._lookahead_ok():
            # speculative path: dispatch every chunk, fetch, then speculate
            # wave N+1 BEFORE routing (whole-batch route; the in-batch
            # first-wins dedup stands in for chunk order as it stands in
            # for the reference's sequential order)
            out = self._fetch_spec_chunks(self._spec_dispatch(
                c_in, n_in, s_in, v_in, p_in, w_in))
            self._speculate_next(out, lv_lanes, pr_lanes)
            n_ins = self._route_extend(*out, lv_lanes, pr_lanes,
                                       cids[src_sel])
            self._commit_spec()
            self.stats["extended"] += n_ins
            self._finish_extend(cids, pids, levels, prio_red)
            return
        n_ins = 0
        for a, b, (oc, on, os_, ov, okk, col) in self._extend_stream(
                c_in, n_in, s_in, v_in, p_in, w_in):
            # routing chunk i overlaps chunks i+1..'s device compute; the
            # insert-time occupancy re-check keeps first-wins order
            # identical to whole-batch routing
            n_ins += self._route_extend(oc, on, os_, ov, okk, col,
                                        lv_lanes[a:b], pr_lanes[a:b],
                                        cids[src_sel[a:b]])
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
        for dev, a, b in self._spec_dispatch(centers, normals, scales, views,
                                             parent_c, widths):
            with self._device_time():
                got = self._host_out(dev)
            yield a, b, got

    def _lookahead_ok(self) -> bool:
        """Wave lookahead needs one extend batch per wave (EXTEND_SUBROUNDS
        sub-rounds interleave depth updates the speculation cannot see)."""
        return bool(self.opt.WAVE_LOOKAHEAD) and self.opt.EXTEND_SUBROUNDS <= 1

    # -- deep waves (ops/deepwave.py) ------------------------------------
    def _deep_bucket(self, n: int) -> int:
        """Lane count of a deep dispatch: 512 doubling, capped at BATCH.
        Generation g+1 holds width // EXTEND_DIRS parents, so a dispatch at
        the wave's exact size would fall back for overflow far more often;
        the JAX engine's ladder keeps its fallback rate."""
        b = 512
        while b < n:
            b *= 2
        return min(b, max(self.opt.BATCH, 16))

    def _deep_ok(self, n: int) -> bool:
        """A wave goes deep while it fits one BATCH chunk; larger waves take
        the chunked lookahead path. Never under a mesh (as in the JAX
        engine: its device router runs on one device)."""
        return (self.opt.WAVE_DEPTH > 1 and self.mesh is None
                and n <= max(self.opt.BATCH, 16))

    def _deep_dispatch(self, c_in, n_in, s_in, v_in, p_in, w_in):
        """Enqueue ONE WAVE_DEPTH-generation dispatch (deepwave.
        optimize_and_gate_deep) without waiting for the device: the device
        router chains the following waves' optimize + gates behind this
        wave's, so the host waits for the device once per WAVE_DEPTH waves.
        Returns (DeepOut on the device, n_lanes)."""
        n = len(c_in)
        with self._device_time():
            pend = self._take_pending()
            lanes = [self._dev(a) for a in deepwave.pad_lanes(
                (c_in, n_in, s_in, v_in, p_in, w_in), self._deep_bucket(n))]
            root = np.concatenate([np.asarray(self.tree.center, np.float32),
                                   np.asarray([self.tree.width],
                                              np.float32)])
            root = self._dev(root)
            out = deepwave.optimize_and_gate_deep(
                self.scene.ctx, self.pack, self.opt, self.scene.n_cameras,
                deepwave.GateIn(*lanes), root[:3], root[3], pend=pend,
                n_gens=int(self.opt.WAVE_DEPTH),
                pack_layout=self._pack_layout)
            self.stats["dispatches"] += 1
            self.stats["disp_deep"] += 1
        return out, n

    def _deep_consume(self, spec, cids, pids):
        """Consume generation spec["g"] of a deep dispatch as the popped
        wave (the deep twin of _extend_finish_from; see ops/deepwave.py for
        the superset / fresh-recheck contract).

        Per generation: re-apply the tree pre-checks FRESH on the
        device-returned candidate positions, reconcile the DEVICE winner
        set with the host router's (device winners are a superset; false
        winners' device depth adds are repaired with staged subtracts, host
        winners the device dedup missed -- float-boundary quantization --
        get their adds staged), route, then either step to the next
        on-device generation (when every host winner has its children rows)
        or fall back to a fresh speculative dispatch."""
        g = int(spec["g"])
        if spec["outs"] is None:
            interval = time.time() - spec["t_dispatched"]
            dev_inside = self.stats["t_device"] - spec["t_dev_mark"]
            self.stats["t_host_overlapped"] += max(interval - dev_inside, 0.0)
            with self._device_time(), trace.span("wait"):
                spec["outs"] = deepwave.to_host(spec["dev"])
            spec["dev"] = None
        W, B = spec["outs"].ok.shape
        DIRS = int(self.opt.EXTEND_DIRS)
        oc_f, on_f, os_f, ov_f, ok_f, col_f, cand_f, win_f = (
            a[g] for a in spec["outs"])
        if g == 0:
            rows = np.arange(int(spec["n_lanes"]))
            cand = spec["cand_c"]        # host-built, f64-accurate
        else:
            rows = spec["rows"]
            cand = cand_f[rows]
        lv_l = spec["lv_lanes"]
        pr_l = spec["pr_lanes"]
        cell_lv = spec["levels"]
        cell_pr = spec["prio_red"]
        oc, on = oc_f[rows], on_f[rows]
        os_, ov = os_f[rows], ov_f[rows]
        col = col_f[rows]
        fresh = (self.tree.contains(cand)
                 & (self.tree.containing_cell(cand) < 0)
                 & (self.tree.structure_level(cand) <= lv_l))
        okf = ok_f[rows] & fresh
        self.stats["extend_candidates"] += int(fresh.sum())
        self.stats["patches_optimized"] += int(fresh.sum())
        self.stats["spec_waste_lanes"] += len(fresh) - int(fresh.sum())
        # the router's acceptance, precomputed (deterministic)
        ok2, _ = self._insert_winners(oc, okf, lv_l)
        acc = np.nonzero(ok2)[0]
        has_next = g + 1 < W
        deep_next = False
        if has_next:
            hw_full = rows[acc]
            if g == 0:
                # generation 0's winner adds happened ON the device (only
                # generation 0's: see optimize_and_gate_deep). Reconcile:
                # subtract the false winners, add the host winners the
                # device dedup missed, and have routing skip its own
                # _set_depths.
                ins_full = np.zeros(B, bool)
                ins_full[hw_full] = True
                false_w = win_f & ~ins_full
                if false_w.any():
                    self._pend_raw(oc_f[false_w], os_f[false_w],
                                   ov_f[false_w], subtract=True)
                    self.stats["deep_false_winner_repairs"] += \
                        int(false_w.sum())
                miss_add = hw_full[~win_f[hw_full]]
                if len(miss_add):
                    self._pend_raw(oc_f[miss_add], os_f[miss_add],
                                   ov_f[miss_add], subtract=False)
                self._depths_pre_added = True
            # next-generation coverage: every host winner must own children
            # rows
            dev_lanes = np.nonzero(win_f)[0]
            n_par = B // DIRS
            if len(acc) == 0:
                self.stats["deep_fb_dead"] += 1
            elif len(dev_lanes) == 0:
                self.stats["deep_fb_mismatch"] += 1
            else:
                pos = np.searchsorted(dev_lanes, hw_full)
                safe = np.minimum(pos, len(dev_lanes) - 1)
                in_dev = (pos < len(dev_lanes)) & (dev_lanes[safe] == hw_full)
                covered = in_dev & (pos < n_par)
                deep_next = bool(covered.all())
                if not deep_next:
                    if bool(in_dev.all()):
                        self.stats["deep_fb_overflow"] += 1
                    else:
                        self.stats["deep_fb_mismatch"] += 1
        if not deep_next:
            if has_next:
                self.stats["deep_fallbacks"] += 1
                self.stats["spec_dropped_lanes"] += (W - g - 1) * B
            # last generation (or fallback): classic next-wave speculation
            # BEFORE routing mutates the tree (may itself go deep)
            self._speculate_next((oc, on, os_, ov, okf, col), lv_l, pr_l)
            n_ins = self._route_extend(oc, on, os_, ov, okf, col, lv_l,
                                       pr_l, cids[spec["src_sel"]])
            self._commit_spec()
            self.stats["extended"] += n_ins
            self._finish_extend(cids, pids, cell_lv, cell_pr)
            return
        n_ins = self._route_extend(oc, on, os_, ov, okf, col, lv_l, pr_l,
                                   cids[spec["src_sel"]])
        self.stats["extended"] += n_ins
        self._finish_extend(cids, pids, cell_lv, cell_pr)
        # step the spec to the next on-device generation: wave N+1's lanes
        # are the children rows of the just-inserted parents, in insertion
        # (ascending-lane) order == their queue pop order
        new_pids = np.asarray(self._last_inserted)
        if len(new_pids) != len(acc):       # never expected
            self._spec = None
            self.stats["deep_fallbacks"] += 1
            return
        spec["rows"] = (pos[:, None] * DIRS + np.arange(DIRS)[None]).ravel()
        spec["lv_lanes"] = np.repeat(lv_l[acc], DIRS)
        spec["pr_lanes"] = np.repeat(pr_l[acc], DIRS)
        spec["src_sel"] = np.repeat(np.arange(len(acc)), DIRS)
        spec["levels"] = lv_l[acc]
        spec["prio_red"] = pr_l[acc]
        spec["n_par"] = len(acc)
        spec["par_pids"] = new_pids.copy()
        spec["par_c"] = self.patches.center[new_pids].copy()
        spec["g"] = g + 1
        self.stats["deep_gens_consumed"] += 1
        self._spec = spec

    # -- wave lookahead ---------------------------------------------------
    def _spec_dispatch(self, c_in, n_in, s_in, v_in, p_in, w_in,
                       count: bool = True):
        """Enqueue a wave's extend batch as BATCH-sized chunk dispatches
        without waiting; returns [(device outputs, a, b), ...] for
        _fetch_spec_chunks. count=False for SPECULATIVE dispatches: their
        lanes count into patches_optimized at consume time, from the fresh
        re-check's survivors (the lanes a non-speculative engine would have
        dispatched), so dropped speculations and stale superset lanes never
        inflate it."""
        cap = max(self.opt.BATCH, 16)
        n = len(c_in)
        devs = []
        with self._device_time():
            for i in range(0, n, cap):
                j = min(i + cap, n)
                devs.append((self._dispatch_extend(
                    c_in[i:j], n_in[i:j], s_in[i:j], v_in[i:j], p_in[i:j],
                    w_in[i:j]), i, j))
            if count:
                self.stats["patches_optimized"] += n
        return devs

    def _fetch_spec_chunks(self, devs):
        """Blocking fetch of _spec_dispatch chunks -> one wave's 6 host
        arrays."""
        with self._device_time():
            outs = [self._host_out(dev) for dev, _, _ in devs]
        if len(outs) == 1:
            return outs[0]
        return tuple(np.concatenate([o[j] for o in outs]) for j in range(6))

    def _spec_matches(self, spec, pids) -> bool:
        # pids AND content: an external mutation between waves leaves pids
        # equal but voids the speculated inputs -- drop_speculation()
        # covers the known sites, the centre comparison is the backstop
        return spec["par_pids"] is not None \
            and len(pids) == len(spec["par_pids"]) \
            and np.array_equal(spec["par_pids"], pids) \
            and np.array_equal(self.patches.center[pids], spec["par_c"])

    def drop_speculation(self):
        """Void any outstanding wave speculation (a deep dispatch included)
        and the router's one-shot record of its last insert. Call between
        waves, before reading or mutating engine state outside the wave
        loop (checkpoint, stream extension, reroot, dense BA): the
        speculative dispatch's inputs were captured before the mutation.
        Its depth side effects are already in the z-buffer and remain
        correct either way, as on a lookahead miss. Between waves the
        routing flag that pre-staged depth adds is always clear."""
        assert not self._depths_pre_added, "called inside a wave's routing"
        self._spec = None
        self._last_inserted = None

    def _commit_spec(self):
        """Bind the speculation to the router's actual alloc: the simulated
        winners and the routed winners are the same deterministic set, so
        the freshly inserted pids ARE the speculated parents (in order). A
        count mismatch (never expected) voids the speculation."""
        spec = self._spec
        if spec is None:
            return
        pids = self._last_inserted
        if pids is None or len(pids) != spec["n_par"]:
            self._spec = None
            return
        spec["par_pids"] = np.asarray(pids).copy()

    def _extend_finish_from(self, spec, cids, pids):
        """Consume a speculative extend dispatch whose predicted wave
        membership matched the popped wave exactly."""
        # host work done between the speculative dispatch and this fetch
        # ran while the dispatch was in flight: off the critical path.
        # Device-blocking time inside the interval (the intervening wave's
        # fetches) is already in t_device, so its delta is subtracted.
        interval = time.time() - spec["t_dispatched"]
        dev_inside = self.stats["t_device"] - spec["t_dev_mark"]
        self.stats["t_host_overlapped"] += max(interval - dev_inside, 0.0)
        out = self._fetch_spec_chunks(spec["devs"])
        # re-apply the economy pre-check FRESH (the dispatch used a one-wave
        # stale tree, so a superset of lanes ran): masking the now occupied
        # or finer targets out of ok makes the routed lane set match a
        # non-speculative wave, except that targets freed between
        # speculation and consumption (remove-phase frees, filters on other
        # cells) stay absent -- the mask only removes lanes
        cand = spec["cand_c"]
        lv = spec["lv_lanes"]
        fresh = (self.tree.contains(cand)
                 & (self.tree.containing_cell(cand) < 0)
                 & (self.tree.structure_level(cand) <= lv))
        self.stats["extend_candidates"] += int(fresh.sum())
        self.stats["patches_optimized"] += int(fresh.sum())
        self.stats["spec_waste_lanes"] += len(fresh) - int(fresh.sum())
        oc, on, os_, ov, ok, col = out
        out = (oc, on, os_, ov, ok & fresh, col)
        self._speculate_next(out, spec["lv_lanes"], spec["pr_lanes"])
        n_ins = self._route_extend(*out, spec["lv_lanes"], spec["pr_lanes"],
                                   cids[spec["src_sel"]])
        self._commit_spec()
        self.stats["extended"] += n_ins
        self._finish_extend(cids, pids, spec["levels"], spec["prio_red"])

    def _speculate_next(self, out, lv_lanes, pr_lanes):
        """Wave-level lookahead: the next extend wave at this pmin consists
        EXACTLY of the patches this wave's routing is about to insert, and
        insertion is a deterministic function of the fetched gate output and
        the current tree -- simulated here with the router's own
        _insert_winners BEFORE routing mutates anything. Dispatching those
        patches' extend batch now lets wave N's host routing overlap wave
        N+1's device work -- the reference gets the same overlap from
        separate scheduler threads (main.cpp:150-154).

        Semantics (documented divergences; WAVE_LOOKAHEAD=False disables):
        wave N's depth ADDS are pre-staged from the simulated winners and
        ride this dispatch -- the same dispatch they ride without
        speculation -- so the next wave's gates read a z-buffer with no add
        lag; only subtracts created after the speculation (removal-phase
        losers) lag one dispatch. The occupancy pre-check at dispatch is
        one wave stale (a superset of lanes runs); _extend_finish_from
        re-applies it fresh before routing. Large waves route whole-batch.
        A wave that fits one BATCH chunk goes deep when WAVE_DEPTH > 1."""
        self._spec = None
        if not self._lookahead_ok():
            return
        oc, on, os_, ov, ok, col = out
        ok2, _ = self._insert_winners(oc, ok, lv_lanes)
        acc = np.nonzero(ok2)[0]
        if len(acc) == 0:
            return
        par_c = np.ascontiguousarray(oc[acc], np.float32)
        par_n = np.ascontiguousarray(on[acc], np.float32)
        par_v = np.ascontiguousarray(ov[acc])
        lv_a = lv_lanes[acc]
        pr_a = pr_lanes[acc]
        widths = self.tree.width / (2.0 ** lv_a.astype(np.float64))
        (c_in, n_in, s_in, v_in, p_in, w_in, src_sel, lv2,
         pr2) = self._extend_candidates(par_c, par_n, par_v, pr_a, widths,
                                        lv_a)
        if len(c_in) == 0:
            return
        # pre-stage wave N's depth ADDS from the simulated winners (the
        # arrays routing's _set_depths(new_pids) would snapshot): they ride
        # this speculative dispatch, so routing skips its own _set_depths
        # for these inserts (_depths_pre_added)
        self._pend_raw(par_c, os_[acc], par_v, subtract=False)
        self._depths_pre_added = True
        # predicted pids: the router allocs deterministically in acc order;
        # recorded AFTER routing by _commit_spec (the next wave's pop is
        # compared against them)
        spec = {"src_sel": src_sel, "par_c": par_c, "cand_c": c_in,
                "lv_lanes": lv2, "pr_lanes": pr2, "levels": lv_a,
                "prio_red": pr_a, "n_par": len(acc), "par_pids": None}
        self._dispatch_spec(spec, c_in, n_in, s_in, v_in, p_in, w_in)

    def _dispatch_spec(self, spec, c_in, n_in, s_in, v_in, p_in, w_in):
        """Dispatch a speculated wave, deep when it fits, and make it the
        outstanding speculation."""
        if self._deep_ok(len(c_in)):
            dev, n_lanes = self._deep_dispatch(c_in, n_in, s_in, v_in, p_in,
                                               w_in)
            spec.update(deep=True, g=0, outs=None, dev=dev, n_lanes=n_lanes)
        else:
            spec["devs"] = self._spec_dispatch(c_in, n_in, s_in, v_in, p_in,
                                               w_in, count=False)
        spec["t_dispatched"] = time.time()
        spec["t_dev_mark"] = float(self.stats["t_device"])
        self._spec = spec

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

    def _route_extend(self, oc, on, os_, ov, ok, col, lv_t, prio_red,
                      src_cids) -> int:
        """Insert the gated extend candidates. Single-tree engine: all
        candidates are local (the spatial engine overrides this to migrate
        cross-shard candidates through the halo -- the distributeBorderCell
        analog, CellProcessor.cpp:487-540)."""
        del src_cids
        return self._insert_new_patches(oc, on, os_, ov, ok, col, lv_t,
                                        prio_red)

    def _insert_new_patches(self, oc, on, os_, ov, ok, col, lv_t, prio_red,
                            flatness: float = -1.0,
                            dirty: bool = False) -> int:
        """addConditional + insertion of new gated patches (extend results
        or migrated border arrivals): the target leaf must be inside the
        root, empty and not finer (doctree.h:396-419), with a deterministic
        first-wins dedup within the batch standing in for the reference's
        sequential arrival order. Accepted patches alloc a cell + patch row,
        scatter into the depth buffers and queue at (level+prio_red)*10.
        Border arrivals come with flatness 0 and dirty set
        (CellProcessor.cpp:513-514, :443)."""
        # addConditional at the *optimized* position (CellProcessor.cpp:154)
        ok, keys = self._insert_winners(oc, ok, lv_t)
        acc = np.nonzero(ok)[0]
        self._last_inserted = acc
        if len(acc) == 0:
            # a leaked one-shot flag would make a later unrelated insert
            # skip its _set_depths
            self._depths_pre_added = False
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
        self.patches.flatness[new_pids] = flatness
        self.patches.expanded[new_pids] = False
        self.patches.prio_red[new_pids] = pr_a
        self.patches.dirty[new_pids] = dirty
        self._last_inserted = new_pids
        self.insert_patches(new_pids, new_cids)
        if self._depths_pre_added:
            # the speculation already staged these adds into the window that
            # rode its dispatch (one-shot flag, set only for the route call
            # right after the speculation)
            self._depths_pre_added = False
        else:
            self._set_depths(new_pids)
        self._push_many((lv_a.astype(np.int64) + pr_a) * 10, new_cids)
        return len(acc)

    def _finish_extend(self, cids, pids, levels, prio_red):
        """Mark expanded + requeue at phase 1 (CellProcessor.cpp:380-387).
        Processing clears the dirty flag set by border arrivals."""
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
        # a multi-process engine counts neighbour positions in other
        # processes' blocks as present with zero plane error (0 here)
        rc = self._remote_neighbor_counts(flat_pts).reshape(B, M).sum(1)

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
        n_neigh = distinct.sum(1) + rc

        pid_nb = np.where(distinct, first_pid[np.minimum(
            srt, len(uniq_cells) - 1)], -1)
        has_patch = pid_nb >= 0
        pb = self.patches.center[np.maximum(pid_nb, 0)]        # (B, M, 3)
        n_unit = normals / np.maximum(
            np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
        e = np.einsum("bj,bmj->bm", n_unit, pb - centers[:, None, :])
        sq = np.where(has_patch, e * e, 0.0)
        cnt = has_patch.sum(1) + rc
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
        if self._count_global(len(work)) == 0:
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
        in_cell = self.tree.keys_at_levels(cand_c, lv_par) == key_par

        sel = np.nonzero(in_cell)[0]
        accepted = np.zeros(len(cand_c), bool)
        if self._count_global(len(sel)):
            c_in = cand_c[sel]
            n_in = normals[work][src[sel]]
            s_in = (widths[work][src[sel]] * opt.BRANCH_SCALE / 2.0
                    ).astype(np.float32)
            v_in = views[work][src[sel]]
            oc, on, os_, ov, ok, col, _ = self._optimize(c_in, n_in, s_in, v_in)
            # still inside the parent cell after optimization (:262)
            ok &= self.tree.keys_at_levels(oc, lv_par[sel]) == key_par[sel]
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
        child_key = self.tree.keys_at_levels(child_c, child_lv)

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
        self._speculate_after_branch(cell_ids, prs)

    def _speculate_after_branch(self, cell_ids, prs):
        """Branch-boundary lookahead: the wave popped after a branch is the
        children's first extend wave, whose membership -- the keeper patch
        per child cell after the multi-patch filter -- is already fully
        determined by the store state the branch just wrote. Simulate the
        filter's keeper decision (_filter_keepers, side-effect free; the
        real filter still runs, and subtracts/frees the losers, when the
        wave pops) and dispatch the keepers' extend batch NOW. Freshness:
        the filter's loser subtracts ride the following dispatch instead of
        this one. Skipped when the children span several priorities or an
        extend speculation is outstanding (its wave pops first); any
        residual mismatch falls back via _spec_matches."""
        if self._spec is not None or not self._lookahead_ok():
            return
        if len(cell_ids) == 0 or len(np.unique(prs)) != 1:
            return
        # simulate _pop_live(pr) WITHOUT popping: cells already queued at
        # this priority pop together with the freshly pushed children
        chunks = self.queue.get(int(prs[0]))
        if not chunks:
            return
        cells = (np.concatenate(chunks) if len(chunks) > 1
                 else np.asarray(chunks[0], np.int64))
        _, first = np.unique(cells, return_index=True)
        cells = cells[np.sort(first)]
        self._ensure_heads()
        cells = cells[self.tree.alive[cells] & (self.cell_head[cells] >= 0)]
        if len(cells) == 0:
            return
        heads = self.cell_head[cells]
        multi = self.patches.nxt[heads] >= 0
        sim_head = heads.copy()
        if multi.any():
            keepers, _ = self._filter_keepers(cells[multi])
            sim_head[multi] = keepers
        # only the not-expanded heads form the extend subset
        ext = ~self.patches.expanded[sim_head]
        if not ext.any():
            return
        par = sim_head[ext]
        cells_ext = cells[ext]
        centers = self.patches.center[par]
        normals = self.patches.normal[par]
        views = self.patches.views[par]
        prio_red = self.patches.prio_red[par]
        _, widths = self.tree.cell_center_width(cells_ext)
        levels = self.tree.node_level(cells_ext)
        (c_in, n_in, s_in, v_in, p_in, w_in, src_sel, lv2,
         pr2) = self._extend_candidates(centers, normals, views, prio_red,
                                        widths, levels)
        if len(c_in) == 0:
            return
        spec = {"src_sel": src_sel, "par_c": centers.copy(), "cand_c": c_in,
                "lv_lanes": lv2, "pr_lanes": pr2, "levels": levels,
                "prio_red": prio_red, "n_par": len(par),
                "par_pids": np.asarray(par).copy()}
        self._dispatch_spec(spec, c_in, n_in, s_in, v_in, p_in, w_in)

    # ------------------------------------------------------------------
    def reroot_tree(self, direction: np.ndarray):
        """Grow the root cube one level toward `direction` (streaming seeds
        outside the cube). Every cell level shifts +1, so queued priorities
        shift +10 to keep prio = (level + prio_red)*10 + phase consistent.
        The tree drops its query index (the native library's flat key
        tables are rebuilt from it at the next query)."""
        self.tree.reroot(direction)
        self.drop_speculation()  # cell widths/keys changed under the spec
        old = dict(self.queue)
        self.queue = defaultdict(list)
        for pr, chunks in old.items():
            self.queue[pr + 10] = chunks
        self.stats["reroots"] += 1

    def set_cameras(self, model):
        """Adopt `model`'s cameras (same images and sizes: a bundle
        adjustment or an SfM update): the camera SoA is rebuilt on the
        engine's device and the host caches refreshed. The z-buffer is left
        as it is; outstanding speculation, captured under the old cameras,
        is dropped."""
        self.drop_speculation()
        self.model = model
        cams = cam_ops.build_cameras(
            model.cameras, [int(w) for w in self.scene.width_np[:, 0]],
            [int(h) for h in self.scene.height_np[:, 0]], self.opt.MAXLEVEL,
            device=self.device)
        self.scene = self.scene._replace(
            ctx=dataclasses.replace(self.scene.ctx, cams=cams))
        self.refresh_host_caches()

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
        """Write the alive cloud; over several processes (every process
        holds the same cloud) only process 0 writes. The span's arg is the
        rows written."""
        with trace.span("io.save_ply") as sp:
            c, n, col, s, v, nv = self.alive_arrays()
            if self._mp and self.mesh.pid != 0:
                return
            sp.arg = len(c)
            ply_io.write_ext_ply(path, c, n, col, s, v, nv, binary=binary,
                                 normal=normal, scale=scale,
                                 visibility=visibility)
