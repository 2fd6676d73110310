"""Per-process scheduler ownership for multi-process spatial runs
(hpmvs_tpu/runtime/owned.py on torch.distributed).

The replicated multi-process convention (Engine._fetch allgathers every
dispatch; every process runs the full host scheduler) is a correctness
proof, not a scalable backend: host memory and serial host work are
O(global) per process. This engine is the reference's actual structure --
each CellProcessor owns its subtree + queue and only border patches cross
processors (CellProcessor.h:60-68, :487-540) -- mapped to processes:

  - Blocks are STATICALLY partitioned across processes by contiguous Morton
    range (process p owns blocks [p*n_blocks/P, (p+1)*n_blocks/P)); within
    a process the dynamic LPT assignment balances its own blocks over its
    own shards. Cross-process balance comes from oversubscription
    (BLOCK_OVERSUB blocks per shard), like the reference's ~100 subtrees
    over ~8 threads.
  - Host state (PatchStore, octree cells, queues, membership chains) exists
    only for owned blocks: host memory and bookkeeping scale 1/P.
  - Every process joins every dispatch round, computing only its own
    shards' lanes (possibly none): a round carries the deferred-window
    gather, so the rounds are agreed from the global per-shard lane counts.
    Participation rides tiny host collectives (a few ints per wavefront:
    queue minima, per-shard lane counts, phase participation).
  - Patch records cross processes ONLY as halo rows (the border-queue
    analog), in one host allgather per halo round; each process reads
    arrivals solely on its own shards.
  - The depth z-buffer remains globally shared state -- the reference's
    one shared structure (Scene.h:75-76): the deferred setDepths windows
    allgather across processes before riding a dispatch, so every
    process's replicas see every update in the same order.
  - Termination: a sum of local queue sizes (have_work), the reference's
    haveWork OR-reduce (main.cpp:174-180).

Where the port differs from the JAX engine:
  - The JAX engine's shape agreements (_agree_dim, _agree_rebuild,
    _agree_pair) exist to give its SPMD collectives one shape; a port
    process sizes its own slabs and hops, so they are the identity here
    (runtime/spatial.py) and stats["host_collectives"] counts only the
    collectives that run.
  - An extend candidate whose cell lies in another process's block is
    computed on one of this process's shards (_lane_shards) and its result
    migrates like any other border patch; the JAX engine places it on the
    owner's shard, where the owner's own lanes overwrite it and it is
    dropped.

Output: n_alive, alive_arrays and save_ply gather the global cloud (process
0 writes).
"""

from __future__ import annotations

import numpy as np

from hpmvs_tpu_torch import trace
from hpmvs_tpu_torch.io import ply as ply_io
from hpmvs_tpu_torch.parallel import mesh as pmesh
from hpmvs_tpu_torch.runtime.spatial import SpatialEngine


class OwnedSpatialEngine(SpatialEngine):
    """SpatialEngine whose host scheduler state is partitioned by process."""

    _REPLICATED = False

    def __init__(self, model, opt, images=None, visdata_path=None,
                 mesh=None, image_subsets: bool = False,
                 native_octree: bool = True):
        if mesh is None:
            raise ValueError("OwnedSpatialEngine requires a device mesh "
                             "(parallel.mesh.make_mesh)")
        if opt.EXTEND_SUBROUNDS != 1:
            raise ValueError("owned multi-process runs require "
                             "EXTEND_SUBROUNDS=1 (sub-round counts are "
                             "process-local)")
        self.pid = mesh.pid
        self.n_proc = mesh.n_proc
        super().__init__(model, opt, images=images,
                         visdata_path=visdata_path, mesh=mesh,
                         image_subsets=image_subsets,
                         native_octree=native_octree)
        # which global shard lives on which process -- identical everywhere
        self.shard_proc = mesh.shard_proc.copy()
        self.my_shards = np.nonzero(self.shard_proc == self.pid)[0]
        if len(self.my_shards) == 0:
            raise ValueError("process owns no shard of the mesh")
        # static block -> process map (contiguous Morton ranges)
        self.block_proc = ((np.arange(self.n_blocks) * self.n_proc)
                           // self.n_blocks).astype(np.int64)
        # static home shard per block: round-robin over the owner's shards
        # (another process never needs a block's current shard: it ships
        # its rows to the home shard's process, which reads arrivals on
        # all its shards)
        self.block_shard = np.empty(self.n_blocks, np.int64)
        for p in range(self.n_proc):
            sh = np.nonzero(self.shard_proc == p)[0]
            mine = np.nonzero(self.block_proc == p)[0]
            self.block_shard[mine] = sh[np.arange(len(mine)) % len(sh)]
        self._home_shard = self.block_shard.copy()

    # -- coordination hooks ---------------------------------------------
    def _gather(self, x) -> np.ndarray:
        self.stats["host_collectives"] += 1
        return pmesh.allgather(x)

    def _count_global(self, n: int) -> int:
        return int(self._gather(np.int64(n)).sum())

    def _agree_pmin(self, prio: int):
        imax = np.iinfo(np.int64).max
        local = min(self.queue) if self.queue else imax
        g = int(self._gather(np.int64(local)).min())
        if g == imax or g > prio:
            return None
        return g

    def _agree_shard_counts(self, counts: np.ndarray) -> np.ndarray:
        # each shard's lanes come from its own process: the sum is exact
        return self._gather(np.asarray(counts, np.int64)).sum(0)

    def _shard_local_mask(self) -> np.ndarray:
        return self.shard_proc == self.pid

    def _lane_shards(self, blocks: np.ndarray) -> np.ndarray:
        """Every lane on this process's shards: a lane whose block belongs
        to another process (an extend candidate across the boundary) runs
        on one of this process's shards, and its result migrates."""
        sh = self.block_shard[blocks]
        far = self.shard_proc[sh] != self.pid
        sh[far] = self.my_shards[blocks[far] % len(self.my_shards)]
        return sh

    def _owned_points(self, pts: np.ndarray) -> np.ndarray:
        return self.block_proc[self.block_of_points(pts)] == self.pid

    def _owned_seed_mask(self, pts: np.ndarray) -> np.ndarray:
        return self._owned_points(pts)

    def _filter_owned(self, keep: np.ndarray, pts: np.ndarray) -> np.ndarray:
        """Every process optimized every seed; ownership keys on the
        OPTIMIZED position, so each seed is kept by exactly one process."""
        return keep & self._owned_seed_mask(pts)

    def _agree_bbox(self, pts: np.ndarray):
        """Pin the tree cube to the provisional SfM-point cube: ownership
        filtering ran against the provisional block boundaries, so the real
        tree must keep the SAME partition or boundary seeds would land in
        foreign blocks (deterministic and identical on every process, no
        collective needed)."""
        t = self._provisional
        half = t.width / 2.0
        return np.asarray(t.center) - half, np.asarray(t.center) + half

    def _remote_neighbor_counts(self, pts: np.ndarray) -> np.ndarray:
        return (~self._owned_points(pts)).astype(np.int64)

    def _gather_pend(self, c, s, v, ph):
        """Merge the deferred depth windows of all processes, ordered by
        process id (deterministic): the z-buffer is globally shared state
        and every replica must apply every update. ONE packed allgather
        (rows padded to the longest process's; phase + 1 marks a row)."""
        K = v.shape[1]
        buf = np.zeros((len(s), 3 + 1 + K + 1), np.float32)
        buf[:, 0:3] = c
        buf[:, 3] = s
        buf[:, 4:4 + K] = v
        buf[:, 4 + K] = ph + 1          # 0 marks padding
        g = self._gather(buf)            # (P, m, D)
        rows = g.reshape(-1, g.shape[-1])
        rows = rows[rows[:, 4 + K] > 0]
        self.stats["pend_gathered_rows"] += len(rows)
        return (rows[:, 0:3], rows[:, 3],
                rows[:, 4:4 + K].astype(np.int32),
                rows[:, 4 + K].astype(np.int32) - 1)

    # -- dynamic assignment constrained to the process ------------------
    def _update_assignment(self, counts: np.ndarray):
        """LPT over THIS process's blocks onto its own shards only.
        Remote blocks keep their static home shard, so every process's halo
        destinations stay valid without knowing remote assignments."""
        mine = self.block_proc == self.pid
        total = int(counts[mine].sum())
        if total == 0:
            return
        if self.image_subsets and self._bpack_dev is not None:
            cur = np.bincount(self.block_shard[mine],
                              weights=counts[mine],
                              minlength=self.n_shards)[self.my_shards]
            bal = total / max(len(self.my_shards) * cur.max(), 1)
            if bal >= self.opt.REBALANCE_BELOW:
                return
        sub = self._lpt_assign(counts[np.nonzero(mine)[0]],
                               len(self.my_shards))
        new = self.block_shard.copy()
        new[np.nonzero(mine)[0]] = self.my_shards[sub]
        if np.array_equal(new, self.block_shard):
            return
        self.block_shard = new
        self.stats["rebalances"] += 1
        if self.image_subsets:
            self._bpack_key = None

    # -- global views ----------------------------------------------------
    def have_work(self) -> bool:
        return self._count_global(
            sum(sum(len(ch) for ch in v) for v in self.queue.values())) > 0

    def n_alive_local(self) -> int:
        return int(self.patches.alive[:self.patches.n].sum())

    def n_alive(self) -> int:
        return self._count_global(self.n_alive_local())

    def alive_arrays(self):
        """GLOBAL alive arrays, gathered to every process in process order
        (used by save_ply, evaluation and dense BA)."""
        self.stats["host_collectives"] += 1
        got = pmesh.allgather_object(super().alive_arrays())
        return tuple(np.concatenate([g[j] for g in got]) for j in range(6))

    def save_ply(self, path: str, binary=False, normal=True, scale=True,
                 visibility=True):
        """Gather the global cloud; only process 0 writes (the span's arg
        is the rows written)."""
        with trace.span("io.save_ply") as sp:
            c, n, col, s, v, nv = self.alive_arrays()
            if self.pid == 0:
                sp.arg = len(c)
                ply_io.write_ext_ply(path, c, n, col, s, v, nv,
                                     binary=binary, normal=normal,
                                     scale=scale, visibility=visibility)
