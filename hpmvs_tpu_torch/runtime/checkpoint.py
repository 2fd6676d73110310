"""Checkpoint / resume for the wavefront engine.

The reference has no checkpoint format; its resumable state is the populated
octree itself via CellProcessor::initFromTree(skip_clean=true)
(CellProcessor.cpp:422-455) plus progressive PLY snapshots (SURVEY.md
section 5). Here the full engine state -- patch SoA, octree cells, priority
queues, depth buffer, statistics -- serializes to one .npz, and
requeue_from_tree reproduces initFromTree's skip-clean semantics so a
checkpoint (or an imported tree) resumes mid-reconstruction.

The file format is hpmvs_tpu/runtime/checkpoint.py's, key for key and dtype
for dtype: a checkpoint written by either package loads into the other's
engine. Any engine of the port saves and loads: one device, a mesh
(shard 0's z-buffer replica is saved; a load re-copies the others) or the
spatial engine (its slabs rebuild at the next dispatch). The owned
multi-process engine writes one share per process (`_owned_path`, the JAX
package's file name), so a share from either package loads into the
other's owned engine; every process calls save and load together (the
deferred-window flush is a collective).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from hpmvs_tpu_torch import resolve_device
from hpmvs_tpu_torch.core.octree import LinearOctree


def _owned_path(engine, path: str):
    """Owned multi-process engines checkpoint per process: each process's
    store holds only its Morton range, so a shared path would clobber
    (P-1)/P of the cloud and a global file loaded everywhere would
    duplicate patches P-fold and violate the ownership invariant. Returns
    the process-suffixed path (hpmvs_tpu/runtime/checkpoint.py:22-34), or
    None for single-store engines."""
    pid = getattr(engine, "pid", None)
    if pid is None:
        return None
    # explicit .npz keeps np.savez from appending another extension, so
    # save and load agree on the exact filename
    return f"{path}.proc{pid}of{engine.n_proc}.npz"


def save_checkpoint(engine, path: str) -> None:
    """Write the engine's state to `path` (an owned engine: its share, to
    _owned_path). No speculation, deep dispatch or one-shot routing flag
    survives into a checkpoint: dropping the speculation first makes the
    saving engine continue exactly as an engine that loads the file."""
    path = _owned_path(engine, path) or path
    engine.drop_speculation()
    engine._flush_depths()  # deferred depth adds must land in the snapshot
    p = engine.patches
    t = engine.tree
    n = p.n
    queue_prios = np.asarray(sorted(engine.queue.keys()), np.int64)
    queue_lists = [np.concatenate(engine.queue[int(pr)]).astype(np.int64)
                   if engine.queue[int(pr)] else np.zeros((0,), np.int64)
                   for pr in queue_prios]
    queue_flat = (np.concatenate(queue_lists) if queue_lists
                  else np.zeros((0,), np.int64))
    queue_sizes = np.asarray([len(q) for q in queue_lists], np.int64)

    np.savez_compressed(
        path,
        patch_center=p.center[:n], patch_normal=p.normal[:n],
        patch_scale=p.scale[:n], patch_views=p.views[:n],
        patch_color=p.color[:n], patch_flatness=p.flatness[:n],
        patch_expanded=p.expanded[:n], patch_prio_red=p.prio_red[:n],
        patch_alive=p.alive[:n], patch_cell=p.cell[:n],
        patch_dirty=p.dirty[:n],
        tree_center=t.center, tree_width=np.asarray([t.width]),
        tree_max_level=np.asarray([t.max_level]),
        tree_level=t.level[:t.n], tree_key=t.key[:t.n],
        tree_alive=t.alive[:t.n],
        depth=engine.pack.depth.cpu().numpy(),   # one copy to the host
        queue_prios=queue_prios, queue_sizes=queue_sizes,
        queue_flat=queue_flat,
        stats=np.frombuffer(json.dumps(dict(engine.stats)).encode(),
                            dtype=np.uint8),
    )


def load_checkpoint(engine, path: str, device="cuda") -> None:
    """Restore engine state in place. The engine must be built on the same
    scene and model (cameras and images come from the NVM, not the file).
    device: where the restored depth buffer goes, the GPU unless
    device="cpu"; it must be the engine's. Owned multi-process engines load
    their process-suffixed share; a single-store checkpoint fed to an owned
    run (or a resume under another process count) raises instead of
    duplicating the cloud P-fold."""
    dev = resolve_device(device)
    if dev.type != engine.device.type:
        raise ValueError(f"load_checkpoint: device {dev} is not the "
                         f"engine's ({engine.device})")
    opath = _owned_path(engine, path)
    if opath is not None:
        if not os.path.exists(opath):
            raise FileNotFoundError(
                f"owned multi-process resume needs the per-process share "
                f"<{opath}> (written by save_checkpoint under the same "
                f"process count); a single-store checkpoint cannot be "
                f"loaded into an owned engine")
        path = opath
    engine.drop_speculation()
    engine._pend = []
    z = np.load(path, allow_pickle=False)
    n = z["patch_center"].shape[0]
    p = engine.patches
    if n > 0:
        p.alloc(n)
    p.n = n
    p.center[:n] = z["patch_center"]
    p.normal[:n] = z["patch_normal"]
    p.scale[:n] = z["patch_scale"]
    p.views[:n] = z["patch_views"]
    p.color[:n] = z["patch_color"]
    p.flatness[:n] = z["patch_flatness"]
    p.expanded[:n] = z["patch_expanded"]
    p.prio_red[:n] = z["patch_prio_red"]
    p.alive[:n] = z["patch_alive"]
    p.cell[:n] = z["patch_cell"]
    # dirty is absent in the JAX package's round-1 checkpoints: False
    p.dirty[:n] = z["patch_dirty"] if "patch_dirty" in z else False

    tree = LinearOctree(z["tree_center"], float(z["tree_width"][0]),
                        int(z["tree_max_level"][0]), native=engine._native)
    nt = z["tree_level"].shape[0]
    if nt > 0:
        tree.alloc_cells(z["tree_level"], z["tree_key"])
        tree.alive[:nt] = z["tree_alive"]
        tree._index = None
    engine.tree = tree

    # rebuild the head/next membership chains; reverse order so the chain
    # heads end up oldest-first like the original insertion order
    engine.cell_head = np.full(max(engine.tree._cap, 1024), -1, np.int64)
    live = np.nonzero(p.alive[:n])[0]
    cids = p.cell[live]
    has = cids >= 0
    engine.insert_patches(live[has][::-1], cids[has][::-1])

    depth = torch.as_tensor(z["depth"])
    if depth.shape != engine.pack.depth.shape:
        raise ValueError(f"checkpoint depth buffer {tuple(depth.shape)} does "
                         f"not fit the scene's {tuple(engine.pack.depth.shape)}")
    engine.pack = dataclasses.replace(engine.pack,
                                      depth=depth.to(engine.device))

    engine.queue.clear()
    pos = 0
    for pr, sz in zip(z["queue_prios"], z["queue_sizes"]):
        engine.queue[int(pr)] = [z["queue_flat"][pos:pos + sz]
                                 .astype(np.int64)]
        pos += sz

    stats = json.loads(bytes(z["stats"]).decode())
    engine.stats.clear()
    engine.stats.update(stats)
    # which octree answers the queries is this engine's, not the writer's
    engine.stats["octree_native"] = engine._native


def requeue_from_tree(engine, skip_clean: bool = True) -> int:
    """CellProcessor::initFromTree (CellProcessor.cpp:422-455): rebuild the
    priority queues from the populated tree, optionally skipping cells whose
    single patch is already expanded AND not dirty (skip_clean skips only
    `expanded_ && !dirty_`, CellProcessor.cpp:443 -- border arrivals are
    marked dirty and therefore re-queued). Returns #queued."""
    engine.drop_speculation()
    engine.queue.clear()
    t = engine.tree
    engine._ensure_heads()
    alive = np.nonzero(t.alive[:t.n])[0]
    heads = engine.cell_head[alive]
    has = heads >= 0
    cand, h = alive[has], heads[has]
    if skip_clean:
        single = engine.patches.nxt[h] < 0
        clean = (single & engine.patches.expanded[h]
                 & ~engine.patches.dirty[h])
        cand = cand[~clean]
    engine._push_many(t.level[cand].astype(np.int64) * 10, cand)
    return len(cand)
