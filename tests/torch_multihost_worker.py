"""Worker process of tests/test_torch_multihost.py: the port's counterpart of
tests/multihost_worker.py on torch.distributed.

Launched twice: each process holds 4 CPU shards of a global 8-shard mesh
(parallel/mesh.make_mesh over one gloo process group, explicit address,
world size 2). Every process rebuilds the same scene deterministically.
Steps 1-7 are the JAX worker's; after step 6 a per-process checkpoint
round trip. The worker asserts what it can see itself and prints one JSON
line (`TORCH_MULTIHOST {...}`) with the counts the test holds to its
single-process references.

Usage: python torch_multihost_worker.py <process_id> <port> <directory>
"""

import copy
import dataclasses
import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hpmvs_tpu_torch.config import Options  # noqa: E402
from hpmvs_tpu_torch.core import depth as depth_mod  # noqa: E402
from hpmvs_tpu_torch.core import scene as scene_mod  # noqa: E402
from hpmvs_tpu_torch.parallel import ba as ba_mod  # noqa: E402
from hpmvs_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from hpmvs_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from hpmvs_tpu_torch.runtime.owned import OwnedSpatialEngine  # noqa: E402
from hpmvs_tpu_torch.runtime.spatial import SpatialEngine  # noqa: E402
from hpmvs_tpu_torch.testing import (_quatR, _rot_to_quat,  # noqa: E402
                                     make_plane_scene)

PID = int(sys.argv[1])
PORT = int(sys.argv[2])
OUT_DIR = sys.argv[3]          # shared by both processes
# the priority steps of steps 4 and 5 (the JAX worker's counts)
REPLICATED_STEPS = 25
OWNED_STEPS = 10


def options():
    return dataclasses.replace(Options(), START_LEVEL=1, MAXLEVEL=3,
                               MAX_VIEWS=6, COVIS_MIN_POINTS=10, LM_ITERS=4)


def run_steps(eng, n):
    """Seed, then n priority steps from the global queue minimum."""
    eng.seed()
    start = eng._agree_pmin(np.iinfo(np.int64).max - 1)
    start = 0 if start is None else int(start)
    for prio in range(start, start + n):
        eng.process_priority_step(prio)
        if not eng.have_work():
            break


def gathered(x):
    return pmesh.allgather(np.asarray(x))


def owned_invariant(eng):
    """Every local live patch's block belongs to this process."""
    p = eng.patches
    live = np.nonzero(p.alive[:p.n])[0]
    own = eng.block_proc[eng.block_of_points(p.center[live])]
    return bool((own == PID).all())


def step_sharded(ps, opt, out):
    """1) one sharded wavefront step across both processes, against the
    same 8-shard step driven by this one process."""
    scene = scene_mod.build_scene(ps.model, opt, images=ps.images,
                                  device="cpu")
    pack = depth_mod.build_depth_pack(scene.width_np, scene.height_np,
                                      opt.DEPTH_SUBSAMPLE, device="cpu")
    c, n, s, v, _ = scene_mod.make_seed_patches(ps.model, scene, opt)
    (cp, np_, sp_, vp), B = pmesh.pad_to_multiple((c, n, s, v), len(c), 8,
                                                  (0.0, 0.0, 0.0, -1))
    res = {}
    for name, mesh in (("mp", pmesh.make_mesh(["cpu"] * 4, shape=(2, 4))),
                       ("one", pmesh.Mesh([torch.device("cpu")] * 8,
                                          (2, 4)))):
        step, _ = pmesh.sharded_optimize_step(mesh, scene.ctx, opt, pack)
        sh = [pmesh.shard_batch(mesh, a) for a in (cp, np_, sp_, vp)]
        got = step(*sh, pmesh.replicate(mesh, pack.depth))
        res[name] = ([pmesh.unshard(x, mesh) for x in got[:6]],
                     [r for r in got[6] if r is not None])
    (mp, mp_reps), (one, _) = res["mp"], res["one"]
    for a, b in zip(mp, one):
        assert np.array_equal(a, b), "sharded step differs from one process"
    for r in mp_reps[1:]:
        assert torch.equal(r, mp_reps[0])
    # the process-spanning pmin equals the one-process 8-shard pmin
    assert torch.equal(mp_reps[0], res["one"][1][0])
    depth = mp_reps[0]
    assert bool((depth < depth_mod.MAX_DEPTH).any())
    g = gathered(depth.numpy())
    assert np.array_equal(g[0], g[1]), "z-buffers differ across processes"
    out["accepted"] = int(mp[4].sum())
    return mesh, B


def step_halo(B):
    """2) halo exchange and ppermute across the process boundary: every
    shard of process 0 sends to process 1 and back."""
    mesh = pmesh.make_mesh(["cpu"] * 4, shape=(2, 4))
    payload = np.zeros((B, 4), np.float32)
    payload[:, 0] = np.arange(B)
    blocks = ((np.arange(B) % 8 + 4) % 8).astype(np.int32)
    recv, valid, dropped = pmesh.make_halo_exchange(mesh, B // 8)(
        pmesh.shard_batch(mesh, blocks), pmesh.shard_batch(mesh, payload))
    assert dropped == 0
    lr, lv = pmesh.unshard(recv, mesh), pmesh.unshard(valid, mesh)
    assert sorted(lr[lv][:, 0].astype(int).tolist()) == list(range(B))
    bufs = [None if d is None else torch.full((3,), float(i))
            for i, d in enumerate(mesh.devices)]
    moved = pmesh.unshard(pmesh.ppermute(mesh, bufs, 4), mesh)
    assert np.array_equal(moved.reshape(8, 3)[:, 0],
                          (np.arange(8) + 4) % 8), moved
    # 3) termination sum over all 8 shards' counts
    assert pmesh.have_work_psum(mesh, np.arange(1, 9, dtype=np.int32)) == 36


def main():
    assert pmesh.init_distributed(f"tcp://127.0.0.1:{PORT}", 2, PID) == 2
    assert pmesh.process_index() == PID and pmesh.process_count() == 2
    opt = options()
    ps = make_plane_scene(n_cams=4, imgsize=96, n_points=24, seed=0)
    out = {"pid": PID}
    _, B = step_sharded(ps, opt, out)
    step_halo(B)

    # 4) the replicated spatial engine across both processes: every
    # process runs the whole scheduler; its count must equal the
    # single-process 8-shard run's (the test computes it)
    pm = pmesh.make_mesh(["cpu"] * 4, shape=(4, 2))
    assert pm.size == 8 and pm.n_proc == 2
    assert pm.local_ids.tolist() == list(range(4 * PID, 4 * PID + 4))
    eng = SpatialEngine(ps.model, opt, images=ps.images, mesh=pm)
    run_steps(eng, REPLICATED_STEPS)
    n_rep = eng.n_alive()
    assert (gathered(np.int64(n_rep)) == n_rep).all(), "replicas diverge"
    out.update(replicated_alive=n_rep, migrated=int(eng.stats["migrated"]),
               replicated_collectives=int(eng.stats["host_collectives"]))

    # 5) the owned engine: each process holds a real share of the patches
    eng2 = OwnedSpatialEngine(ps.model, opt, images=ps.images, mesh=pm)
    run_steps(eng2, OWNED_STEPS)
    counts2 = gathered(np.int64(eng2.n_alive_local()))
    total2 = int(counts2.sum())
    assert counts2.min() > 0 and counts2.max() < total2, counts2
    assert owned_invariant(eng2), "foreign patches in the local store"
    assert len(eng2.alive_arrays()[0]) == total2 == eng2.n_alive()
    assert total2 > 24       # grew beyond the seeds: extends and halo ran
    out.update(owned_total=total2,
               owned_collectives=int(eng2.stats["host_collectives"]))

    # 6) owned + image subsets to completion
    opt3 = dataclasses.replace(opt, MAX_TREE_LEVEL=8)
    eng3 = OwnedSpatialEngine(ps.model, opt3, images=ps.images, mesh=pm,
                              image_subsets=True)
    eng3.seed()
    share_floor_ok = True
    for prio in range(opt3.max_prio):
        eng3.process_priority_step(prio)
        if prio % 20 == 19:
            cts = gathered(np.int64(eng3.n_alive_local()))
            if cts.sum() > 40 and cts.min() < 0.05 * cts.sum():
                share_floor_ok = False
        if not eng3.have_work():
            break
    counts3 = gathered(np.int64(eng3.n_alive_local()))
    total3 = int(counts3.sum())
    assert share_floor_ok, "a process's share collapsed mid-run"
    assert counts3.min() > 0.1 * total3, counts3
    assert owned_invariant(eng3), "foreign patches in the local store"
    st = eng3.stats
    assert st["slab_miss"] == 0
    mig = gathered(np.int64([st["migrated"], st["halo_arrivals"]]))
    assert mig[:, 0].sum() == mig[:, 1].sum(), mig
    cg3, _, _, _, vg3, _ = eng3.alive_arrays()
    assert len(cg3) == total3
    z_rms = float(np.sqrt(np.mean(cg3[:, 2] ** 2)))
    assert z_rms < 0.05, z_rms

    # per-process checkpoint: each process writes and reads its own share
    path = os.path.join(OUT_DIR, "owned.npz")
    ckpt.save_checkpoint(eng3, path)
    assert os.path.exists(f"{path}.proc{PID}of2.npz")
    eng4 = OwnedSpatialEngine(ps.model, opt3, images=ps.images, mesh=pm,
                              image_subsets=True)
    ckpt.load_checkpoint(eng4, path, device="cpu")
    p3, p4 = eng3.patches, eng4.patches
    assert p3.n == p4.n and np.array_equal(p3.center[:p3.n],
                                           p4.center[:p4.n])
    assert np.array_equal(p3.alive[:p3.n], p4.alive[:p4.n])
    assert np.array_equal(eng3.tree.key[:eng3.tree.n],
                          eng4.tree.key[:eng4.tree.n])
    assert torch.equal(eng3.pack.depth, eng4.pack.depth)
    assert eng4.n_alive() == total3

    # 7) owned dense BA: record observations under the true cameras,
    # perturb all but two anchors (one seed: the same on both processes),
    # re-solve jointly
    true_model = eng3.model
    true_centers = np.asarray([c.c for c in true_model.cameras])
    prob_true = ba_mod.build_dense_problem(true_model, cg3, vg3,
                                           device="cpu")
    rng = np.random.default_rng(11)
    pert_model = copy.deepcopy(true_model)
    for cam in pert_model.cameras[2:]:
        w = rng.normal(0, 0.004, 3)
        th = np.linalg.norm(w) + 1e-12
        Km = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                       [-w[1], w[0], 0]]) / th
        dR = np.eye(3) + np.sin(th) * Km + (1 - np.cos(th)) * (Km @ Km)
        cam.rq = _rot_to_quat(_quatR(cam.rq) @ dR)
        cam.c = cam.c + rng.normal(0, 0.01, 3)
    pre_err = np.linalg.norm(np.asarray(
        [c.c for c in pert_model.cameras]) - true_centers, axis=1)
    eng3.model = pert_model
    prob = ba_mod.build_dense_problem(pert_model, cg3, vg3,
                                      device="cpu")._replace(
        m_uv=prob_true.m_uv)
    hist = np.asarray(ba_mod.apply_dense_ba(eng3, problem=prob,
                                            device="cpu"))
    assert hist[-1] < hist[0] / 3.0, hist
    post = np.asarray([np.concatenate([c.rq, c.c])
                       for c in eng3.model.cameras])
    post_err = np.linalg.norm(post[:, 4:] - true_centers, axis=1)
    assert np.median(post_err[2:]) < np.median(pre_err[2:]) / 2.0, \
        (pre_err, post_err)
    g = gathered(post)
    assert np.array_equal(g[0], g[1]), "cameras differ across processes"
    out.update(owned_complete_total=total3,
               owned_complete_local=int(counts3[PID]),
               owned_complete_zrms=z_rms,
               owned_collectives_complete=int(st["host_collectives"]),
               owned_ba_rms=[float(hist[0]), float(hist[-1])])
    print("TORCH_MULTIHOST " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
