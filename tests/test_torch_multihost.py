"""The port's multi-process system: 2 torch.distributed (gloo) processes x
4 CPU shards, the counterpart of tests/test_multihost.py.

The worker (torch_multihost_worker.py) runs the JAX worker's steps 1-7 on
a global 8-shard mesh -- the sharded wavefront step, a halo exchange and a
ppermute across the process boundary, the termination sum, the replicated
spatial engine for 25 steps, the owned engine for 10, the owned engine
with image subsets to completion with a per-process checkpoint round trip,
and owned dense BA -- and asserts what each process can see: equal
z-buffers, counts and cameras (bit for bit) on both processes, the
ownership invariant, every process's share, migrations equal to arrivals,
slab_miss 0, the BA's recovery. Meanwhile this test computes the
references: the replicated run must EQUAL the port's single-process
8-shard run; the completed owned run with image subsets lies within 15%
of the JAX package's completed single-process owned engine on 8 virtual
devices, with z-RMS < 0.05."""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

torch.set_num_threads(1)

WORKER_TIMEOUT_S = 200


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _port_replicated_reference() -> int:
    """The worker's step 4 on one process: the same 8-shard mesh shape."""
    from hpmvs_tpu_torch.config import Options
    from hpmvs_tpu_torch.parallel import mesh as pmesh
    from hpmvs_tpu_torch.runtime.spatial import SpatialEngine
    from hpmvs_tpu_torch.testing import make_plane_scene
    opt = dataclasses.replace(Options(), START_LEVEL=1, MAXLEVEL=3,
                              MAX_VIEWS=6, COVIS_MIN_POINTS=10, LM_ITERS=4)
    ps = make_plane_scene(n_cams=4, imgsize=96, n_points=24, seed=0)
    eng = SpatialEngine(ps.model, opt, images=ps.images,
                        mesh=pmesh.make_mesh(["cpu"] * 8, shape=(4, 2)))
    eng.seed()
    start = min(eng.queue) if eng.queue else 0
    for prio in range(start, start + 25):
        eng.process_priority_step(prio)
        if not eng.have_work():
            break
    return eng.n_alive()


def _jax_completed_reference() -> int:
    """The worker's step 6 on one process in the JAX package: its owned
    engine over 8 virtual devices, to completion. Without image subsets:
    the JAX engine compiles a program per slab shape (~4x the time here),
    and the slabs do not change what it computes (792 alive with them,
    803 without).
    (tests/test_multihost.py holds its owned run to the JAX SpatialEngine's
    count instead, 137 here, while the JAX owned engine completes with
    ~800 -- its root cube is pinned to the SfM points' cube, 1.86 wide
    against the seeds' 1.57: tools/plane_reference.py --scene tiny
    --shards 8 --spatial [--owned].)"""
    from hpmvs_tpu.config import Options
    from hpmvs_tpu.parallel import mesh as jmesh
    from hpmvs_tpu.runtime.owned import OwnedSpatialEngine
    from hpmvs_tpu.testing import make_plane_scene
    opt = dataclasses.replace(Options(), START_LEVEL=1, MAXLEVEL=3,
                              MAX_VIEWS=6, COVIS_MIN_POINTS=10, LM_ITERS=4,
                              MAX_TREE_LEVEL=8)
    ps = make_plane_scene(n_cams=4, imgsize=96, n_points=24, seed=0)
    eng = OwnedSpatialEngine(ps.model, opt, images=ps.images,
                             mesh=jmesh.make_mesh(8, shape=(4, 2)))
    eng.seed()
    for prio in range(opt.max_prio):
        eng.process_priority_step(prio)
        if not eng.have_work():
            break
    return int(eng.n_alive())


def test_two_process_port(tmp_path):
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__),
                          "torch_multihost_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-u", worker, str(pid),
                               str(port), str(tmp_path)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for pid in range(2)]
    try:
        # the references run while the workers do
        replicated = _port_replicated_reference()
        completed = _jax_completed_reference()
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    res = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-6000:]}"
        line = [ln for ln in out.splitlines()
                if ln.startswith("TORCH_MULTIHOST ")]
        assert line, out[-4000:]
        res.append(json.loads(line[-1].split(" ", 1)[1]))
    for r in res:
        # step 4: the replicated run equals the single-process run
        assert r["replicated_alive"] == replicated, (r, replicated)
        # steps 6-7: the completed owned run against the JAX engine's
        assert abs(r["owned_complete_total"] - completed) <= max(
            0.15 * completed, 10), (r, completed)
        assert r["owned_complete_zrms"] < 0.05
        assert r["owned_ba_rms"][1] < r["owned_ba_rms"][0] / 3.0
    assert res[0]["owned_complete_total"] == res[1]["owned_complete_total"]
    assert (res[0]["owned_complete_local"] + res[1]["owned_complete_local"]
            == res[0]["owned_complete_total"])
