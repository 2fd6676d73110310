"""hpmvs_tpu_torch must run without JAX: the GPU host has none.

A fresh interpreter imports the port's whole main path, builds a scene with
its own testing module and optimizes one seed batch on the CPU on each
refiner path (batched stages, the per-patch stages with the reference's
setRefImage and the FD/Broyden GN mode, the plain jacfwd refiner); then
imports the modules of the single-device system (eval, export,
checkpoint, streaming, bundle adjustment), round-trips a checkpoint,
extends a stream by one chunk and solves a tiny bundle adjustment; then
imports the mesh, image subsets and spatial engine and runs one priority
step of a 2-shard spatial engine with image subsets; then brings up a
one-process group (init_distributed) and runs one priority step of the
owned engine (runtime/owned.py) over 2 shards; neither jax nor hpmvs_tpu
may appear in sys.modules afterwards."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

SCRIPT = r"""
import sys
import dataclasses
import numpy as np
import torch
torch.set_num_threads(1)
import hpmvs_tpu_torch
from hpmvs_tpu_torch import cli, interop, kernel_check
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.core import scene as scene_mod
from hpmvs_tpu_torch.ops import optimizer as popt
from hpmvs_tpu_torch.runtime import pipeline
from hpmvs_tpu_torch.testing import make_plane_scene, make_facade_scene

opt = dataclasses.replace(Options(), START_LEVEL=1, MAXLEVEL=3, MAX_VIEWS=6,
                          COVIS_MIN_POINTS=10)
ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2)
make_facade_scene(n_cams=3, imgsize=64, n_points=10, seed=0)
scene = scene_mod.build_scene(ps.model, opt, images=ps.images, device="cpu")
c, n, s, v, _ = scene_mod.make_seed_patches(ps.model, scene, opt)
for kw in ({}, dict(FAST_SETREF=False, LM_EXACT_J=False),
           dict(USE_PALLAS_GN=False)):
    out = popt.optimize_batch(scene.ctx, dataclasses.replace(opt, **kw),
                              torch.as_tensor(c), torch.as_tensor(n),
                              torch.as_tensor(s), torch.as_tensor(v))
    assert bool(out[4].any()), kw

import tempfile
from hpmvs_tpu_torch import eval as peval
from hpmvs_tpu_torch.io import export
from hpmvs_tpu_torch.parallel import ba
from hpmvs_tpu_torch.runtime import checkpoint as ckpt
from hpmvs_tpu_torch.runtime.streaming import StreamingEngine
from hpmvs_tpu_torch.runtime.wavefront import Engine
from hpmvs_tpu_torch.testing import (make_occlusion_scene,
                                     make_ring_plane_scene,
                                     make_sphere_scene, split_model)
make_sphere_scene(n_cams=2, imgsize=32, n_points=5)
make_occlusion_scene(n_cams=2, imgsize=32, n_points=6)
make_ring_plane_scene(n_cams=4, imgsize=32, n_points=8)
eng = Engine(ps.model, opt, images=ps.images, device="cpu")
eng.seed()
path = tempfile.mkdtemp() + "/c.npz"
ckpt.save_checkpoint(eng, path)
eng2 = Engine(ps.model, opt, images=ps.images, device="cpu")
ckpt.load_checkpoint(eng2, path, device="cpu")
assert eng2.n_alive() == eng.n_alive() > 0
export.tree_to_ply(eng2, tempfile.mkdtemp() + "/t")
st = StreamingEngine(opt, device="cpu")
first, second = split_model(ps.model, 3, np.arange(15))
st.add_chunk(first, images=ps.images[:3])
st.add_chunk(second, images=ps.images[3:])
assert st.engine.scene.n_cameras == 4
prob = ba.build_problem(ps.model, device="cpu")
_, _, hist = ba.ba_solve(prob, 4, ps.model.n_points, iters=2, cg_iters=5,
                         device="cpu")
assert bool(torch.isfinite(hist).all())
peval.plane_metrics(eng2.alive_arrays()[0].astype(np.float64), 0.0, 1.0,
                    0.02)

from hpmvs_tpu_torch.parallel import mesh as pmesh
from hpmvs_tpu_torch.parallel import subsets
from hpmvs_tpu_torch.runtime.spatial import SpatialEngine
mesh = pmesh.make_mesh(["cpu"] * 2)
sp = SpatialEngine(ps.model, opt, images=ps.images, mesh=mesh,
                   image_subsets=True)
sp.seed()
pmin = min(sp.queue)
assert sp.process_priority_step(pmin)
assert sp.n_alive() > 0 and sp.stats["subset_rebuilds"] >= 1
assert sp.stats["slab_miss"] == 0

import socket
from hpmvs_tpu_torch.runtime.owned import OwnedSpatialEngine
sock = socket.socket()
sock.bind(("127.0.0.1", 0))
port = sock.getsockname()[1]
sock.close()
assert pmesh.init_distributed(f"tcp://127.0.0.1:{port}", 1, 0) == 1
ow = OwnedSpatialEngine(ps.model, opt, images=ps.images,
                        mesh=pmesh.make_mesh(["cpu"] * 2))
ow.seed()
assert ow.process_priority_step(ow._agree_pmin(10 ** 9))
assert ow.n_alive() > 0 and ow.stats["host_collectives"] > 0
torch.distributed.destroy_process_group()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "hpmvs_tpu"))
print("BAD", bad)
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "BAD []" in res.stdout, res.stdout[-2000:]
