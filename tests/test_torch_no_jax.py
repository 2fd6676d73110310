"""hpmvs_tpu_torch must run without JAX: the GPU host has none.

A fresh interpreter imports the port's whole main path, builds a scene with
its own testing module and optimizes one seed batch on the CPU on each
refiner path (batched stages, the per-patch stages with the reference's
setRefImage and the FD/Broyden GN mode, the plain jacfwd refiner); neither
jax nor hpmvs_tpu may appear in sys.modules afterwards."""

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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "hpmvs_tpu"))
print("BAD", bad)
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "BAD []" in res.stdout, res.stdout[-2000:]
