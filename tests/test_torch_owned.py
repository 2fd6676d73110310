"""The port's OwnedSpatialEngine (hpmvs_tpu_torch/runtime/owned.py) at one
process against hpmvs_tpu/runtime/owned.py on the CPU: the JAX engine over
conftest's 8 virtual devices, the port's over 8 CPU shards shaped (4, 2).

End to end on tests/test_subsets.py's _tiny plane (4 cameras x 96 px, 24
points) at MAX_TREE_LEVEL=8, both to completion: alive within 10%, the RMS
to the plane within 15% (+1e-4, as tests/test_owned_parity.py), the
ownership filters ran (stats["seeds"] > 0) and every live patch's block is
owned. At one process the owned engine differs from the spatial engine in
its root cube (pinned to the SfM points' cube) and its per-process
assignment, so it is held to the JAX owned engine, not the spatial one.

Per-process checkpoints: _owned_path names the share as the JAX package
does, a share written by either package loads into the other's owned
engine with equal patch, tree and queue state, and a single-store
checkpoint fed to an owned engine raises FileNotFoundError."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from hpmvs_tpu.config import Options as JOptions
from hpmvs_tpu.parallel import mesh as jmesh
from hpmvs_tpu.runtime import checkpoint as jckpt
from hpmvs_tpu.runtime.owned import OwnedSpatialEngine as JOwned
from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.parallel import mesh as pmesh
from hpmvs_tpu_torch.runtime import checkpoint as pckpt
from hpmvs_tpu_torch.runtime.owned import OwnedSpatialEngine as POwned

torch.set_num_threads(1)

TINY = dict(START_LEVEL=1, MAXLEVEL=3, MAX_VIEWS=6, COVIS_MIN_POINTS=10,
            LM_ITERS=4, MAX_TREE_LEVEL=8)


def _engines(ps):
    je = JOwned(ps.model, dataclasses.replace(JOptions(), **TINY),
                images=ps.images, mesh=jmesh.make_mesh(8, shape=(4, 2)))
    pe = POwned(ps.model, dataclasses.replace(POptions(), **TINY),
                images=ps.images,
                mesh=pmesh.make_mesh(["cpu"] * 8, shape=(4, 2)))
    return je, pe


def _complete(eng):
    eng.seed()
    start = eng._agree_pmin(np.iinfo(np.int64).max - 1)
    for prio in range(int(start or 0), eng.opt.max_prio):
        eng.process_priority_step(prio)
        if not eng.have_work():
            break
    return eng


@pytest.fixture(scope="module")
def runs():
    ps = make_plane_scene(n_cams=4, imgsize=96, n_points=24, seed=0)
    je, pe = _engines(ps)
    return ps, _complete(je), _complete(pe)


def _rms(eng, z):
    d = eng.alive_arrays()[0][:, 2] - z
    return float(np.sqrt((d ** 2).mean()))


def test_owned_against_jax(runs):
    ps, je, pe = runs
    nj, np_ = je.n_alive(), pe.n_alive()
    assert abs(np_ - nj) <= 0.1 * nj, (nj, np_)
    rj, rp = _rms(je, ps.plane_z), _rms(pe, ps.plane_z)
    assert rp <= rj * 1.15 + 1e-4, (rj, rp)
    assert pe.stats["seeds"] > 0 and not pe.have_work()
    assert pe.n_alive_local() == np_ == len(pe.alive_arrays()[0])
    # the ownership invariant (trivial at one process) and the tree cube
    # pinned to the provisional one, as in the JAX engine
    live = np.nonzero(pe.patches.alive[:pe.patches.n])[0]
    assert (pe.block_proc[pe.block_of_points(pe.patches.center[live])]
            == pe.pid).all()
    assert pe.tree.width == pytest.approx(pe._provisional.width)
    assert je.tree.width == pytest.approx(pe.tree.width)
    assert pe.stats["host_collectives"] > 0


def _state(eng):
    p, t = eng.patches, eng.tree
    q = {int(k): np.concatenate(v) for k, v in eng.queue.items() if v}
    return (p.n, p.center[:p.n].copy(), p.views[:p.n].copy(),
            p.alive[:p.n].copy(), t.key[:t.n].copy(), t.alive[:t.n].copy(),
            q)


def _assert_state_equal(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:6], b[1:6]):
        np.testing.assert_array_equal(x, y)
    assert a[6].keys() == b[6].keys()
    for k in a[6]:
        np.testing.assert_array_equal(a[6][k], b[6][k])


def test_owned_checkpoints_cross_packages(runs, tmp_path):
    ps, je, pe = runs
    path = str(tmp_path / "ckpt.npz")
    assert pckpt._owned_path(pe, path) == jckpt._owned_path(je, path) \
        == f"{path}.proc0of1.npz"
    assert pckpt._owned_path(object(), path) is None
    # the port's share into a fresh JAX owned engine
    pckpt.save_checkpoint(pe, path)
    assert os.path.exists(f"{path}.proc0of1.npz")
    assert not os.path.exists(path)
    je2, _ = _engines(ps)
    jckpt.load_checkpoint(je2, path)
    _assert_state_equal(_state(je2), _state(pe))
    np.testing.assert_array_equal(np.asarray(je2.pack.depth),
                                  pe.pack.depth.numpy())
    # the JAX share into a fresh port owned engine
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(je, jpath)
    _, pe2 = _engines(ps)
    pckpt.load_checkpoint(pe2, jpath, device="cpu")
    _assert_state_equal(_state(pe2), _state(je))
    np.testing.assert_array_equal(pe2.pack.depth.numpy(),
                                  np.asarray(je.pack.depth))
    assert pe2.n_alive() == je.n_alive()
    # a single-store checkpoint never loads into an owned engine
    single = str(tmp_path / "single.npz")
    np.savez(single, x=np.zeros(1))
    with pytest.raises(FileNotFoundError):
        pckpt.load_checkpoint(pe2, single, device="cpu")
