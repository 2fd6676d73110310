"""The port's SpatialEngine (hpmvs_tpu_torch/runtime/spatial.py) against
hpmvs_tpu/runtime/spatial.py on the CPU: the JAX engine over conftest's 8
virtual devices, the port's over 8 CPU shards shaped (4, 2).

Bitwise: block_of_points and block_of_cells on one random octree built
identically by both packages (64 blocks at block level 2), and the
assignment policies _lpt_assign, _quantile_assign and _xy_order on random
block counts.

End to end on tests/test_subsets.py's _tiny plane (4 cameras x 96 px, 24
points): the port's spatial run against the JAX spatial run -- alive within
10%, the RMS to the plane within 10% (+1e-4) of the JAX run's --, real
migration with every migrated patch arriving (halo_arrivals == migrated >
0, wire bytes >= logical bytes), every arrival inserted with flatness 0 and
dirty set (tests/test_spatial.py:117), no live patch left dirty once the
run completes, and requeue_from_tree re-queueing a dirty expanded patch
(CellProcessor.cpp:443).
"""

import dataclasses

import numpy as np
import pytest
import torch

from hpmvs_tpu.config import Options as JOptions
from hpmvs_tpu.core.octree import LinearOctree as JOctree
from hpmvs_tpu.parallel import mesh as jmesh
from hpmvs_tpu.runtime.spatial import SpatialEngine as JSpatial
from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.core.octree import LinearOctree as POctree
from hpmvs_tpu_torch.parallel import mesh as pmesh
from hpmvs_tpu_torch.runtime import checkpoint as pckpt
from hpmvs_tpu_torch.runtime.spatial import SpatialEngine as PSpatial

torch.set_num_threads(1)

TINY = dict(START_LEVEL=1, MAXLEVEL=3, MAX_VIEWS=6, COVIS_MIN_POINTS=10,
            LM_ITERS=4)


def _bare(cls, tree, n_blocks=64, block_level=2):
    """An engine object holding only what the partition functions read."""
    e = object.__new__(cls)
    e.tree, e._provisional = tree, None
    e.n_blocks, e.block_level = n_blocks, block_level
    e._xy_order_cache = None
    return e


@pytest.fixture(scope="module")
def trees():
    rng = np.random.default_rng(0)
    center, width = np.array([0.1, -0.2, 0.3]), 2.0
    pts = center + (rng.random((400, 3)) - 0.5) * width * 0.999
    lv = rng.integers(1, 7, 400)
    out = []
    for cls in (JOctree, POctree):
        kw = {} if cls is JOctree else dict(native=False)
        t = cls(center, width, max_level=10, **kw)
        keys = np.zeros(len(pts), np.uint64)
        for L in np.unique(lv):
            m = lv == L
            keys[m] = t.key_at(pts[m], int(L))
        pair = np.unique(np.stack([lv.astype(np.uint64), keys]), axis=1)
        t.alloc_cells(pair[0].astype(np.int8), pair[1].astype(np.uint64))
        out.append(t)
    return out, pts


def test_block_partition_equals_jax(trees):
    (jt, pt), pts = trees
    je, pe = _bare(JSpatial, jt), _bare(PSpatial, pt)
    q = np.concatenate([pts, pts * 3.0])       # some outside the root
    np.testing.assert_array_equal(pe.block_of_points(q),
                                  je.block_of_points(q))
    cids = np.arange(jt.n)
    got = pe.block_of_cells(cids)
    np.testing.assert_array_equal(got, je.block_of_cells(cids))
    assert got.min() >= 0 and got.max() < 64 and len(np.unique(got)) > 8
    # cells at or below the block level lie in their centre's block
    deep = cids[pt.level[cids] >= 2]
    c, _ = pt.cell_center_width(deep)
    np.testing.assert_array_equal(pe.block_of_cells(deep),
                                  pe.block_of_points(c))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assignment_policies_equal_jax(trees, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 50, 64) * (rng.random(64) < 0.6)
    for n in (4, 8):
        np.testing.assert_array_equal(PSpatial._lpt_assign(counts, n),
                                      JSpatial._lpt_assign(counts, n))
        np.testing.assert_array_equal(PSpatial._quantile_assign(counts, n),
                                      JSpatial._quantile_assign(counts, n))
    (jt, pt), _ = trees
    np.testing.assert_array_equal(_bare(PSpatial, pt)._xy_order(),
                                  _bare(JSpatial, jt)._xy_order())


def _run(eng, steps=25):
    eng.seed()
    start = min(eng.queue) if eng.queue else 0
    for prio in range(start, start + steps):
        eng.process_priority_step(prio)
        if not eng.have_work():
            break
    return eng


@pytest.fixture(scope="module")
def runs():
    ps = make_plane_scene(n_cams=4, imgsize=96, n_points=24, seed=0)
    je = _run(JSpatial(ps.model, dataclasses.replace(JOptions(), **TINY),
                       images=ps.images,
                       mesh=jmesh.make_mesh(8, shape=(4, 2))))
    pe = PSpatial(ps.model, dataclasses.replace(POptions(), **TINY),
                  images=ps.images,
                  mesh=pmesh.make_mesh(["cpu"] * 8, shape=(4, 2)))
    arrivals = []
    insert = pe._insert_new_patches

    def spy(*a, flatness=-1.0, dirty=False):
        n0 = pe.patches.n
        n = insert(*a, flatness=flatness, dirty=dirty)
        if dirty:
            new = np.arange(n0, pe.patches.n)
            arrivals.append((n, pe.patches.flatness[new].copy(),
                             pe.patches.dirty[new].copy(), flatness))
        return n
    pe._insert_new_patches = spy
    _run(pe)
    return ps, je, pe, arrivals


def _rms(eng, z):
    d = eng.alive_arrays()[0][:, 2] - z
    return float(np.sqrt((d ** 2).mean()))


def test_spatial_against_jax(runs):
    ps, je, pe, _ = runs
    nj, np_ = je.n_alive(), pe.n_alive()
    assert abs(np_ - nj) <= 0.1 * nj, (nj, np_)
    rj, rp = _rms(je, ps.plane_z), _rms(pe, ps.plane_z)
    assert rp <= rj * 1.1 + 1e-4, (rj, rp)
    assert not pe.have_work()


def test_migration_and_arrivals(runs):
    _, je, pe, arrivals = runs
    st = pe.stats
    assert st["migrated"] > 0 and je.stats["migrated"] > 0
    assert st["halo_arrivals"] == st["migrated"]
    assert 0 < st["migrated_inserted"] <= st["migrated"]
    assert st["halo_hops"] > 0
    assert st["halo_bytes_wire"] >= st["halo_bytes_logical"] > 0
    assert st["block_work_lanes"] > 0 and st["block_balance_den"] > 0
    # every arrival batch inserted with flatness 0 and dirty
    assert sum(a[0] for a in arrivals) == st["migrated_inserted"]
    for n, flat, dirty, asked in arrivals:
        assert asked == 0.0 and len(flat) == n
        assert (flat == 0.0).all() and dirty.all()


def test_arrival_dirty_requeue(runs):
    _, _, eng, _ = runs
    p = eng.patches
    live = np.nonzero(p.alive[:p.n])[0]
    # the run completed: every arrival was processed, none stays dirty
    assert not p.dirty[:p.n][live].any()
    victim = live[0]
    was = bool(p.expanded[victim])
    p.expanded[victim] = True
    queued_clean = pckpt.requeue_from_tree(eng, skip_clean=True)
    p.dirty[victim] = True
    queued_dirty = pckpt.requeue_from_tree(eng, skip_clean=True)
    assert queued_dirty == queued_clean + 1
    p.dirty[victim] = False
    p.expanded[victim] = was
    eng.queue.clear()
