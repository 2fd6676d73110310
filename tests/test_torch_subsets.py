"""Per-block image subsets (hpmvs_tpu_torch/parallel/subsets.py) against
hpmvs_tpu/parallel/subsets.py on the CPU, and the slab path against the
port's own replicated path.

Bitwise against the JAX functions: assign_images_to_blocks (a far root
cube, per-camera depth bounds, a finer occupancy grid, and
tests/test_subsets.py's two fake cameras with disjoint frusta),
camera_depth_bounds, slab_rows and build_block_packs (tex, row tables,
dims and mask; the JAX pack's extra `texb` copy has no counterpart).

Port-internal, bitwise: the fetch twin cutting windows out of a slab with
its block-local row table equals the windows cut from the full pack (also
through kernel_check.check_fetch_slab, the card's check); one
sharded optimize+gate dispatch with per-shard slabs equals the replicated
dispatch on the same lanes (every output, and the z-buffer replicas); and,
as tests/test_subsets.py:46-86, a SpatialEngine whose slabs are forced to
the full pack on every shard (the same assignment policy and hysteresis)
reproduces the true-subsets run bit for bit (alive count, sorted centres),
with slab_miss == 0 and no more rows per shard than the full-slab twin.

Coverage (tests/test_subsets.py:89-107): with absurd depth bounds that
exclude every camera geometrically, the pending-view union still covers
every dispatched lane (slab_miss == 0, patches alive, overrides counted);
and every resident patch's views lie in its block's camera subset.

Scene: tests/test_subsets.py's _tiny (4 cameras x 96 px, 24 points,
START_LEVEL=1, MAXLEVEL=3, MAX_VIEWS=6, COVIS_MIN_POINTS=10, LM_ITERS=4)
over 8 CPU shards shaped (4, 2).
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import pytest
import torch

from hpmvs_tpu.config import Options as JOptions
from hpmvs_tpu.core import depth as jdepth
from hpmvs_tpu.core import scene as jscene
from hpmvs_tpu.parallel import subsets as jsub
from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.image.pyramid import ImagePack as PImagePack
from hpmvs_tpu_torch.ops import fetch as pfetch
from hpmvs_tpu_torch.parallel import mesh as pmesh
from hpmvs_tpu_torch.parallel import subsets as psub
from hpmvs_tpu_torch.runtime.spatial import SpatialEngine

from torch_parity import port_ctx, port_pack

torch.set_num_threads(1)

TINY = dict(START_LEVEL=1, MAXLEVEL=3, MAX_VIEWS=6, COVIS_MIN_POINTS=10,
            LM_ITERS=4)


def _mesh():
    return pmesh.make_mesh(["cpu"] * 8, shape=(4, 2))


@pytest.fixture(scope="module")
def tiny():
    ps = make_plane_scene(n_cams=4, imgsize=96, n_points=24, seed=0)
    jo = dataclasses.replace(JOptions(), **TINY)
    scene = jscene.build_scene(ps.model, jo, images=ps.images)
    return ps, jo, scene, port_ctx(scene.ctx)


def _dims(scene):
    return (np.asarray(scene.ctx.imgs.width)[:, 0],
            np.asarray(scene.ctx.imgs.height)[:, 0])


@pytest.mark.parametrize("case", ["far_root", "depth_bounds", "occupancy"])
def test_assign_images_to_blocks_equals_jax(tiny, case):
    ps, _, scene, ctx = tiny
    w0, h0 = _dims(scene)
    kw = {}
    center, width, nb, L = np.zeros(3), 3.0, 16, 2
    if case == "far_root":
        center, width, nb, L = np.array([190.0, 190.0, 190.0]), 400.0, 8, 1
    if case != "far_root":
        near, far = jsub.camera_depth_bounds(scene.ctx.cams, ps.model)
        kw = dict(near=near, far=far)
    if case == "occupancy":
        occ = np.random.default_rng(0).random(8 ** 3) < 0.3
        kw.update(oct_level=3, occ_oct=occ)
    ref = jsub.assign_images_to_blocks(scene.ctx.cams, w0, h0, center,
                                       width, nb, L, **kw)
    got = psub.assign_images_to_blocks(ctx.cams, w0, h0, center, width, nb,
                                       L, **kw)
    np.testing.assert_array_equal(got, ref)
    if case == "far_root":
        assert ref.sum() < ref.size       # some (block, cam) pairs pruned


def test_camera_depth_bounds_equals_jax(tiny):
    ps, _, scene, ctx = tiny
    for got, ref in zip(psub.camera_depth_bounds(ctx.cams, ps.model),
                        jsub.camera_depth_bounds(scene.ctx.cams, ps.model)):
        np.testing.assert_array_equal(got, ref)


def test_disjoint_frusta_equal_jax():
    """tests/test_subsets.py:131-177: two cameras looking at opposite
    corners of the root; no block needs both, and the slab is half the
    replicated pack."""
    f, w, h = 100.0, 64, 64

    def pmat(C, flip):
        K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
        R = np.diag([1.0, 1.0, 1.0]) if not flip else np.diag([1.0, -1.0,
                                                               -1.0])
        return K @ np.hstack([R, -R @ np.asarray(C, float)[:, None]])

    class FakeCams(NamedTuple):
        P: np.ndarray

    P = np.stack([pmat([0.0, 0.0, -30.0], False),
                  pmat([380.0, 380.0, 420.0], True)])
    cams = FakeCams(P=P[:, None])
    args = (np.array([w, w]), np.array([h, h]),
            np.array([190.0, 190.0, 190.0]), 400.0)
    mask = psub.assign_images_to_blocks(cams, *args, n_blocks=8,
                                        block_level=1)
    np.testing.assert_array_equal(
        mask, jsub.assign_images_to_blocks(cams, *args, n_blocks=8,
                                           block_level=1))
    assert mask.any(1).any() and (mask.sum(1) <= 1).all()
    rows = 20
    gtex = np.arange(2 * rows * 8 * 3, dtype=np.float32).reshape(2 * rows,
                                                                  8, 3)
    row0 = np.array([[0], [rows]], np.int32)
    wid = np.full((2, 1), 8, np.int32)
    hei = np.full((2, 1), rows, np.int32)
    bp = psub.build_block_packs(PImagePack(gtex, row0, wid, hei), mask)
    jb = jsub.build_block_packs(
        jsub.ImagePack(gtex, np.zeros((2 * rows, 1, 128), np.float32), row0,
                       wid, hei), mask)
    assert bp.tex.shape[1] == rows
    for f_ in ("tex", "row0", "width", "height", "mask"):
        np.testing.assert_array_equal(getattr(bp, f_), getattr(jb, f_))


def _host_imgs(scene):
    return tuple(np.array(a) for a in (scene.ctx.imgs.tex,
                                         scene.ctx.imgs.row0,
                                         scene.ctx.imgs.width,
                                         scene.ctx.imgs.height))


@pytest.mark.parametrize("seed", [0, 1])
def test_slab_rows_and_block_packs_equal_jax(tiny, seed):
    _, _, scene, _ = tiny
    tex, row0, wd, ht = _host_imgs(scene)
    mask = np.random.default_rng(seed).random((8, len(row0))) < 0.5
    mask[0] = False                         # one empty slab
    jimgs = jsub.ImagePack(*(np.asarray(a) for a in scene.ctx.imgs))
    jb = jsub.build_block_packs(jimgs, mask)
    pb = psub.build_block_packs(PImagePack(tex, row0, wd, ht), mask)
    assert psub.slab_rows(ht, mask) == jsub.slab_rows(ht, mask)
    for f_ in ("tex", "row0", "width", "height", "mask"):
        np.testing.assert_array_equal(getattr(pb, f_), getattr(jb, f_))
    # rows_b override (the multi-process global max)
    big = psub.build_block_packs(PImagePack(tex, row0, wd, ht), mask,
                                 rows_b=pb.tex.shape[1] + 7)
    assert big.tex.shape[1] == pb.tex.shape[1] + 7
    np.testing.assert_array_equal(
        big.tex, jsub.build_block_packs(jimgs, mask,
                                        rows_b=pb.tex.shape[1] + 7).tex)


def test_fetch_twin_reads_slab(tiny):
    """Windows cut from a slab with its block-local rows equal the windows
    cut from the full pack at the global rows."""
    _, _, scene, _ = tiny
    tex, row0, wd, ht = _host_imgs(scene)
    ncam = len(row0)
    mask = np.zeros((2, ncam), bool)
    mask[0, 1::2] = True
    mask[1, :] = True
    mask[1, 0] = False
    bp = psub.build_block_packs(PImagePack(tex, row0, wd, ht), mask)
    W = 12
    rng = np.random.default_rng(0)
    for b in range(2):
        cams = np.nonzero(mask[b])[0]
        ci = rng.choice(cams, 64)
        lv = rng.integers(0, row0.shape[1], 64)
        oy = rng.integers(0, np.maximum(ht[ci, lv] - W, 0) + 1)
        ox = rng.integers(0, np.maximum(wd[ci, lv] - W, 0) + 1)
        glob = pfetch.fetch_windows_twin(
            torch.as_tensor(tex), torch.as_tensor(row0[ci, lv] + oy,
                                                  dtype=torch.int32),
            torch.as_tensor(ox, dtype=torch.int32), W)
        loc = pfetch.fetch_windows_twin(
            torch.as_tensor(bp.tex[b]),
            torch.as_tensor(bp.row0[b][ci, lv] + oy, dtype=torch.int32),
            torch.as_tensor(ox, dtype=torch.int32), W)
        assert torch.equal(glob, loc)


def test_check_fetch_slab_on_the_twin(tiny):
    """kernel_check.check_fetch_slab (which chip_smoke.py and the CUDA
    tests run on the card) on CPU tensors: both sides take the twin, and
    the slab's windows equal the full pack's where a plane holds a whole
    window."""
    from hpmvs_tpu_torch import kernel_check
    ps, jo, scene, ctx = tiny
    c, _, s, v, _ = jscene.make_seed_patches(ps.model, scene, jo)
    mask = np.zeros((2, len(ps.model.cameras)), bool)
    mask[0, 1::2] = True
    mask[1, 1:] = True
    slabs = psub.place_block_pack(pmesh.make_mesh(["cpu"] * 2),
                                  psub.build_block_packs(ctx.imgs, mask))
    vt = torch.as_tensor(v)
    for slab in slabs:
        r = kernel_check.check_fetch_slab(
            ctx.cams, slab, ctx.imgs, vt,
            torch.as_tensor(c)[:, None].expand(vt.shape + (3,)),
            torch.as_tensor(s)[:, None].expand(vt.shape), 2, 12, reps=0)
        assert r["equal_twin"] and r["equal_full"], r
        assert 0 < r["compared"] <= r["live"] < r["n"]


def test_slab_gate_equals_replicated(tiny):
    """One sharded dispatch with per-shard slabs (each shard's slab the
    union of its lanes' cameras and their covis reach, as the engine stages
    it) equals the replicated dispatch bit for bit."""
    ps, jo, scene, ctx = tiny
    opt = dataclasses.replace(POptions(), **TINY)
    jpack = jdepth.build_depth_pack(np.asarray(scene.ctx.imgs.width),
                                    np.asarray(scene.ctx.imgs.height))
    pack = port_pack(jpack)
    c, n, s, v, _ = jscene.make_seed_patches(ps.model, scene, jo)
    m = _mesh()
    per = -(-len(c) // m.size)
    # half the lanes gated (widths in the scale window), half bare
    widths = np.where(np.arange(len(c)) % 2 == 0, 3.0 * s, -1.0)
    lanes_np = [tuple(a[i * per:(i + 1) * per] for a in
                      (c, n, s, v, c, widths.astype(np.float32)))
                for i in range(m.size)]
    ncam = len(ps.model.cameras)
    cv = np.asarray(scene.covis_np)
    adj = np.eye(ncam, dtype=bool)
    for i in range(ncam):
        adj[i, cv[i][cv[i] >= 0]] = True
    reach = adj @ adj
    mask = np.zeros((m.size, ncam), bool)
    for i, ln in enumerate(lanes_np):
        vv = ln[3][ln[3] >= 0]
        mask[i, vv] = True
    mask = mask @ reach
    slabs = psub.place_block_pack(
        m, psub.build_block_packs(ctx.imgs, mask))
    lanes = [None if len(ln[0]) == 0 else
             tuple(torch.as_tensor(np.asarray(a)) for a in ln)
             for ln in lanes_np]
    ra = pmesh.replicate(m, pack.depth)
    rb = pmesh.replicate(m, pack.depth)
    f_rep, _ = pmesh.sharded_optimize_and_gate(m, ctx, opt, pack, ncam)
    f_sub, _ = pmesh.sharded_optimize_and_gate(m, ctx, opt, pack, ncam,
                                               image_subsets=True)
    a = f_rep(lanes, ra)
    b = f_sub(lanes, rb, slabs=slabs)
    n_ok = 0
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is None:
            continue
        for t, u in zip(x, y):
            assert torch.equal(t, u)
        n_ok += int(x[4].sum())
    assert n_ok > 0
    for x, y in zip(ra, rb):
        assert torch.equal(x, y)


def _run(eng, steps=25):
    eng.seed()
    start = min(eng.queue) if eng.queue else 0
    for prio in range(start, start + steps):
        eng.process_priority_step(prio)
        if not eng.have_work():
            break
    return eng


class _FullSlabEngine(SpatialEngine):
    """Subsets engine whose slabs are forced to the full pack on every
    shard, running the same assignment policy and hysteresis as true
    subsets (tests/test_subsets.py:34-43)."""

    def _resident_view_mask(self):
        out = super()._resident_view_mask()
        out[:] = True
        return out


def test_subset_parity_with_full_slab_twin(tiny):
    ps = tiny[0]
    opt = dataclasses.replace(POptions(), **TINY)
    e0 = _run(_FullSlabEngine(ps.model, opt, images=ps.images, mesh=_mesh(),
                              image_subsets=True))
    e1 = _run(SpatialEngine(ps.model, opt, images=ps.images, mesh=_mesh(),
                            image_subsets=True))
    assert e1.stats["subset_rows_per_block"] > 0
    assert e1.stats["subset_rebuilds"] >= 1
    assert (e1.stats["subset_rows_per_block"]
            <= e0.stats["subset_rows_per_block"])
    assert e1.stats["slab_miss"] == 0 and e0.stats["slab_miss"] == 0
    assert e1.n_alive() == e0.n_alive() > 0
    np.testing.assert_array_equal(np.sort(e0.alive_arrays()[0], axis=0),
                                  np.sort(e1.alive_arrays()[0], axis=0))
    d1 = np.abs(e1.alive_arrays()[0][:, 2] - ps.plane_z)
    assert float(np.sqrt((d1 ** 2).mean())) < 0.05


def test_pending_views_force_slab_coverage(tiny):
    ps = tiny[0]
    opt = dataclasses.replace(POptions(), **TINY)
    eng = SpatialEngine(ps.model, opt, images=ps.images, mesh=_mesh(),
                        image_subsets=True)
    ncam = eng.scene.n_cameras
    # bounded-but-absurd: every octant fails the depth window
    eng._depth_bounds = (np.full(ncam, 1e9), np.full(ncam, 2e9))
    pend_seen = []
    orig = eng._ensure_subsets

    def spy():
        # the stat holds the latest dispatch's overrides: keep every one
        orig()
        pend_seen.append(eng.stats["subset_pending_overrides"])
    eng._ensure_subsets = spy
    _run(eng)
    assert eng.n_alive() > 0
    assert eng.stats["slab_miss"] == 0
    assert max(pend_seen) > 0 or eng.stats["subset_bound_overrides"] > 0


def test_assignment_conservative_for_resident_patches(tiny):
    ps = tiny[0]
    opt = dataclasses.replace(POptions(), **TINY)
    eng = _run(SpatialEngine(ps.model, opt, images=ps.images, mesh=_mesh()))
    mask = psub.assign_images_to_blocks(
        eng.scene.ctx.cams, eng.scene.width_np[:, 0],
        eng.scene.height_np[:, 0], np.asarray(eng.tree.center),
        eng.tree.width, eng.n_blocks, eng.block_level)
    pids = np.nonzero(eng.patches.alive[:eng.patches.n])[0]
    assert len(pids) > 0
    blk = eng.block_of_points(eng.patches.center[pids])
    views = eng.patches.views[pids]
    for k in range(views.shape[1]):
        vk = views[:, k]
        ok = vk >= 0
        assert mask[blk[ok], vk[ok]].all()
