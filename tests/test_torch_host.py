"""Host layer of the port vs the JAX package, exactly: Options, the scene
generators, NVM and PLY I/O, image packing, covisibility, seeds, octree
queries and triangulation."""

import dataclasses

import numpy as np
import pytest
import torch

from hpmvs_tpu import testing as jtesting
from hpmvs_tpu.config import Options as JOptions
from hpmvs_tpu.core import octree as joctree
from hpmvs_tpu.core import scene as jscene
from hpmvs_tpu.geom import triangulation as jtri
from hpmvs_tpu.image import pyramid as jpyr
from hpmvs_tpu.io import nvm as jnvm
from hpmvs_tpu.io import ply as jply

from hpmvs_tpu_torch import testing as ptesting
from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.core import octree as poctree
from hpmvs_tpu_torch.core import scene as pscene
from hpmvs_tpu_torch.geom import triangulation as ptri
from hpmvs_tpu_torch.image import pyramid as ppyr
from hpmvs_tpu_torch.io import nvm as pnvm
from hpmvs_tpu_torch.io import ply as pply

from torch_parity import plane_options

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    return (jtesting.make_plane_scene(n_cams=4, imgsize=128, n_points=30,
                                      seed=2),
            ptesting.make_plane_scene(n_cams=4, imgsize=128, n_points=30,
                                      seed=2))


def test_options_fields_and_defaults():
    jf = {f.name: f.default for f in dataclasses.fields(JOptions)}
    pf = {f.name: f.default for f in dataclasses.fields(POptions)}
    assert list(jf) == list(pf)
    differ = {k for k in jf if jf[k] != pf[k]}
    assert differ == set()
    assert pf["WAVE_DEPTH"] == 4 and pf["WAVE_LOOKAHEAD"] is True
    assert POptions().max_prio == JOptions().max_prio
    assert POptions().n_levels == JOptions().n_levels


def _models_equal(a, b):
    for f in ("points_xyz", "points_rgb", "meas_start", "meas_img",
              "meas_feat", "meas_xy"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert len(a.cameras) == len(b.cameras)
    for ca, cb in zip(a.cameras, b.cameras):
        assert (ca.filename, ca.f, ca.r) == (cb.filename, cb.f, cb.r)
        np.testing.assert_array_equal(ca.rq, cb.rq)
        np.testing.assert_array_equal(ca.c, cb.c)


@pytest.mark.parametrize("kind", ["plane", "facade"])
def test_scene_generators_identical(kind):
    if kind == "plane":
        a = jtesting.make_plane_scene(n_cams=3, imgsize=96, n_points=20, seed=5)
        b = ptesting.make_plane_scene(n_cams=3, imgsize=96, n_points=20, seed=5)
    else:
        a = jtesting.make_facade_scene(n_cams=4, imgsize=96, n_points=20,
                                       seed=1)
        b = ptesting.make_facade_scene(n_cams=4, imgsize=96, n_points=20,
                                       seed=1)
        assert a.slope == b.slope and a.k1s == b.k1s
        pts = np.random.default_rng(0).normal(size=(50, 3))
        np.testing.assert_array_equal(
            jtesting.facade_surface_dist(pts, a.slope),
            ptesting.facade_surface_dist(pts, b.slope))
    _models_equal(a.model, b.model)
    for ia, ib in zip(a.images, b.images):
        np.testing.assert_array_equal(ia, ib)


def test_nvm_round_trip_both_ways(scenes, tmp_path):
    js, ps = scenes
    pnvm.save_nvm(str(tmp_path / "p.nvm"), [ps.model])
    jnvm.save_nvm(str(tmp_path / "j.nvm"), [js.model])
    assert (tmp_path / "p.nvm").read_text() == (tmp_path / "j.nvm").read_text()
    a = jnvm.read_nvm(str(tmp_path / "p.nvm"))[0]
    b = pnvm.read_nvm(str(tmp_path / "p.nvm"))[0]
    _models_equal(a, b)
    np.testing.assert_array_equal(b.meas_xy, js.model.meas_xy)


def _same_ply(tmp_path, args, visibility=True, **kw):
    """Both packages' writers on the same arrays, binary and ASCII: the
    same bytes, and the port's file of each format read back to the input's
    centres and, with visibility, each row's view count."""
    for binary in (True, False):
        jply.write_ext_ply(str(tmp_path / "j.ply"), *args, binary=binary,
                           visibility=visibility, **kw)
        pply.write_ext_ply(str(tmp_path / "p.ply"), *args, binary=binary,
                           visibility=visibility, **kw)
        assert (tmp_path / "j.ply").read_bytes() == \
            (tmp_path / "p.ply").read_bytes()
        got = pply.read_ext_ply(str(tmp_path / "p.ply"))
        np.testing.assert_array_equal(got["xyz"], args[0])
        if visibility and len(args[0]):
            assert [len(v) for v in got["visibility"]] == list(args[5])


def test_ply_writer_identical(tmp_path):
    rng = np.random.default_rng(1)
    n = 17
    args = (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(0, 255, (n, 3)), rng.uniform(0, 1, n).astype(np.float32),
            rng.integers(-1, 4, (n, 4)).astype(np.int32),
            rng.integers(0, 4, n))
    _same_ply(tmp_path, args)


def _cloud(rng, n, k=6, scale=1.0):
    """n patches with k view slots: every row's nviews in 0..k, the
    views past it -1."""
    nv = rng.integers(0, k + 1, n)
    nv[:2] = (0, k)[:n]
    views = np.where(np.arange(k) < nv[:, None],
                     rng.integers(0, 11, (n, k)), -1).astype(np.int32)
    return [(rng.normal(size=(n, 3)) * scale).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(0, 255, (n, 3)),
            rng.uniform(0, 1, n).astype(np.float32), views, nv]


def _empty(rng):
    return [np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
            np.zeros((0, 3)), np.zeros(0, np.float32),
            np.zeros((0, 6), np.int32), np.zeros(0, np.int64)]


def _colours_outside(rng):
    a = _cloud(rng, 40)
    a[2] = rng.uniform(-400, 700, (40, 3))
    a[2][:4] = [[-0.5, 255.5, 1e9], [-1e9, 0.0, 255.0], [254.99, 0.4, 256],
                [-np.inf, np.inf, 128.7]]
    return a


def _colours_fortran(rng):
    a = _cloud(rng, 20)
    a[2] = rng.uniform(0, 255, (3, 20)).T
    assert not a[2].flags.c_contiguous
    return a


def _nonfinite(rng):
    a = _cloud(rng, 30, scale=1e3)
    a[0][:5] = [[np.nan, np.inf, -np.inf], [-0.0, 0.0, -np.nan],
                [1e-5, 1e-4, 9.999e-5], [1e15, 1e16, -1e16],
                [1.4e-45, 3.4028235e38, -1.17549435e-38]]
    a[1][:2] = [[-0.0, np.nan, 1.0], [123456789.0, -1.0, 0.1]]
    a[3][:3] = [np.nan, -0.0, 1e-30]
    return a


@pytest.mark.parametrize("case,kw", [
    ("empty", {}),
    ("empty", dict(visibility=False)),
    ("k0_and_kK", {}),
    ("k0_and_kK", dict(normal=False, scale=False)),
    ("colours_outside", {}),
    ("colours_fortran", {}),
    ("nonfinite_centres", {}),
    ("block_boundary", {}),
], ids=["empty", "empty_novis", "k0_and_kK", "k0_and_kK_xyz_rgb_vis",
        "colours_outside", "colours_fortran", "nonfinite_centres",
        "block_boundary"])
def test_ply_writer_identical_cases(tmp_path, case, kw):
    """The edges of the port's native ASCII formatter and vectorised binary
    body against the JAX writer's per-patch loops: no rows, rows with no
    view and with all K, float64 colours outside 0..255 and in Fortran
    order, centres with nan, inf and -0.0, and a cloud crossing the
    formatter's block of rows."""
    rng = np.random.default_rng(7)
    args = {"empty": _empty, "k0_and_kK": lambda r: _cloud(r, 25),
            "colours_outside": _colours_outside,
            "colours_fortran": _colours_fortran,
            "nonfinite_centres": _nonfinite,
            "block_boundary": lambda r: _cloud(r, pply.BLOCK + 4464,
                                               scale=30.0)}[case](rng)
    if case == "block_boundary":
        assert len(args[0]) > pply.BLOCK
    _same_ply(tmp_path, args, **kw)


def test_pack_pyramids_identical(scenes):
    js, ps = scenes
    jp = jpyr.pack_pyramids([jpyr.build_pyramid(im, 4) for im in js.images])
    pp = ppyr.pack_pyramids([ppyr.build_pyramid(im, 4) for im in ps.images])
    assert pp._fields == ("tex", "row0", "width", "height")   # no texb
    for f in pp._fields:
        np.testing.assert_array_equal(getattr(pp, f), getattr(jp, f))
    # pixel values are integers at every level: float32 and bf16 windows
    # are both exact
    assert np.array_equal(pp.tex, np.round(pp.tex))
    img = js.images[0]
    for k1 in (0.2, -0.15):
        np.testing.assert_array_equal(jpyr.undistort_vsfm(img, 150.0, k1),
                                      ppyr.undistort_vsfm(img, 150.0, k1))


def test_covisibility_and_seeds_identical(scenes):
    js, ps = scenes
    jopt = plane_options(JOptions)
    popt = plane_options(POptions)
    np.testing.assert_array_equal(jscene.extract_covisibility(js.model, jopt),
                                  pscene.extract_covisibility(ps.model, popt))
    jsc = jscene.build_scene(js.model, jopt, images=js.images)
    psc = pscene.build_scene(ps.model, popt, images=ps.images, device="cpu")
    np.testing.assert_array_equal(np.asarray(jsc.ctx.imgs.tex),
                                  psc.ctx.imgs.tex.numpy())
    np.testing.assert_array_equal(jsc.covis_np, psc.covis_np)
    np.testing.assert_array_equal(jsc.ncovis_np, psc.ncovis_np)
    for f in jsc.ctx.cams._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jsc.ctx.cams, f)),
                                      getattr(psc.ctx.cams, f).numpy())
    jseeds = jscene.make_seed_patches(js.model, jsc, jopt)
    pseeds = pscene.make_seed_patches(ps.model, psc, popt)
    assert len(pseeds[0]) > 0
    for a, b in zip(jseeds, pseeds):
        np.testing.assert_array_equal(a, b)
    jc, jr = jscene.scene_center_radius(jsc.ctx.cams)
    pc, pr = pscene.scene_center_radius(psc.ctx.cams)
    np.testing.assert_array_equal(jc, pc)
    assert jr == pr


def test_octree_queries_identical():
    rng = np.random.default_rng(7)
    center, width = np.array([0.1, -0.2, 0.3]), 3.0
    jt = joctree.LinearOctree(center, width, max_level=12)
    pt = poctree.LinearOctree(center, width, max_level=12)
    pts = (rng.uniform(-1.4, 1.4, (400, 3)) + center).astype(np.float32)
    lv = rng.integers(2, 9, 400)
    for tree in (jt, pt):
        keys = np.zeros(len(pts), np.uint64)
        for L in np.unique(lv):
            keys[lv == L] = tree.key_at(pts[lv == L], int(L))
        pair = np.unique(np.stack([lv.astype(np.uint64), keys]), axis=1)
        tree.alloc_cells(pair[0].astype(np.int8), pair[1])
        tree.free_cells(np.arange(0, tree.n, 7))
    q = (rng.uniform(-1.6, 1.6, (5000, 3)) + center).astype(np.float32)
    np.testing.assert_array_equal(jt.key_at(q, 9), pt.key_at(q, 9))
    np.testing.assert_array_equal(jt.contains(q), pt.contains(q))
    np.testing.assert_array_equal(jt.structure_level(q),
                                  pt.structure_level(q))
    np.testing.assert_array_equal(jt.containing_cell(q),
                                  pt.containing_cell(q))
    cid = np.arange(jt.n)
    np.testing.assert_array_equal(jt.lookup(jt.level[cid].astype(np.int64),
                                            jt.key[cid]),
                                  pt.lookup(pt.level[cid].astype(np.int64),
                                            pt.key[cid]))
    for a, b in zip(jt.cell_center_width(cid), pt.cell_center_width(cid)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jt.histogram(), pt.histogram())
    np.testing.assert_array_equal(jt.level_for_width(np.array([0.1, 0.01])),
                                  pt.level_for_width(np.array([0.1, 0.01])))
    jt.reroot(np.array([1.0, -1.0, 1.0]))
    pt.reroot(np.array([1.0, -1.0, 1.0]))
    np.testing.assert_array_equal(jt.structure_level(q),
                                  pt.structure_level(q))


def test_triangulation_identical():
    rng = np.random.default_rng(3)
    o = rng.normal(size=(6, 3))
    d = rng.normal(size=(6, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_array_equal(jtri.triangulate_midpoint(o, d),
                                  ptri.triangulate_midpoint(o, d))
