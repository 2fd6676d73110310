"""The port's bundle adjustment (hpmvs_tpu_torch/parallel/ba.py) against
hpmvs_tpu/parallel/ba.py on the CPU.

- Residuals and Jacobians (torch.func.jacfwd under vmap) against jax.jacfwd
  on 1,000 measurements, 100 of them at w = 0 exactly: within 1e-5 of the
  largest entry (measured 1.5e-7).
- The problem builders array-equal.
- ba_solve on tests/test_ba.py's problem (6 cameras x 256 px, 120 points,
  perturbed). With two anchor cameras (the 7-DoF gauge pinned) the RMS
  history agrees within 1% (measured 1e-6 relative) and the cameras and
  points within 1e-5 (measured 3.8e-7 and 2.4e-7). With one anchor, the
  default, the global scale stays free: the order of the float32 sums
  moves the two CG solutions apart along it (camera translations by
  ~0.03), so only gauge-free quantities are held: the first RMS (within
  1e-6), the convergence (both below 1e-4 px), the points' planarity
  (tests/test_ba.py's 0.005) and the camera rotations (within 1e-4,
  measured 2.5e-7).
- apply_cameras_to_model and apply_to_model within 1e-12.
- apply_dense_ba on a JAX engine and a port engine loaded from one
  checkpoint, with the same perturbation: RMS falls > 5x, the camera
  centres recover >= 3x on both, the RMS histories agree within 1% above
  1e-3 px (both below 1e-4 px after: float32 noise), and the replayed
  depth buffers hold a depth in the same cells, equal within 1e-6 relative
  (measured 1.4e-7: the two solves' cameras differ by float32 rounding)
  and bit-equal in >= 90% of all cells (measured 95.3%).
- A periodic ba_dense_every run with a mid-run camera drift (port only,
  tests/test_ba.py:95-150), on tests/test_export_checkpoint.py's plane (5
  cameras x 192 px, 60 points) for time. Its seeds sit at octree level 4
  (prio 40), so the drift at prio 35 comes after the seeds were stamped
  under the true cameras and, with a pass every level (ba_dense_every=1),
  the prio-39 pass solves against those stamps before level 4 creates
  patches under the drifted cameras. tests/test_ba.py's larger plane seeds
  at level 5 and passes every second level (ba_dense_every=2, the same
  drift at 35; the smoke's plane_ba_dense_every phase runs it on the card).
- Over a mesh (8 CPU shards against conftest's 8 virtual devices):
  shard_problem bitwise; ba_solve_sharded with two anchors within 1e-5 of
  the JAX sharded solve's cameras and points and 1% of its history, with
  one anchor within tests/test_ba.py:62-79's bars of the port's own
  single-device solve; apply_dense_ba's mesh branch on a 4-shard engine
  recovers the cameras and replays the same z-buffer on every replica as
  one device does from the same solution.
"""

import jax
import numpy as np
import pytest
import torch

from hpmvs_tpu.config import Options as JOptions
from hpmvs_tpu.parallel import ba as jba
from hpmvs_tpu.parallel import mesh as jmesh
from hpmvs_tpu.runtime import checkpoint as jckpt
from hpmvs_tpu.runtime.wavefront import Engine as JEngine
from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.parallel import ba as pba
from hpmvs_tpu_torch.parallel import mesh as pmesh
from hpmvs_tpu_torch.runtime import checkpoint as pckpt
from hpmvs_tpu_torch.runtime import pipeline as ppipe
from hpmvs_tpu_torch.runtime.wavefront import Engine as PEngine
from hpmvs_tpu_torch.testing import perturb_model

from torch_parity import ckpt_options

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ba_setup():
    """tests/test_ba.py:28-34's problem."""
    scene = make_plane_scene(n_cams=6, imgsize=256, n_points=120, seed=17)
    noisy = perturb_model(scene.model, np.random.default_rng(3))
    return (scene, noisy, jba.build_problem(noisy),
            pba.build_problem(noisy, device="cpu"))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, rel):
    got, ref = _np(got), _np(ref)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=rel,
                               atol=rel * float(np.abs(ref).max()))


def test_residuals_and_jacobians_match_jacfwd(ba_setup):
    _, _, jp, _ = ba_setup
    rng = np.random.default_rng(0)
    M = 1000
    idx = rng.integers(0, len(jp.m_cam), M)
    cc, pp = np.asarray(jp.m_cam)[idx], np.asarray(jp.m_pt)[idx]
    cam = rng.normal(0, 0.01, (M, 6)).astype(np.float32)
    cam[:100, :3] = 0.0                               # w = 0 exactly
    args = (cam, np.asarray(jp.pts0)[pp], np.asarray(jp.cam_K)[cc],
            np.asarray(jp.cam_R0)[cc], np.asarray(jp.cam_t0)[cc],
            np.asarray(jp.m_uv)[idx])
    jr = jax.vmap(jba._residual)(*args)
    jJc = jax.vmap(jax.jacfwd(jba._residual, argnums=0))(*args)
    jJp = jax.vmap(jax.jacfwd(jba._residual, argnums=1))(*args)
    targs = tuple(torch.as_tensor(a) for a in args)
    (pJc, pJp), pr = pba.jac_fn(*targs)
    _close(pba.res_fn(*targs), jr, 1e-5)
    _close(pr, jr, 1e-5)
    _close(pJc, jJc, 1e-5)
    _close(pJp, jJp, 1e-5)


def _dense_inputs(model, n=300, seed=4):
    """Seeded patch centres near the plane's points with view lists of 2-6
    cameras, -1 padded to 8 slots."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, model.n_points, n)
    centers = model.points_xyz[idx] + rng.normal(0, 0.01, (n, 3))
    views = np.full((n, 8), -1, np.int32)
    ncam = len(model.cameras)
    for i in range(n):
        k = rng.integers(2, 7)
        views[i, :k] = rng.permutation(ncam)[:k]
    return centers, views


@pytest.mark.parametrize("builder", ["sparse", "dense", "stamp",
                                     "dense_obs"])
def test_builders_equal(ba_setup, builder):
    scene, noisy, _, _ = ba_setup
    centers, views = _dense_inputs(scene.model)
    if builder == "stamp":
        got = pba.stamp_obs(noisy, centers, views)
        ref = jba.stamp_obs(noisy, centers, views)
        assert np.isfinite(got).any()
        np.testing.assert_array_equal(got, ref)
        return
    if builder == "sparse":
        ref = jba.build_problem(noisy, max_points=100)
        got = pba.build_problem(noisy, max_points=100, device="cpu")
    elif builder == "dense":
        ref = jba.build_dense_problem(noisy, centers, views)
        got = pba.build_dense_problem(noisy, centers, views, device="cpu")
    else:
        uv = jba.stamp_obs(scene.model, centers, views)
        uv[::7, 1] = np.nan                          # invalid slots drop
        ref = jba.build_dense_problem_obs(noisy, centers, views, uv)
        got = pba.build_dense_problem_obs(noisy, centers, views, uv,
                                          device="cpu")
    assert len(got.m_cam) > 0
    for f in ref._fields:
        r, g = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert g.dtype == r.dtype, f
        np.testing.assert_array_equal(g, r, err_msg=f)


def _solve_both(ba_setup, **kw):
    _, noisy, jp, pp = ba_setup
    n = (len(noisy.cameras), noisy.n_points)
    j = [np.asarray(a) for a in jba.ba_solve(jp, *n, iters=8, cg_iters=40,
                                             **kw)]
    p = [a.numpy() for a in pba.ba_solve(pp, *n, iters=8, cg_iters=40,
                                         device="cpu", **kw)]
    return j, p


def test_ba_solve_matches_jax_two_anchors(ba_setup):
    (jc, jpt, jh), (pc, ppt, ph) = _solve_both(ba_setup, fix_count=2)
    np.testing.assert_allclose(ph, jh, rtol=1e-2)
    np.testing.assert_allclose(pc, jc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ppt, jpt, rtol=0, atol=1e-5)
    assert ph[-1] < 0.5 * ph[0]


def _plane_rms(p):
    c = p - p.mean(0)
    return np.linalg.svd(c, compute_uv=False)[-1] / np.sqrt(len(p))


def test_ba_solve_one_anchor(ba_setup):
    """One anchor leaves the global scale free: the two solutions differ
    along it (translations), so only gauge-free quantities are held."""
    (jc, jpt, jh), (pc, ppt, ph) = _solve_both(ba_setup)
    assert ph[0] == pytest.approx(float(jh[0]), rel=1e-6)
    assert ph[0] > 1.0
    for h, pts in ((jh, jpt), (ph, ppt)):
        assert h[-1] < 1e-4
        assert _plane_rms(pts) < 0.005          # tests/test_ba.py's bar
    np.testing.assert_allclose(pc[:, :3], jc[:, :3], rtol=0, atol=1e-4)


def test_apply_to_models(ba_setup):
    _, noisy, _, _ = ba_setup
    rng = np.random.default_rng(9)
    cam = rng.normal(0, 0.01, (len(noisy.cameras), 6))
    cam[0] = 0.0
    pts = noisy.points_xyz + rng.normal(0, 0.01, noisy.points_xyz.shape)
    for got, ref in ((pba.apply_cameras_to_model(noisy, cam),
                      jba.apply_cameras_to_model(noisy, cam)),
                     (pba.apply_to_model(noisy, cam, pts),
                      jba.apply_to_model(noisy, cam, pts))):
        for a, b in zip(got.cameras, ref.cameras):
            np.testing.assert_allclose(a.rq, b.rq, rtol=0, atol=1e-12)
            np.testing.assert_allclose(a.c, b.c, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got.points_xyz, ref.points_xyz, rtol=0,
                                   atol=1e-12)
    np.testing.assert_array_equal(
        pba.apply_cameras_to_model(noisy, cam).points_xyz, noisy.points_xyz)


def _centers(model):
    return np.asarray([c.c for c in model.cameras])


@pytest.fixture(scope="module")
def periodic(tmp_path_factory):
    """The port's pipeline with ba_dense_every=1 and the cameras drifted at
    prio 35 through snapshot_hook, as a streaming SfM update would."""
    scene = make_plane_scene(n_cams=5, imgsize=192, n_points=60, seed=8)
    out = tmp_path_factory.mktemp("periodic")
    opt = ckpt_options(POptions, OUTFOLDER=str(out))
    state = {"injected": False, "pre_err": None}
    true_c = _centers(scene.model)

    def inject_drift(engine, prio):
        if prio != 35 or state["injected"]:
            return
        pert = perturb_model(engine.model, np.random.default_rng(21),
                             rot=0.002, trans=0.005, pts=0.0, keep=2)
        pert.points_xyz = engine.model.points_xyz
        engine.set_cameras(pert)
        state["injected"] = True
        state["pre_err"] = np.linalg.norm(_centers(pert) - true_c, axis=1)

    eng = ppipe.run(scene.model, opt, images=scene.images, ba_dense_every=1,
                    snapshot_hook=inject_drift, device="cpu")
    return scene, eng, state, out


def test_periodic_dense_ba_recovers_midrun_drift(periodic):
    scene, eng, state, _ = periodic
    assert state["injected"], "drift hook never fired"
    assert eng.n_alive() > 200
    post = np.linalg.norm(_centers(eng.model) - _centers(scene.model),
                          axis=1)
    assert np.median(post[2:]) < np.median(state["pre_err"][2:]) / 2.0, (
        state["pre_err"], post)
    z = eng.alive_arrays()[0][:, 2] - scene.plane_z
    assert float(np.sqrt((z ** 2).mean())) < 0.02


def test_apply_dense_ba_on_both_engines(periodic):
    """One checkpoint of the periodic run's final state loaded into a JAX
    engine and a port engine (both on that run's refined cameras); the
    same perturbation of every camera but the two anchors; each package
    solves against the observations under the unperturbed cameras."""
    scene, eng, _, out = periodic
    path = str(out / "ba.npz")
    pckpt.save_checkpoint(eng, path)
    model = eng.model
    je = JEngine(model, ckpt_options(JOptions), images=scene.images)
    pe = PEngine(model, ckpt_options(POptions), images=scene.images,
                 device="cpu")
    jckpt.load_checkpoint(je, path)
    pckpt.load_checkpoint(pe, path, device="cpu")
    pert = perturb_model(model, np.random.default_rng(5), rot=0.004,
                         trans=0.01, pts=0.0, keep=2)
    pre = np.linalg.norm(_centers(pert) - _centers(model), axis=1)
    p = pe.patches
    pids = np.nonzero(p.alive[:p.n])[0]
    c, v = p.center[pids], p.views[pids]
    jtrue = jba.build_dense_problem(model, c, v)
    jprob = jba.build_dense_problem(pert, c, v)._replace(m_uv=jtrue.m_uv)
    ptrue = pba.build_dense_problem(model, c, v, device="cpu")
    pprob = pba.build_dense_problem(pert, c, v, device="cpu")._replace(
        m_uv=ptrue.m_uv)
    je.model = pert
    pe.model = pert
    jh = np.asarray(jba.apply_dense_ba(je, problem=jprob))
    ph = pba.apply_dense_ba(pe, problem=pprob, device="cpu")
    for e, h in ((je, jh), (pe, ph)):
        assert h[-1] < h[0] / 5.0, h
        post = np.linalg.norm(_centers(e.model) - _centers(model), axis=1)
        assert np.median(post[2:]) < np.median(pre[2:]) / 3.0, (pre, post)
    # above 1e-3 px within 1%; below it both sit at float32 noise
    big = jh > 1e-3
    assert big[:2].all()
    np.testing.assert_allclose(ph[big], jh[big], rtol=1e-2)
    assert (ph[~big] < 1e-4).all()
    jd, pd = np.asarray(je.pack.depth), pe.pack.depth.numpy()
    assert (pd < 999.0).sum() > 1000
    # the same cells hold a depth; their depths differ by an ulp or two,
    # the two solves' cameras by float32 rounding
    occ = jd < 999.0
    np.testing.assert_array_equal(pd < 999.0, occ)
    np.testing.assert_allclose(pd[occ], jd[occ], rtol=1e-6)
    assert (jd == pd).mean() >= 0.9, (jd != pd).sum()


@pytest.mark.parametrize("n", [3, 8])
def test_shard_problem_equals_jax(ba_setup, n):
    """The point-grouped, padded measurement table bitwise."""
    _, _, jp, pp = ba_setup
    js, ps_ = jba.shard_problem(jp, n), pba.shard_problem(pp, n)
    for f in pba.BAProblem._fields:
        np.testing.assert_array_equal(_np(getattr(ps_, f)),
                                      np.asarray(getattr(js, f)), err_msg=f)
    # no point straddles two shards
    m_pt, m_w = _np(ps_.m_pt).reshape(n, -1), _np(ps_.m_w).reshape(n, -1)
    owners = [set(m_pt[s][m_w[s] > 0].tolist()) for s in range(n)]
    for a in range(n):
        for b in range(a + 1, n):
            assert not owners[a] & owners[b]


def _sharded_both(ba_setup, **kw):
    _, noisy, jp, pp = ba_setup
    n = (len(noisy.cameras), noisy.n_points)
    j = [np.asarray(a) for a in jba.ba_solve_sharded(
        jmesh.make_mesh(8, shape=(2, 4)), jba.shard_problem(jp, 8), *n,
        iters=4, cg_iters=30, **kw)]
    pm = pmesh.make_mesh(["cpu"] * 8, shape=(2, 4))
    p = [a.numpy() for a in pba.ba_solve_sharded(
        pm, pba.shard_problem(pp, 8), *n, iters=4, cg_iters=30, **kw)]
    s = [a.numpy() for a in pba.ba_solve(pp, *n, iters=4, cg_iters=30,
                                         device="cpu", **kw)]
    return j, p, s


def test_ba_solve_sharded_against_jax(ba_setup):
    """8 shards, tests/test_ba.py:62-79. With two anchors (the gauge
    pinned) the port's sharded solve holds the JAX sharded solve's cameras
    within 1e-5 and its history within 1% (both length iters: no final
    RMS); with one anchor, the test's own bars against the port's
    single-device solve: first RMS within 1e-3 relative, cameras within
    5e-3, the RMS falling."""
    (jc, jpt, jh), (pc, ppt, ph), _ = _sharded_both(ba_setup, fix_count=2)
    assert ph.shape == jh.shape == (4,)
    np.testing.assert_allclose(ph, jh, rtol=1e-2)
    np.testing.assert_allclose(pc, jc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ppt, jpt, rtol=0, atol=1e-5)
    _, (pc, _, ph), (sc, _, sh) = _sharded_both(ba_setup)
    np.testing.assert_allclose(ph[0], sh[0], rtol=1e-3)
    assert ph[-1] < ph[0]
    np.testing.assert_allclose(pc, sc, rtol=0, atol=5e-3)


def test_apply_dense_ba_over_a_mesh(periodic):
    """apply_dense_ba's mesh branch (the one periodic_dense_ba reaches):
    the periodic run's final state loaded into a 4-shard mesh engine,
    every camera but the two anchors perturbed; the sharded solve (history
    of `iters` entries, as the JAX sharded solve) recovers the cameras,
    and the replayed z-buffer is the same on every shard's replica and
    equal (bitwise) to the single-device engine's replay of the same
    solution's cameras and centres."""
    scene, eng, _, out = periodic
    path = str(out / "ba_mesh.npz")
    pckpt.save_checkpoint(eng, path)
    model = eng.model
    pm = pmesh.make_mesh(["cpu"] * 4)
    me = PEngine(model, ckpt_options(POptions), images=scene.images,
                 mesh=pm)
    pckpt.load_checkpoint(me, path, device="cpu")
    pert = perturb_model(model, np.random.default_rng(5), rot=0.004,
                         trans=0.01, pts=0.0, keep=2)
    p = me.patches
    pids = np.nonzero(p.alive[:p.n])[0]
    c, v = p.center[pids], p.views[pids]
    true = pba.build_dense_problem(model, c, v, device="cpu")
    prob = pba.build_dense_problem(pert, c, v, device="cpu")._replace(
        m_uv=true.m_uv)
    me.model = pert
    h = pba.apply_dense_ba(me, iters=8, problem=prob)
    assert len(h) == 8 and h[-1] < h[0] / 5.0, h
    pre = np.linalg.norm(_centers(pert) - _centers(model), axis=1)
    post = np.linalg.norm(_centers(me.model) - _centers(model), axis=1)
    assert np.median(post[2:]) < np.median(pre[2:]) / 3.0
    reps = me._replicas()
    assert len(reps) == 4 and reps[0] is me.pack.depth
    for r in reps[1:]:
        assert torch.equal(r, me.pack.depth)
    # one device replays the same cameras and centres into the same buffer
    se = PEngine(me.model, ckpt_options(POptions), images=scene.images,
                 device="cpu")
    pckpt.load_checkpoint(se, path, device="cpu")
    se.patches.center[pids] = me.patches.center[pids]
    se.pack.depth.fill_(1000.0)
    se._pend = []
    se._set_depths(pids)
    se._flush_depths()
    assert torch.equal(se.pack.depth, me.pack.depth)
