"""The per-patch optimizer path (USE_BATCHED_STAGES=False, FAST_SETREF=False,
USE_WINDOWS=False, USE_PALLAS_GN=False) of the port against the JAX
package's single-patch functions under jax.vmap, on the small plane of
tests/torch_parity.py at B=128 (numpy-seeded jitter).

Tolerances and why:
- Window fetch: bit-exact (a copy).
- Textures and incc values: the port samples 4 taps per texel, the JAX
  package sums hat weights over all W columns, and XLA contracts the
  projections into fused multiply-adds while torch does not, so grid
  coordinates differ by an ulp: incc within 1e-4 where both sampled, the
  full-image textures (whose coordinates are ~100x larger) within 2e-4.
- Stage decisions (view lists, ok flags): a keep/drop threshold can flip on
  those ulps, so the view lists agree on at least 98% of the patches (and
  `ok` on at least 98%).
- The plain refiner (_optimize_patch), both branches, and optimize_batch in
  each configuration: centre within 2e-3, f within 5e-3 on at least 95% of
  the patches both accept, the normal within 5e-3 on at least 90% (85% with
  the GN kernel's FD mode). The refiners' 3x3 systems are ill-conditioned,
  condition numbers near 1e6, so the same ulps send a few patches down
  another accept/reject path; the FD mode amplifies them most (see
  tests/test_torch_gn_fd.py).
- jacfwd: the port's hat sampler takes JAX's derivatives at the kinks
  exactly (integer and clipped coordinates), to 1e-6.
- The engine with FAST_SETREF=False, LM_EXACT_J=False against the JAX
  engine with its GN kernel in interpret mode (the path it takes on a TPU;
  on the CPU it would refine with its plain FD refiner, another algorithm):
  alive within 10%, the fraction of the cloud within 0.02 of the plane
  within 0.05 of the JAX engine's. On this small coarse plane the FD mode
  leaves both clouds less accurate than the exact mode does.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpmvs_tpu.config import Options as JOptions
from hpmvs_tpu.core import scene as jscene
from hpmvs_tpu.ops import optimizer as jopt
from hpmvs_tpu.ops import pallas_gn
from hpmvs_tpu.ops import windows as jwin
from hpmvs_tpu.runtime import pipeline as jpipe
from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch import kernels
from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.ops import optimizer as popt
from hpmvs_tpu_torch.ops import windows as pwin
from hpmvs_tpu_torch.runtime import pipeline as ppipe

from torch_parity import plane_options, port_ctx, t, tiled_batch

torch.set_num_threads(1)

# an OUTFOLDER no other test uses: a distinct static Options value, so the
# patched JAX traces below never meet a cached executable of another test
_OUT = "/tmp/hpmvs_torch_parity_per_patch"


def _opts(**kw):
    return (plane_options(JOptions, OUTFOLDER=_OUT, **kw),
            plane_options(POptions, OUTFOLDER=_OUT, **kw))


def _pws(ws):
    return pwin.WinState(win=t(ws.win), ox=t(ws.ox), oy=t(ws.oy),
                         level=t(ws.level))


def _vm(fn, *static):
    return jax.vmap(functools.partial(fn, *static))


@pytest.fixture(scope="module")
def S():
    jo, po = _opts()
    ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2)
    sc = jscene.build_scene(ps.model, jo, images=ps.images)
    c, n, s, v = tiled_batch(jscene.make_seed_patches(ps.model, sc, jo),
                             jitter=0.003)
    n = n / np.linalg.norm(n, axis=1, keepdims=True)
    jc, jn, js = jnp.asarray(c), jnp.asarray(n), jnp.asarray(s)
    views, _ = _vm(jopt._add_images, sc.ctx, jo)(jc, jn, js, jnp.asarray(v))
    ws = _vm(jopt._fetch_ws, sc.ctx, jo)(views, jc, js)
    return dict(jo=jo, po=po, ps=ps, sc=sc, ctx=port_ctx(sc.ctx), c=c, n=n,
                s=s, v=v, views=np.asarray(views), ws=ws,
                j=(jc, jn, js, views), p=(t(c), t(n), t(s), t(views)))


def _same_rows(a, b):
    return (np.asarray(a) == np.asarray(b)).all(axis=1)


def test_fetch_windows_exact(S):
    jc, jn, js, jv = S["j"]
    pc, pn, ps_, pv = S["p"]
    kernels.reset_counts()
    pws = popt._fetch_ws(S["ctx"], S["po"], pv, pc, ps_)
    assert kernels.STATS["fetch"].twin_calls == 1
    for f in ("win", "ox", "oy", "level"):
        np.testing.assert_array_equal(getattr(pws, f).numpy(),
                                      np.asarray(getattr(S["ws"], f)))


@pytest.mark.parametrize("ref_slot,robust", [(0, False), (2, True)])
def test_set_inccs(S, ref_slot, robust):
    jc, jn, js, jv = S["j"]
    pc, pn, ps_, pv = S["p"]
    jval = np.asarray(jax.vmap(lambda *a: jopt._set_inccs(
        S["sc"].ctx, S["jo"], a[3], a[0], a[1], a[2], ref_slot, robust,
        a[4]))(jc, jn, js, jv, S["ws"]))
    pval = popt._set_inccs(S["ctx"], S["po"], pv, pc, pn, ps_, ref_slot,
                           robust, _pws(S["ws"])).numpy()
    sampled = (jval < 2.0) & (pval < 2.0)
    assert sampled.sum() > 200
    assert ((jval < 2.0) == (pval < 2.0)).mean() >= 0.99
    np.testing.assert_allclose(pval[sampled], jval[sampled], atol=1e-4)


def test_sample_views_without_windows(S):
    """The full-image sampling path (USE_WINDOWS=False) of _sample_views."""
    jc, jn, js, jv = S["j"]
    pc, pn, ps_, pv = S["p"]
    from hpmvs_tpu.ops import sampling as jsamp
    from hpmvs_tpu_torch.ops import sampling as psamp
    ref = jnp.maximum(jv[:, 0], 0)
    jax_ = jax.vmap(jsamp.patch_axes, (None, 0, 0, 0))(S["sc"].ctx.cams, ref,
                                                       jn, js)
    jtex, jval = _vm(jopt._sample_views, S["sc"].ctx, S["jo"])(
        jv, jc, js, *jax_)
    pax = psamp.patch_axes(S["ctx"].cams, torch.clamp(pv[:, 0], min=0), pn,
                           ps_)
    ptex, pval = popt._sample_views(S["ctx"], S["po"], pv, pc, ps_, *pax)
    np.testing.assert_array_equal(pval.numpy(), np.asarray(jval))
    m = np.asarray(jval)
    np.testing.assert_allclose(ptex.numpy()[m], np.asarray(jtex)[m],
                               atol=2e-4)


@pytest.mark.parametrize("windows", [False, True])
def test_objective_matches_jax(S, windows):
    """The scalar objective (objective_fn) at the patches' own parameters,
    from the full images and from the window cache."""
    from hpmvs_tpu.ops import sampling as jsamp
    jc, jn, js, jv = S["j"]
    jctx, jo = S["sc"].ctx, S["jo"]

    def frame(c, n, v):
        ref = jnp.maximum(v[0], 0)
        rr = jsamp.normalize3(c - jctx.cams.center[ref])
        ax = [jsamp.normalize3(a[ref])
              for a in (jctx.cams.xaxis, jctx.cams.yaxis, jctx.cams.zaxis)]
        x = jopt._params_from_center_norm(c, n, c, rr, *ax, jo)
        return x, rr, *ax

    fr = jax.vmap(frame)(jc, jn, jv)
    ws = S["ws"] if windows else None
    jf = np.asarray(jax.vmap(
        lambda x, c, rr, a0, a1, a2, s, v, w: jopt._objective(
            jctx, jo, x, c, rr, a0, a1, a2, s, v, w),
        in_axes=(0,) * 8 + (0 if windows else None,))(
            fr[0], jc, *fr[1:], js, jv, ws))
    pf = popt._objective(S["ctx"], S["po"], t(fr[0]), S["p"][0],
                         *(t(a) for a in fr[1:]), S["p"][2], S["p"][3],
                         _pws(ws) if windows else None).numpy()
    assert (jf < 2.0).sum() > 64
    np.testing.assert_array_equal(pf < 2.0, jf < 2.0)
    np.testing.assert_allclose(pf, jf, atol=1e-4)


def _stage_pair(S, name, jfn, pfn):
    jout = jfn()
    pout = pfn()
    jviews, pviews = np.asarray(jout[0]), pout[0].numpy()
    same = _same_rows(jviews, pviews)
    assert same.mean() >= 0.98, (name, np.nonzero(~same)[0])
    return jout, pout, same


def test_filter_ncc_sort_and_angle_stages(S):
    jc, jn, js, jv = S["j"]
    pc, pn, ps_, pv = S["p"]
    ctx, jctx, jo, po = S["ctx"], S["sc"].ctx, S["jo"], S["po"]
    jout, pout, same = _stage_pair(
        S, "filter_ncc",
        lambda: jax.vmap(lambda *a: jopt._filter_ncc(
            jctx, jo, *a[:4], jo.NCC_ALPHA_1, a[4]))(jc, jn, js, jv, S["ws"]),
        lambda: popt._filter_ncc(ctx, po, pc, pn, ps_, pv, po.NCC_ALPHA_1,
                                 _pws(S["ws"])))
    assert (np.asarray(jout[1]) == pout[1].numpy()).mean() >= 0.98
    # the window cache travels with its views
    np.testing.assert_array_equal(pout[2].win.numpy()[same],
                                  np.asarray(jout[2].win)[same])
    jv1, jws1 = jout[0], jout[2]
    pv1, pws1 = t(jv1), _pws(jws1)
    jout, pout, same = _stage_pair(
        S, "sort_images",
        lambda: _vm(jopt._sort_images, jctx, jo)(jc, jn, js, jv1, jws1),
        lambda: popt._sort_images(ctx, po, pc, pn, ps_, pv1, pws1))
    np.testing.assert_array_equal(pout[2].level.numpy()[same],
                                  np.asarray(jout[2].level)[same])
    jout, pout, same = _stage_pair(
        S, "filter_by_angle",
        lambda: _vm(jopt._filter_by_angle, jctx, jo)(jc, jn, jv1, jws1),
        lambda: popt._filter_by_angle(ctx, po, pc, pn, pv1, pws1))
    np.testing.assert_array_equal(np.asarray(jout[1]), pout[1].numpy())
    ja = _vm(jopt._assure_angles, jctx, jo)(jc, jv1)
    pa = popt._assure_angles_b(ctx, po, pc, pv1)
    np.testing.assert_array_equal(np.asarray(ja), pa.numpy())


@pytest.mark.parametrize("fast", [True, False])
def test_set_ref_image(S, fast):
    jc, jn, js, jv = S["j"]
    pc, pn, ps_, pv = S["p"]
    jo, po = (dataclasses.replace(o, FAST_SETREF=fast)
              for o in (S["jo"], S["po"]))
    jout, pout, same = _stage_pair(
        S, "set_ref_image",
        lambda: _vm(jopt._set_ref_image, S["sc"].ctx, jo)(jc, jn, js, jv,
                                                          S["ws"]),
        lambda: popt._set_ref_image(S["ctx"], po, pc, pn, ps_, pv,
                                    _pws(S["ws"])))
    # a new reference was picked somewhere, and the windows followed it
    assert (np.asarray(jout[0])[:, 0] != S["views"][:, 0]).any()
    np.testing.assert_array_equal(pout[1].ox.numpy()[same],
                                  np.asarray(jout[1].ox)[same])


def test_get_color(S):
    jc, jn, js, jv = S["j"]
    pc, pn, ps_, pv = S["p"]
    jcol = np.asarray(_vm(jopt._get_color, S["sc"].ctx, S["jo"])(jc, js, jv))
    pcol = popt._get_color(S["ctx"], S["po"], pc, ps_, pv).numpy()
    np.testing.assert_allclose(pcol, jcol, atol=1e-3)


def test_run_pre_and_post(S):
    jc, jn, js, _ = S["j"]
    pc, pn, ps_, _ = S["p"]
    jv0, pv0 = jnp.asarray(S["v"]), t(S["v"])
    jpre = _vm(jopt._run_pre, S["sc"].ctx, S["jo"])(jc, jn, js, jv0)
    kernels.reset_counts()
    ppre = popt._run_pre(S["ctx"], S["po"], pc, pn, ps_, pv0)
    assert _same_rows(jpre[2], ppre[2]).mean() >= 0.98
    assert (np.asarray(jpre[3]) == ppre[3].numpy()).mean() >= 0.98
    ok = jnp.asarray(np.asarray(jpre[3]))
    jpost = _vm(jopt._run_post, S["sc"].ctx, S["jo"])(jc, jn, js, jpre[2], ok)
    ppost = popt._run_post(S["ctx"], S["po"], pc, pn, ps_, t(jpre[2]), t(ok))
    same = _same_rows(jpost[3], ppost[3])
    assert same.mean() >= 0.98
    assert (np.asarray(jpost[4]) == ppost[4].numpy()).mean() >= 0.98
    np.testing.assert_allclose(ppost[5].numpy()[same],
                               np.asarray(jpost[5])[same], atol=1e-3)
    assert {k: v.twin_calls for k, v in kernels.STATS.items()} == \
        {"fetch": 2, "score": 0, "permute": 0, "gn": 0, "gn_fd": 0,
         "add_views": 2, "sort_views": 0}


def _hold(jc, jn, jf, jok, pc, pn, pf, pok, ok_frac=1.0, normal_frac=0.90):
    jc, jn, jf, jok = (np.asarray(a) for a in (jc, jn, jf, jok))
    pc, pn, pf, pok = (a.numpy() for a in (pc, pn, pf, pok))
    assert (jok == pok).mean() >= ok_frac
    both = jok & pok
    assert both.sum() >= 64
    within = ((np.abs(pc - jc).max(1) <= 2e-3)
              & (np.abs(pf - jf) <= 5e-3))[both]
    assert within.mean() >= 0.95, within.mean()
    normal = (np.abs(pn - jn).max(1) <= 5e-3)[both]
    assert (within & normal).mean() >= normal_frac, (within & normal).mean()


@pytest.mark.parametrize("exact", [True, False])
def test_optimize_patch_matches_jax(S, exact):
    """The plain refiner, both branches, on the pre-stage output."""
    jo, po = (dataclasses.replace(o, LM_EXACT_J=exact)
              for o in (S["jo"], S["po"]))
    jc, jn, js, _ = S["j"]
    jpre = _vm(jopt._run_pre, S["sc"].ctx, jo)(jc, jn, js,
                                              jnp.asarray(S["v"]))
    jout = _vm(jopt._optimize_patch, S["sc"].ctx, jo)(
        jpre[0], jpre[1], js, jpre[2], jpre[4])
    pout = popt._optimize_patch(S["ctx"], po, t(jpre[0]), t(jpre[1]),
                                t(S["s"]), t(jpre[2]), _pws(jpre[4]))
    _hold(jout[0], jout[1], jout[3], jout[2], pout[0], pout[1], pout[3],
          pout[2])
    moved = np.linalg.norm(np.asarray(jout[0]) - np.asarray(jpre[0]), axis=1)
    assert (moved > 1e-4).mean() > 0.5


def test_jacfwd_takes_jax_subgradients():
    """jvp of the port's hat sampler (and of its jnp.clip twin) equals
    jax.jvp of windows.hat_sample at integer coordinates, at the window
    edges and beyond them (clipped), where abs, the hat's maximum and the
    clip all sit on a kink."""
    rng = np.random.default_rng(3)
    W = 12
    win = rng.integers(0, 256, (2, W, W, 3)).astype(np.float32)
    g = np.array([[0.0, 3.0, 5.5, 11.0, -0.5, 12.5, 7.0, 1.0],
                  [11.0, 0.0, 2.25, 4.0, 13.0, -2.0, 10.0, 6.0]], np.float32)
    gy = g[:, ::-1].copy()
    dg = rng.normal(size=g.shape).astype(np.float32)
    dgy = rng.normal(size=g.shape).astype(np.float32)

    def jf(gx, gy):
        cl = lambda v: jnp.clip(v, 0.0, W - 1.0)
        return jwin.hat_sample(jnp.asarray(win), cl(gx), cl(gy))

    def pf(gx, gy):
        cl = lambda v: pwin.jax_clip(v, 0.0, W - 1.0)
        return pwin.hat_sample(t(win), cl(gx), cl(gy))

    jv, jt = jax.jvp(jf, (jnp.asarray(g), jnp.asarray(gy)),
                     (jnp.asarray(dg), jnp.asarray(dgy)))
    pv, pt = torch.func.jvp(pf, (t(g), t(gy)), (t(dg), t(dgy)))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-4)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-4)
    # the kinks matter: torch.abs / torch.clamp would give other tangents
    assert np.abs(np.asarray(jt)).max() > 1.0


_JAX_KERNEL_CONFIGS = {
    "vmapped": dict(USE_BATCHED_STAGES=False),
    "exactref": dict(FAST_SETREF=False),
    "fd": dict(LM_EXACT_J=False),
    "nowindows": dict(USE_WINDOWS=False),
}


@pytest.mark.parametrize("name", list(_JAX_KERNEL_CONFIGS))
def test_optimize_batch_matches_jax(S, name):
    """optimize_batch against the JAX package's, with the JAX refiner
    switched to its GN kernel in interpret mode wherever it would take it on
    a TPU (every configuration with windows)."""
    jo, po = _opts(**_JAX_KERNEL_CONFIGS[name])
    args = tuple(jnp.asarray(a) for a in (S["c"], S["n"], S["s"], S["v"]))
    mp = pytest.MonkeyPatch()
    try:
        if jo.USE_WINDOWS:
            mp.setattr(jopt, "_use_pallas_gn", lambda opt: True)
            mp.setattr(pallas_gn, "gn_refine_batch",
                       functools.partial(pallas_gn.gn_refine_batch,
                                         interpret=True))
        jout = tuple(np.asarray(a) for a in
                     jopt.optimize_batch(S["sc"].ctx, jo, *args))
    finally:
        mp.undo()
    kernels.reset_counts()
    pout = popt.optimize_batch(S["ctx"], po,
                               *(t(a) for a in (S["c"], S["n"], S["s"],
                                                S["v"])))
    jc, jn, js, jv, jok, jcol, jf = jout
    pc, pn, ps_, pv, pok, pcol, pf = pout
    assert _same_rows(jv, pv).mean() >= 0.95
    _hold(jc, jn, jf, jok, pc, pn, pf, pok, ok_frac=0.98,
          normal_frac=0.90 if po.LM_EXACT_J else 0.85)
    calls = {k: v.twin_calls for k, v in kernels.STATS.items()}
    refiner = "gn" if po.LM_EXACT_J else "gn_fd"
    # addImages runs in both halves of every pipeline
    if name == "nowindows":
        assert calls == {"fetch": 0, "score": 0, "permute": 0, "gn": 0,
                         "gn_fd": 0, "add_views": 2, "sort_views": 0}
    elif name == "fd":
        assert calls == {"fetch": 2, "score": 2, "permute": 1, "gn": 0,
                         "gn_fd": 1, "add_views": 2, "sort_views": 1}
    else:
        assert calls == {"fetch": 2, "score": 0, "permute": 0,
                         "gn": refiner == "gn", "gn_fd": refiner == "gn_fd",
                         "add_views": 2, "sort_views": 0}


def test_exactref_fd_twin_calls(S):
    """The per-patch path with the FD GN mode (chip_smoke's
    plane_exactref_fd) runs fetch and add_views twice and the FD
    refinement once, and no other batched-stage kernel."""
    _, po = _opts(FAST_SETREF=False, LM_EXACT_J=False)
    kernels.reset_counts()
    popt.optimize_batch(S["ctx"], po, *(t(a) for a in (S["c"], S["n"],
                                                        S["s"], S["v"])))
    assert {k: (v.launches, v.twin_calls)
            for k, v in kernels.STATS.items()} == {
        "fetch": (0, 2), "score": (0, 0), "permute": (0, 0), "gn": (0, 0),
        "gn_fd": (0, 1), "add_views": (0, 2), "sort_views": (0, 0)}


def test_engine_exactref_fd_matches_jax_engine(tmp_path):
    ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2)
    kw = dict(FAST_SETREF=False, LM_EXACT_J=False)
    # both engines classic (one wave per dispatch, no lookahead)
    kw.update(WAVE_DEPTH=1, WAVE_LOOKAHEAD=False)
    jo = plane_options(JOptions, OUTFOLDER=str(tmp_path / "jax"), **kw)
    po = plane_options(POptions, OUTFOLDER=str(tmp_path / "port"), **kw)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jopt, "_use_pallas_gn", lambda opt: True)
        mp.setattr(pallas_gn, "gn_refine_batch",
                   functools.partial(pallas_gn.gn_refine_batch,
                                     interpret=True))
        je = jpipe.run(ps.model, jo, images=ps.images, mesh=None)
    finally:
        mp.undo()
    pe = ppipe.run(ps.model, po, images=ps.images, device="cpu")
    nj, np_ = je.n_alive(), pe.n_alive()
    assert nj > 100
    assert abs(np_ - nj) <= 0.10 * nj, (nj, np_)
    acc = [float((np.abs(e.alive_arrays()[0][:, 2] - ps.plane_z)
                  < 0.02).mean()) for e in (je, pe)]
    assert abs(acc[1] - acc[0]) <= 0.05 and min(acc) >= 0.7, acc
