"""geom/camera.py and ops/sampling.py of the port vs the JAX package and vs
the scalar reference sampler (sampling.np_reference_sample).

Tolerances: projected pixel coordinates 1e-4 px, normalized textures 1e-5
from identical coordinates (1e-4 end to end, see test_sampling_ops);
integer outputs (levels, validity) exactly."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpmvs_tpu.config import Options as JOptions
from hpmvs_tpu.core import scene as jscene
from hpmvs_tpu.geom import camera as jcam
from hpmvs_tpu.ops import sampling as jsamp
from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch.geom import camera as pcam
from hpmvs_tpu_torch.ops import sampling as psamp

from torch_parity import plane_options, port_ctx, t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    opt = plane_options(JOptions)
    ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2)
    sc = jscene.build_scene(ps.model, opt, images=ps.images)
    rng = np.random.default_rng(11)
    n = 200
    pts = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.normal(0, 0.05, n)
    ci = rng.integers(0, 4, n).astype(np.int32)
    lv = rng.integers(0, 4, n).astype(np.int32)
    scale = rng.uniform(0.005, 0.05, n).astype(np.float32)
    normal = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    normal[:, 2] -= 1.0
    return opt, ps, sc, port_ctx(sc.ctx), (pts, ci, lv, scale, normal)


def test_build_cameras_identical(setup):
    opt, ps, sc, ctx, _ = setup
    cams = pcam.build_cameras(ps.model.cameras, [128] * 4, [128] * 4,
                              opt.MAXLEVEL, device="cpu")
    for f in sc.ctx.cams._fields:
        np.testing.assert_array_equal(getattr(cams, f).numpy(),
                                      np.asarray(getattr(sc.ctx.cams, f)))


def test_projection_and_levels(setup):
    opt, ps, sc, ctx, (pts, ci, lv, scale, _) = setup
    jc, pc = sc.ctx.cams, ctx.cams
    np.testing.assert_allclose(
        pcam.mult(pc, t(ci), t(pts), t(lv)).numpy(),
        np.asarray(jcam.mult(jc, jnp.asarray(ci), jnp.asarray(pts),
                             jnp.asarray(lv))), rtol=1e-6, atol=1e-4)
    behind = pts.copy()
    behind[:10] = np.asarray(jc.center)[ci[:10]] * 2.0   # behind the camera
    pp = pcam.project(pc, t(ci), t(behind), t(lv)).numpy()
    jp = np.asarray(jcam.project(jc, jnp.asarray(ci), jnp.asarray(behind),
                                 jnp.asarray(lv)))
    np.testing.assert_allclose(pp, jp, atol=1e-4)
    assert (pp[:10, 2] == -1.0).any()
    np.testing.assert_allclose(
        pcam.get_scale(pc, t(ci), t(pts), t(lv)).numpy(),
        np.asarray(jcam.get_scale(jc, jnp.asarray(ci), jnp.asarray(pts),
                                  jnp.asarray(lv))), rtol=1e-6)
    np.testing.assert_allclose(
        pcam.get_level(pc, t(ci), t(pts), t(scale)).numpy(),
        np.asarray(jcam.get_level(jc, jnp.asarray(ci), jnp.asarray(pts),
                                  jnp.asarray(scale))), atol=1e-5)
    np.testing.assert_array_equal(
        pcam.get_leveli(pc, t(ci), t(pts), t(scale), 3).numpy(),
        np.asarray(jcam.get_leveli(jc, jnp.asarray(ci), jnp.asarray(pts),
                                   jnp.asarray(scale), 3)))
    np.testing.assert_array_equal(
        pcam.get_level_fit(pc, t(ci), t(pts), t(scale), 3, 12).numpy(),
        np.asarray(jcam.get_level_fit(jc, jnp.asarray(ci), jnp.asarray(pts),
                                      jnp.asarray(scale), 3, 12)))


def test_float_to_int_saturates_like_xla():
    v = np.array([np.nan, 1e12, -1e12, 3.7, -3.7, 2.1e9, -2.2e9], np.float32)
    got = pcam.f2i(t(v)).numpy()
    want = np.asarray(jnp.asarray(v).astype(jnp.int32))
    # same sign and saturation side; exact inside the int32 range
    np.testing.assert_array_equal(got[[0, 3, 4]], want[[0, 3, 4]])
    assert got[1] > 2 ** 30 and want[1] > 2 ** 30
    assert got[2] == want[2] == -2 ** 31
    assert got[5] == 2100000000 == want[5]


def test_sampling_ops(setup):
    opt, ps, sc, ctx, (pts, ci, lv, scale, normal) = setup
    jc = sc.ctx.cams
    np.testing.assert_allclose(psamp.normalize3(t(normal)).numpy(),
                               np.asarray(jsamp.normalize3(jnp.asarray(normal))),
                               atol=1e-6)
    for a, b in zip(psamp.patch_axes(ctx.cams, t(ci), t(normal), t(scale)),
                    jsamp.patch_axes(jc, jnp.asarray(ci), jnp.asarray(normal),
                                     jnp.asarray(scale))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    mac = math.cos(opt.MAX_ANGLE)
    xa, ya, za = psamp.patch_axes(ctx.cams, t(ci), t(normal), t(scale))
    ptex, pval = psamp.sample_texture(ctx.cams, ctx.imgs, t(ci), t(pts),
                                      t(scale), xa, ya, za, mac, 2)
    jxa, jya, jza = jsamp.patch_axes(jc, jnp.asarray(ci), jnp.asarray(normal),
                                     jnp.asarray(scale))
    jtex, jval = jsamp.sample_texture(jc, sc.ctx.imgs, jnp.asarray(ci),
                                      jnp.asarray(pts), jnp.asarray(scale),
                                      jxa, jya, jza, mac, 2)
    pval = pval.numpy()
    np.testing.assert_array_equal(pval, np.asarray(jval))
    assert pval.sum() > 50
    # end to end the grid coordinates differ by an ulp (XLA on the CPU
    # contracts its dot products into fused multiply-adds, torch does not);
    # a normalized texel moves by gradient * 1 ulp / std, so this compare
    # takes the pixel tolerance. From identical coordinates the textures
    # agree to 1e-5 (normalize_tex below).
    np.testing.assert_allclose(ptex.numpy()[pval], np.asarray(jtex)[pval],
                               atol=1e-4)
    a, b = ptex.numpy()[pval][:20], ptex.numpy()[pval][20:40]
    np.testing.assert_allclose(
        psamp.ncc(t(a), t(b)).numpy(),
        np.asarray(jsamp.ncc(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
    x = np.linspace(-0.3, 2.0, 30).astype(np.float32)
    np.testing.assert_allclose(psamp.robust_incc(t(x)).numpy(),
                               np.asarray(jsamp.robust_incc(jnp.asarray(x))),
                               rtol=1e-6)
    raw = np.random.default_rng(2).uniform(0, 255, (5, 49, 3)).astype(np.float32)
    np.testing.assert_allclose(
        psamp.normalize_tex(t(raw)).numpy(),
        np.asarray(jsamp.normalize_tex(jnp.asarray(raw))), atol=1e-5)
    gx = np.random.default_rng(3).uniform(0, 50, (40,)).astype(np.float32)
    np.testing.assert_allclose(
        psamp.bilinear(ctx.imgs.tex, ctx.imgs.row0, ctx.imgs.width,
                       t(ci[:40]), t(lv[:40]), t(gx), t(gx * 0.5)).numpy(),
        np.asarray(jsamp.bilinear(sc.ctx.imgs.tex, sc.ctx.imgs.row0,
                                  sc.ctx.imgs.width, jnp.asarray(ci[:40]),
                                  jnp.asarray(lv[:40]), jnp.asarray(gx),
                                  jnp.asarray(gx * 0.5))), atol=1e-3)


def test_sample_texture_matches_scalar_reference(setup):
    opt, ps, sc, ctx, (pts, ci, lv, scale, normal) = setup
    mac = math.cos(opt.MAX_ANGLE)
    lvl = 1
    tex, val = psamp.sample_texture(ctx.cams, ctx.imgs, t(ci), t(pts),
                                    t(np.full_like(scale, 0.02)),
                                    *psamp.patch_axes(ctx.cams, t(ci),
                                                      t(normal),
                                                      t(np.full_like(scale, 0.02))),
                                    mac, lvl)
    level = pcam.get_leveli(ctx.cams, t(ci), t(pts),
                            t(np.full_like(scale, 0.02)), lvl).numpy()
    row0 = ctx.imgs.row0.numpy()
    w, h = ctx.imgs.width.numpy(), ctx.imgs.height.numpy()
    texnp = ctx.imgs.tex.numpy()
    P = ctx.cams.P.numpy()
    checked = 0
    for i in np.nonzero(val.numpy())[0][:25]:
        c, L = ci[i], level[i]
        plane = texnp[row0[c, L]:row0[c, L] + h[c, L], :w[c, L]]
        ref = psamp.np_reference_sample(
            plane, P[c, L], ctx.cams.center[c].numpy(),
            ctx.cams.xaxis[c].numpy(), ctx.cams.yaxis[c].numpy(), pts[i],
            normal[i], 0.02, mac)
        assert ref is not None
        np.testing.assert_allclose(tex[i].numpy().reshape(7, 7, 3), ref,
                                   atol=1e-3)
        checked += 1
    assert checked >= 10
