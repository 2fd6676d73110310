"""The port's pooled depth and view-block gates (core/depth.pool_full_depth)
against its own 9-gather path, bitwise, and against the JAX package's pooled
gates, which compare sums (nm_max < d + tol) where the port compares
differences (nm_max - d < tol).

The lanes cover every outcome: on the surface, in front of it (blocked),
behind it, at the image edges (neighbourhoods that reach past the border),
over empty windows, and with tolerances placed on the threshold and one or
two ulps either side of it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpmvs_tpu.config import Options as JOptions
from hpmvs_tpu.core import depth as jdepth
from hpmvs_tpu.core import scene as jscene
from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.core import depth as pdepth
from hpmvs_tpu_torch.geom import camera as cam_ops

from torch_parity import plane_options, port_ctx, port_pack, t

torch.set_num_threads(1)

MARGIN = 1.0


@pytest.fixture(scope="module")
def setup():
    jo = plane_options(JOptions)
    po = plane_options(POptions)
    ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2)
    sc = jscene.build_scene(ps.model, jo, images=ps.images)
    ctx = port_ctx(sc.ctx)
    pack = port_pack(jdepth.build_depth_pack(sc.width_np, sc.height_np))
    c, n, s, v, _ = jscene.make_seed_patches(ps.model, sc, jo)
    # the z-buffer: a patch grid over part of the plane (phase 0), a third
    # of it subtracted (phase 1), a shifted copy of another part (phase 2)
    rng = np.random.default_rng(3)
    g = rng.uniform(-0.45, 0.25, (1500, 2))
    gc = np.column_stack([g, np.full(len(g), ps.plane_z)]).astype(np.float32)
    gs = np.full(len(g), float(np.median(s)), np.float32)
    gv = np.tile(np.arange(sc.n_cameras, dtype=np.int32), (len(g), 1))
    sub = gc[:500]
    add2 = gc[500:700] + np.array([0, 0, -0.04], np.float32)
    pc = np.concatenate([gc, sub, add2])
    psz = np.concatenate([gs, gs[:500], gs[500:700]])
    pv = np.concatenate([gv, gv[:500], gv[500:700]])
    ph = np.concatenate([np.zeros(len(gc)), np.ones(500),
                         np.full(200, 2)]).astype(np.int32)
    pdepth.apply_phased_updates(pack, ctx.cams, t(pc), t(psz), t(pv), t(ph))
    pw, phh = pack.width.numpy(), pack.height.numpy()
    lay = tuple((int(phh[0, lv]), int(pw[0, lv])) for lv in range(pw.shape[1]))
    full0 = pdepth.collapse_full_depth(pack.depth, lay, sc.n_cameras)
    return jo, po, ps, sc, ctx, pack, full0, (c, n, s, v)


def _edge_points(ctx, plane_z, ncam):
    """Plane points whose level-0 projection in each camera lands on the
    first and last pixels of its rows and columns (ix0 = trunc(u+0.5)-1 in
    -1..1 and w0-4..w0-2)."""
    P = ctx.cams.P.numpy().astype(np.float64)[:, 0]          # (ncam, 3, 4)
    w0 = int(ctx.imgs.width.numpy()[0, 0])
    h0 = int(ctx.imgs.height.numpy()[0, 0])
    us = [0.2, 0.7, 1.2, 1.7, 2.2, w0 - 3.4, w0 - 2.8, w0 - 2.2, w0 - 1.7,
          w0 - 1.2]
    vs = [0.3, 1.4, h0 / 2, h0 - 2.4, h0 - 1.6]
    pts = []
    for ci in range(ncam):
        for u in us:
            for v in vs:
                for uu, vv in ((u, v), (v * w0 / h0, u * h0 / w0)):
                    # u * P3.X = P1.X, v * P3.X = P2.X on z = plane_z
                    A = np.array([uu * P[ci, 2, :2] - P[ci, 0, :2],
                                  vv * P[ci, 2, :2] - P[ci, 1, :2]])
                    b = -np.array([(uu * P[ci, 2, 2] - P[ci, 0, 2]) * plane_z
                                   + uu * P[ci, 2, 3] - P[ci, 0, 3],
                                   (vv * P[ci, 2, 2] - P[ci, 1, 2]) * plane_z
                                   + vv * P[ci, 2, 3] - P[ci, 1, 3]])
                    xy = np.linalg.solve(A, b)
                    pts.append([xy[0], xy[1], plane_z])
    return np.asarray(pts, np.float32)


def _base_lanes(ctx, ps, seeds, ncam):
    """Seeds on and off the surface along their rays, random plane points
    (many over empty windows) and edge points; every lane sees every
    camera."""
    c, n, s, v = seeds
    rng = np.random.default_rng(7)
    cam_c = ctx.cams.center.numpy()[v[:, 0]]
    ray = c - cam_c
    ray /= np.linalg.norm(ray, axis=1, keepdims=True)
    cc = [c + k * s[:, None] * ray for k in (0.0, 0.5, -0.5, -3.0, 3.0,
                                             -20.0, -60.0)]
    rnd = rng.uniform(-0.9, 0.9, (300, 2))
    cc.append(np.column_stack([rnd, np.full(300, ps.plane_z)]))
    cc.append(_edge_points(ctx, ps.plane_z, ncam))
    cc = np.concatenate(cc).astype(np.float32)
    L = len(cc)
    nn = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (L, 1))
    nn += rng.normal(0, 0.1, nn.shape).astype(np.float32)
    ss = np.full(L, float(np.median(s)), np.float32) \
        * rng.choice([0.5, 1.0, 2.0], L).astype(np.float32)
    vv = np.tile(np.arange(ncam, dtype=np.int32), (L, 1))
    return cc, nn.astype(np.float32), ss, vv


def _terms(ctx, pool3, c, n, ci):
    """Per (lane, view) the quantities the pooled test compares, computed
    with the gate's own expressions: d, factor, the pooled cells, and
    whether the 3x3 neighbourhood is inside the image."""
    cams = ctx.cams
    B, K = ci.shape
    cc = c[:, None].expand(B, K, 3)
    nn = n[:, None].expand(B, K, 3)
    imgC = cam_ops.mult(cams, ci, cc, torch.zeros_like(ci))
    d = imgC[..., 2]
    ix0 = cam_ops.f2i(imgC[..., 0] / d + 0.5) - 1
    iy0 = cam_ops.f2i(imgC[..., 1] / d + 0.5) - 1
    nm_min, nm_max, raw_max = pool3
    xs = torch.clamp(torch.div(ix0, 2, rounding_mode="floor"), 0,
                     nm_min.shape[2] - 1).long()
    ys = torch.clamp(torch.div(iy0, 2, rounding_mode="floor"), 0,
                     nm_min.shape[1] - 1).long()
    ray = cc - cams.center[ci]
    ray = ray / torch.clamp(torch.linalg.vector_norm(ray, dim=-1,
                                                     keepdim=True), min=1e-12)
    factor = torch.clamp(2.0 + torch.sum(ray * nn, dim=-1), max=2.0)
    w0 = ctx.imgs.width[ci, 0]
    h0 = ctx.imgs.height[ci, 0]
    allinb = ((d >= 0) & (ix0 >= 0) & (ix0 < w0 - 2) & (iy0 >= 0)
              & (iy0 < h0 - 2))
    return dict(d=d, factor=factor, lo=nm_min[ci, ys, xs],
                hi=nm_max[ci, ys, xs], raw=raw_max[ci, ys, xs],
                allinb=allinb, ix0=ix0, w0=w0)


def _threshold_lanes(ctx, pool3, base, ncam):
    """Base lanes whose scale puts tol on one of the gate's thresholds for
    one of their views, and 1-2 ulps either side: |nm_max - d|,
    |nm_min - d| (depth test) and nm_min - d (view block)."""
    c, n, s, v = base
    ci = t(v).long()
    T = _terms(ctx, pool3, t(c), t(n), ci)
    tgt = torch.stack([T["hi"] - T["d"], -(T["lo"] - T["d"]),
                       T["lo"] - T["d"]], -1)                  # (L, K, 3)
    ok = (T["allinb"][..., None] & torch.isfinite(tgt) & (tgt > 0)
          & (T["raw"] < pdepth.MAX_DEPTH)[..., None])
    lane, view, kind = np.nonzero(ok.numpy())
    rng = np.random.default_rng(11)
    pick = rng.choice(len(lane), min(len(lane), 240), replace=False)
    lane, view, kind = lane[pick], view[pick], kind[pick]
    target = tgt.numpy()[lane, view, kind]
    f = T["factor"].numpy()[lane, view]
    s0 = (target / (MARGIN * f * 2.0)).astype(np.float32)
    cs, ns, ss, vs = [], [], [], []
    for step in (-2, -1, 0, 1, 2):
        sc = s0.copy()
        for _ in range(abs(step)):
            sc = np.nextafter(sc, np.float32(np.inf if step > 0 else -np.inf))
        cs.append(c[lane]), ns.append(n[lane]), ss.append(sc)
        vs.append(v[lane])
    return (np.concatenate(cs), np.concatenate(ns),
            np.concatenate(ss).astype(np.float32), np.concatenate(vs))


@pytest.fixture(scope="module")
def lanes(setup):
    jo, po, ps, sc, ctx, pack, full0, seeds = setup
    pool3 = pdepth.pool_full_depth(full0)
    base = _base_lanes(ctx, ps, seeds, sc.n_cameras)
    near = _threshold_lanes(ctx, pool3, base, sc.n_cameras)
    lanes = tuple(np.concatenate([a, b]) for a, b in zip(base, near))
    return pool3, lanes, len(base[0])


def _views(opt, ctx, pack, full0, pool3, c, n, s, v, view_block):
    """Per (lane, view) results of the 9-gather and the pooled path."""
    ci = t(v).long()
    B, K = ci.shape
    args = (t(c)[:, None].expand(B, K, 3), t(n)[:, None].expand(B, K, 3),
            t(s)[:, None].expand(B, K), ci, MARGIN, view_block)
    nine = pdepth._depth_test_view(pack, ctx.cams, ctx.imgs, opt, *args,
                                   full0=full0)
    pooled = pdepth._depth_test_view_pooled(ctx.cams, ctx.imgs, *args,
                                            pool3=pool3)
    return nine.numpy(), pooled.numpy()


@pytest.mark.parametrize("view_block", [False, True])
def test_pooled_views_bitwise_equal_to_nine_gathers(setup, lanes, view_block):
    jo, po, ps, sc, ctx, pack, full0, _ = setup
    pool3, (c, n, s, v), n_base = lanes
    nine, pooled = _views(po, ctx, pack, full0, pool3, c, n, s, v, view_block)
    np.testing.assert_array_equal(pooled, nine)
    T = _terms(ctx, pool3, t(c), t(n), t(v).long())
    inb = T["allinb"].numpy()
    empty = inb & (T["lo"].numpy() == np.inf)
    # every kind of lane is there: both outcomes, empty windows, and
    # neighbourhoods at and past each image edge
    assert nine.sum() >= 20 and (~nine & inb).sum() >= 20
    assert empty.sum() >= 20
    ix0, w0 = T["ix0"].numpy(), T["w0"].numpy()
    for edge in (-1, 0, 1):
        assert (ix0 == edge).any()
        assert (ix0 == w0 - 3 + edge).any()
    if view_block:
        # blocked views exist (the check would pass vacuously without them)
        assert nine.sum() >= 20
    else:
        assert nine[empty].all()


def test_threshold_lanes_sit_on_tol(setup, lanes):
    """Some lanes have tol exactly on |nm - d|, others one ulp either side,
    so the bitwise test above decides them at the threshold."""
    jo, po, ps, sc, ctx, pack, full0, _ = setup
    pool3, (c, n, s, v), n_base = lanes
    T = _terms(ctx, pool3, t(c), t(n), t(v).long())
    tol = (t(s)[:, None] * MARGIN * T["factor"] * 2.0).numpy()[n_base:]
    d = T["d"].numpy()[n_base:]
    gaps = np.stack([np.abs(T["hi"].numpy()[n_base:] - d) - tol,
                     np.abs(T["lo"].numpy()[n_base:] - d) - tol])
    ulp = np.spacing(tol.astype(np.float32))
    assert (gaps == 0).sum() >= 20
    assert (np.abs(np.abs(gaps) - ulp) <= ulp * 0.5).sum() >= 20


@pytest.mark.parametrize("kind", ["depth_tests", "view_block_test"])
def test_public_counts_bitwise(setup, lanes, kind):
    """depth_tests / view_block_test with pool3 equal their full0 and
    pyramid forms, including lanes that are blocked."""
    jo, po, ps, sc, ctx, pack, full0, _ = setup
    pool3, (c, n, s, v), _ = lanes
    P = (t(c), t(n), t(s))
    if kind == "depth_tests":
        outs = [pdepth.depth_tests(pack, ctx.cams, ctx.imgs, po, *P, t(v),
                                   MARGIN, full0=f0, pool3=p3).numpy()
                for f0, p3 in ((None, None), (full0, None), (full0, pool3))]
        assert (outs[0] == 0).any() and (outs[0] == sc.n_cameras).any()
    else:
        outs = [pdepth.view_block_test(pack, ctx.cams, ctx.imgs, po, *P,
                                       MARGIN, sc.n_cameras, full0=f0,
                                       pool3=p3).numpy()
                for f0, p3 in ((None, None), (full0, None), (full0, pool3))]
        assert (outs[0] > 0).sum() >= 10
    np.testing.assert_array_equal(outs[2], outs[1])
    np.testing.assert_array_equal(outs[2], outs[0])


def test_pools_equal_jax(setup):
    jo, po, ps, sc, ctx, pack, full0, _ = setup
    pj = jdepth.pool_full_depth(jnp.asarray(full0.numpy()))
    for a, b in zip(pdepth.pool_full_depth(full0), pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("view_block", [False, True])
def test_jax_sum_form_differs_only_at_the_threshold(setup, lanes, view_block):
    """The JAX pooled gates compare sums (d + tol, d - tol); where they
    decide a (lane, view) otherwise than the port, the lane's |nm - d| lies
    within a few ulps of d from tol."""
    jo, po, ps, sc, ctx, pack, full0, _ = setup
    pool3, (c, n, s, v), _ = lanes
    _, pooled = _views(po, ctx, pack, full0, pool3, c, n, s, v, view_block)
    B, K = v.shape
    bc = lambda a, *sh: jnp.broadcast_to(jnp.asarray(a)[:, None], (B, K) + sh)
    jp3 = tuple(jnp.asarray(a.numpy()) for a in pool3)
    jres = np.asarray(jdepth._depth_test_view_pooled(
        sc.ctx.cams, sc.ctx.imgs, jo, bc(c, 3), bc(n, 3), bc(s),
        jnp.asarray(v), MARGIN, view_block, jp3))
    T = _terms(ctx, pool3, t(c), t(n), t(v).long())
    d = T["d"].numpy()
    tol = (t(s)[:, None] * MARGIN * T["factor"] * 2.0).numpy()
    cells = (T["lo"].numpy(),) if view_block else (T["lo"].numpy(),
                                                   T["hi"].numpy())
    dist = np.min([np.abs(np.abs(x - d) - tol) for x in cells], axis=0)
    diff = jres != pooled
    few = 4 * np.spacing(np.maximum(np.abs(d), 1.0).astype(np.float32))
    assert (dist[diff] <= few[diff]).all(), dist[diff]
    # the count of (lane, view) pairs the two forms decide otherwise
    print(f"sum form vs difference form: {int(diff.sum())} of {diff.size} "
          f"(lane, view) pairs differ, all within 4 ulps of d of tol")
