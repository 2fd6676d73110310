"""Kernel B1 (window fetch) and B3 (slot permutation): the plain PyTorch
twins, run by the port's wrappers on CPU tensors, against the JAX package's
CPU paths -- fetch_windows_t on its dynamic_slice path, permute_wst with
use_kernel=False and in pallas interpret mode. Exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpmvs_tpu.config import Options as JOptions
from hpmvs_tpu.core import scene as jscene
from hpmvs_tpu.ops import optimizer as jopt
from hpmvs_tpu.ops import pallas_score
from hpmvs_tpu.ops import windows as jwin
from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch import kernels
from hpmvs_tpu_torch.ops import fetch, score
from hpmvs_tpu_torch.ops import windows as pwin

from torch_parity import plane_options, port_ctx, t, tiled_batch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    opt = plane_options(JOptions, MAX_VIEWS=8)
    ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2)
    sc = jscene.build_scene(ps.model, opt, images=ps.images)
    seeds = jscene.make_seed_patches(ps.model, sc, opt)
    c, n, s, v = tiled_batch(seeds)
    views, _ = jopt._add_images_b(sc.ctx, opt, jnp.asarray(c),
                                  jnp.asarray(n), jnp.asarray(s),
                                  jnp.asarray(v))
    return opt, sc, port_ctx(sc.ctx), c, s, np.asarray(views)


def _fetch_both(opt, sc, ctx, c, s, views, mask, prev_j=None, prev_p=None):
    ci = np.maximum(views, 0)
    cb = np.broadcast_to(c[:, None], ci.shape + (3,)).copy()
    sb = np.broadcast_to(s[:, None], ci.shape).copy()
    args = (opt.MAXLEVEL - 1, opt.WINDOW_SIZE)
    wj = jwin.fetch_windows_t(sc.ctx.cams, sc.ctx.imgs, jnp.asarray(ci),
                              jnp.asarray(cb), jnp.asarray(sb), *args,
                              fetch_mask=jnp.asarray(mask), prev=prev_j)
    wp = pwin.fetch_windows_t(ctx.cams, ctx.imgs, t(ci), t(cb), t(sb), *args,
                              fetch_mask=t(mask), prev=prev_p)
    return wj, wp


def test_fetch_matches_dynamic_slice(setup):
    opt, sc, ctx, c, s, views = setup
    mask = views >= 0
    kernels.reset_counts()
    wj, wp = _fetch_both(opt, sc, ctx, c, s, views, mask)
    assert kernels.STATS["fetch"].twin_calls == 1
    assert kernels.STATS["fetch"].launches == 0
    for f in ("ox", "oy", "level"):
        np.testing.assert_array_equal(getattr(wp, f).numpy(),
                                      np.asarray(getattr(wj, f)))
    w5 = np.asarray(wj.to_win5())
    assert mask.sum() > 300 and (~mask).sum() > 0
    np.testing.assert_array_equal(wp.win.numpy()[mask], w5[mask])
    # masked slots are not read
    assert not wp.win.numpy()[~mask].any()


def test_fetch_selective_refetch_with_prev(setup):
    opt, sc, ctx, c, s, views = setup
    mask = views >= 0
    wj0, wp0 = _fetch_both(opt, sc, ctx, c, s, views, mask)
    # move the patches (as refinement does) and refetch only the slots at
    # or after each patch's old view count
    rng = np.random.default_rng(4)
    c2 = (c + rng.normal(0, 0.01, c.shape)).astype(np.float32)
    nv_old = rng.integers(1, views.shape[1], len(c))
    remask = (np.arange(views.shape[1])[None] >= nv_old[:, None]) & mask
    assert remask.any() and (mask & ~remask).any()
    wj, wp = _fetch_both(opt, sc, ctx, c2, s, views, remask, wj0, wp0)
    for f in ("ox", "oy", "level"):
        np.testing.assert_array_equal(getattr(wp, f).numpy(),
                                      np.asarray(getattr(wj, f)))
    w5 = np.asarray(wj.to_win5())
    np.testing.assert_array_equal(wp.win.numpy()[mask], w5[mask])


def test_fetch_twin_contract():
    """Direct twin contract: rows/cols cut, unread pairs zero or prev."""
    rng = np.random.default_rng(0)
    tex = torch.as_tensor(rng.integers(0, 256, (40, 30, 3)).astype(np.float32))
    rows = torch.as_tensor(rng.integers(0, 28, 9).astype(np.int32))
    ox = torch.as_tensor(rng.integers(0, 18, 9).astype(np.int32))
    mask = torch.as_tensor(rng.random(9) < 0.6)
    prev = torch.full((9, 12, 12, 3), 7.0)
    out = fetch.fetch_windows(tex, rows, ox, 12, mask=mask, prev=prev)
    for n in range(9):
        want = (tex[rows[n]:rows[n] + 12, ox[n]:ox[n] + 12] if mask[n]
                else prev[n])
        assert torch.equal(out[n], want)


@pytest.mark.parametrize("W", [7, 10, 16])
@pytest.mark.parametrize("with_prev", [False, True])
def test_fetch_twin_any_width(W, with_prev):
    """The twin contract the CUDA kernel is held to at every W it takes: a
    bool mask (the kernel reads its bytes in place), unread pairs zero
    without prev and prev's window with it, windows touching the pyramid's
    last row and column."""
    rng = np.random.default_rng(W)
    R, wmax, n = 3 * W, 2 * W + 5, 17
    tex = torch.as_tensor(rng.random((R, wmax, 3)).astype(np.float32) * 255)
    rows = torch.as_tensor(rng.integers(0, R - W + 1, n).astype(np.int32))
    ox = torch.as_tensor(rng.integers(0, wmax - W + 1, n).astype(np.int32))
    rows[0], ox[0] = R - W, wmax - W
    mask = torch.as_tensor(rng.random(n) < 0.6)
    mask[0] = True
    prev = torch.full((n, W, W, 3), -3.0) if with_prev else None
    out = fetch.fetch_windows(tex, rows, ox, W, mask=mask, prev=prev)
    assert out.shape == (n, W, W, 3) and out.dtype == torch.float32
    for i in range(n):
        if mask[i]:
            want = tex[rows[i]:rows[i] + W, ox[i]:ox[i] + W]
        else:
            want = prev[i] if with_prev else torch.zeros((W, W, 3))
        assert torch.equal(out[i], want)


@pytest.mark.parametrize("mode", ["take_along_axis", "interpret"])
def test_permute_matches_jax(setup, mode):
    opt, sc, ctx, c, s, views = setup
    mask = views >= 0
    wj, wp = _fetch_both(opt, sc, ctx, c, s, views, mask)
    rng = np.random.default_rng(1)
    order = np.stack([rng.permutation(views.shape[1])
                      for _ in range(len(c))]).astype(np.int32)
    kw = dict(use_kernel=False) if mode == "take_along_axis" \
        else dict(interpret=True)
    pj = pallas_score.permute_wst(wj, jnp.asarray(order), **kw)
    kernels.reset_counts()
    pp = score.permute_ws(wp, t(order))
    assert kernels.STATS["permute"].twin_calls == 1
    for f in ("ox", "oy", "level"):
        np.testing.assert_array_equal(getattr(pp, f).numpy(),
                                      np.asarray(getattr(pj, f)))
    # compare the slots fetched in both (JAX fills unread slots too)
    m2 = np.take_along_axis(mask, order, 1)
    np.testing.assert_array_equal(pp.win.numpy()[m2],
                                  np.asarray(pj.to_win5())[m2])
    # the permutation itself is a bit-exact copy
    np.testing.assert_array_equal(
        pp.win.numpy(),
        np.take_along_axis(wp.win.numpy(), order[:, :, None, None, None], 1))
