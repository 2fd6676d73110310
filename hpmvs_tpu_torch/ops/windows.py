"""Window cache: gather one pixel window per (patch, view), sample densely.

Every NCC pass and every Gauss-Newton iteration of a batch samples the same
(patch, view) neighbourhoods, so each is cut once per pipeline half as a
W x W x 3 window around the projected patch centre (kernel B1, ops/fetch.py)
and every later sample reads the window instead of the full image.

Layout (private to the port): win (B, K, W, W, 3) float32, patch-major, so
each (patch, view) window is 432 contiguous floats at W=12. Pixel values are
the pyramid's uint8 values (integers 0..255 at every level), so the float32
window is exact; bfloat16 would be exact too and halve the bytes, but
float32 keeps the kernels free of conversions.

Samples whose grid leaves the cached window are flagged invalid (documented
divergence: the reference, re-fetching every texel, would still sample them;
the window margin is sized so this only happens when the optimizer drifts
further than the extend/branch gates allow anyway).

The per-patch stages (ops/optimizer.py, USE_BATCHED_STAGES=False or
FAST_SETREF=False) sample with `sample_from_windows`, which reads 4 taps per
texel (score.bilinear_taps) where the JAX package sums hat weights over all
W columns and rows: at the FAST_SETREF=False path's B x K x K samples the
dense form's (..., 49, W, 3) intermediate would take ~0.9 GB per batch of
2048. The plain refiner (_optimize_patch) differentiates its objective with
torch.func.jacfwd, so it samples with `hat_sample`, the dense form written
so that its forward-mode derivatives at the kinks are JAX's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hpmvs_tpu_torch.geom import camera as cam_ops
from hpmvs_tpu_torch.ops import fetch, sampling

PATCH_SIZE = sampling.PATCH_SIZE


class WinState(NamedTuple):
    win: torch.Tensor    # (B, K, W, W, 3) float32 pixel windows
    ox: torch.Tensor     # (B, K) int32 window origin x (global, at `level`)
    oy: torch.Tensor     # (B, K) int32 window origin y
    level: torch.Tensor  # (B, K) int32 pyramid level the window was cut at

    @property
    def W(self) -> int:
        return self.win.shape[2]

    @property
    def K(self) -> int:
        return self.win.shape[1]


def window_cut(cams, imgs, ci, center, scale, maxlevel: int, W: int):
    """Where each (patch, view) window is cut: its level (the
    window-fitting level, camera.get_level_fit; the sampling passes use the
    same rule), its origin (ox, oy) at that level, and the flat top row and
    left column the fetch kernel reads, kept inside the buffer as the
    reference's dynamic_slice fetch does (this only bites for levels
    narrower than W). ci, center, scale: (B, K[, 3])."""
    level = cam_ops.get_level_fit(cams, ci, center, scale, maxlevel, W)
    lvl = level.long()
    uvw = cam_ops.project(cams, ci, center, lvl)
    w = imgs.width[ci, lvl]
    h = imgs.height[ci, lvl]
    zero = torch.zeros_like(w)
    ox = torch.minimum(torch.clamp(
        cam_ops.f2i(torch.round(uvw[..., 0])) - W // 2, min=0),
        torch.maximum(w - W, zero))
    oy = torch.minimum(torch.clamp(
        cam_ops.f2i(torch.round(uvw[..., 1])) - W // 2, min=0),
        torch.maximum(h - W, zero))
    # the clamp's bound is this pack's own row count: a per-shard image
    # slab (parallel/subsets.py) is shorter than the replicated pack
    tex = imgs.tex
    rows = torch.clamp(imgs.row0[ci, lvl] + oy, 0, tex.shape[0] - W)
    cols = torch.clamp(ox, 0, tex.shape[1] - W)
    return (level, ox, oy, rows.reshape(-1).to(torch.int32).contiguous(),
            cols.reshape(-1).to(torch.int32).contiguous())


def fetch_windows_t(cams, imgs, ci, center, scale, maxlevel: int, W: int,
                    fetch_mask=None, prev: WinState = None) -> WinState:
    """Cut a W x W window around the projected patch centre in each view
    (without fetch_mask and prev: every slot, as windows.fetch_windows of
    the JAX package cuts them for the per-patch stages).

    ci: (B, K) int; center: (B, K, 3); scale: (B, K). fetch_mask (B, K)
    bool: slots with False are not read; with `prev` they keep prev's
    window, origin and level (the post stage reuses the pre-stage windows of
    surviving view slots; only newly added views are read), without it
    their window is zero. Validity of a reused window is enforced
    downstream by the level/coverage gates (score._geometry)."""
    ci = ci.long()
    B, K = ci.shape
    level, ox, oy, rows, cols = window_cut(cams, imgs, ci, center, scale,
                                           maxlevel, W)
    mask = None if fetch_mask is None else fetch_mask.reshape(-1)
    pw = None if prev is None else prev.win.reshape(B * K, W, W, 3)
    win = fetch.fetch_windows(imgs.tex, rows, cols, W, mask=mask,
                              prev=pw).reshape(B, K, W, W, 3)
    if prev is None:
        return WinState(win=win, ox=ox, oy=oy, level=level)
    return WinState(win=win,
                    ox=torch.where(fetch_mask, ox, prev.ox),
                    oy=torch.where(fetch_mask, oy, prev.oy),
                    level=torch.where(fetch_mask, level, prev.level))


def sample_from_windows(cams, imgs, ws: WinState, ci, center, scale, xaxis,
                        yaxis, zaxis, max_angle_cos, maxlevel: int):
    """Windowed sampling.sample_texture: same angle / margin / level
    semantics (PatchOptimizer.cpp:476-529), bilinear from the cached windows
    (4 taps per texel). ci (B, K); center/xaxis/yaxis/zaxis (B, K, 3);
    scale (B, K).

    Returns (tex (B, K, 49, 3) normalized, valid (B, K))."""
    from hpmvs_tpu_torch.ops.score import bilinear_taps
    ci = ci.long()
    W = ws.W
    ray = sampling.normalize3(cams.center[ci] - center)
    angle_ok = torch.sum(ray * zaxis, dim=-1) >= max_angle_cos

    level = cam_ops.get_level_fit(cams, ci, center, scale, maxlevel, W)
    level_ok = level == ws.level
    level = ws.level.long()   # sample at the window's level

    c2 = cam_ops.project(cams, ci, center, level)[..., :2]
    dx = cam_ops.project(cams, ci, center + xaxis, level)[..., :2] - c2
    dy = cam_ops.project(cams, ci, center + yaxis, level)[..., :2] - c2
    tl, mn, mx = grid_box(c2, dx, dy)

    m = 3.0
    w = imgs.width[ci, level].to(c2.dtype)
    h = imgs.height[ci, level].to(c2.dtype)
    bounds_ok = ((mn[..., 0] >= m) & (mn[..., 1] >= m)
                 & (mx[..., 0] < w - m) & (mx[..., 1] < h - m))
    # window coverage: the whole grid must lie inside [0, W-1] locally
    org = torch.stack([ws.ox, ws.oy], dim=-1).to(c2.dtype)
    cover_ok = (torch.all(mn - org >= 0.0, dim=-1)
                & torch.all(mx - org <= W - 1.0, dim=-1))
    valid = angle_ok & bounds_ok & level_ok & cover_ok

    gx, gy = local_grid(tl, dx, dy, ws)
    tex = bilinear_taps(ws.win, torch.clamp(gx, 0.0, W - 1.0),
                        torch.clamp(gy, 0.0, W - 1.0))
    return sampling.normalize_tex(tex), valid


def grid_box(c2, dx, dy):
    """Top-left corner and bounding box of the projected 7x7 grid."""
    half = PATCH_SIZE / 2.0
    tl = c2 - half * dx - half * dy
    tr = c2 + half * dx - half * dy
    bl = c2 - half * dx + half * dy
    br = c2 + half * dx + half * dy
    mn = torch.minimum(torch.minimum(tl, tr), torch.minimum(bl, br))
    mx = torch.maximum(torch.maximum(tl, tr), torch.maximum(bl, br))
    return tl, mn, mx


def local_grid(tl, dx, dy, ws: WinState):
    """Window-local texel coordinates (..., 49) of the grid p(yy, xx) =
    tl + xx*dx + yy*dy (PatchOptimizer.cpp:511-524), unclipped."""
    ii = torch.arange(PATCH_SIZE, dtype=tl.dtype, device=tl.device)
    P2 = PATCH_SIZE * PATCH_SIZE
    gx = (tl[..., None, None, 0] + ii[None, :] * dx[..., None, None, 0]
          + ii[:, None] * dy[..., None, None, 0])
    gy = (tl[..., None, None, 1] + ii[None, :] * dx[..., None, None, 1]
          + ii[:, None] * dy[..., None, None, 1])
    gx = gx.reshape(gx.shape[:-2] + (P2,)) - ws.ox[..., None].to(tl.dtype)
    gy = gy.reshape(gy.shape[:-2] + (P2,)) - ws.oy[..., None].to(tl.dtype)
    return gx, gy


def jax_abs(u):
    """|u| whose forward-mode derivative at 0 is +1, as jnp.abs's is
    (torch.abs's is 0)."""
    return torch.where(u >= 0, u, -u)


def jax_clip(v, lo: float, hi: float):
    """jnp.clip(v, lo, hi) = minimum(hi, maximum(lo, v)): at a bound the
    forward-mode derivative is 0.5 (torch.clamp's is 1)."""
    return torch.minimum(torch.maximum(v, torch.full_like(v, lo)),
                         torch.full_like(v, hi))


def hat_sample(win, gx, gy):
    """Bilinear sampling as dense hat-weight contractions (windows.hat_sample
    of the JAX package), with JAX's derivatives at the kinks: hat(u) =
    max(0, 1 - |u|) takes slope -1 at u = 0 (jnp.abs) and half the slope at
    |u| = 1 (a tie of the maximum), so torch.func.jacfwd through it equals
    jax.jacfwd. win (..., W, W, 3); gx/gy (..., T). Returns (..., T, 3)."""
    W = win.shape[-2]
    jw = torch.arange(W, dtype=gx.dtype, device=gx.device)

    def hat(u):
        return torch.maximum(torch.zeros_like(u), 1.0 - jax_abs(u))

    Ax = hat(gx[..., None] - jw)                       # (..., T, W)
    Ay = hat(gy[..., None] - jw)
    tmp = torch.einsum("...tx,...yxc->...tyc", Ax, win)
    return torch.einsum("...ty,...tyc->...tc", Ay, tmp)
