"""Kernels B2 and B3: view-texture sampling for the NCC stages, and the
window-slot permutation.

Replaces hpmvs_tpu/ops/pallas_score.py (_sample_pallas, _permute_pallas).
The view-selection pipeline around the refiner (filterImagesNCC,
setRefImage -- src/hpmvs/PatchOptimizer.cpp:138-181, 448-474) samples the
7x7 patch texture of every view slot from the cached windows. The geometry
(projected patch grid: top-left + du/dv per view) and every validity gate
are small (B, K) tensors computed here with plain torch ops; the kernel
(csrc/score.cu) does the sampling and Patch2d normalisation
(Patch2d.hpp:37-84). csrc/permute.cu reorders window slots.
"""

from __future__ import annotations

import ctypes

import torch

from hpmvs_tpu_torch import kernels
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.geom import camera as cam_ops
from hpmvs_tpu_torch.ops import sampling
from hpmvs_tpu_torch.ops.windows import WinState

P = sampling.PATCH_SIZE
P2 = P * P
CHALF = P / 2.0   # the true projected center sits at tl + 3.5*(du+dv);
                  # the grid texels are tl + i*(du,dv), i in [0,7) -- texel
                  # (3,3) is half a texel off (reference sampleTexture
                  # convention, PatchOptimizer.cpp:495-523)


def _geometry(ctx, opt: Options, center, normal, scale, views, ws: WinState):
    """Per-view sampling geometry + validity (PatchOptimizer::sampleTexture
    gates, PatchOptimizer.cpp:476-529): angle gate against
    normalize(normal), level pinned to the window's level, image-bounds
    margin 3, window-coverage gate.

    Returns (tl_local, du, dv -- (B, K, 2) at the window's level,
             valid (B, K) bool)."""
    cams, imgs = ctx.cams, ctx.imgs
    ci = torch.clamp(views, min=0).long()
    nz = sampling.normalize3(normal)                    # (B, 3)
    ref_ci = torch.clamp(views[:, 0], min=0)
    xax, yax, _ = sampling.patch_axes(cams, ref_ci, normal, scale)

    ray = sampling.normalize3(cams.center[ci] - center[:, None])
    angle_ok = (torch.sum(ray * nz[:, None], dim=-1)
                >= sampling.cos32(opt.MAX_ANGLE))

    cb = center[:, None].expand(ci.shape + (3,))
    lvl = cam_ops.get_level_fit(cams, ci, cb, scale[:, None].expand(ci.shape),
                                opt.MAXLEVEL - 1, ws.W)
    level_ok = lvl == ws.level
    level = ws.level.long()

    c2 = cam_ops.project(cams, ci, cb, level)[..., :2]
    du = cam_ops.project(cams, ci, cb + xax[:, None], level)[..., :2] - c2
    dv = cam_ops.project(cams, ci, cb + yax[:, None], level)[..., :2] - c2

    half = P / 2.0
    tl = c2 - half * du - half * dv
    tr = c2 + half * du - half * dv
    bl = c2 - half * du + half * dv
    br = c2 + half * du + half * dv
    mn = torch.minimum(torch.minimum(tl, tr), torch.minimum(bl, br))
    mx = torch.maximum(torch.maximum(tl, tr), torch.maximum(bl, br))

    m = 3.0
    w = imgs.width[ci, level].to(c2.dtype)
    h = imgs.height[ci, level].to(c2.dtype)
    bounds_ok = ((mn[..., 0] >= m) & (mn[..., 1] >= m)
                 & (mx[..., 0] < w - m) & (mx[..., 1] < h - m))

    org = torch.stack([ws.ox, ws.oy], dim=-1).to(c2.dtype)
    cover_ok = (torch.all(mn - org >= 0.0, dim=-1)
                & torch.all(mx - org <= ws.W - 1.0, dim=-1))

    valid = angle_ok & bounds_ok & level_ok & cover_ok
    return tl - org, du, dv, valid


def sample_views_batch(ctx, opt: Options, center, normal, scale, views,
                       ws: WinState, with_color=False):
    """Texture of every view slot from the cached windows.

    center (B,3), normal (B,3), scale (B,), views (B,K), ws over (B,K).
    Returns (tex (B,K,49,3) normalized, valid (B,K) bool[, col (B,K,3)]);
    valid does NOT include views >= 0. col is the raw bilinear RGB at the
    patch centre per slot -- the pixel Scene::getColor fetches
    (Scene.cpp:311-315), at the window's level (documented divergence:
    capped at MAXLEVEL-1, where getColor caps at MAXLEVEL)."""
    tl, du, dv, valid = _geometry(ctx, opt, center, normal, scale, views, ws)
    geom = torch.cat([tl, du, dv], dim=-1).contiguous()     # (B, K, 6)
    tex, col = sample_windows(geom, ws.win, with_color)
    if with_color:
        return tex, valid, col
    return tex, valid


def sample_windows(geom, win, with_color: bool = False):
    """Kernel B2. geom (B, K, 6) = tlx, tly, dux, duy, dvx, dvy in window
    pixels; win (B, K, W, W, 3) f32. Returns (tex (B, K, 49, 3), col
    (B, K, 3) or None)."""
    if not geom.is_cuda:
        return sample_windows_twin(geom, win, with_color)
    B, K = geom.shape[:2]
    W = win.shape[2]
    kernels.check(geom, "geom", torch.float32, (B, K, 6))
    kernels.check(win, "win", torch.float32, (B, K, W, W, 3))
    tex = torch.empty((B, K, P2, 3), dtype=torch.float32, device=geom.device)
    col = (torch.empty((B, K, 3), dtype=torch.float32, device=geom.device)
           if with_color else None)
    kernels.launch("hpmvs_sample_views", kernels.ptr(geom), kernels.ptr(win),
                   kernels.ptr(tex), kernels.ptr(col), ctypes.c_int(B * K),
                   ctypes.c_int(W))
    kernels.STATS["score"].launches += 1
    return tex, col


def _grid_taps(g, W: int):
    """4-tap bilinear decomposition of coordinates g clipped to [0, W-1]:
    (i0, w0, w1, active) with the hat weights of taps i0 and i0+1
    (csrc/common.cuh::taps)."""
    i0 = torch.clamp(torch.floor(g), 0, W - 2)
    u = g - i0
    w0 = 1.0 - torch.abs(u)
    w1 = 1.0 - torch.abs(g - (i0 + 1.0))
    return i0.long(), w0, w1, (u > 0.0) & (u < 1.0)


def _taps4(win, tx, ty):
    """Gather the 4 taps of each sample: win (..., W, W, 3), tap indices
    (..., T). Returns a, b, c, d (..., T, 3) = (y0,x0), (y0,x1), (y1,x0),
    (y1,x1)."""
    W = win.shape[-2]
    flat = win.reshape(win.shape[:-3] + (W * W, 3))
    base = ty * W + tx

    def g(off):
        idx = (base + off)[..., None].expand(base.shape + (3,))
        return torch.gather(flat, -2, idx)

    return g(0), g(1), g(W), g(W + 1)


def bilinear_taps(win, gx, gy, with_grad: bool = False):
    """Bilinear samples of win (..., W, W, 3) at clipped local coordinates
    gx, gy (..., T); with_grad also returns the partials d/dgx, d/dgy.
    Plain PyTorch form of csrc/common.cuh::bilinear3(_grad)."""
    W = win.shape[-2]
    ix, wx0, wx1, ax = _grid_taps(gx, W)
    iy, wy0, wy1, ay = _grid_taps(gy, W)
    a, b, c, d = _taps4(win, ix, iy)
    wx0, wx1, wy0, wy1 = (t[..., None] for t in (wx0, wx1, wy0, wy1))
    t0 = wx0 * a + wx1 * b
    t1 = wx0 * c + wx1 * d
    val = wy0 * t0 + wy1 * t1
    if not with_grad:
        return val
    gyv = torch.where(ay[..., None], t1 - t0, torch.zeros_like(t0))
    s0 = wy0 * a + wy1 * c
    s1 = wy0 * b + wy1 * d
    gxv = torch.where(ax[..., None], s1 - s0, torch.zeros_like(s0))
    return val, gxv, gyv


def seq_sum(t, dim: int):
    """Sum along dim as the twins need it. On CUDA tensors, where a twin is
    held against its kernel, one element at a time in index order (the
    kernels' loop order), so the two round alike; on the CPU, where the
    twins are held against the JAX package, torch.sum (neither order is
    XLA's)."""
    if not t.is_cuda:
        return torch.sum(t, dim=dim)
    t = t.movedim(dim, 0)
    acc = t[0]
    for i in range(1, t.shape[0]):
        acc = acc + t[i]
    return acc


def div(t, c: float):
    """t / c rounded once. On CUDA torch evaluates tensor / python_scalar as
    t * (1 / c), which rounds twice; the kernels divide."""
    return t / torch.tensor(c, dtype=t.dtype, device=t.device)


def normalize_patch(tex):
    """Patch2d::normalize on (..., 49, 3) as the kernels compute it: centred
    values times 1/std (1 when std is 0), sums in the kernels' order (texels,
    then channels). Returns (cen, inv (..., 1, 1))."""
    mc = div(seq_sum(tex, -2), P2)[..., None, :]
    cen = tex - mc
    var = seq_sum(seq_sum(cen * cen, -2), -1)[..., None, None]
    sd = torch.sqrt(div(var, P2 * 3.0))
    inv = torch.where(sd == 0.0, torch.ones_like(sd), 1.0 / sd)
    return cen * inv, inv


def sampling_grid(device):
    """(49,) float32 texel column and row indices of the 7x7 grid."""
    ii = torch.arange(P2, device=device)
    return (ii % P).to(torch.float32), (ii // P).to(torch.float32)


def sample_windows_twin(geom, win, with_color: bool = False):
    """Plain PyTorch version of the sampling kernel (same contract)."""
    kernels.STATS["score"].twin_calls += 1
    W = win.shape[2]
    IX, IY = sampling_grid(geom.device)
    g = geom[..., None]                                  # (B, K, 6, 1)
    gx = torch.clamp(g[:, :, 0] + IX * g[:, :, 2] + IY * g[:, :, 4],
                     0.0, W - 1.0)
    gy = torch.clamp(g[:, :, 1] + IX * g[:, :, 3] + IY * g[:, :, 5],
                     0.0, W - 1.0)
    tex, _ = normalize_patch(bilinear_taps(win, gx, gy))
    col = None
    if with_color:
        gxc = torch.clamp(g[:, :, 0] + CHALF * (g[:, :, 2] + g[:, :, 4]),
                          0.0, W - 1.0)
        gyc = torch.clamp(g[:, :, 1] + CHALF * (g[:, :, 3] + g[:, :, 5]),
                          0.0, W - 1.0)
        col = bilinear_taps(win, gxc, gyc)[:, :, 0]
    return tex, col


# ---------------------------------------------------------------------------
# Slot permutation of the window cache (kernel B3).
# ---------------------------------------------------------------------------

def permute_ws(ws: WinState, order) -> WinState:
    """View-slot permutation of a window cache. order: (B, K) int, new slot
    k holds old slot order[b, k] (always a permutation)."""
    o = order.long()
    return WinState(win=permute_windows(ws.win, order.to(torch.int32)),
                    ox=torch.gather(ws.ox, 1, o),
                    oy=torch.gather(ws.oy, 1, o),
                    level=torch.gather(ws.level, 1, o))


def permute_windows(win, order):
    """Kernel B3: out[b, k] = win[b, order[b, k]]. win (B, K, W, W, 3) f32,
    order (B, K) int32."""
    if not win.is_cuda:
        return permute_windows_twin(win, order)
    B, K, W = win.shape[:3]
    kernels.check(win, "win", torch.float32, (B, K, W, W, 3))
    kernels.check(order, "order", torch.int32, (B, K))
    per_win = W * W * 3
    out = torch.empty_like(win)
    if per_win % 4 or win.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("permute_windows: windows must be 16-byte aligned "
                         "multiples of 4 floats")
    kernels.launch("hpmvs_permute_windows", kernels.ptr(win),
                   kernels.ptr(order), kernels.ptr(out), ctypes.c_int(B),
                   ctypes.c_int(K), ctypes.c_int(per_win))
    kernels.STATS["permute"].launches += 1
    return out


def permute_windows_twin(win, order):
    """Plain PyTorch version of the permutation kernel."""
    kernels.STATS["permute"].twin_calls += 1
    B, K = order.shape
    return win[torch.arange(B, device=win.device)[:, None], order.long()]
