"""Batched 7x7 patch-texture sampling and NCC scoring.

Behavioral equivalent of the reference hot path:
  - PatchOptimizer::sampleTexture (src/hpmvs/PatchOptimizer.cpp:476-529):
    project patch center + tangent axes into the view at the patch's pyramid
    level, walk a 7x7 grid in image space, bilinear-fetch RGB.
  - Patch2d::normalize / dot (include/hpmvs/Patch2d.hpp:37-84): subtract
    per-channel mean, divide by global std; NCC = mean elementwise product.
  - PatchOptimizer::calculatePatchAxis (PatchOptimizer.cpp:532-548).

Plain tensor code over arbitrary leading dims. The engine's hot loop samples
from cached windows instead (ops/score.py, ops/gn.py); `sample_texture` is
the direct full-image path those windows are checked against.
"""

from __future__ import annotations

import numpy as np
import torch

from hpmvs_tpu_torch.geom import camera as cam_ops

PATCH_SIZE = 7
N_TEXELS = PATCH_SIZE * PATCH_SIZE * 3


def cos32(angle: float) -> float:
    """cos evaluated in float32, as jnp.cos(python_float) is in the JAX
    package's stage gates (the GN kernel uses math.cos instead)."""
    return float(torch.cos(torch.tensor(angle, dtype=torch.float32)))


def normalize3(v, eps=1e-12):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)


def bilinear(tex, row0, width, ci, level, x, y):
    """Bilinear RGB fetch from the packed 2D buffer.

    tex: (rows, wmax, 3); row0/width: (ncam, nlevel) tables; ci/level/x/y:
    broadcastable (...,) tensors. Matches Image::getColor (Image.h:89-115):
    integer truncation of the top-left texel (callers guarantee x,y >= 0).
    Returns (..., 3) float32.
    """
    base = row0[ci.long(), level.long()]
    lx = torch.floor(x).to(torch.int64)
    ly = torch.floor(y).to(torch.int64)
    dx1 = (x - lx)[..., None]
    dy1 = (y - ly)[..., None]
    r = base + ly
    c = (tex[r, lx] * ((1 - dx1) * (1 - dy1)) + tex[r, lx + 1] * (dx1 * (1 - dy1))
         + tex[r + 1, lx] * ((1 - dx1) * dy1) + tex[r + 1, lx + 1] * (dx1 * dy1))
    return c


def patch_axes(cams, ref_ci, normal, scale):
    """Reference-camera-aligned tangent frame (PatchOptimizer.cpp:532-548).

    normal: (..., 3) (need not be unit); scale: (...,).
    Returns (xaxis, yaxis, zaxis): xaxis/yaxis scaled by `scale`, zaxis unit.
    """
    ref_ci = ref_ci.long()
    z = normalize3(normal)
    cam_x = cams.xaxis[ref_ci]
    y = normalize3(torch.linalg.cross(z, cam_x, dim=-1))
    x = normalize3(torch.linalg.cross(y, z, dim=-1))
    x = x * scale[..., None]
    ys = y * scale[..., None]
    # y *= dot(unit_y, unit_cam_y): aligns/flips y toward the camera's y axis
    cam_y = normalize3(cams.yaxis[ref_ci])
    ys = ys * torch.sum(y * cam_y, dim=-1, keepdim=True)
    return x, ys, z


def sample_texture(cams, imgs, ci, center, scale, xaxis, yaxis, zaxis,
                   max_angle_cos, maxlevel):
    """Sample the 7x7x3 patch texture in view ci (PatchOptimizer.cpp:476-529).

    imgs: ImagePack of device tensors. ci: (...,) int; center/xaxis/yaxis/
    zaxis: (..., 3); scale: (...,).
    Returns (tex (..., 49, 3) normalized, valid (...,) bool).
    """
    ci = ci.long()
    ray = normalize3(cams.center[ci] - center)
    angle_ok = torch.sum(ray * zaxis, dim=-1) >= max_angle_cos

    level = cam_ops.get_leveli(cams, ci, center, scale, maxlevel).long()
    c2 = cam_ops.project(cams, ci, center, level)[..., :2]
    dx = cam_ops.project(cams, ci, center + xaxis, level)[..., :2] - c2
    dy = cam_ops.project(cams, ci, center + yaxis, level)[..., :2] - c2

    half = PATCH_SIZE / 2.0  # 3.5, as in the reference (texture.size()/2.0f)
    tl = c2 - half * dx - half * dy
    tr = c2 + half * dx - half * dy
    bl = c2 - half * dx + half * dy
    br = c2 + half * dx + half * dy
    mn = torch.minimum(torch.minimum(tl, tr), torch.minimum(bl, br))
    mx = torch.maximum(torch.maximum(tl, tr), torch.maximum(bl, br))

    m = 3.0  # safety margin (PatchOptimizer.cpp:503)
    w = imgs.width[ci, level].to(c2.dtype)
    h = imgs.height[ci, level].to(c2.dtype)
    bounds_ok = ((mn[..., 0] >= m) & (mn[..., 1] >= m)
                 & (mx[..., 0] < w - m) & (mx[..., 1] < h - m))
    valid = angle_ok & bounds_ok

    # grid: p(yy, xx) = tl + xx*dx + yy*dy  (PatchOptimizer.cpp:511-524)
    ii = torch.arange(PATCH_SIZE, dtype=c2.dtype, device=c2.device)
    gx = (tl[..., None, None, 0] + ii[None, :] * dx[..., None, None, 0]
          + ii[:, None] * dy[..., None, None, 0])
    gy = (tl[..., None, None, 1] + ii[None, :] * dx[..., None, None, 1]
          + ii[:, None] * dy[..., None, None, 1])
    gx = gx.reshape(gx.shape[:-2] + (PATCH_SIZE * PATCH_SIZE,))
    gy = gy.reshape(gy.shape[:-2] + (PATCH_SIZE * PATCH_SIZE,))

    # clamp so invalid patches still gather in-bounds (masked out by
    # `valid`); written as jnp.clip is (minimum of maximum), so that
    # torch.func.jacfwd through it takes JAX's derivative at the bounds
    zero = torch.zeros_like(gx)
    gx = torch.minimum(torch.maximum(gx, zero),
                       torch.clamp(w[..., None] - 2.0, min=0.0))
    gy = torch.minimum(torch.maximum(gy, zero),
                       torch.clamp(h[..., None] - 2.0, min=0.0))

    tex = bilinear(imgs.tex, imgs.row0, imgs.width,
                   ci[..., None], level[..., None], gx, gy)  # (..., 49, 3)
    return normalize_tex(tex), valid


def normalize_tex(tex):
    """Patch2d::normalize (Patch2d.hpp:46-84): per-channel mean removal,
    global std division."""
    mean = torch.mean(tex, dim=-2, keepdim=True)             # per channel
    centered = tex - mean
    var = torch.sum(centered * centered, dim=(-1, -2), keepdim=True) / N_TEXELS
    std = torch.sqrt(var)
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    return centered / std


def ncc(tex_a, tex_b):
    """Patch2d::dot (Patch2d.hpp:37-44): mean of elementwise product."""
    return torch.sum(tex_a * tex_b, dim=(-1, -2)) / N_TEXELS


def robust_incc(x):
    """robustincc r/(1+3r) (PatchOptimizer.h:92-98)."""
    return x / (1.0 + 3.0 * x)


def np_reference_sample(tex_plane: np.ndarray, P: np.ndarray, cam_center,
                        cam_xaxis, cam_yaxis, center, normal, scale,
                        max_angle_cos: float):
    """Tiny NumPy reimplementation of the reference sampling math for tests.

    tex_plane: (H, W, 3) image at the chosen level; P: (3, 4) projection at
    that level. Level selection is the caller's job. Scalar, unbatched, written
    directly from PatchOptimizer.cpp:476-529 semantics for golden comparison.
    """
    z = np.asarray(normal, dtype=np.float64)
    z = z / np.linalg.norm(z)
    ray = np.asarray(cam_center) - np.asarray(center)
    ray = ray / np.linalg.norm(ray)
    if float(ray @ z) < max_angle_cos:
        return None
    y = np.cross(z, cam_xaxis)
    y /= np.linalg.norm(y)
    x = np.cross(y, z)
    x /= np.linalg.norm(x)
    x = x * scale
    ys = y * scale
    cy = cam_yaxis / np.linalg.norm(cam_yaxis)
    ys = ys * float(y @ cy)

    def proj(p):
        ph = P @ np.append(p, 1.0)
        return ph[:2] / ph[2]

    c2 = proj(center)
    dx = proj(center + x) - c2
    dy = proj(center + ys) - c2
    half = 3.5
    corners = [c2 - half * dx - half * dy, c2 + half * dx - half * dy,
               c2 - half * dx + half * dy, c2 + half * dx + half * dy]
    mn = np.min(corners, axis=0)
    mx = np.max(corners, axis=0)
    h, w = tex_plane.shape[:2]
    if mn[0] < 3 or mn[1] < 3 or mx[0] >= w - 3 or mx[1] >= h - 3:
        return None
    tl = corners[0]
    out = np.zeros((7, 7, 3), dtype=np.float64)
    img = tex_plane.astype(np.float64)
    for yy in range(7):
        for xx in range(7):
            px, py = tl + xx * dx + yy * dy
            lx, ly = int(px), int(py)
            fx, fy = px - lx, py - ly
            out[yy, xx] = (img[ly, lx] * (1 - fx) * (1 - fy)
                           + img[ly, lx + 1] * fx * (1 - fy)
                           + img[ly + 1, lx] * (1 - fx) * fy
                           + img[ly + 1, lx + 1] * fx * fy)
    flat = out.reshape(49, 3)
    mean = flat.mean(axis=0)
    centered = flat - mean
    std = np.sqrt((centered ** 2).sum() / 147.0)
    if std == 0:
        std = 1.0
    return (centered / std).reshape(7, 7, 3)
