"""Depth z-buffer pyramid with batched scatter-min updates and visibility tests.

Behavioral equivalent of the reference Scene depth machinery
(src/hpmvs/Scene.cpp:351-644, include/hpmvs/Scene.h:74-106): a subsampled
(factor 2) min-depth buffer per (image, pyramid level), initialized to
MAX_DEPTH = 1000, with
  - setDepths: per visible view scatter-min of the patch depth (subtract mode
    resets the cell to MAX_DEPTH when it still holds this patch's depth)
  - depthTest: level-0 projection, 3x3 neighborhood, tolerance
    scale * margin * min(2, 2 + ray.normal) * 2 against getFullDepth
    (min across the whole pyramid)
  - viewBlockTest: is the patch floating in front of a confirmed surface, over
    ALL images
  - pixelFreeTest: is the buffer cell at the patch's own level still empty.

All buffers are packed into ONE flat float32 device tensor; updates are
batched Tensor.scatter_reduce_ ("amin"/"amax") over (B patches x K views),
applied in place (the engine owns the one buffer). The 3x3 tests are written
in the difference form of the reference (|full_depth - d| against the
tolerance, per neighbour) and read the collapsed full-depth buffer when every
camera shares the pyramid dims; with DEPTH_SUBSAMPLE=2 they read its 2x2
pools instead (pool_full_depth: 2 gathers per (lane, image) instead of 9),
in the same difference form and bitwise equal to the 9-gather path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from hpmvs_tpu_torch import resolve_device, trace
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.geom import camera as cam_ops

MAX_DEPTH = 1000.0


@dataclasses.dataclass
class DepthPack:
    depth: torch.Tensor   # (total_cells,) float32
    offset: torch.Tensor  # (ncam, nlevel) int32
    width: torch.Tensor   # (ncam, nlevel) int32  (cols)
    height: torch.Tensor  # (ncam, nlevel) int32  (rows)


def build_depth_pack(img_width: np.ndarray, img_height: np.ndarray,
                     subsample: int = 2, device="cuda") -> DepthPack:
    """Allocate per-(image,level) buffers of (H/subsample, W/subsample)
    (Scene.cpp:74-81, integer division) on `device` (the GPU unless
    device="cpu")."""
    device = resolve_device(device)
    ncam, nlevel = img_width.shape
    offset = np.zeros((ncam, nlevel), dtype=np.int32)
    width = np.zeros((ncam, nlevel), dtype=np.int32)
    height = np.zeros((ncam, nlevel), dtype=np.int32)
    pos = 0
    for ci in range(ncam):
        for lv in range(nlevel):
            w = int(img_width[ci, lv]) // subsample
            h = int(img_height[ci, lv]) // subsample
            offset[ci, lv] = pos
            width[ci, lv] = w
            height[ci, lv] = h
            pos += w * h
    return DepthPack(
        depth=torch.full((pos,), MAX_DEPTH, dtype=torch.float32, device=device),
        offset=torch.as_tensor(offset, device=device),
        width=torch.as_tensor(width, device=device),
        height=torch.as_tensor(height, device=device))


def _patch_view_cells(pack: DepthPack, cams, centers, scales, views,
                      subsample: int):
    """Per (patch, view): flat buffer index + depth (Scene::setDepths
    projection, Scene.cpp:352-367). Returns (idx, d, valid)."""
    ci = torch.clamp(views, min=0).long()           # (B, K)
    B, K = views.shape
    cc = centers[:, None, :].expand(B, K, 3)
    ss = scales[:, None].expand(B, K)
    lvl = cam_ops.get_leveli(cams, ci, cc, ss, cams.n_levels - 1).long()
    imgC = cam_ops.mult(cams, ci, cc, lvl)           # (B, K, 3)
    d = imgC[..., 2]
    x = torch.div(cam_ops.f2i(imgC[..., 0] / d + 0.5), subsample,
                  rounding_mode="floor")
    y = torch.div(cam_ops.f2i(imgC[..., 1] / d + 0.5), subsample,
                  rounding_mode="floor")
    w = pack.width[ci, lvl]
    h = pack.height[ci, lvl]
    valid = (views >= 0) & (d >= 0) & (x >= 0) & (x < w) & (y >= 0) & (y < h)
    idx = pack.offset[ci, lvl] + y * w + x
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    return idx, d, valid


def apply_phased_updates(pack: DepthPack, cams, centers, scales, views,
                         phase, subsample: int = 2) -> DepthPack:
    """Ordered batch of deferred setDepths updates in ONE pass, in place on
    pack.depth: phase 0 adds (scatter-min), then phase 1 subtracts
    (reset-to-MAX-if-equal, Scene.cpp:369-379), then phase 2 adds. Phase runs
    reproduce the sequential add*/sub*/add* order the engine deferred;
    entries project once (idx/d shared across phases)."""
    with trace.span("depth.updates"):
        idx, d, valid = _patch_view_cells(pack, cams, centers, scales, views,
                                          subsample)
        idx = idx.reshape(-1).long()
        d = d.reshape(-1)
        K = views.shape[1]
        # (expand, not repeat_interleave: its output size can cost a host
        # sync)
        ph = phase[:, None].expand(-1, K).reshape(-1)
        valid = valid.reshape(-1)
        depth = pack.depth
        inf = torch.full_like(d, float("inf"))
        depth.scatter_reduce_(0, idx, torch.where(valid & (ph == 0), d, inf),
                              "amin")
        hit = valid & (ph == 1) & (depth[idx] == d)
        depth.scatter_reduce_(0, torch.where(hit, idx, torch.zeros_like(idx)),
                              torch.where(hit, torch.full_like(d, MAX_DEPTH),
                                          -inf), "amax")
        depth.scatter_reduce_(0, idx, torch.where(valid & (ph == 2), d, inf),
                              "amin")
    return pack


def apply_depth_updates(pack: DepthPack, cams, centers, scales, views,
                        phase, subsample: int = 2) -> DepthPack:
    """Standalone flush of deferred phased depth updates (the engine's
    _flush_depths)."""
    return apply_phased_updates(pack, cams, centers, scales, views, phase,
                                subsample)


def _floordiv(v, d):
    return torch.div(v, d, rounding_mode="floor")


def get_depth_at_level(pack: DepthPack, ci, x, y, level, subsample: int = 2):
    """Scene::getDetphAtLevel (Scene.cpp:383-404)."""
    xs = _floordiv(x, subsample)
    ys = _floordiv(y, subsample)
    w = pack.width[ci, level]
    h = pack.height[ci, level]
    inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    idx = torch.where(inb, pack.offset[ci, level] + ys * w + xs,
                      torch.zeros_like(xs))
    return torch.where(inb, pack.depth[idx.long()],
                       torch.full_like(pack.depth[:1], MAX_DEPTH))


def get_full_depth(pack: DepthPack, ci, x, y, n_levels: int,
                   subsample: int = 2):
    """Scene::getFullDepth (Scene.cpp:406-431): min over the pyramid,
    stopping at the first out-of-bounds level."""
    shape = torch.broadcast_shapes(ci.shape, x.shape)
    depth = torch.full(shape, MAX_DEPTH, dtype=torch.float32,
                       device=pack.depth.device)
    alive = torch.ones(shape, dtype=torch.bool, device=pack.depth.device)
    xs = _floordiv(x, subsample)
    ys = _floordiv(y, subsample)
    for lv in range(n_levels):
        w = pack.width[ci, lv]
        h = pack.height[ci, lv]
        inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        alive = alive & inb
        idx = torch.where(alive, pack.offset[ci, lv] + ys * w + xs,
                          torch.zeros_like(xs))
        depth = torch.where(alive, torch.minimum(depth, pack.depth[idx.long()]),
                            depth)
        xs = _floordiv(xs, 2)
        ys = _floordiv(ys, 2)
    return depth


def collapse_full_depth(depth, layout, ncam: int):
    """Collapse the per-level z-buffer pyramid into ONE level-0-resolution
    full-depth buffer: out[c, y, x] == get_full_depth(pack, c, x*ss, y*ss)
    for every level-0 (subsampled) cell -- the pyramid min with the exact
    stop-at-first-out-of-bounds rule of Scene::getFullDepth
    (Scene.cpp:406-431), reproduced by an `alive` mask that goes false at
    the first level whose cell is out of bounds and stays false.

    layout: tuple of per-level pack dims ((h0,w0),(h1,w1),...), valid when
    every camera shares them (the engine passes None otherwise and the gates
    take the per-level pyramid lookups). Dense repeats + mins, no gathers;
    the gates then read one cell per (lane, view, neighbour)."""
    h0, w0 = layout[0]
    S = sum(h * w for h, w in layout)
    d2 = depth.reshape(ncam, S)
    acc = d2[:, :h0 * w0].reshape(ncam, h0, w0)
    dev = depth.device
    ys = torch.arange(h0, device=dev)[:, None]
    xs = torch.arange(w0, device=dev)[None, :]
    alive = torch.ones((h0, w0), dtype=torch.bool, device=dev)
    pre = h0 * w0
    for lv in range(1, len(layout)):
        h, w = layout[lv]
        f = 1 << lv
        # in-bounds at this level: the L0 cell's ancestor (y>>lv, x>>lv)
        # exists; empty slabs (h*w == 0) kill every cell from here down
        alive = alive & (ys < h * f) & (xs < w * f)
        if h > 0 and w > 0:
            slab = d2[:, pre:pre + h * w].reshape(ncam, h, w)
            up = slab[:, :, None, :, None].expand(ncam, h, f, w, f).reshape(
                ncam, h * f, w * f)
            uh, uw = min(h0, h * f), min(w0, w * f)
            up = up[:, :uh, :uw]
            if uh < h0 or uw < w0:
                up = F.pad(up, (0, w0 - uw, 0, h0 - uh), value=MAX_DEPTH)
            acc = torch.minimum(acc, torch.where(alive[None], up,
                                                 torch.full_like(up, MAX_DEPTH)))
        pre += h * w
    return acc


def pool_full_depth(full0):
    """2x2 forward-window pools of the collapsed full-depth buffer, for
    DEPTH_SUBSAMPLE=2 (the reference constant, Scene.h:74): the 3x3
    full-resolution neighbourhood of Scene::depthTest (Scene.cpp:534-556)
    projects onto exactly the subsampled cells {ix0//2, ix0//2+1} x
    {iy0//2, iy0//2+1} for every alignment of ix0 >= 0, so the 9 gathers
    per (lane, image) become 2 gathers of pooled values.

    Returns (nm_min, nm_max, raw_max), each (ncam, h0, w0): min and max over
    the window of the non-empty cells (+inf / -inf when all are empty), and
    the raw max (>= MAX_DEPTH iff a cell is empty). Cells past the buffer's
    edge count as empty (padding with MAX_DEPTH), as out-of-range cells do
    in the 9-gather path."""
    v = F.pad(full0, (0, 1, 0, 1), value=MAX_DEPTH)
    inf = torch.full_like(v, float("inf"))
    filled = v < MAX_DEPTH
    vm = torch.where(filled, v, inf)
    vM = torch.where(filled, v, -inf)
    h0, w0 = full0.shape[1], full0.shape[2]

    def pool2(a, red):
        b = red(a[:, :h0, :], a[:, 1:h0 + 1, :])
        return red(b[:, :, :w0], b[:, :, 1:w0 + 1])

    return (pool2(vm, torch.minimum), pool2(vM, torch.maximum),
            pool2(v, torch.maximum))


def _depth_test_view_pooled(cams, imgs, centers, normals, scales, ci, margin,
                            view_block: bool, pool3):
    """Scene::depthTest from one pooled cell per (lane, image) (see
    pool_full_depth), in the difference form of _depth_test_at. Subtracting
    one d is monotone in float arithmetic, so max_i fl(x_i - d) equals
    fl(max_i x_i - d): bitwise equal to the 9-gather path.

      depth test: every cell empty, or every non-empty cell within the
                  band: nm_max - d < tol  and  nm_min - d > -tol
      view block: no cell empty and every cell beyond the band,
                  raw_max < MAX_DEPTH  and  nm_min - d > tol"""
    nm_min, nm_max, raw_max = pool3
    imgC = cam_ops.mult(cams, ci, centers, torch.zeros_like(ci))
    d = imgC[..., 2]
    ix0 = cam_ops.f2i(imgC[..., 0] / d + 0.5) - 1
    iy0 = cam_ops.f2i(imgC[..., 1] / d + 0.5) - 1
    w0 = imgs.width[ci, 0]
    h0 = imgs.height[ci, 0]
    # all 9 neighbours in the image (ix0 + 2 < w0 could wrap int32)
    allinb = ((d >= 0) & (ix0 >= 0) & (ix0 < w0 - 2)
              & (iy0 >= 0) & (iy0 < h0 - 2))
    xs = torch.clamp(_floordiv(ix0, 2), 0, nm_min.shape[2] - 1).long()
    ys = torch.clamp(_floordiv(iy0, 2), 0, nm_min.shape[1] - 1).long()

    ray = centers - cams.center[ci]
    ray = ray / torch.clamp(torch.linalg.vector_norm(ray, dim=-1, keepdim=True),
                            min=1e-12)
    factor = torch.clamp(2.0 + torch.sum(ray * normals, dim=-1), max=2.0)
    tol = scales * margin * factor * 2.0
    lo_cell = nm_min[ci, ys, xs]
    lo = lo_cell - d
    if view_block:
        res = (raw_max[ci, ys, xs] < MAX_DEPTH) & (lo > tol)
    else:
        # an all-empty window passes whatever tol is, as its 9 cells do
        res = ((nm_max[ci, ys, xs] - d < tol) & (lo > -tol)) \
            | (lo_cell == float("inf"))
    return res & allinb


def _depth_test_at(pack: DepthPack, cams, imgs, opt: Options, centers,
                   normals, scales, ci, ix, iy, d, margin, view_block: bool,
                   full0=None):
    """Inner Scene::depthTest (Scene.cpp:558-582) at explicit pixel coords,
    in the reference's difference form. full0: optional collapsed
    full-depth buffer (ncam, h0, w0) from collapse_full_depth."""
    w0 = imgs.width[ci, 0]
    h0 = imgs.height[ci, 0]
    inb = (d >= 0) & (ix >= 0) & (ix < w0) & (iy >= 0) & (iy < h0)

    if full0 is not None:
        ss = opt.DEPTH_SUBSAMPLE
        xs = _floordiv(ix, ss)
        ys = _floordiv(iy, ss)
        pw = pack.width[ci, 0]
        ph = pack.height[ci, 0]
        inb0 = (xs >= 0) & (xs < pw) & (ys >= 0) & (ys < ph)
        img_depth = torch.where(
            inb0,
            full0[ci, torch.clamp(ys, 0, full0.shape[1] - 1).long(),
                  torch.clamp(xs, 0, full0.shape[2] - 1).long()],
            torch.full_like(d, MAX_DEPTH))
    else:
        img_depth = get_full_depth(pack, ci, ix, iy, opt.n_levels,
                                   opt.DEPTH_SUBSAMPLE)
    empty = img_depth >= MAX_DEPTH

    ray = centers - cams.center[ci]
    ray = ray / torch.clamp(torch.linalg.vector_norm(ray, dim=-1, keepdim=True),
                            min=1e-12)
    diff = img_depth - d
    factor = torch.clamp(2.0 + torch.sum(ray * normals, dim=-1), max=2.0)
    tol = scales * margin * factor * 2.0
    if view_block:
        res = (diff > tol) & ~empty
    else:
        res = (torch.abs(diff) < tol) | empty
    return res & inb


def _depth_test_view(pack, cams, imgs, opt: Options, centers, normals, scales,
                     ci, margin, view_block: bool, full0=None):
    """Scene::depthTest with 3x3 neighborhood (Scene.cpp:534-556): level-0
    projection; ALL 9 neighbors must pass."""
    imgC = cam_ops.mult(cams, ci, centers, torch.zeros_like(ci))
    d = imgC[..., 2]
    ix0 = cam_ops.f2i(imgC[..., 0] / d + 0.5) - 1
    iy0 = cam_ops.f2i(imgC[..., 1] / d + 0.5) - 1
    res = torch.ones_like(ci, dtype=torch.bool)
    for yy in range(3):
        for xx in range(3):
            res = res & _depth_test_at(pack, cams, imgs, opt, centers, normals,
                                       scales, ci, ix0 + xx, iy0 + yy, d,
                                       margin, view_block, full0=full0)
    return res


def depth_tests(pack: DepthPack, cams, imgs, opt: Options, centers, normals,
                scales, views, margin, full0=None, pool3=None):
    """Scene::depthTests (Scene.cpp:518-524): #views passing the depth test.
    pool3: pool_full_depth(full0), for DEPTH_SUBSAMPLE=2 only."""
    ci = torch.clamp(views, min=0).long()
    B, K = views.shape
    cc = centers[:, None, :].expand(B, K, 3)
    nn = normals[:, None, :].expand(B, K, 3)
    ss = scales[:, None].expand(B, K)
    if pool3 is not None:
        res = _depth_test_view_pooled(cams, imgs, cc, nn, ss, ci, margin,
                                      view_block=False, pool3=pool3)
    else:
        res = _depth_test_view(pack, cams, imgs, opt, cc, nn, ss, ci, margin,
                               view_block=False, full0=full0)
    return torch.sum(res & (views >= 0), dim=-1)


def view_block_test(pack: DepthPack, cams, imgs, opt: Options, centers,
                    normals, scales, margin, n_images: int, full0=None,
                    pool3=None):
    """Scene::viewBlockTest (Scene.cpp:610-644): over ALL images, count views
    where the patch floats in front of a confirmed surface."""
    B = centers.shape[0]
    dev = centers.device
    ci = torch.arange(n_images, device=dev)[None, :].expand(B, n_images)
    cc = centers[:, None, :].expand(B, n_images, 3)
    nn = normals[:, None, :].expand(B, n_images, 3)
    ss = scales[:, None].expand(B, n_images)

    lvl_f = torch.round(cam_ops.get_level(cams, ci, cc, ss))
    lvl_ok = (lvl_f >= 0) & (lvl_f <= cams.n_levels - 1)
    lvl = cam_ops.f2i(torch.clamp(lvl_f, 0, cams.n_levels - 1)).long()
    uvw = cam_ops.project(cams, ci, cc, lvl)
    w = imgs.width[ci, lvl].to(uvw.dtype)
    h = imgs.height[ci, lvl].to(uvw.dtype)
    vis = ((uvw[..., 0] >= 0) & (uvw[..., 0] <= w)
           & (uvw[..., 1] >= 0) & (uvw[..., 1] <= h))

    if pool3 is not None:
        blocked = _depth_test_view_pooled(cams, imgs, cc, nn, ss, ci, margin,
                                          view_block=True, pool3=pool3)
    else:
        blocked = _depth_test_view(pack, cams, imgs, opt, cc, nn, ss, ci,
                                   margin, view_block=True, full0=full0)
    return torch.sum(blocked & lvl_ok & vis, dim=-1)


def pixel_free_tests(pack: DepthPack, cams, imgs, opt: Options, centers,
                     scales, views):
    """Scene::pixelFreeTests (Scene.cpp:584-608): #views whose buffer cell at
    the patch's own level is still MAX_DEPTH."""
    ci = torch.clamp(views, min=0).long()
    B, K = views.shape
    cc = centers[:, None, :].expand(B, K, 3)
    ss = scales[:, None].expand(B, K)

    lvl_f = torch.round(cam_ops.get_level(cams, ci, cc, ss))
    lvl_ok = (lvl_f >= 0) & (lvl_f < cams.n_levels)
    lvl = cam_ops.f2i(torch.clamp(lvl_f, 0, cams.n_levels - 1)).long()
    uvw = cam_ops.project(cams, ci, cc, lvl)
    ix = cam_ops.f2i(uvw[..., 0] + 0.5)
    iy = cam_ops.f2i(uvw[..., 1] + 0.5)
    w = imgs.width[ci, lvl]
    h = imgs.height[ci, lvl]
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    d = get_depth_at_level(pack, ci, ix, iy, lvl, opt.DEPTH_SUBSAMPLE)
    free = (d == MAX_DEPTH) & inb & lvl_ok & (views >= 0)
    return torch.sum(free, dim=-1)
