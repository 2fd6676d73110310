"""Per-block image subsets: each octree block holds only the images whose
cameras can see it.

This is the missing half of the reference's subtree decomposition: a
CellProcessor's subtree only ever touches the images its patches reference
(main.cpp:50-96 gives each subtree view the shared Scene, but the working
set per subtree is its cameras' frusta). When the replicated image pack
outgrows one device's memory, the spatial engine shards the pack by block:
shard b holds the row-slices of the packed pyramid buffer
(image/pyramid.ImagePack) for exactly the cameras whose frusta intersect
its blocks' octants.

Correctness without view masking in the kernels: a patch resident in block
b projects in-bounds ONLY into cameras whose frustum intersects b's AABB
(the patch center lies inside it), and the assignment is conservative
(frustum-vs-octant-cube, unbounded when the camera plane cuts the cube).
Absent cameras get width = height = 0 in the block-local tables, so every
existing in-bounds gate (sampling, windows, view growth) rejects them with
no new code paths; the fetch kernel reads a slab like the full pack (its
row clamp is the slab's own row count, ops/windows.window_cut).
Depth/visibility gates keep the GLOBAL image dims (optimize_and_gate
gate_imgs): the reference's depth tests run over all images
(Scene.cpp:610-644).

hpmvs_tpu/parallel/subsets.py on torch devices: the slabs are host numpy,
bit for bit the JAX package's (without its `texb` copy, which the port does
not have), placed once per shard on its device (`place_block_pack`). The
JAX package's sharded_optimize_and_gate_subset is
parallel/mesh.sharded_optimize_and_gate(image_subsets=True), whose fn
takes the placed slabs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hpmvs_tpu_torch.core.octree import morton_encode
from hpmvs_tpu_torch.image.pyramid import ImagePack
from hpmvs_tpu_torch.parallel import mesh as pmesh


class BlockImagePack(NamedTuple):
    """Per-block row-slices of the global ImagePack, stacked + padded to the
    largest block (leading dim = n_blocks; the engine's blocks are its
    shards)."""
    tex: np.ndarray     # (n_blocks, rows_b, W, 3)
    row0: np.ndarray    # (n_blocks, ncam, nlevel) int32 (0 when absent)
    width: np.ndarray   # (n_blocks, ncam, nlevel) int32 (0 when absent)
    height: np.ndarray  # (n_blocks, ncam, nlevel) int32 (0 when absent)
    mask: np.ndarray    # (n_blocks, ncam) bool


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assign_images_to_blocks(cams, img_w0, img_h0, root_center: np.ndarray,
                            root_width: float, n_blocks: int,
                            block_level: int, near: np.ndarray = None,
                            far: np.ndarray = None,
                            oct_level: int = None,
                            occ_oct: np.ndarray = None) -> np.ndarray:
    """(n_blocks, ncam) bool: camera c's frustum intersects block b.

    Blocks are the contiguous Morton ranges of runtime/spatial.py
    (block = key * n_blocks >> 3L); each is a union of level-L octant
    cubes. Test: project the 8 corners of each octant cube with the
    level-0 P; the camera sees the cube if the corner hull's bbox meets
    the image rect, conservatively unbounded when corners straddle the
    camera plane. Cameras behind every corner are excluded.

    near/far: optional per-camera depth bounds (from the camera's SfM
    measurement depth range) truncating the otherwise infinite pyramid --
    without them, every block BEYOND the observed surface still intersects
    the frustum and spatially-distributed captures save no memory.

    oct_level/occ_oct: optional FINER test grid (oct_level >= block_level)
    with an occupancy mask at that grid -- the frustum intersection then
    only counts octants that actually hold reconstruction. occ_oct is
    (8^oct_level,) in Morton order."""
    P0 = _host(cams.P)[:, 0].astype(np.float64)        # (ncam, 3, 4)
    ncam = P0.shape[0]
    L = oct_level if oct_level is not None else block_level
    assert L >= block_level
    g = 1 << L
    ix, iy, iz = np.meshgrid(np.arange(g), np.arange(g), np.arange(g),
                             indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    keys = morton_encode(ix.astype(np.uint64), iy.astype(np.uint64),
                         iz.astype(np.uint64))
    blk = ((keys >> np.uint64(3 * (L - block_level))).astype(np.int64)
           * n_blocks) >> (3 * block_level)
    cw = root_width / g
    lo = (root_center - root_width / 2.0)
    # octant corner grid: (ncell, 8, 3)
    base = lo[None, :] + np.stack([ix, iy, iz], 1) * cw
    corner = np.array([[dx, dy, dz] for dx in (0, 1) for dy in (0, 1)
                       for dz in (0, 1)], np.float64) * cw
    pts = base[:, None, :] + corner[None]              # (ncell, 8, 3)
    hom = np.concatenate([pts, np.ones_like(pts[..., :1])], -1)
    proj = np.einsum("cij,nkj->cnki", P0, hom)         # (ncam, ncell, 8, 3)
    z = proj[..., 2]
    front = z > 1e-9                                   # (ncam, ncell, 8)
    any_front = front.any(-1)
    straddle = any_front & (~front).any(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        x = proj[..., 0] / z
        y = proj[..., 1] / z
    big = 1e12
    x = np.where(front, x, np.nan)
    y = np.where(front, y, np.nan)
    with np.errstate(invalid="ignore"):
        xmin = np.where(straddle, -big,
                        np.nanmin(np.where(front, x, np.inf), -1))
        xmax = np.where(straddle, big,
                        np.nanmax(np.where(front, x, -np.inf), -1))
        ymin = np.where(straddle, -big,
                        np.nanmin(np.where(front, y, np.inf), -1))
        ymax = np.where(straddle, big,
                        np.nanmax(np.where(front, y, -np.inf), -1))
    w = np.asarray(img_w0, np.float64)[:, None]
    h = np.asarray(img_h0, np.float64)[:, None]
    sees = any_front & (xmax >= 0) & (xmin < w) & (ymax >= 0) & (ymin < h)
    if near is not None and far is not None:
        zmin = np.where(front, z, np.inf).min(-1)      # (ncam, ncell)
        zmax = np.where(front, z, -np.inf).max(-1)
        bounded = np.isfinite(np.asarray(near)) & np.isfinite(np.asarray(far))
        depth_ok = ((zmax >= np.asarray(near)[:, None])
                    & (zmin <= np.asarray(far)[:, None]))
        sees &= depth_ok | ~bounded[:, None]
    if occ_oct is not None:
        occ = np.asarray(occ_oct, bool)[keys.astype(np.int64)]
        sees &= occ[None, :]
    mask = np.zeros((n_blocks, ncam), bool)
    for b in range(n_blocks):
        mask[b] = sees[:, blk == b].any(1)
    return mask


def camera_depth_bounds(cams, model, lo: float = 0.5, hi: float = 1.8):
    """Per-camera frustum depth bounds from the SfM measurement depths:
    [lo*min_depth, hi*max_depth]. Cameras with no measurements stay
    unbounded (inf markers). The working set of a camera is where its
    observed structure lives -- reconstruction densifies around the sparse
    points, so a generous margin around their depth range bounds it."""
    ncam = len(model.cameras)
    near = np.full(ncam, np.inf)
    far = np.full(ncam, -np.inf)
    if model.n_points == 0:
        return near, far
    P0 = _host(cams.P)[:, 0]                          # (ncam, 3, 4)
    pt_idx = np.repeat(np.arange(model.n_points),
                       np.diff(model.meas_start))
    ci = np.asarray(model.meas_img)
    pts = np.asarray(model.points_xyz)[pt_idx]        # (M, 3)
    row2 = P0[ci, 2]                                  # (M, 4)
    z = (row2[:, :3] * pts).sum(1) + row2[:, 3]
    ok = z > 0
    np.minimum.at(near, ci[ok], z[ok])
    np.maximum.at(far, ci[ok], z[ok])
    with np.errstate(invalid="ignore"):
        near = near * lo
        far = far * hi
    far[~np.isfinite(far)] = -np.inf
    return near, far


def slab_rows(heights: np.ndarray, mask: np.ndarray) -> int:
    """Rows of the largest per-block slab for a given assignment mask."""
    rows_of = np.asarray(heights).sum(1)
    return max(int(max((rows_of * mask[b]).sum()
                       for b in range(mask.shape[0]))), 1)


def build_block_packs(imgs: ImagePack, mask: np.ndarray,
                      rows_b: int = None) -> BlockImagePack:
    """Slice the global packed pyramid buffer (host arrays) into per-block
    slabs.

    rows_b: slab height override. The spatial engine passes its own
    shards' largest (runtime/spatial.py::_agree_dim): the JAX owned engine
    agrees the global max because its slabs form one SPMD array, while a
    port process places only its own shards' slabs, each a tensor of its
    own."""
    n_blocks, ncam = mask.shape
    tex_g = _host(imgs.tex)
    g_row0 = _host(imgs.row0)
    g_w = _host(imgs.width)
    g_h = _host(imgs.height)
    nlevel = g_row0.shape[1]
    rows_of = g_h.sum(1)                                # rows per camera
    if rows_b is None:
        rows_b = slab_rows(g_h, mask)
    rows_b = max(int(rows_b), 1)
    tex = np.zeros((n_blocks, rows_b) + tex_g.shape[1:], tex_g.dtype)
    row0 = np.zeros((n_blocks, ncam, nlevel), np.int32)
    width = np.zeros((n_blocks, ncam, nlevel), np.int32)
    height = np.zeros((n_blocks, ncam, nlevel), np.int32)
    for b in range(n_blocks):
        pos = 0
        for c in range(ncam):
            if not mask[b, c]:
                continue
            n = int(rows_of[c])
            src = int(g_row0[c, 0])
            tex[b, pos:pos + n] = tex_g[src:src + n]
            row0[b, c] = g_row0[c] - src + pos
            width[b, c] = g_w[c]
            height[b, c] = g_h[c]
            pos += n
    return BlockImagePack(tex=tex, row0=row0, width=width, height=height,
                          mask=mask)


def place_block_pack(mesh: pmesh.Mesh, bpack: BlockImagePack) -> list:
    """Commit the slabs: shard i's slab (row i of every table) as an
    ImagePack on shard i's device, uploaded once; dispatches then pass the
    placed tensors, so nothing re-transfers. Shards that share a device
    hold one slab each: on one GPU their sum can exceed the replicated
    pack, which only a mesh of several devices divides. None for the
    shards of other processes (they place their own)."""
    out = []
    for i, dev in enumerate(mesh.devices):
        if dev is None:
            out.append(None)
            continue
        out.append(ImagePack(*(torch.as_tensor(np.ascontiguousarray(a[i]))
                               .to(dev) for a in (bpack.tex, bpack.row0,
                                                  bpack.width,
                                                  bpack.height))))
    return out
