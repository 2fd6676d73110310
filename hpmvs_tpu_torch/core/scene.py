"""Scene assembly: cameras + packed images + covisibility + seed patches.

Equivalent of the reference Scene init path (src/hpmvs/Scene.cpp:42-208,
241-298): addCameras (image load + camera init), extractCoVisiblilty
(images sharing >= 50 SfM points), and initPatches (per-SfM-point seed
creation + first optimization).

Seeds are created as one structure-of-arrays batch and refined by a single
optimize_batch call instead of an OpenMP loop over points
(Scene.cpp:114-178).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hpmvs_tpu_torch import resolve_device, trace
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.geom import camera as cam_ops
from hpmvs_tpu_torch.geom.triangulation import triangulate_midpoint
from hpmvs_tpu_torch.image import pyramid as pyr
from hpmvs_tpu_torch.io import nvm as nvm_io
from hpmvs_tpu_torch.ops import optimizer as popt


class Scene(NamedTuple):
    ctx: popt.SceneCtx       # device-side context (cams, imgs, covis)
    covis_np: np.ndarray     # (ncam, C) host copy, -1 padded
    ncovis_np: np.ndarray    # (ncam,)
    n_cameras: int
    width_np: np.ndarray     # (ncam, nlevel) host copies of image dims
    height_np: np.ndarray


def extract_covisibility(model: nvm_io.NvmModel, opt: Options,
                         visdata_path: Optional[str] = None) -> np.ndarray:
    """Scene::extractCoVisiblilty (Scene.cpp:241-298): pair counts of shared
    SfM points; covisible if >= COVIS_MIN_POINTS. Returns (ncam, C) padded."""
    ncam = len(model.cameras)
    vis = np.zeros((ncam, ncam), dtype=np.int64)
    for ii in range(model.n_points):
        s, e = model.meas_start[ii], model.meas_start[ii + 1]
        ids = model.meas_img[s:e]
        np.add.at(vis, (ids[:, None], ids[None, :]), 1)
    np.fill_diagonal(vis, 0)

    covis_lists = [np.nonzero(vis[ii] >= opt.COVIS_MIN_POINTS)[0]
                   for ii in range(ncam)]
    cmax = max(1, min(opt.MAX_COVIS, max((len(c) for c in covis_lists),
                                         default=1)))
    covis = np.full((ncam, cmax), -1, dtype=np.int32)
    for ii, lst in enumerate(covis_lists):
        # keep the most-covisible candidates if the list overflows the slots
        if len(lst) > cmax:
            order = np.argsort(-vis[ii][lst], kind="stable")
            lst = lst[order[:cmax]]
        covis[ii, :len(lst)] = np.sort(lst)

    if visdata_path is not None:
        # PMVS-style VISDATA debug dump (Scene.cpp:279-293)
        with open(visdata_path, "w") as fh:
            fh.write("VISDATA\n")
            fh.write(f"{ncam}\n")
            for ii in range(ncam):
                lst = covis[ii][covis[ii] >= 0]
                fh.write(f"{ii} {len(lst)}")
                for jj in lst:
                    fh.write(f" {jj}")
                fh.write("\n")
    return covis


def build_scene(model: nvm_io.NvmModel, opt: Options,
                images: Optional[list] = None,
                visdata_path: Optional[str] = None, device="cuda",
                host_pack: bool = False) -> Scene:
    """Load images, build cameras and the device scene context
    (Scene::addCameras, Scene.cpp:42-88) on `device` (the GPU unless
    device="cpu"). images: optional in-memory (H, W, 3) uint8 images used
    instead of the NVM's files.

    host_pack: keep the packed pyramid's texture (imgs.tex) on the host --
    for per-block image subsets, where the replicated pack may exceed one
    device's memory and only the per-shard slabs ever go to the devices
    (parallel/subsets.py). The small row and dim tables still go to
    `device`."""
    device = resolve_device(device)
    with trace.span("load.images"):
        if images is None:
            imgs = pyr.load_scene_images(model.cameras, opt.n_levels)
        else:
            pyramids = [pyr.build_pyramid(im, opt.n_levels) for im in images]
            imgs = pyr.pack_pyramids(pyramids)
    with trace.span("load.scene"):
        return _assemble(model, opt, imgs, visdata_path, device, host_pack)


def _assemble(model, opt, imgs, visdata_path, device, host_pack) -> Scene:
    """Cameras, covisibility and the device context around packed images."""
    widths = [int(imgs.width[ci, 0]) for ci in range(imgs.n_cameras)]
    heights = [int(imgs.height[ci, 0]) for ci in range(imgs.n_cameras)]
    cams = cam_ops.build_cameras(model.cameras, widths, heights, opt.MAXLEVEL,
                                 device=device)

    covis = extract_covisibility(model, opt, visdata_path)
    ncovis = (covis >= 0).sum(axis=1).astype(np.int32)

    ctx = popt.SceneCtx(
        cams=cams,
        imgs=pyr.ImagePack(
            tex=torch.as_tensor(imgs.tex,
                                device="cpu" if host_pack else device),
            row0=torch.as_tensor(imgs.row0, device=device),
            width=torch.as_tensor(imgs.width, device=device),
            height=torch.as_tensor(imgs.height, device=device)),
        covis=torch.as_tensor(covis, device=device),
        ncovis=torch.as_tensor(ncovis, device=device))
    return Scene(ctx=ctx, covis_np=covis, ncovis_np=ncovis,
                 n_cameras=len(model.cameras),
                 width_np=np.asarray(imgs.width),
                 height_np=np.asarray(imgs.height))


def scene_center_radius(cams: cam_ops.Cameras) -> Tuple[np.ndarray, float]:
    """Scene::getSceneCenter (Scene.cpp:210-239): midpoint triangulation of
    the optical axes; radius = max camera distance (reference uses max)."""
    origins = cams.center.cpu().numpy().astype(np.float64)
    rays = cams.oaxis[:, :3].cpu().numpy().astype(np.float64)
    rays = rays / np.linalg.norm(rays, axis=1, keepdims=True)
    center = triangulate_midpoint(origins, rays)
    dists = np.linalg.norm(origins - center[None], axis=1)
    return center, float(np.max(dists))


def make_seed_patches(model: nvm_io.NvmModel, scene: Scene, opt: Options):
    """Seed creation from SfM points (Scene::initPatches, Scene.cpp:112-163):
    per-point visible-image list (projection in bounds at START_LEVEL with
    margin 2), normal toward the FIRST camera (Scene.cpp:159 overwrites the
    mean-direction computation), scale from camera 0 at START_LEVEL.

    Returns host numpy (centers, normals, scales, views) ready for
    optimize_batch, plus the original point positions for the drift gate.
    """
    npts = model.n_points
    K = opt.MAX_VIEWS
    cams = scene.ctx.cams
    widths = scene.width_np
    heights = scene.height_np

    cam_P = cams.P.cpu().numpy()           # (ncam, L, 3, 4)
    cam_center = cams.center.cpu().numpy()
    fsum = cams.fsum.cpu().numpy()

    sl = opt.START_LEVEL
    margin = opt.SEED_PROJ_MARGIN

    if opt.FILTER_SCENE_CENTER:
        ccenter, radius = scene_center_radius(cams)
    else:
        ccenter, radius = None, None

    centers, normals, scales, views_all = [], [], [], []
    for ii in range(npts):
        pt = model.points_xyz[ii]
        if ccenter is not None and np.linalg.norm(pt - ccenter) > radius:
            continue
        s, e = model.meas_start[ii], model.meas_start[ii + 1]
        if e - s < opt.MIN_IMAGES_PER_PATCH:
            continue
        vlist = []
        for mi in range(s, e):
            ci = int(model.meas_img[mi])
            if ci < 0:
                continue
            ph = cam_P[ci, sl] @ np.append(pt, 1.0)
            if ph[2] <= 0:
                continue
            u, v = ph[0] / ph[2], ph[1] / ph[2]
            if (u < margin or v < margin or u >= widths[ci, sl] - margin
                    or v >= heights[ci, sl] - margin):
                continue
            vlist.append(ci)
        if len(vlist) < 2:
            continue
        vlist = vlist[:K]
        n = cam_center[vlist[0]] - pt
        n = n / np.linalg.norm(n)
        fz = np.linalg.norm(pt - cam_center[vlist[0]])
        scale = 2.0 * fz * (1 << sl) / fsum[vlist[0]]

        centers.append(pt)
        normals.append(n)
        scales.append(scale)
        vrow = np.full((K,), -1, dtype=np.int32)
        vrow[:len(vlist)] = vlist
        views_all.append(vrow)

    if not centers:
        z = np.zeros((0,))
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                z.astype(np.float32), np.zeros((0, K), np.int32),
                np.zeros((0, 3), np.float32))
    return (np.asarray(centers, np.float32), np.asarray(normals, np.float32),
            np.asarray(scales, np.float32), np.stack(views_all),
            np.asarray(centers, np.float32).copy())
