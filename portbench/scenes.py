"""The benchmark's scene generators and input writers, frozen.

Copies of hpmvs_tpu_torch/testing.py's make_facade_scene and
make_ring_plane_scene (same random streams, same geometry), of its NVM
writer and of the raw HPI1 image format, kept here so that later edits to
the program cannot move the yardstick. The facade renders its images on a
torch device (the GPU in a run, float64): the numpy render of eleven 2048 px
views takes most of a minute on a host CPU. Everything else is numpy.
tests/test_portbench_inputs.py holds both generators against the program's
at 256 px.

A scene is a dict: cameras (list of dicts: name, f, rq (w,x,y,z), c, k1),
images (list of (H, W, 3) uint8), points (n, 3), meas (list of
(point, camera, x, y) rows), surface ("wedge" with slope, or "plane"),
imgsize, f.
"""

from __future__ import annotations

import os
import struct

import numpy as np


def _rot_to_quat(R):
    """Rotation matrix -> quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
        q = np.zeros(4)
        q[1 + i] = 0.25 * s
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


def quat_to_R(q):
    """Quaternion (w, x, y, z) -> world-to-camera rotation."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _lookat(eye, target, up=(0.0, 1.0, 0.0)):
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, dtype=np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=0)


def smooth_texture(rng, size, cells=24):
    """Smooth random RGB texture in [0,255]: bilinear upsample of a grid."""
    grid = rng.uniform(30, 225, size=(cells + 1, cells + 1, 3))
    u = np.linspace(0, cells, size)
    iu = np.minimum(u.astype(np.int64), cells - 1)
    fu = u - iu
    rows = (grid[iu] * (1 - fu)[:, None, None]
            + grid[iu + 1] * fu[:, None, None])
    return (rows[:, iu] * (1 - fu)[None, :, None]
            + rows[:, iu + 1] * fu[None, :, None])


def _tex_bilinear(tex, tex_size, u, v):
    """Sample a texture (numpy or torch) with normalized coords in [-1, 1]."""
    if isinstance(tex, np.ndarray):
        uu = np.clip((np.asarray(u) * 0.5 + 0.5) * (tex_size - 1), 0,
                     tex_size - 1.001)
        vv = np.clip((np.asarray(v) * 0.5 + 0.5) * (tex_size - 1), 0,
                     tex_size - 1.001)
        iu, iv = uu.astype(np.int64), vv.astype(np.int64)
    else:
        uu = ((u * 0.5 + 0.5) * (tex_size - 1)).clamp(0, tex_size - 1.001)
        vv = ((v * 0.5 + 0.5) * (tex_size - 1)).clamp(0, tex_size - 1.001)
        iu, iv = uu.long(), vv.long()
    fu, fv = (uu - iu)[..., None], (vv - iv)[..., None]
    return (tex[iv, iu] * (1 - fu) * (1 - fv) + tex[iv, iu + 1] * fu * (1 - fv)
            + tex[iv + 1, iu] * (1 - fu) * fv
            + tex[iv + 1, iu + 1] * fu * fv)


def _wedge_hit(eye, d, slope, extent, xp):
    """First intersection of rays eye + t d with z = slope*|x| (two
    half-planes), numpy or torch. Returns (t, px, py, left, hit)."""
    if xp is np:
        best_t = np.full(d.shape[:-1], np.inf)
        best_left = np.zeros(d.shape[:-1], bool)
    else:
        best_t = xp.full(d.shape[:-1], float("inf"), dtype=d.dtype,
                         device=d.device)
        best_left = xp.zeros(d.shape[:-1], dtype=xp.bool, device=d.device)
    for left in (True, False):
        s = -slope if left else slope
        den = d[..., 2] - s * d[..., 0]
        den = xp.where(abs(den) < 1e-12, xp.full_like(den, 1e-12), den)
        t = (s * eye[0] - eye[2]) / den
        px = eye[0] + t * d[..., 0]
        py = eye[1] + t * d[..., 1]
        okx = (px <= 0) if left else (px >= 0)
        ok = (t > 0.1) & okx & (abs(px) <= extent) & (abs(py) <= extent)
        closer = ok & (t < best_t)
        best_t = xp.where(closer, t, best_t)
        best_left = (best_left | closer) if left else (best_left & ~closer)
    hit = xp.isfinite(best_t)
    tt = xp.where(hit, best_t, xp.ones_like(best_t))
    return tt, eye[0] + tt * d[..., 0], eye[1] + tt * d[..., 1], best_left, hit


def make_facade(n_cams=11, imgsize=256, n_points=200, extent=1.0, slope=0.55,
                cam_dist=3.5, arc_deg=110.0,
                k1_pattern=(0.25, -0.18, 0.2, -0.12, 0.15), seed=0,
                device="cpu"):
    """make_facade_scene's convex building corner z = slope*|x| seen by an
    arc of cameras, rendered WITH VisualSFM radial distortion (per-camera
    k1: the undistorted ray of distorted normalized pixel d is
    d * (1 + k1 |d|^2)). Images are rendered on `device` in float64."""
    import torch
    rng = np.random.default_rng(seed)
    f = imgsize * 1.2
    tex_size = 1024
    tex_l = torch.as_tensor(smooth_texture(rng, tex_size, cells=20),
                            device=device)
    tex_r = torch.as_tensor(smooth_texture(rng, tex_size, cells=20),
                            device=device)
    cameras, images = [], []
    angles = np.linspace(-np.deg2rad(arc_deg) / 2, np.deg2rad(arc_deg) / 2,
                         n_cams)
    ar = torch.arange(imgsize, dtype=torch.float64, device=device)
    vv, uu = torch.meshgrid(ar, ar, indexing="ij")
    for ci, a in enumerate(angles):
        eye = np.array([cam_dist * np.sin(a), 0.35 * np.sin(2.7 * a),
                        -cam_dist * np.cos(a)])
        R = _lookat(eye, np.array([0.0, 0.0, 0.35]))
        k1 = float(k1_pattern[ci % len(k1_pattern)])
        xd = (uu - imgsize / 2.0) / f
        yd = (vv - imgsize / 2.0) / f
        fac = 1.0 + k1 * (xd * xd + yd * yd)
        d_cam = torch.stack([xd * fac, yd * fac, torch.ones_like(xd)], -1)
        d_world = d_cam @ torch.as_tensor(R, device=device)
        _, px, py, left, hit = _wedge_hit(
            [float(v) for v in eye], d_world, slope, extent, torch)
        img = torch.where(left[..., None],
                          _tex_bilinear(tex_l, tex_size, px / extent,
                                        py / extent),
                          _tex_bilinear(tex_r, tex_size, px / extent,
                                        py / extent))
        img = torch.clamp(img + 0.5, 0, 255).to(torch.uint8)
        img[~hit] = 8
        cameras.append(dict(name=f"facade{ci:02d}.hpi", f=f,
                            rq=_rot_to_quat(R), c=eye.copy(), k1=k1))
        images.append(img.cpu().numpy())

    pts = np.zeros((n_points, 3))
    pts[:, 0] = rng.uniform(-0.8 * extent, 0.8 * extent, n_points)
    pts[:, 1] = rng.uniform(-0.8 * extent, 0.8 * extent, n_points)
    pts[:, 2] = slope * np.abs(pts[:, 0])
    pts[:, 2] += rng.normal(0, 0.002, n_points)
    Rs = [quat_to_R(c["rq"]) for c in cameras]
    meas = []
    for ii in range(n_points):
        for ci, cam in enumerate(cameras):
            pc = Rs[ci] @ (pts[ii] - cam["c"])
            if pc[2] <= 0:
                continue
            u = f * pc[0] / pc[2] + imgsize / 2.0
            v = f * pc[1] / pc[2] + imgsize / 2.0
            if not (12 <= u < imgsize - 12 and 12 <= v < imgsize - 12):
                continue
            d = (pts[ii] - cam["c"])[None, None, :]
            t, _, _, _, hit = _wedge_hit(cam["c"], d, slope, extent, np)
            if hit[0, 0] and t[0, 0] < 1.0 - 5e-3:
                continue
            meas.append((ii, ci, u - imgsize / 2.0, v - imgsize / 2.0))
    return dict(cameras=cameras, images=images, points=pts, meas=meas,
                rgb=np.full((n_points, 3), 128.0), surface="wedge",
                slope=slope, extent=extent, imgsize=imgsize, f=f)


def make_ring_plane(n_cams=150, imgsize=128, n_points=600, extent=8.0,
                    cam_height=3.5, seed=0, roll=True):
    """make_ring_plane_scene's large ground plane z = 0 with broadband
    texture, seen by cameras on an outer ring and an inner grid, each
    looking almost straight down (no distortion)."""
    rng = np.random.default_rng(seed)
    f = imgsize * 1.2
    tex_size = 2048
    gsd = cam_height / f
    feat = (14.0 * gsd, 5.0 * gsd, 2.3 * gsd)
    tex = sum(w * smooth_texture(rng, tex_size,
                                 cells=max(int(2 * extent / fz), 8))
              for w, fz in zip((0.4, 0.33, 0.27), feat))
    n_ring = (2 * n_cams) // 3
    n_grid = n_cams - n_ring
    gpos = []
    for i in range(n_ring):
        a = 2.0 * np.pi * i / n_ring
        gpos.append((0.72 * extent * np.cos(a), 0.72 * extent * np.sin(a)))
    g = max(int(np.ceil(np.sqrt(n_grid))), 1)
    for i in range(n_grid):
        gx = (i % g + 0.5) / g * 2 - 1
        gy = (i // g + 0.5) / g * 2 - 1
        gpos.append((gx * 0.55 * extent, gy * 0.55 * extent))
    cameras, images = [], []
    uu, vv = np.meshgrid(np.arange(imgsize), np.arange(imgsize))
    for ci, (gx, gy) in enumerate(gpos):
        eye = np.array([gx, gy, -cam_height])
        tgt = np.array([gx + 0.35 * np.cos(ci), gy + 0.35 * np.sin(ci), 0.0])
        up = (np.cos(ci * 0.7), np.sin(ci * 0.7), 0.0) if roll \
            else (1.0, 0.0, 0.0)
        R = _lookat(eye, tgt, up=up)
        d_cam = np.stack([(uu - imgsize / 2.0) / f, (vv - imgsize / 2.0) / f,
                          np.ones_like(uu, dtype=np.float64)], axis=-1)
        d_world = d_cam @ R
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (0.0 - eye[2]) / d_world[..., 2]
        px = eye[0] + t * d_world[..., 0]
        py = eye[1] + t * d_world[..., 1]
        img = np.clip(_tex_bilinear(tex, tex_size, px / extent, py / extent)
                      + 0.5, 0, 255).astype(np.uint8)
        bad = (np.abs(px) > extent) | (np.abs(py) > extent) | (t <= 0) \
            | ~np.isfinite(t)
        img[bad] = 8
        cameras.append(dict(name=f"ring{ci:03d}.hpi", f=f, rq=_rot_to_quat(R),
                            c=eye.copy(), k1=0.0))
        images.append(img)
    pts = np.zeros((n_points, 3))
    base = rng.integers(0, n_cams, n_points)
    for ii in range(n_points):
        gx, gy = gpos[base[ii]]
        pts[ii, 0] = np.clip(gx + rng.normal(0, 0.5), -extent, extent)
        pts[ii, 1] = np.clip(gy + rng.normal(0, 0.5), -extent, extent)
    pts[:, 2] = rng.normal(0, 0.002, n_points)
    Rs = [quat_to_R(c["rq"]) for c in cameras]
    meas = []
    for ii in range(n_points):
        for ci, cam in enumerate(cameras):
            pc = Rs[ci] @ (pts[ii] - cam["c"])
            if pc[2] <= 0:
                continue
            u = f * pc[0] / pc[2] + imgsize / 2.0
            v = f * pc[1] / pc[2] + imgsize / 2.0
            if 6 <= u < imgsize - 6 and 6 <= v < imgsize - 6:
                meas.append((ii, ci, u - imgsize / 2.0, v - imgsize / 2.0))
    return dict(cameras=cameras, images=images, points=pts, meas=meas,
                rgb=np.full((n_points, 3), 128.0), surface="plane",
                plane_z=0.0, extent=extent, imgsize=imgsize, f=f)


GENERATORS = {"facade": make_facade, "ring_plane": make_ring_plane}


def make_scene(generator: str, args: dict, seed: int, device="cpu"):
    """The scene of a run. When the configuration fixes the generator's own
    `seed` (one capture, as a deployment reconstructs one capture), the
    run's seed only permutes the colour channels of every image
    (recolour), which leaves the work the same: the NCC of a patch and the
    norm that picks its colour do not depend on the channels' order.
    Otherwise the run's seed draws the scene."""
    kw = dict(args)
    kw.setdefault("seed", seed)
    if generator == "facade":
        kw["device"] = device
    scene = GENERATORS[generator](**kw)
    return recolour(scene, seed) if "seed" in args else scene


def recolour(scene: dict, seed: int) -> dict:
    """The scene with the RGB channels of every image (and of the SfM
    points' colours) in an order drawn from `seed`."""
    perm = np.random.default_rng(seed).permutation(3)
    return dict(scene, images=[np.ascontiguousarray(im[..., perm])
                               for im in scene["images"]],
                rgb=scene["rgb"][:, perm], channels=perm.tolist())


def write_hpi(path: str, img: np.ndarray) -> None:
    """The raw image format both the program and the reference read:
    b"HPI1", int32 width, int32 height, then H*W*3 uint8 RGB."""
    h, w = img.shape[:2]
    with open(path, "wb") as fh:
        fh.write(b"HPI1" + struct.pack("<ii", w, h))
        fh.write(np.ascontiguousarray(img, np.uint8).tobytes())


def read_hpi(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        if fh.read(4) != b"HPI1":
            raise ValueError(f"{path}: not an HPI1 image")
        w, h = struct.unpack("<ii", fh.read(8))
        return np.frombuffer(fh.read(w * h * 3), np.uint8).reshape(h, w, 3)


def write_scene(scene: dict, folder: str) -> str:
    """Write the images (HPI1) and an NVM_V3 file naming them relative to
    its folder; returns the NVM's path."""
    os.makedirs(folder, exist_ok=True)
    for cam, img in zip(scene["cameras"], scene["images"]):
        write_hpi(os.path.join(folder, cam["name"]), img)
    meas = scene["meas"]
    by_point = [[] for _ in range(len(scene["points"]))]
    for ii, ci, x, y in meas:
        by_point[ii].append((ci, x, y))
    lines = ["NVM_V3", "", str(len(scene["cameras"]))]
    for cam in scene["cameras"]:
        rq = " ".join(repr(float(v)) for v in cam["rq"])
        c = " ".join(repr(float(v)) for v in cam["c"])
        lines.append(f"{cam['name']} {float(cam['f'])!r} {rq} {c} "
                     f"{float(cam['k1'])!r} 0")
    lines += ["", str(len(scene["points"]))]
    for ii, p in enumerate(scene["points"]):
        col = " ".join(str(int(v)) for v in scene["rgb"][ii])
        row = [" ".join(repr(float(v)) for v in p), col, str(len(by_point[ii]))]
        row += [f"{ci} {ii} {float(x)!r} {float(y)!r}"
                for ci, x, y in by_point[ii]]
        lines.append(" ".join(row))
    lines.append("0")
    path = os.path.join(folder, "scene.nvm")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path
