"""The plain reference that decides `correct`: every delivered patch held to
the guarantees its configuration states, recomputed from the raw images and
the cameras that the benchmark made.

It imports neither the program nor JAX, and takes nothing the program
derived: it reads the scene as written (NVM cameras, raw HPI1 images with
their radial distortion, the analytic surface) and judges the program's
outputs (the delivered clouds and, for the octree, each job's cells).
Plain torch, in blocks of patches, on the device it is given.

Per patch, a fault is any of:
  surface   -- farther from the scene's analytic surface than `surface_tol`
               plus `surface_scales` times its scale (its pixel footprint
               at its sampling level: coarse patches are placed to their
               level's pixel); the whole chain: seeding, refinement,
               extension;
  views     -- fewer than MIN_IMAGES_PER_PATCH claimed views (reference
               view included) that pass: the view sees the patch within
               MAX_ANGLE of its normal, the 7x7x3 texture on the patch's
               tangent plane sampled there correlates with the reference
               view's at NCC >= NCC_ALPHA_2 (fetch, score and GN, the stage
               pipelines), and no other delivered patch hides it by more
               than `visibility_tol` plus two cell footprints in a z-buffer
               of the whole cloud with cells of `zbuf_px` pixels (the depth
               gates);
  colour    -- its RGB farther than `colour_tol` (any channel) from the
               median-by-norm of the centre colours over its claimed views;
  octree    -- its cell is dead, holds another delivered patch once the
               job has no work left, or lies more than `cell_margin` cell
               widths from its centre (the scheduler's occupancy per
               level).
The verdict holds `fault_share`, the share of delivered patches with a
fault, over every cloud of the run, and `surface_p<q>`, the q-th
percentile (10, 25, 50, 90) over those patches of the distance from the
analytic surface in units of the patch's scale: how closely the
refinement places a patch, far below the surface fault's tolerance. A
cell's limits file names the numbers compared.

Sampling: the raw (distorted) image's own 2x2 box pyramid, bilinear, at the
pyramid level whose pixel matches the patch scale (round(log2(scale * f /
depth)), clamped to [0, MAXLEVEL - 1]); a world point maps to its distorted
pixel through the VisualSFM model (undistorted normalized = distorted * (1 +
k1 |distorted|^2), solved for the distorted radius by Newton's method).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.scenes import quat_to_R

PATCH = 7
SURFACE_QUANTILES = (10, 25, 50, 90)


class SceneRef:
    """Cameras and raw-image pyramids on `device`."""

    def __init__(self, scene: dict, n_levels: int, device):
        self.device = device
        self.scene = scene
        cams = scene["cameras"]
        self.R = torch.tensor(np.stack([quat_to_R(c["rq"]) for c in cams]),
                              dtype=torch.float64, device=device)
        self.C = torch.tensor(np.stack([c["c"] for c in cams]),
                              dtype=torch.float64, device=device)
        self.f = torch.tensor([c["f"] for c in cams], dtype=torch.float64,
                              device=device)
        self.k1 = torch.tensor([c["k1"] for c in cams], dtype=torch.float64,
                               device=device)
        h, w = scene["images"][0].shape[:2]
        self.h, self.w = h, w
        lv = torch.tensor(np.stack(scene["images"]), device=device).float()
        self.pyr = [lv]                               # (ncam, H, W, 3)
        for _ in range(n_levels - 1):
            a = self.pyr[-1]
            hh, ww = a.shape[1] // 2, a.shape[2] // 2
            a = a[:, :2 * hh, :2 * ww]
            self.pyr.append((a[:, 0::2, 0::2] + a[:, 1::2, 0::2]
                             + a[:, 0::2, 1::2] + a[:, 1::2, 1::2]) / 4.0)

    def to_cam(self, ci, X):
        """World points X (..., 3) in camera ci (...,): (x, y, z)."""
        return torch.einsum("...ij,...j->...i", self.R[ci], X - self.C[ci])

    def pixel(self, ci, X):
        """Distorted level-0 pixel (..., 2) and depth (...,) of X in ci."""
        pc = self.to_cam(ci, X)
        z = pc[..., 2]
        zs = torch.where(z > 1e-9, z, torch.ones_like(z))
        un = pc[..., :2] / zs[..., None]
        ru = torch.linalg.vector_norm(un, dim=-1)
        k1 = self.k1[ci]
        rd = ru.clone()
        for _ in range(8):      # rd (1 + k1 rd^2) = ru
            g = rd * (1 + k1 * rd * rd) - ru
            rd = rd - g / (1 + 3 * k1 * rd * rd)
        fac = torch.where(ru > 1e-12, rd / torch.clamp(ru, min=1e-12),
                          torch.ones_like(ru))
        d = un * fac[..., None]
        f = self.f[ci][..., None]
        uv = d * f + torch.tensor([self.w / 2.0, self.h / 2.0],
                                  dtype=d.dtype, device=d.device)
        return uv, z

    def sample(self, ci, level, uv0):
        """Bilinear RGB at level-0 pixel coordinates uv0 (..., 2) mapped to
        `level` (...,) of camera ci (...,); (rgb (..., 3), inside (...,))."""
        out = torch.zeros(uv0.shape[:-1] + (3,), device=uv0.device)
        inside = torch.zeros(uv0.shape[:-1], dtype=torch.bool,
                             device=uv0.device)
        for L in torch.unique(level).tolist():
            m = level == L
            img = self.pyr[L]
            H, W = img.shape[1], img.shape[2]
            uv = uv0[m] * (0.5 ** L)
            x, y = uv[:, 0], uv[:, 1]
            ok = (x >= 0) & (y >= 0) & (x <= W - 2) & (y <= H - 2)
            x = x.clamp(0, W - 2)
            y = y.clamp(0, H - 2)
            x0, y0 = x.floor().long(), y.floor().long()
            fx = (x - x0).float()[:, None]
            fy = (y - y0).float()[:, None]
            c = ci[m]
            v = (img[c, y0, x0] * (1 - fx) * (1 - fy)
                 + img[c, y0, x0 + 1] * fx * (1 - fy)
                 + img[c, y0 + 1, x0] * (1 - fx) * fy
                 + img[c, y0 + 1, x0 + 1] * fx * fy)
            out[m] = v
            inside[m] = ok
        return out, inside


def surface_distance(scene: dict, X: np.ndarray) -> np.ndarray:
    if scene["surface"] == "wedge":
        s = scene["slope"]
        return np.abs(X[:, 2] - s * np.abs(X[:, 0])) / math.sqrt(1 + s * s)
    return np.abs(X[:, 2] - scene["plane_z"])


def _levels(ref: SceneRef, ci, X, scale, max_level):
    depth = torch.linalg.vector_norm(X - ref.C[ci], dim=-1)
    lv = torch.round(torch.log2(torch.clamp(scale * ref.f[ci] / depth,
                                            min=1e-30)))
    return torch.clamp(torch.nan_to_num(lv, nan=0.0), 0, max_level).long()


def _view_checks(ref: SceneRef, rules: dict, C, N, S, V, zbufs):
    """(photo-and-visibility pass count, colour (B, 3)) for a block."""
    B, K = V.shape
    dev = ref.device
    valid = V >= 0
    vi = torch.clamp(V, min=0)
    n = N / torch.clamp(torch.linalg.vector_norm(N, dim=-1, keepdim=True),
                        min=1e-12)
    # tangent frame aligned to the reference camera's x axis
    camx = ref.R[vi[:, 0], 0]
    y = torch.linalg.cross(n, camx, dim=-1)
    y = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True),
                        min=1e-12)
    x = torch.linalg.cross(y, n, dim=-1)
    o = torch.arange(PATCH, dtype=C.dtype, device=dev) - (PATCH - 1) / 2
    grid = (C[:, None, None] + o[None, None, :, None] * x[:, None, None]
            * S[:, None, None, None] + o[None, :, None, None]
            * y[:, None, None] * S[:, None, None, None])       # (B,7,7,3)
    grid = grid.reshape(B, 1, PATCH * PATCH, 3).expand(B, K, -1, 3)
    civ = vi[:, :, None].expand(B, K, PATCH * PATCH)
    lv = _levels(ref, vi, C[:, None].expand(B, K, 3), S[:, None],
                 rules["max_level"])
    uv, z = ref.pixel(civ, grid)
    tex, inside = ref.sample(civ, lv[:, :, None].expand_as(civ), uv)
    seen = inside.all(-1) & (z > 0).all(-1)
    t = tex - tex.mean(dim=2, keepdim=True)
    t = t.reshape(B, K, -1)
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                        min=1e-6)
    ncc = torch.einsum("bp,bkp->bk", t[:, 0], t)
    ray = ref.C[vi] - C[:, None]
    ray = ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)
    angle_ok = (ray * n[:, None]).sum(-1) > math.cos(rules["max_angle"])
    ok = valid & seen & angle_ok & (ncc >= rules["ncc_min"])
    ok[:, 0] = valid[:, 0] & seen[:, 0] & angle_ok[:, 0]
    # visibility against the z-buffer of the whole delivered cloud
    uvc, zc = ref.pixel(vi, C[:, None].expand(B, K, 3))
    ok &= ~_hidden(ref, rules, zbufs, vi, uvc, zc)
    # colour: median-by-norm over the claimed views, darkest when white
    cuv, cin = ref.sample(vi, lv, uvc)
    norms = torch.where(valid, torch.linalg.vector_norm(cuv, dim=-1),
                        torch.full_like(cuv[..., 0], 1e9))
    order = torch.argsort(norms, dim=-1, stable=True)
    nk = torch.clamp(valid.sum(-1), min=1)
    med = torch.gather(cuv, 1, torch.gather(order, 1, (nk // 2)[:, None])
                       [:, :, None].expand(B, 1, 3))[:, 0]
    first = torch.gather(cuv, 1, order[:, :1, None].expand(B, 1, 3))[:, 0]
    col = torch.where(torch.linalg.vector_norm(med, dim=-1, keepdim=True)
                      > 250.0, first, med)
    return ok.sum(-1), col


def build_zbufs(ref: SceneRef, rules: dict, C: torch.Tensor):
    """Per camera, the nearest delivered patch centre per cell of
    `zbuf_px` level-0 pixels: (ncam, Hc, Wc) depths (inf where empty)."""
    cell = rules["zbuf_px"]
    ncam = ref.R.shape[0]
    Hc, Wc = -(-ref.h // cell), -(-ref.w // cell)
    zb = torch.full((ncam * Hc * Wc,), float("inf"), dtype=torch.float64,
                    device=ref.device)
    for ci in range(ncam):
        cc = torch.full((C.shape[0],), ci, dtype=torch.long,
                        device=ref.device)
        uv, z = ref.pixel(cc, C)
        ix = torch.floor(uv / cell).long()
        m = ((z > 0) & (ix[:, 0] >= 0) & (ix[:, 1] >= 0) & (ix[:, 0] < Wc)
             & (ix[:, 1] < Hc))
        flat = ci * Hc * Wc + ix[m, 1] * Wc + ix[m, 0]
        zb.scatter_reduce_(0, flat, z[m], "amin")
    return zb.reshape(ncam, Hc, Wc)


def _hidden(ref, rules, zbufs, vi, uv, z):
    cell = rules["zbuf_px"]
    _, Hc, Wc = zbufs.shape
    ix = torch.floor(uv / cell).long()
    m = ((ix[..., 0] >= 0) & (ix[..., 1] >= 0) & (ix[..., 0] < Wc)
         & (ix[..., 1] < Hc))
    zz = zbufs[vi, ix[..., 1].clamp(0, Hc - 1), ix[..., 0].clamp(0, Wc - 1)]
    # a surface seen within MAX_ANGLE of its normal spans up to
    # tan(60 deg) < 2 cell footprints of depth inside one z-buffer cell
    slack = 2.0 * cell * z / ref.f[vi]
    return m & (z > zz + rules["visibility_tol"] + slack)


def morton_decode(keys: np.ndarray):
    """(ix, iy, iz) of 63-bit Morton keys (x in bit 0, y bit 1, z bit 2)."""
    keys = keys.astype(np.uint64)
    out = []
    for axis in range(3):
        v = keys >> np.uint64(axis)
        r = np.zeros(keys.shape, np.uint64)
        for b in range(21):
            r |= ((v >> np.uint64(3 * b)) & np.uint64(1)) << np.uint64(b)
        out.append(r.astype(np.int64))
    return out


def octree_faults(cloud: dict, margin: float) -> np.ndarray:
    """Per patch: its cell dead, shared with another delivered patch (in
    the cloud of a job that ran until no work was left: a job stopped at a
    deadline or at max_prio leaves cells that its next steps would filter),
    or
    farther from its centre than `margin` cell widths outside the cell's
    cube (from the root, the cell's level and its Morton key; refinement
    may move a patch EXTEND_DRIFT = 1.5 widths from where it was placed)."""
    tr = cloud.get("octree")
    n = len(cloud["center"])
    if tr is None:
        return np.zeros(n, bool)
    cell = tr["cell"]
    bad = ~tr["cell_alive"]
    _, inv, cnt = np.unique(cell, return_inverse=True, return_counts=True)
    if cloud.get("final", True):
        bad |= cnt[inv] > 1
    lv = tr["cell_level"].astype(np.int64)
    cw = tr["root_width"] / (2.0 ** lv)
    lo = np.asarray(tr["root_center"], np.float64) - tr["root_width"] / 2.0
    ijk = np.stack(morton_decode(tr["cell_key"]), axis=1).astype(np.float64)
    c0 = lo + ijk * cw[:, None]
    X = cloud["center"].astype(np.float64)
    eps = margin * cw[:, None]
    inside = np.all((X >= c0 - eps) & (X <= c0 + cw[:, None] + eps), axis=1)
    return bad | ~inside


def judge(scene: dict, rules: dict, clouds: list, device, block=8192):
    """Fault flags of every delivered patch. Returns a dict of counts:
    patches, and per fault kind; plus `fault_share` and the
    `surface_p<q>` percentiles."""
    ref = SceneRef(scene, rules["max_level"] + 1, device)
    tot = dict(patches=0, surface=0, views=0, colour=0, octree=0, any=0)
    rel = []
    for cl in clouds:
        n = len(cl["center"])
        if n == 0:
            continue
        C = torch.tensor(cl["center"], dtype=torch.float64, device=device)
        zb = build_zbufs(ref, rules, C)
        dist = surface_distance(scene, cl["center"].astype(np.float64))
        f_surf = dist > rules["surface_tol"] \
            + rules["surface_scales"] * cl["scale"]
        rel.append(dist / np.maximum(cl["scale"], 1e-12))
        f_oct = octree_faults(cl, rules["cell_margin"])
        f_views = np.zeros(n, bool)
        f_col = np.zeros(n, bool)
        for s in range(0, n, block):
            e = min(n, s + block)
            passes, col = _view_checks(
                ref, rules, C[s:e],
                torch.tensor(cl["normal"][s:e], dtype=torch.float64,
                             device=device),
                torch.tensor(cl["scale"][s:e], dtype=torch.float64,
                             device=device),
                torch.tensor(cl["views"][s:e], dtype=torch.long,
                             device=device), zb)
            f_views[s:e] = (passes < rules["min_images"]).cpu().numpy()
            got = torch.tensor(cl["color"][s:e], dtype=torch.float32,
                               device=device)
            f_col[s:e] = ((got - col).abs().amax(-1)
                          > rules["colour_tol"]).cpu().numpy()
        tot["patches"] += n
        tot["surface"] += int(f_surf.sum())
        tot["views"] += int(f_views.sum())
        tot["colour"] += int(f_col.sum())
        tot["octree"] += int(f_oct.sum())
        tot["any"] += int((f_surf | f_views | f_col | f_oct).sum())
    tot["fault_share"] = tot["any"] / max(tot["patches"], 1)
    rel = np.concatenate(rel) if rel else np.zeros(1)
    for q in SURFACE_QUANTILES:
        tot[f"surface_p{q}"] = float(np.quantile(rel, q / 100.0))
    return tot
