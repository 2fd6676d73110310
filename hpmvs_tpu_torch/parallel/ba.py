"""Sparse and dense bundle adjustment via Schur-complement reduction.

New capability beyond the reference (BASELINE.json north star: "sparse
bundle-adjustment refinement of cameras+patches via Schur-complement
reduction"); hpmvs itself has no BA. Standard structure:

  - residuals: reprojection of every (point, camera) measurement,
    r = project(R0 exp([w]x) X + t) - uv, camera parameterized by a local
    so(3) twist + translation delta, points by their 3D position.
  - Gauss-Newton with point-block elimination: H_pp is 3x3 block-diagonal,
    so points are eliminated in closed form; the reduced camera system
    S = H_cc - H_cp H_pp^-1 H_pc is solved by Jacobi-preconditioned
    conjugate gradients whose matvec is assembled per measurement, never
    materialising S.

hpmvs_tpu/parallel/ba.py on torch devices. The JAX package runs it as XLA
ops (no Pallas kernel): the port writes it as plain torch on the device.
The Jacobians come from torch.func.jacfwd of the per-measurement residual
(9 parameters -> 2 residuals, camera and point in one pass) under
torch.func.vmap, as the JAX package uses jax.jacfwd, in chunks of
JAC_CHUNK measurements. Every segment sum over cameras or points is an
index_add_ (atomic adds on CUDA: the sums are not reproducible bit for bit
from run to run); a camera's adds spread over CAM_SPREAD rows first, since
one camera holds ~10^5 measurements of a dense cloud. ba_solve enqueues its
whole Gauss-Newton/CG loop without one host synchronisation: the damping,
the CG step sizes and the Levenberg accept stay 0-d device tensors, and the
3x3 point blocks invert with linalg.inv_ex (linalg.inv checks for errors, a
host sync on CUDA).

Over a mesh (parallel/mesh.py): shard_problem orders the measurements by
point and pads them so that no point straddles two shards;
ba_solve_sharded keeps one replica of the solver state per shard, sums
every per-camera and per-point accumulation over the shards' partial sums
(mesh.psum) and runs the CG with a summed matvec, as the JAX package's
shard_map does. ba_solve is the same solve over a one-shard mesh, so one
body serves both. apply_dense_ba takes the mesh branch for an engine with
a mesh. Over a mesh that spans processes each process holds its own
shards' measurements and mesh.psum sums across the processes in process
order, so every process ends with the same bits: the cameras and points of
an owned engine's dense BA are bit-identical on every process, although a
CUDA index_add_ is not deterministic (each partial sum is computed once, by
its shard's process, and the reduction order is fixed).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from hpmvs_tpu_torch import resolve_device
from hpmvs_tpu_torch.parallel import mesh as pmesh
from hpmvs_tpu_torch.testing import _quatR, _rot_to_quat


class BAProblem(NamedTuple):
    """Measurement table in point-sorted order (host-built, on a device)."""
    cam_K: torch.Tensor      # (C, 3, 3) intrinsics (fixed)
    cam_R0: torch.Tensor     # (C, 3, 3) initial rotations (world->cam)
    cam_t0: torch.Tensor     # (C, 3) initial translations
    pts0: torch.Tensor       # (Pn, 3) initial points
    m_cam: torch.Tensor      # (M,) int32 camera index per measurement
    m_pt: torch.Tensor       # (M,) int32 point index per measurement
    m_uv: torch.Tensor       # (M, 2) observed pixel coordinates
    m_w: torch.Tensor        # (M,) weight (0 pads)

    def to(self, device) -> "BAProblem":
        return BAProblem(*(t.to(device) for t in self))


def _skew(w):
    z = torch.zeros_like(w[0])
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def _exp_so3(w):
    """Rodrigues with Taylor-safe coefficients: differentiable at w = 0
    (a plain norm() NaNs the forward-mode Jacobian there; forward mode
    selects the Taylor branch's tangent, so the other branch's 0/0 never
    reaches it)."""
    th2 = torch.dot(w, w)
    th = torch.sqrt(th2 + 1e-24)
    small = th2 < 1e-8
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2)
    K = _skew(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + A * K + B * (K @ K)


def _residual(cam_param, pt, K, R0, t0, uv):
    """cam_param = (w(3), dt(3)); returns (2,) reprojection residual."""
    R = R0 @ _exp_so3(cam_param[:3])
    t = t0 + cam_param[3:6]
    xc = R @ pt + t
    z = torch.clamp(xc[2], min=1e-6)
    uvp = (K @ (xc / z))[:2]
    return uvp - uv


def _residual_aux(cam_param, pt, K, R0, t0, uv):
    r = _residual(cam_param, pt, K, R0, t0, uv)
    return r, r


# batched residuals, and ((M,2,6) camera, (M,2,3) point) Jacobians with
# the residuals as aux, in one forward-mode pass over 9 tangents
res_fn = vmap(_residual)
jac_fn = vmap(jacfwd(_residual_aux, argnums=(0, 1), has_aux=True))


def _cam_tables(model):
    """(R0 (C,3,3), t0 (C,3), f (C,)) world->cam tables from an NVM model."""
    ncam = len(model.cameras)
    R0 = np.zeros((ncam, 3, 3))
    t0 = np.zeros((ncam, 3))
    f = np.zeros(ncam)
    for ci, cam in enumerate(model.cameras):
        R0[ci] = _quatR(cam.rq)
        t0[ci] = -R0[ci] @ cam.c
        f[ci] = cam.f
    return R0, t0, f


def _problem(K, R0, t0, pts, m_cam, m_pt, m_uv, device) -> BAProblem:
    """Host arrays -> BAProblem on `device` (float32, int32 indices)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                               device=dev)

    m_cam = np.asarray(m_cam, np.int32)
    return BAProblem(
        cam_K=f32(K), cam_R0=f32(R0), cam_t0=f32(t0), pts0=f32(pts),
        m_cam=torch.as_tensor(m_cam, device=dev),
        m_pt=torch.as_tensor(np.asarray(m_pt, np.int32), device=dev),
        m_uv=f32(np.asarray(m_uv, np.float64).reshape(-1, 2)),
        m_w=torch.ones(len(m_cam), dtype=torch.float32, device=dev))


def _intrinsics(f):
    """(C, 3, 3) K with the principal point at 0: NVM uv is relative to the
    image center (VisualSFM convention)."""
    K = np.zeros((len(f), 3, 3))
    K[:, 0, 0] = f
    K[:, 1, 1] = f
    K[:, 2, 2] = 1.0
    return K


def build_problem(model, max_points: int = 0, device="cuda") -> BAProblem:
    """Sparse problem from a parsed NVM model (measurements sorted by point
    already, NVM stores them per point), on `device` (the GPU unless
    device="cpu")."""
    R0, t0, f = _cam_tables(model)
    npts = model.n_points if max_points <= 0 else min(model.n_points,
                                                      max_points)
    m_end = int(model.meas_start[npts])
    counts = np.diff(model.meas_start[:npts + 1])
    return _problem(_intrinsics(f), R0, t0, model.points_xyz[:npts],
                    model.meas_img[:m_end],
                    np.repeat(np.arange(npts), counts),
                    model.meas_xy[:m_end], device)


# Per-measurement and per-point products of tiny blocks, written as
# elementwise products and sums: einsum would hand them to batched cuBLAS
# gemv/gemm calls with millions of 3x6 problems, which run far below the
# memory rate on the card.
def _mv(A, x):
    """A @ x per row: (N, a, b), (N, b) -> (N, a)."""
    return (A * x.unsqueeze(-2)).sum(-1)


def _mtv(A, y):
    """A^T @ y per row: (N, a, b), (N, a) -> (N, b)."""
    return (A * y.unsqueeze(-1)).sum(-2)


def _gram(A, B):
    """A^T @ B per row: (N, i, a), (N, i, b) -> (N, a, b)."""
    return sum(A[:, i, :, None] * B[:, i, None, :] for i in range(A.shape[1]))


def _segsum(vals, idx, n):
    """Segment sum of vals (M, ...) by idx (M,) into n rows (index_add_)."""
    return vals.new_zeros((n,) + vals.shape[1:]).index_add_(0, idx, vals)


# A camera holds ~M / C measurements (10^5 and more on a dense cloud), so
# its index_add_ rows would take that many atomic adds each on CUDA: the
# adds spread over CAM_SPREAD copies of every camera row (by measurement
# index), which a second sum folds. Points hold a few measurements each
# and take the plain index_add_.
CAM_SPREAD = 256

# measurements per Jacobian pass: bounds forward mode's (chunk, 9, 3, 3)
# intermediates
JAC_CHUNK = 1 << 18


def _jacobians(cam, pts, cc, pp, K_m, R0_m, t0_m, uv):
    """((M,2,6) camera, (M,2,3) point) Jacobians and (M,2) residuals, in
    chunks of JAC_CHUNK measurements."""
    parts = [jac_fn(cam.index_select(0, cc[a:a + JAC_CHUNK]),
                    pts.index_select(0, pp[a:a + JAC_CHUNK]),
                    K_m[a:a + JAC_CHUNK], R0_m[a:a + JAC_CHUNK],
                    t0_m[a:a + JAC_CHUNK], uv[a:a + JAC_CHUNK])
             for a in range(0, len(cc), JAC_CHUNK)]
    if len(parts) == 1:
        return parts[0]
    return ((torch.cat([q[0][0] for q in parts]),
             torch.cat([q[0][1] for q in parts])),
            torch.cat([q[1] for q in parts]))


def ba_solve(prob: BAProblem, n_cams: int, n_pts: int, iters: int = 5,
             cg_iters: int = 30, damping: float = 1e-3, fix_count: int = 1,
             device="cuda"):
    """Gauss-Newton BA with point elimination on `device` (the GPU unless
    device="cpu"; the problem moves there): the solve of ba_solve_sharded
    over a one-shard mesh, whose sums are the lone shard's own tensors. The
    whole solve is enqueued without a host synchronisation.

    Returns device tensors (cam_params (C,6), points (Pn,3),
    rms_history (iters+1,))."""
    dev = pmesh._resolve(device)
    return _solve(pmesh.Mesh([dev], (1, 1)), prob.to(dev), n_cams, n_pts,
                  iters, cg_iters, damping, fix_count, final_rms=True)


def ba_solve_sharded(mesh, prob: BAProblem, n_cams: int, n_pts: int,
                     iters: int = 5, cg_iters: int = 30,
                     damping: float = 1e-3, fix_count: int = 1):
    """Distributed BA: measurements sharded by point over the mesh (shard i
    holds rows [i*M/n, (i+1)*M/n) of the table); every per-camera and
    per-point accumulation is a sum of per-shard partial sums and every CG
    matvec a summed one. Each shard keeps its own replica of the cameras,
    points, damping and CG vectors, computed alike from the sums.

    The measurement table must be padded so that M divides the mesh size
    and no point's measurements straddle a shard boundary (pad rows with
    m_w = 0): use shard_problem(). Returns this process's first shard's
    replicas (cam_params (C,6), points (Pn,3), rms_history (iters,): the
    RMS before each step, without ba_solve's final entry, as the JAX
    package's sharded solve) on its device. Over a mesh that spans
    processes, every process calls it with the same problem and computes
    its own shards' rows."""
    return _solve(mesh, prob, n_cams, n_pts, iters, cg_iters, damping,
                  fix_count, final_rms=False)


def _solve(mesh, prob: BAProblem, n_cams: int, n_pts: int, iters: int,
           cg_iters: int, damping: float, fix_count: int, final_rms: bool):
    """The Gauss-Newton / Schur / Jacobi-CG solve over per-shard lists
    (ba_solve_sharded's contract); final_rms appends the RMS after the last
    step to the history (ba_solve's)."""
    n = mesh.size
    M = int(prob.m_cam.shape[0])
    if M % n:
        raise ValueError(f"{M} measurements do not split over {n} shards: "
                         "use shard_problem")
    per = M // n
    tabs = pmesh.replicate_tables(mesh, (prob.cam_K, prob.cam_R0,
                                         prob.cam_t0, prob.pts0))
    # this process's shards (every shard of a single-process mesh)
    loc = [int(i) for i in mesh.local_ids]
    sh = []
    for i in loc:
        dev = mesh.devices[i]
        rows = slice(i * per, (i + 1) * per)
        K, R0, t0, _ = tabs[i]
        cc = prob.m_cam[rows].to(dev).long()
        pp = prob.m_pt[rows].to(dev).long()
        wm = prob.m_w[rows].to(dev)
        spread = torch.arange(per, device=dev) % CAM_SPREAD
        sh.append(dict(cc=cc, pp=pp, wm=wm, w2=wm[:, None],
                       w3=wm[:, None, None], uv=prob.m_uv[rows].to(dev),
                       K_m=K.index_select(0, cc), R0_m=R0.index_select(0, cc),
                       t0_m=t0.index_select(0, cc),
                       cc_spread=cc * CAM_SPREAD + spread))

    def camsum(x, vals):
        return _segsum(vals, x["cc_spread"], n_cams * CAM_SPREAD).view(
            (n_cams, CAM_SPREAD) + vals.shape[1:]).sum(1)

    def psum(parts):
        return pmesh.psum(parts, mesh)

    devs = [mesh.devices[i] for i in loc]
    eye3 = [torch.eye(3, dtype=torch.float32, device=d) for d in devs]
    # gauge fix: freeze the first fix_count cameras. ONE camera pins 6 DoF
    # but leaves the global-scale gauge free (reprojection-only BA); TWO
    # anchors pin the full 7-DoF similarity gauge.
    mask_c = []
    for d in devs:
        m = torch.ones((n_cams, 1), dtype=torch.float32, device=d)
        if fix_count > 0:
            m[:fix_count] = 0.0
        mask_c.append(m)

    def prms(rs):
        """Weighted RMS over all shards' residuals (replicated)."""
        sq = psum([torch.sum(x["wm"] * torch.sum(r * r, -1))
                   for x, r in zip(sh, rs)])
        nw = psum([torch.sum(x["wm"]) for x in sh])
        return [torch.sqrt(a / torch.clamp(b, min=1.0))
                for a, b in zip(sq, nw)]

    def residuals(cam, pts):
        return [res_fn(c.index_select(0, x["cc"]), p.index_select(0, x["pp"]),
                       x["K_m"], x["R0_m"], x["t0_m"], x["uv"])
                for x, c, p in zip(sh, cam, pts)]

    cam = [torch.zeros((n_cams, 6), dtype=torch.float32, device=d)
           for d in devs]
    pts = [tabs[i][3] for i in loc]
    lam = [torch.full((), damping, dtype=torch.float32, device=d)
           for d in devs]
    hist = []
    for _ in range(iters):
        jr = [_jacobians(c, p, x["cc"], x["pp"], x["K_m"], x["R0_m"],
                         x["t0_m"], x["uv"])
              for x, c, p in zip(sh, cam, pts)]
        Jc = [j[0][0] for j in jr]
        Jp = [j[0][1] for j in jr]
        r = [j[1] for j in jr]
        Hcc = psum([camsum(x, x["w3"] * _gram(a, a))
                    for x, a in zip(sh, Jc)])
        bc = psum([camsum(x, x["w2"] * _mtv(a, b))
                   for x, a, b in zip(sh, Jc, r)])
        # point blocks live entirely on one shard (sharded by point); the
        # sums gather the full point-block table on every shard
        Hpp = psum([_segsum(x["w3"] * _gram(a, a), x["pp"], n_pts)
                    for x, a in zip(sh, Jp)])
        bp = psum([_segsum(x["w2"] * _mtv(a, b), x["pp"], n_pts)
                   for x, a, b in zip(sh, Jp, r)])
        Hpp_inv = [torch.linalg.inv_ex(h + lm * e)[0]
                   for h, lm, e in zip(Hpp, lam, eye3)]
        Wpc = [x["w3"] * _gram(a, b) for x, a, b in zip(sh, Jp, Jc)]

        def pc(xc):
            """H_pc xc accumulated per point, summed over the shards."""
            return psum([_segsum(_mv(w, v.index_select(0, x["cc"])),
                                 x["pp"], n_pts)
                         for x, w, v in zip(sh, Wpc, xc)])

        def cp(yp):
            """H_cp yp accumulated per camera, summed over the shards."""
            return psum([camsum(x, _mtv(w, v.index_select(0, x["pp"])))
                         for x, w, v in zip(sh, Wpc, yp)])

        # Schur RHS: b_s = bc - Hcp Hpp^-1 bp
        y = [_mv(h, b) for h, b in zip(Hpp_inv, bp)]
        b_s = [a - b for a, b in zip(bc, cp(y))]

        def s_matvec(xc):
            """S @ xc without materialising S, summed over the shards."""
            xc = [v.reshape(n_cams, 6) * m for v, m in zip(xc, mask_c)]
            t1 = [_mv(h, v) + lm * v for h, v, lm in zip(Hcc, xc, lam)]
            z = [_mv(h, v) for h, v in zip(Hpp_inv, pc(xc))]
            return [((a - b) * m).reshape(-1)
                    for a, b, m in zip(t1, cp(z), mask_c)]

        # Jacobi-preconditioned CG on the reduced camera system, one
        # replica of its vectors per shard
        b_vec = [(b * m).reshape(-1) for b, m in zip(b_s, mask_c)]
        diag = [torch.clamp(torch.diagonal(h, dim1=1, dim2=2).reshape(-1)
                            + lm, min=1e-8) for h, lm in zip(Hcc, lam)]
        x = [torch.zeros_like(b) for b in b_vec]
        rr = b_vec
        p = [b / d for b, d in zip(b_vec, diag)]
        rz = [a @ b for a, b in zip(rr, p)]
        for _ in range(cg_iters):
            Ap = s_matvec(p)
            alpha = [a / torch.clamp(q @ b, min=1e-20)
                     for a, q, b in zip(rz, p, Ap)]
            x = [v + al * q for v, al, q in zip(x, alpha, p)]
            rr = [v - al * b for v, al, b in zip(rr, alpha, Ap)]
            z = [v / d for v, d in zip(rr, diag)]
            rz_new = [a @ b for a, b in zip(rr, z)]
            beta = [a / torch.clamp(b, min=1e-20)
                    for a, b in zip(rz_new, rz)]
            p = [a + be * q for a, be, q in zip(z, beta, p)]
            rz = rz_new
        dc = [-v.reshape(n_cams, 6) * m for v, m in zip(x, mask_c)]
        # back-substitute points: dp = -Hpp^-1 (bp + Hpc dc)
        dp = [-_mv(h, b + z) for h, b, z in zip(Hpp_inv, bp, pc(dc))]
        new_cam = [a + b for a, b in zip(cam, dc)]
        new_pts = [a + b for a, b in zip(pts, dp)]
        # Levenberg adaptation: accept + relax on improvement, reject +
        # stiffen otherwise
        rms0 = prms(r)
        better = [a < b for a, b in
                  zip(prms(residuals(new_cam, new_pts)), rms0)]
        cam = [torch.where(bt, a, b) for bt, a, b in zip(better, new_cam, cam)]
        pts = [torch.where(bt, a, b) for bt, a, b in zip(better, new_pts, pts)]
        lam = [torch.where(bt, torch.clamp(lm / 3.0, min=1e-6), lm * 10.0)
               for bt, lm in zip(better, lam)]
        hist.append(rms0[0])
    if final_rms:
        hist.append(prms(residuals(cam, pts))[0])
    return cam[0], pts[0], torch.stack(hist)


def shard_problem(prob: BAProblem, n_shards: int) -> BAProblem:
    """Pad + reorder the measurement table so points don't straddle shards
    (on the problem's device)."""
    dev = prob.m_cam.device
    m_pt = prob.m_pt.cpu().numpy()
    m_cam = prob.m_cam.cpu().numpy()
    m_uv = prob.m_uv.cpu().numpy()
    m_w = prob.m_w.cpu().numpy()
    order = np.argsort(m_pt, kind="stable")
    m_pt, m_cam, m_uv, m_w = (m_pt[order], m_cam[order], m_uv[order],
                              m_w[order])
    M = len(m_pt)
    per = -(-M // n_shards)
    # greedy: walk the points' runs, close a shard when it would overflow
    # `per`
    cut = np.flatnonzero(np.diff(m_pt)) + 1
    run_a = np.concatenate([[0], cut]).astype(np.int64)
    run_b = np.concatenate([cut, [M]]).astype(np.int64)
    rows = [[] for _ in range(n_shards)]
    shard, filled = 0, 0
    for i, j in (zip(run_a, run_b) if M else ()):
        if filled + (j - i) > per and shard + 1 < n_shards:
            shard += 1
            filled = 0
        rows[shard].append(np.arange(i, j))
        filled += j - i
    idx = [np.concatenate(r) if r else np.zeros(0, np.int64) for r in rows]
    width = max(per, max(len(r) for r in idx))
    out_cam = np.zeros((n_shards, width), np.int32)
    out_pt = np.zeros((n_shards, width), np.int32)
    out_uv = np.zeros((n_shards, width, 2), np.float32)
    out_w = np.zeros((n_shards, width), np.float32)
    for s, r in enumerate(idx):
        out_cam[s, :len(r)] = m_cam[r]
        out_pt[s, :len(r)] = m_pt[r]
        out_uv[s, :len(r)] = m_uv[r]
        out_w[s, :len(r)] = m_w[r]
    return prob._replace(
        m_cam=torch.as_tensor(out_cam.reshape(-1), device=dev),
        m_pt=torch.as_tensor(out_pt.reshape(-1), device=dev),
        m_uv=torch.as_tensor(out_uv.reshape(-1, 2), device=dev),
        m_w=torch.as_tensor(out_w.reshape(-1), device=dev))


def build_dense_problem(model, centers: np.ndarray, views: np.ndarray,
                        device="cuda") -> BAProblem:
    """BAProblem over DENSIFIED PATCHES: point i = patch center i, with one
    measurement per entry of its view list, uv = the patch's reprojection
    under the given cameras (its creation-time observation).

    The cameras+PATCHES bundle adjustment of the north star: the dense
    cloud acts as a large tie-point set, and H_pp stays 3x3
    block-diagonal exactly as for sparse points."""
    R0, t0, f = _cam_tables(model)
    views = np.asarray(views)
    centers = np.asarray(centers, np.float64)
    pt_idx, k_idx = np.nonzero(views >= 0)
    cam_idx = views[pt_idx, k_idx].astype(np.int64)
    # uv (principal-point-relative, the NVM/VisualSFM convention the
    # residual's cx=cy=0 intrinsics expect)
    xc = np.einsum("mij,mj->mi", R0[cam_idx], centers[pt_idx]) + t0[cam_idx]
    z = np.maximum(xc[:, 2], 1e-6)
    uv = f[cam_idx, None] * xc[:, :2] / z[:, None]
    keep = xc[:, 2] > 1e-6
    return _problem(_intrinsics(f), R0, t0, centers, cam_idx[keep],
                    pt_idx[keep], uv[keep], device)


def stamp_obs(model, centers: np.ndarray, views: np.ndarray) -> np.ndarray:
    """(N, K, 2) uv reprojections of each patch center into its view
    cameras under `model` -- the creation-time observation record for
    periodic dense BA. Invalid/behind-camera slots are NaN."""
    R0, t0, f = _cam_tables(model)
    centers = np.asarray(centers, np.float64)
    views = np.asarray(views)
    N, K = views.shape
    uv = np.full((N, K, 2), np.nan, np.float32)
    pt_idx, k_idx = np.nonzero(views >= 0)
    ci = views[pt_idx, k_idx].astype(np.int64)
    xc = np.einsum("mij,mj->mi", R0[ci], centers[pt_idx]) + t0[ci]
    ok = xc[:, 2] > 1e-6
    z = np.maximum(xc[:, 2], 1e-6)
    vals = (f[ci, None] * xc[:, :2] / z[:, None]).astype(np.float32)
    vals[~ok] = np.nan
    uv[pt_idx, k_idx] = vals
    return uv


class DenseObsStore:
    """Per-patch creation-time observations for periodic dense BA
    (ba_dense_every): each alive patch's uv reprojections are stamped ONCE,
    under the cameras current when the patch is first seen by a periodic
    pass. Later passes then solve cameras+centers against these earlier
    measurements, so camera drift accumulated since is genuinely
    constrained -- a problem built fresh from the current state would be
    self-consistent and the solve a no-op. pids are append-only
    (PatchStore.alloc never reuses slots), so stamps stay valid for a
    patch's lifetime."""

    def __init__(self, max_views: int):
        self.K = max_views
        self.uv = np.full((0, max_views, 2), np.nan, np.float32)
        self.stamped = np.zeros((0,), bool)

    def _ensure(self, n: int):
        if len(self.stamped) >= n:
            return
        cap = max(1024, len(self.stamped))
        while cap < n:
            cap *= 2
        uv = np.full((cap, self.K, 2), np.nan, np.float32)
        uv[:len(self.uv)] = self.uv
        st = np.zeros((cap,), bool)
        st[:len(self.stamped)] = self.stamped
        self.uv, self.stamped = uv, st


def build_dense_problem_obs(model, centers: np.ndarray, views: np.ndarray,
                            uv: np.ndarray, device="cuda") -> BAProblem:
    """BAProblem whose measurements are the STORED observations `uv`
    ((N, K, 2), NaN = invalid) instead of reprojections under the current
    cameras (cf. build_dense_problem)."""
    R0, t0, f = _cam_tables(model)
    views = np.asarray(views)
    centers = np.asarray(centers, np.float64)
    pt_idx, k_idx = np.nonzero(views >= 0)
    cam_idx = views[pt_idx, k_idx].astype(np.int64)
    muv = uv[pt_idx, k_idx]
    keep = np.isfinite(muv).all(1)
    return _problem(_intrinsics(f), R0, t0, centers, cam_idx[keep],
                    pt_idx[keep], muv[keep], device)


def periodic_dense_ba(engine, obs: DenseObsStore, iters: int = 6,
                      cg_iters: int = 40, device="cuda"):
    """One ba_dense_every pass: stamp observations for patches created
    since the last pass, then re-solve cameras+patches against ALL stamped
    observations on `device` and fold the result back (apply_dense_ba).

    Owned multi-process engines take the consistency-solve path (the
    problem built from the globally gathered current state), as the JAX
    package does: per-process stamp stores would need gather-order
    bookkeeping."""
    if hasattr(engine, "n_alive_local"):
        return apply_dense_ba(engine, iters=iters, cg_iters=cg_iters,
                              device=device)
    p = engine.patches
    pids = np.nonzero(p.alive[:p.n])[0]
    if len(pids) < 16:
        return None
    obs._ensure(p.n)
    new = pids[~obs.stamped[pids]]
    if len(new):
        obs.uv[new] = stamp_obs(engine.model, p.center[new], p.views[new])
        obs.stamped[new] = True
    prob = build_dense_problem_obs(engine.model, p.center[pids],
                                   p.views[pids], obs.uv[pids], device=device)
    return apply_dense_ba(engine, iters=iters, cg_iters=cg_iters,
                          problem=prob, device=device)


def _refined_cameras(model, cam_params: np.ndarray):
    """A copy of `model` with the refined camera parameters written back."""
    out = copy.deepcopy(model)
    cam_params = np.asarray(cam_params, np.float64)
    for ci, cam in enumerate(out.cameras):
        R0 = _quatR(cam.rq)
        t0 = -R0 @ cam.c
        w = cam_params[ci, :3]
        th = np.linalg.norm(w) + 1e-12
        Km = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                       [-w[1], w[0], 0]]) / th
        R = R0 @ (np.eye(3) + np.sin(th) * Km + (1 - np.cos(th)) * (Km @ Km))
        t = t0 + cam_params[ci, 3:6]
        cam.rq = _rot_to_quat(R)
        cam.c = -R.T @ t
    return out


def apply_cameras_to_model(model, cam_params: np.ndarray):
    """Write refined camera parameters back into a (copied) NVM model,
    leaving the sparse points untouched."""
    return _refined_cameras(model, cam_params)


def apply_to_model(model, cam_params: np.ndarray, points: np.ndarray):
    """Write the refined cameras/points back into a (copied) NVM model."""
    out = _refined_cameras(model, cam_params)
    out.points_xyz = np.asarray(points, np.float64).copy()
    return out


def apply_dense_ba(engine, iters: int = 8, cg_iters: int = 40,
                   problem: BAProblem = None, fix_count: int = 2,
                   device="cuda"):
    """Run cameras+patches BA on a densified engine, solving on `device`
    (the GPU unless device="cpu"), and fold the result back in: the
    engine's camera SoA rebuilt on its device, patch centers updated, the
    depth z-buffer replayed from scratch (one _set_depths pass over the
    live patches). Returns the RMS history (host numpy), or None without
    patches.

    problem: a pre-built BAProblem whose observations were recorded under
    earlier cameras (drift correction); the default builds one from the
    CURRENT state (then the solve is a consistency no-op unless cameras
    have been perturbed since densification).

    Sharding: with engine.mesh, the measurement table shards by patch over
    the mesh (shard_problem) and every reduction is a sum over the shards
    (ba_solve_sharded); `device` is then unused.

    Owned multi-process engines (hpmvs_tpu/parallel/ba.py:537-552): every
    process gathers the GLOBAL cloud (the engine's alive_arrays, in
    process order), solves the same problem over the process-spanning mesh
    -- bit-identical on every process -- and folds back its own segment;
    the z-buffer replay gathers every process's adds. Every process calls
    it together, with the same `problem`."""
    from hpmvs_tpu_torch.core import depth as depth_mod
    owned = hasattr(engine, "n_alive_local")
    mesh = getattr(engine, "mesh", None)
    dev = engine.device if mesh is not None else resolve_device(device)
    # outstanding speculation captured pre-BA cameras and centers
    engine.drop_speculation()
    p = engine.patches
    pids = np.nonzero(p.alive[:p.n])[0]
    if owned:
        centers, _, _, _, views, _ = engine.alive_arrays()
        my_off = int(engine._gather(np.int64(len(pids)))[:engine.pid].sum())
    else:
        centers, views = p.center[pids], p.views[pids]
    if len(centers) == 0:
        return None
    if problem is None:
        problem = build_dense_problem(engine.model, centers, views,
                                      device=dev)
    n_cams, n_pts = len(engine.model.cameras), len(centers)
    if mesh is not None:
        cam, pts, hist = ba_solve_sharded(
            mesh, shard_problem(problem, mesh.size), n_cams, n_pts,
            iters=iters, cg_iters=cg_iters, fix_count=fix_count)
    else:
        cam, pts, hist = ba_solve(problem, n_cams, n_pts, iters=iters,
                                  cg_iters=cg_iters, fix_count=fix_count,
                                  device=dev)
    cam, pts, hist = (cam.cpu().numpy(), pts.cpu().numpy(),
                      hist.cpu().numpy())

    # fold back: cameras -> model + device SoA, centers -> patch store,
    # depth z-buffer replayed under the new geometry
    engine.set_cameras(apply_cameras_to_model(engine.model, cam))
    p.center[pids] = pts[my_off:my_off + len(pids)] if owned else pts
    engine._pend = []
    fresh = depth_mod.build_depth_pack(engine.scene.width_np,
                                       engine.scene.height_np,
                                       engine.opt.DEPTH_SUBSAMPLE,
                                       device=engine.device)
    engine.pack = dataclasses.replace(engine.pack, depth=fresh.depth)
    engine._set_depths(pids)
    engine._flush_depths()
    return hist
