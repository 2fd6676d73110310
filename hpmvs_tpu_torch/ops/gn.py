"""Kernels B4/B5: the batched Gauss-Newton (Levenberg) patch refinement.

Replaces hpmvs_tpu/ops/pallas_gn.py in all three of its modes: the
exact-Jacobian loop (LM_EXACT_J=True, the default; kernel "gn"), the
finite-difference/Broyden loop (LM_EXACT_J=False; kernel "gn_fd") and the
debug_j output (rho and the analytic J at x0, for checks). It is the
per-patch optimization of the reference
(PatchOptimizer::optimizePatch + objective_fn,
src/hpmvs/PatchOptimizer.cpp:286-382) over x = (depth along the reference
ray, two normal angles x pi/48). `_prep` packs the per-patch terms with
plain torch ops; the loop runs in csrc/gn.cu for CUDA tensors and in
`gn_refine_twin` (the same algorithm in plain PyTorch) for CPU tensors.

Both stop a 128-patch block early together, exactly as the TPU kernel does
over its 128-lane block, so the batch is always padded to a multiple of 128.
The objective evaluates the first min(K, MAX_IMAGES_PER_PATCH) view slots
(the cap the reference computes at PatchOptimizer.cpp:298).

The FD mode is the TPU kernel's algorithm, not the plain refiner's
(ops/optimizer._optimize_patch, FD branch): it shrinks the FD step every
round and stops a block early.

The kernel runs one warp per patch and sums over the 49 texels in its lane
order (`lane_sum`); on CUDA tensors the twin sums in the same order, so the
two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from hpmvs_tpu_torch import kernels
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.ops import sampling
from hpmvs_tpu_torch.ops.score import (bilinear_taps, div, sampling_grid,
                                       seq_sum)
from hpmvs_tpu_torch.ops.windows import WinState

NB = 128          # patches per early-stop block
P = sampling.PATCH_SIZE
P2 = P * P
BIG = 1e9
GN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class GNStatics:
    W: int
    K: int
    iters: int          # FD mode: iterations (rounds = ceil(iters / inner))
    inner: int          # FD mode: Broyden trials per Jacobian refresh
    angle_scale: float
    cos_max: float
    min_images: int
    angle_bound: float
    lam0: float
    ftol: float
    h_shrink: float     # FD mode: FD step decay per round
    exact_j: bool
    iters_exact: int
    step_clamp: float
    debug_j: bool = False


def _prep(ctx, opt: Options, center, normal, scale, views, ws: WinState):
    """Per-patch precomputed terms (patch-major).

    center (B,3), normal (B,3), scale (B,), views (B,K'), ws over K' slots;
    only the first K = min(K', MAX_IMAGES_PER_PATCH) slots enter. With
    center(x) = ref_center + x0*ref_ray the homogeneous projection is affine
    in x0: P.[center;1] = P.[ref_center;1] + x0 * P3.ref_ray."""
    from hpmvs_tpu_torch.ops.optimizer import _params_from_center_norm

    B = center.shape[0]
    K = min(views.shape[1], opt.MAX_IMAGES_PER_PATCH)
    views_k = views[:, :K]
    level = ws.level[:, :K].long()
    cams, imgs = ctx.cams, ctx.imgs

    ref_ci = torch.clamp(views[:, 0], min=0).long()
    ref_center = center
    ref_ray = sampling.normalize3(center - cams.center[ref_ci])
    ax_x = sampling.normalize3(cams.xaxis[ref_ci])
    ax_y = sampling.normalize3(cams.yaxis[ref_ci])
    ax_z = sampling.normalize3(cams.zaxis[ref_ci])

    ci = torch.clamp(views_k, min=0).long()              # (B, K)
    Pm = cams.P[ci, level]                               # (B, K, 3, 4)
    Pl3 = Pm[..., :3]
    ch = torch.cat([ref_center, torch.ones_like(ref_center[:, :1])], -1)
    Pc = torch.einsum("bkij,bj->bki", Pm, ch)             # (B, K, 3)
    Pr = torch.einsum("bkij,bj->bki", Pl3, ref_ray)
    camc = cams.center[ci]
    lim = torch.stack([imgs.width[ci, level], imgs.height[ci, level]],
                      dim=-1).to(center.dtype)
    org = torch.stack([ws.ox[:, :K], ws.oy[:, :K]], dim=-1).to(center.dtype)
    mask = (views_k >= 0).to(center.dtype)

    x0 = _params_from_center_norm(center, sampling.normalize3(normal),
                                  ref_center, ref_ray, ax_x, ax_y, ax_z, opt)
    h = torch.stack([0.05 * scale, torch.full_like(scale, 0.25),
                     torch.full_like(scale, 0.25)], dim=-1)
    ref = torch.stack([ref_center, ref_ray, ax_x, ax_y, ax_z], dim=1)
    args = dict(x0=x0, h=h, ref=ref, scale=scale, pc=Pc, pr=Pr,
                p9=Pl3.reshape(B, K, 9), camc=camc, lim=lim, org=org,
                mask=mask, win=ws.win)
    args = {k: v.contiguous() for k, v in args.items()}
    st = GNStatics(W=ws.W, K=K, iters=int(opt.LM_ITERS),
                   inner=max(1, int(opt.LM_INNER)),
                   angle_scale=float(opt.ANGLE_SCALE),
                   cos_max=float(math.cos(opt.MAX_ANGLE)),
                   min_images=int(opt.MIN_IMAGES_PER_PATCH),
                   angle_bound=float(opt.ANGLE_BOUND),
                   lam0=float(opt.LM_LAMBDA0), ftol=float(opt.LM_FTOL),
                   h_shrink=float(opt.LM_H_SHRINK),
                   exact_j=bool(opt.LM_EXACT_J),
                   iters_exact=int(opt.LM_ITERS_EXACT),
                   step_clamp=float(opt.LM_STEP_CLAMP))
    return st, args, (ref_center, ref_ray, ax_x, ax_y, ax_z)


def gn_refine(st: GNStatics, x0, h, ref, scale, pc, pr, p9, camc, lim, org,
              mask, win):
    """The GN kernel in the mode st selects, on prepped inputs (B % 128 ==
    0). Returns (x (B,3), f (B,)); with st.debug_j (x0, f at x0, J (B,3,K),
    rho (B,K)) instead.

    win may hold more view slots than st.K; only the first st.K are read."""
    if not x0.is_cuda:
        return gn_refine_twin(st, x0, h, ref, scale, pc, pr, p9, camc, lim,
                              org, mask, win)
    B, K = x0.shape[0], st.K
    if B % NB:
        raise ValueError(f"gn_refine: B={B} is not a multiple of {NB}")
    Kw = win.shape[1]
    f32 = torch.float32
    for name, t, shape in (("x0", x0, (B, 3)), ("h", h, (B, 3)),
                           ("ref", ref, (B, 5, 3)), ("scale", scale, (B,)),
                           ("pc", pc, (B, K, 3)), ("pr", pr, (B, K, 3)),
                           ("p9", p9, (B, K, 9)), ("camc", camc, (B, K, 3)),
                           ("lim", lim, (B, K, 2)), ("org", org, (B, K, 2)),
                           ("mask", mask, (B, K)),
                           ("win", win, (B, Kw, st.W, st.W, 3))):
        kernels.check(t, name, f32, shape)
    if Kw < K:
        raise ValueError("gn_refine: fewer window slots than views")
    x = torch.empty((B, 3), dtype=f32, device=x0.device)
    f = torch.empty((B,), dtype=f32, device=x0.device)
    p = kernels.ptr
    ci, cf = ctypes.c_int, ctypes.c_float
    ins = (p(x0), p(h), p(ref), p(scale), p(pc), p(pr), p(p9), p(camc),
           p(lim), p(org), p(mask), p(win), p(x), p(f))
    if st.debug_j:
        J = torch.empty((B, 3, K), dtype=f32, device=x0.device)
        rho = torch.empty((B, K), dtype=f32, device=x0.device)
        kernels.launch("hpmvs_gn_debug_j", *ins, p(J), p(rho), ci(B), ci(K),
                       ci(Kw), ci(st.W), cf(st.angle_scale), cf(st.cos_max),
                       cf(float(st.min_images)))
        kernels.STATS["gn"].launches += 1
        return x, f, J, rho
    if st.exact_j:
        kernels.launch("hpmvs_gn_refine", *ins, ci(B), ci(K), ci(Kw),
                       ci(st.W), ci(st.iters_exact), cf(st.angle_scale),
                       cf(st.cos_max), cf(float(st.min_images)),
                       cf(st.angle_bound), cf(st.lam0), cf(st.ftol),
                       cf(st.step_clamp))
        kernels.STATS["gn"].launches += 1
    else:
        kernels.launch("hpmvs_gn_refine_fd", *ins, ci(B), ci(K), ci(Kw),
                       ci(st.W), ci(st.iters), ci(st.inner),
                       cf(st.angle_scale), cf(st.cos_max),
                       cf(float(st.min_images)), cf(st.angle_bound),
                       cf(st.lam0), cf(st.ftol), cf(st.h_shrink))
        kernels.STATS["gn_fd"].launches += 1
    return x, f


_LAUNCH_KEYS = ("ctas", "threads_per_cta", "ctas_per_cluster",
                "static_smem_bytes", "registers", "local_bytes",
                "max_active_clusters")


def launch_info(st: GNStatics, B: int) -> dict:
    """How the GN kernel in st's mode launches for B patches, as the loaded
    library and the CUDA runtime report it: CTAs, threads per CTA, CTAs per
    cluster, static shared memory per CTA, registers and local memory per
    thread, and the most clusters the card holds at once."""
    mode = 2 if st.debug_j else (0 if st.exact_j else 1)
    out = (ctypes.c_int * len(_LAUNCH_KEYS))()
    err = kernels.lib().hpmvs_gn_launch_info(ctypes.c_int(mode),
                                             ctypes.c_int(B), out)
    if err != 0:
        raise RuntimeError(f"hpmvs_gn_launch_info failed with error {err}")
    return dict(zip(_LAUNCH_KEYS, out))


# ---------------------------------------------------------------------------
# Plain PyTorch twin: the kernel's algorithm, vectorized over patches.
# ---------------------------------------------------------------------------

def _ordered(t, ordered):
    return t.is_cuda if ordered is None else ordered


def lane_sum(t, dim: int, ordered=None):
    """Sum over the 49-texel axis dim. Ordered (by default on CUDA tensors,
    where the twin is held against its kernel) in the kernel's order: lane
    l < 17 adds texel l + 32 to texel l, then an xor butterfly over 32
    lanes with offsets 16, 8, 4, 2, 1 (csrc/gn.cu::lane_sums); otherwise
    torch.sum, as ops/score.py::seq_sum on the CPU. ordered=True forces the
    kernel's order on any device."""
    if not _ordered(t, ordered):
        return torch.sum(t, dim=dim)
    t = t.movedim(dim, -1)
    v = t[..., :32].clone()
    v[..., :P2 - 32] += t[..., 32:P2]
    o = 16
    while o:
        v = v[..., :o] + v[..., o:2 * o]
        o //= 2
    return v[..., 0]


def _chan_sum(t, ordered):
    """Sum over the last (channel) axis in channel order when ordered, as
    ops/score.py::seq_sum does on CUDA."""
    if not _ordered(t, ordered):
        return torch.sum(t, dim=-1)
    return t[..., 0] + t[..., 1] + t[..., 2]


def _normalize_lanes(tex, ordered=None):
    """Patch2d::normalize of (..., 49, 3) as the GN kernel computes it
    (csrc/gn.cu::normalize_lanes): texel sums by lane_sum, channel sums in
    channel order. Returns (cen, inv (..., 1, 1))."""
    mc = div(lane_sum(tex, -2, ordered), P2)[..., None, :]
    cen = tex - mc
    var = _chan_sum(lane_sum(cen * cen, -2, ordered), ordered)[..., None, None]
    sd = torch.sqrt(div(var, P2 * 3.0))
    inv = torch.where(sd == 0.0, torch.ones_like(sd), 1.0 / sd)
    return cen * inv, inv

def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _norm3(v):
    return v * torch.rsqrt(torch.clamp(_dot3(v, v), min=1e-24))[..., None]


def _objective(st: GNStatics, a, x, grad: bool, ordered=None):
    """One objective pass at x (B, 3) for all patches. Returns (rho (B,K),
    n (B,), ref_ok (B,), J (B,3,K) or None); see csrc/gn.cu::objective.
    ordered: the texel and channel sums in the kernel's order (lane_sum)."""
    K, W = st.K, st.W
    sA = st.angle_scale
    half = P / 2.0
    rc, rr, e0, e1, e2 = (a["ref"][:, i] for i in range(5))
    scale = a["scale"][:, None]
    x0v, x1v, x2v = x[:, 0:1], x[:, 1], x[:, 2]
    c = rc + x0v * rr
    a1, a2 = x1v * sA, x2v * sA
    sa1, ca1, sa2, ca2 = torch.sin(a1), torch.cos(a1), torch.sin(a2), torch.cos(a2)

    def world(fx, fy, fz):
        return (e0 * fx[:, None] + e1 * fy[:, None] + e2 * fz[:, None])

    z = _norm3(world(sa1 * ca2, sa2, -ca1 * ca2))
    dz = [None,
          world(ca1 * ca2 * sA, torch.zeros_like(sa2), sa1 * ca2 * sA),
          world(-sa1 * sa2 * sA, ca2 * sA, ca1 * sa2 * sA)]
    for q in (1, 2):
        dz[q] = dz[q] - z * _dot3(dz[q], z)[:, None]
    u = _cross(z, e0)
    rnu = torch.rsqrt(torch.clamp(_dot3(u, u), min=1e-24))[:, None]
    y = u * rnu
    v = _norm3(_cross(y, z))
    xax = v * scale
    ydot = _dot3(y, e1)[:, None] * scale
    yax = y * ydot
    dxax = [None, None, None]
    dyax = [None, None, None]
    if grad:
        for q in (1, 2):
            dup = _cross(dz[q], e0)
            dyp = (dup - y * _dot3(y, dup)[:, None]) * rnu
            dv = _cross(dyp, z) + _cross(y, dz[q])
            dxax[q] = (dv - v * _dot3(v, dv)[:, None]) * scale
            de1 = _dot3(dyp, e1)[:, None] * scale
            dyax[q] = dyp * ydot + y * de1

    pc, pr, p9 = a["pc"], a["pr"], a["p9"]          # (B,K,3), (B,K,3), (B,K,9)

    def pmul(w3, i):                                 # w3 (B, 3) -> (B, K)
        return (p9[..., 3 * i] * w3[:, None, 0] + p9[..., 3 * i + 1] * w3[:, None, 1]
                + p9[..., 3 * i + 2] * w3[:, None, 2])

    phc = [pc[..., i] + x0v * pr[..., i] for i in range(3)]
    phx = [phc[i] + pmul(xax, i) for i in range(3)]
    phy = [phc[i] + pmul(yax, i) for i in range(3)]
    one = torch.ones_like(phc[2])
    front = phc[2] > 0.0
    rwc = 1.0 / torch.where(front, phc[2], one)
    c2x, c2y = phc[0] * rwc, phc[1] * rwc
    rwx = 1.0 / torch.where(phx[2] != 0.0, phx[2], one)
    xx2, xy2 = phx[0] * rwx, phx[1] * rwx
    dxx, dxy = xx2 - c2x, xy2 - c2y
    rwy = 1.0 / torch.where(phy[2] != 0.0, phy[2], one)
    yx2, yy2 = phy[0] * rwy, phy[1] * rwy
    dyx, dyy = yx2 - c2x, yy2 - c2y

    r = _norm3(a["camc"] - c[:, None])
    angle_ok = _dot3(r, z[:, None]) >= st.cos_max
    adx = half * (torch.abs(dxx) + torch.abs(dyx))
    ady = half * (torch.abs(dxy) + torch.abs(dyy))
    mnx, mxx = c2x - adx, c2x + adx
    mny, mxy = c2y - ady, c2y + ady
    lim, org = a["lim"], a["org"]
    bounds_ok = ((mnx >= 3.0) & (mny >= 3.0) & (mxx < lim[..., 0] - 3.0)
                 & (mxy < lim[..., 1] - 3.0))
    oxf, oyf = org[..., 0], org[..., 1]
    cover_ok = ((mnx - oxf >= 0.0) & (mny - oyf >= 0.0)
                & (mxx - oxf <= W - 1.0) & (mxy - oyf <= W - 1.0))
    valid = front & angle_ok & bounds_ok & cover_ok & (a["mask"] > 0.0)

    IX, IY = sampling_grid(x.device)
    tlx = (c2x - half * (dxx + dyx) - oxf)[..., None]
    tly = (c2y - half * (dxy + dyy) - oyf)[..., None]
    gx = torch.clamp(tlx + IX * dxx[..., None] + IY * dyx[..., None], 0.0, W - 1.0)
    gy = torch.clamp(tly + IX * dxy[..., None] + IY * dyy[..., None], 0.0, W - 1.0)
    win = a["win"][:, :K]
    if grad:
        tex, Gx, Gy = bilinear_taps(win, gx, gy, with_grad=True)
    else:
        tex = bilinear_taps(win, gx, gy)
    cen, inv = _normalize_lanes(tex, ordered)         # (B,K,49,3), (B,K,1,1)
    cenr = cen[:, :1]
    dot = _chan_sum(lane_sum(cenr * cen, -2, ordered), ordered)   # (B, K)
    incc = 1.0 - div(dot, P2 * 3.0)
    others = valid.clone()
    others[:, 0] = False
    rho = torch.where(others, incc / (1.0 + 3.0 * incc), torch.zeros_like(incc))
    n = others.to(x.dtype).sum(-1)
    ref_ok = valid[:, 0].to(x.dtype)
    if not grad:
        return rho, n, ref_ok, None

    zero = torch.zeros_like(c2x)
    dc2x = [(pr[..., 0] - c2x * pr[..., 2]) * rwc, zero, zero]
    dc2y = [(pr[..., 1] - c2y * pr[..., 2]) * rwc, zero, zero]
    ddxx = [(pr[..., 0] - xx2 * pr[..., 2]) * rwx - dc2x[0], None, None]
    ddxy = [(pr[..., 1] - xy2 * pr[..., 2]) * rwx - dc2y[0], None, None]
    ddyx = [(pr[..., 0] - yx2 * pr[..., 2]) * rwy - dc2x[0], None, None]
    ddyy = [(pr[..., 1] - yy2 * pr[..., 2]) * rwy - dc2y[0], None, None]
    for q in (1, 2):
        a0, a1_, a2_ = (pmul(dxax[q], i) for i in range(3))
        b0, b1, b2 = (pmul(dyax[q], i) for i in range(3))
        ddxx[q] = (a0 - xx2 * a2_) * rwx
        ddxy[q] = (a1_ - xy2 * a2_) * rwx
        ddyx[q] = (b0 - yx2 * b2) * rwy
        ddyy[q] = (b1 - yy2 * b2) * rwy
    dr = 1.0 / ((1.0 + 3.0 * incc) * (1.0 + 3.0 * incc))
    J = []
    for q in range(3):
        dtlx = (dc2x[q] - half * (ddxx[q] + ddyx[q]))[..., None]
        dtly = (dc2y[q] - half * (ddxy[q] + ddyy[q]))[..., None]
        dgx = dtlx + IX * ddxx[q][..., None] + IY * ddyx[q][..., None]
        dgy = dtly + IX * ddxy[q][..., None] + IY * ddyy[q][..., None]
        dtex = Gx * dgx[..., None] + Gy * dgy[..., None]          # (B,K,49,3)
        dm = div(lane_sum(dtex, -2, ordered), P2)[..., None, :]
        ds = div(_chan_sum(lane_sum(cen * dtex, -2, ordered), ordered),
                 P2 * 3.0)
        ds = ds[..., None, None]
        dcen = (dtex - dm) * inv - cen * (ds * inv)
        ddot = _chan_sum(lane_sum(dcen[:, :1] * cen + cenr * dcen, -2,
                                  ordered), ordered)
        J.append(torch.where(others, div(-ddot, P2 * 3.0) * dr,
                             torch.zeros_like(ddot)))
    return rho, n, ref_ok, torch.stack(J, dim=1)


def _mean_or_2(st: GNStatics, rho, n, ref_ok):
    mean = seq_sum(rho, -1) / torch.clamp(n, min=1.0)
    good = (ref_ok > 0.0) & (n >= st.min_images - 1)
    return torch.where(good, mean, torch.full_like(mean, 2.0))


def _newton_step(J, rho, n, lam):
    """Damped GN step (pallas_gn.py:435-464): J (B,3,K), rho (B,K)."""
    nf = torch.clamp(n, min=1.0)
    wgt = torch.full_like(rho, 0.5) / (rho + GN_EPS)
    g = [seq_sum(J[:, i], -1) / nf for i in range(3)]
    H = {}
    for i in range(3):
        for j in range(i, 3):
            H[(i, j)] = seq_sum(J[:, i] * wgt * J[:, j], -1) / nf
    d = 1e-6
    h00 = H[(0, 0)] + lam * torch.clamp(torch.abs(H[(0, 0)]), min=d)
    h11 = H[(1, 1)] + lam * torch.clamp(torch.abs(H[(1, 1)]), min=d)
    h22 = H[(2, 2)] + lam * torch.clamp(torch.abs(H[(2, 2)]), min=d)
    h01, h02, h12 = H[(0, 1)], H[(0, 2)], H[(1, 2)]
    c00 = h11 * h22 - h12 * h12
    c01 = h02 * h12 - h01 * h22
    c02 = h01 * h12 - h02 * h11
    c11 = h00 * h22 - h02 * h02
    c12 = h01 * h02 - h00 * h12
    c22 = h00 * h11 - h01 * h01
    det = h00 * c00 + h01 * c01 + h02 * c02
    rdet = torch.where(torch.abs(det) > 1e-30, 1.0 / det, torch.zeros_like(det))
    s0 = -(c00 * g[0] + c01 * g[1] + c02 * g[2]) * rdet
    s1 = -(c01 * g[0] + c11 * g[1] + c12 * g[2]) * rdet
    s2 = -(c02 * g[0] + c12 * g[1] + c22 * g[2]) * rdet
    step = torch.stack([s0, s1, s2], dim=-1)
    return torch.where(torch.isfinite(step), step, torch.zeros_like(step))


def gn_refine_twin(st: GNStatics, x0, h, ref, scale, pc, pr, p9, camc, lim,
                   org, mask, win, passes: dict = None, ordered=None):
    """Plain PyTorch version of the GN kernel (same contract, every mode).
    Each 128-patch block runs its own loop: a block that stopped keeps its
    state while the others iterate on. passes: optional dict that receives
    the number of 128-patch block passes the kernel would run ("value",
    "grad"), the work this run's data needs. ordered: see lane_sum (None:
    the kernel's order on CUDA tensors only)."""
    kernels.STATS["gn" if st.exact_j or st.debug_j else "gn_fd"
                  ].twin_calls += 1
    B = x0.shape[0]
    if B % NB:
        raise ValueError(f"gn_refine: B={B} is not a multiple of {NB}")
    a = dict(ref=ref, scale=scale, pc=pc, pr=pr, p9=p9, camc=camc, lim=lim,
             org=org, mask=mask, win=win)
    passes = {} if passes is None else passes

    def tally(kind, n):
        passes[kind] = passes.get(kind, 0) + int(n)

    if st.debug_j:
        tally("grad", B // NB)
        rho, n, ref_ok, J = _objective(st, a, x0, True, ordered)
        return x0, _mean_or_2(st, rho, n, ref_ok), J, rho
    b = st.angle_bound
    lo = x0.new_tensor([-BIG, -b, -b])
    hi = x0.new_tensor([BIG, b, b])
    refine = _refine_exact if st.exact_j else _refine_fd
    return refine(st, x0, h, lo, hi, tally,
                  lambda x, grad: _objective(st, a, x, grad, ordered))


def _clip(v, lo, hi):
    return torch.minimum(torch.maximum(v, lo), hi)


def _refine_exact(st: GNStatics, x0, h, lo, hi, tally, objective):
    """The exact-Jacobian loop (pallas_gn.py:475-522); objective(x, grad)
    is one pass."""
    B = x0.shape[0]
    cl = h * st.step_clamp
    nblk = B // NB
    x = x0
    tally("grad", nblk)
    rho, n, ref_ok, J = objective(x, True)
    f = _mean_or_2(st, rho, n, ref_ok)
    lam = torch.full_like(f, st.lam0)
    dry = torch.zeros(nblk, dtype=torch.int32, device=x.device)
    for _ in range(st.iters_exact - 1):
        run_blk = dry < 2
        if not bool(run_blk.any()):
            break
        run = run_blk.repeat_interleave(NB)
        tally("grad", run_blk.sum())
        step = _clip(_newton_step(J, rho, n, lam), -cl, cl)
        xt = _clip(x + step, lo, hi)
        rho_t, n_t, ref_t, J_t = objective(xt, True)
        f_t = _mean_or_2(st, rho_t, n_t, ref_t)
        acc = f_t < f
        imp = torch.where(acc, f - f_t, torch.zeros_like(f))
        improved = imp.reshape(nblk, NB).amax(dim=1)
        upd = acc & run
        x = torch.where(upd[:, None], xt, x)
        rho = torch.where(upd[:, None], rho_t, rho)
        n = torch.where(upd, n_t, n)
        ref_ok = torch.where(upd, ref_t, ref_ok)
        f = torch.where(upd, f_t, f)
        J = torch.where(upd[:, None, None], J_t, J)
        lam_new = torch.clamp(torch.where(acc, lam * 0.5, lam * 4.0), 1e-7, 1e7)
        lam = torch.where(run, lam_new, lam)
        dry = torch.where(run_blk, torch.where(improved > st.ftol,
                                               torch.zeros_like(dry), dry + 1),
                          dry)
    if st.iters_exact > 0:
        tally("value", nblk)
        step = _clip(_newton_step(J, rho, n, lam), -cl, cl)
        xt = _clip(x + step, lo, hi)
        rho_t, n_t, ref_t, _ = objective(xt, False)
        f_t = _mean_or_2(st, rho_t, n_t, ref_t)
        acc = f_t < f
        x = torch.where(acc[:, None], xt, x)
        f = torch.where(acc, f_t, f)
    return x, f


def _refine_fd(st: GNStatics, x0, h, lo, hi, tally, objective):
    """The FD/Broyden loop (pallas_gn.py:524-595): value passes only. Each
    round refreshes J by forward differences at x + e_i h_i hs, runs
    st.inner unclamped trials with a Broyden update after each (accepted or
    not), then shrinks hs; a block stops after the first round in which no
    patch's f fell by more than ftol."""
    B = x0.shape[0]
    nblk = B // NB
    x = x0
    tally("value", nblk)
    rho, n, ref_ok, _ = objective(x, False)
    f = _mean_or_2(st, rho, n, ref_ok)
    lam = torch.full_like(f, st.lam0)
    hs = torch.ones((), dtype=x.dtype, device=x.device)
    shrink = torch.tensor(st.h_shrink, dtype=x.dtype, device=x.device)
    go = torch.ones(nblk, dtype=torch.bool, device=x.device)
    for _ in range(-(-st.iters // st.inner)):
        if not bool(go.any()):
            break
        run = go.repeat_interleave(NB)
        tally("value", (3 + st.inner) * go.sum())
        f_before = f
        hr = h * hs
        cols = []
        for q in range(3):
            xp = x.clone()
            xp[:, q] = x[:, q] + hr[:, q]
            rho_q = objective(xp, False)[0]
            cols.append((rho_q - rho) / hr[:, q:q + 1])
        J = torch.stack(cols, dim=1)                         # (B, 3, K)
        for _ in range(st.inner):
            xn = _clip(x + _newton_step(J, rho, n, lam), lo, hi)
            rho_t, n_t, ref_t, _ = objective(xn, False)
            dx = xn - x
            dd = dx[:, 0] * dx[:, 0] + dx[:, 1] * dx[:, 1] + dx[:, 2] * dx[:, 2]
            pred = (J[:, 0] * dx[:, 0:1] + J[:, 1] * dx[:, 1:2]
                    + J[:, 2] * dx[:, 2:3])
            resb = (rho_t - rho - pred) / torch.clamp(dd, min=1e-20)[:, None]
            J = torch.where((dd > 1e-20)[:, None, None],
                            J + dx[:, :, None] * resb[:, None, :], J)
            f_t = _mean_or_2(st, rho_t, n_t, ref_t)
            acc = f_t < f
            upd = acc & run
            x = torch.where(upd[:, None], xn, x)
            rho = torch.where(upd[:, None], rho_t, rho)
            n = torch.where(upd, n_t, n)
            ref_ok = torch.where(upd, ref_t, ref_ok)
            f = torch.where(upd, f_t, f)
            lam_new = torch.clamp(torch.where(acc, lam * 0.5, lam * 4.0),
                                  1e-7, 1e7)
            lam = torch.where(run, lam_new, lam)
        go = go & ((f_before - f).reshape(nblk, NB).amax(dim=1) > st.ftol)
        hs = hs * shrink
    return x, f


def gn_refine_batch(ctx, opt: Options, center, normal, scale, views,
                    ws: WinState):
    """Refine B patches. The batch is padded to a multiple of the 128-patch
    early-stop block here, always and with the JAX package's fill (zero
    centres, normals, scales and windows, no views), so every device sees the
    same blocks; padded lanes never improve and leave the block max alone.

    Returns (new_center (B,3), new_normal (B,3), ok (B,), f (B,))."""
    B = center.shape[0]
    pad = (-B) % NB
    if pad:
        def padf(a, fill=0):
            return torch.cat([a, torch.full((pad,) + a.shape[1:], fill,
                                            dtype=a.dtype, device=a.device)])
        center, normal, scale = padf(center), padf(normal), padf(scale)
        views = padf(views, -1)
        ws = WinState(*(padf(a) for a in ws))
    st, args, extra = _prep(ctx, opt, center, normal, scale, views, ws)
    x, f = gn_refine(st, **args)
    ref_center, ref_ray, ax_x, ax_y, ax_z = extra
    new_center = ref_center + x[:, 0:1] * ref_ray
    a1 = x[:, 1:2] * opt.ANGLE_SCALE
    a2 = x[:, 2:3] * opt.ANGLE_SCALE
    new_normal = (ax_x * (torch.sin(a1) * torch.cos(a2)) + ax_y * torch.sin(a2)
                  + ax_z * (-torch.cos(a1) * torch.cos(a2)))
    ok = torch.sum(views >= 0, dim=1) >= opt.MIN_IMAGES_PER_PATCH
    return new_center[:B], new_normal[:B], ok[:B], f[:B]
