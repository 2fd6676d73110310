"""Each CUDA kernel against its plain PyTorch twin on the card, at the shapes
the main path gives it, with both timed.

Inputs come from the main path itself: a seed batch tiled to B patches goes
through the pre stage (view growth, window fetch, NCC filter, sort) on the
device, and each kernel is called on exactly the tensors the optimizer hands
it there. Used by chip_smoke.py and tests/test_torch_kernels_cuda.py.

Every result carries its bound: the least time an H100 SXM could take for
the same work, the larger of the bytes the function must move (each input
read once, each output written once) over 3.35 TB/s and the float32
operations it does on these inputs over 67 TFLOP/s (no tensor cores). For
the GN modes the operations are counted from the passes this run's data
needed (the twin reports how many 128-patch block passes ran) times the
kernel's per-pass arithmetic (flops_per_pass). `library_ms` times one
PyTorch call that computes the same function where there is one (fetch: one
advanced-indexing gather; permute: one torch.gather), else None (score:
F.grid_sample samples but neither normalises nor clips as the kernel does).

Two times for every kernel and yardstick (timing.py): device_ms (time_ms:
a run of back-to-back calls behind a sleeping stream, so only device time
counts) and call_ms (call_ms: events around one call on an idle stream,
the host's work in the wrapper included: what the main path pays a
launch). Their difference is the wrapper's host cost. The twins get
call_ms only.

Tolerances:
  fetch (B1), permute (B3): bit-exact (copies).
  score (B2): 2e-5 on the normalized textures; the centre colour (raw
    0..255 values, where one float32 ulp is 1.5e-5) to 2e-5 relative.
  add_views, sort_views (view selection, csrc/select.cu): every output
    (views, ok, the slot order) equal to the twin's on every lane, or, on
    at most 1 lane in 1,000, different where a deciding quantity lies
    within 4 float32 ulps of its threshold (float64, the twin's formulas):
    torch's projection einsum runs in an order cuBLAS picks by the batch's
    shape, which no fixed kernel order matches at every shape (the
    pooled-gates rule of tests/test_torch_pooled_gates.py).
  gn (B4), gn_fd (B5) and gn_debug_j: bit-equal. x and f at x0 (no
    iterations) and after the full loop, and debug_j's J, rho, f and x, are
    torch.equal to the twin's on every patch. gn.cu compiles without fused
    multiply-adds and the twin sums in the kernel's order on CUDA
    (ops/gn.py::lane_sum), so any difference is a fault. The FD mode needs
    no less: its trajectories are chaotic, and the detail line reports how
    many patches the twin itself keeps within centre 2e-3 / f 5e-3 when x0
    is perturbed by 1e-6 (its own sensitivity), beside the block passes the
    data needed, the max errors (0 when bit-equal), the kernel's launch
    (gn.launch_info: CTAs, cluster, registers, local memory) and the time of
    the first blocks that fit the card at once (one wave of clusters).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hpmvs_tpu_torch.ops import fetch, gn, optimizer as popt, sampling, score
from hpmvs_tpu_torch.ops import select
from hpmvs_tpu_torch.ops import windows as win_ops
from hpmvs_tpu_torch.timing import call_ms, time_ms

KERNELS = {
    "fetch": ("hpmvs_tpu_torch/csrc/fetch.cu",
              "hpmvs_tpu/ops/pallas_fetch.py:31"),
    "score": ("hpmvs_tpu_torch/csrc/score.cu",
              "hpmvs_tpu/ops/pallas_score.py:48"),
    "permute": ("hpmvs_tpu_torch/csrc/permute.cu",
                "hpmvs_tpu/ops/pallas_score.py:249"),
    "gn": ("hpmvs_tpu_torch/csrc/gn.cu", "hpmvs_tpu/ops/pallas_gn.py:475"),
    "gn_fd": ("hpmvs_tpu_torch/csrc/gn.cu",
              "hpmvs_tpu/ops/pallas_gn.py:524"),
    # no TPU kernel: plain-PyTorch chains of the stage pipelines
    "add_views": ("hpmvs_tpu_torch/csrc/select.cu",
                  "hpmvs_tpu_torch/ops/optimizer.py::_add_images_twin"),
    "sort_views": ("hpmvs_tpu_torch/csrc/select.cu",
                   "hpmvs_tpu_torch/ops/optimizer.py::_sort_views_twin"),
}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12      # H100 SXM float32 without tensor cores
F32 = 4


def main_path_inputs(ctx, opt, center, normal, scale, views):
    """The tensors each kernel receives in _run_pre_b / gn_refine_batch for
    this batch (all on ctx's device)."""
    normal = sampling.normalize3(normal)
    views, _ = popt._add_images_b(ctx, opt, center, normal, scale, views)
    ws = popt._fetch_ws_b(ctx, opt, views, center, scale)
    ci = torch.clamp(views, min=0).long()
    W = opt.WINDOW_SIZE
    *_, rows, cols = win_ops.window_cut(
        ctx.cams, ctx.imgs, ci, center[:, None].expand(ci.shape + (3,)),
        scale[:, None].expand(ci.shape), opt.MAXLEVEL - 1, W)
    b1 = dict(tex=ctx.imgs.tex, rows=rows, ox=cols, W=W,
              mask=(views >= 0).reshape(-1))
    tl, du, dv, _ = score._geometry(ctx, opt, center, normal, scale, views,
                                    ws)
    b2 = dict(geom=torch.cat([tl, du, dv], dim=-1).contiguous(), win=ws.win)
    nccs, valid = popt._ref_nccs(ctx, opt, center, normal, scale, views, ws)
    v2, _, order = popt._sort_views(ctx, opt, center, normal, scale, views,
                                    nccs, valid)
    order = order.to(torch.int32).contiguous()
    b3 = dict(win=ws.win, order=order)
    ws_sorted = score.permute_ws(ws, order)
    st, args, _ = gn._prep(ctx, opt, center, normal, scale, v2, ws_sorted)
    return b1, b2, b3, (st, args)


@dataclasses.dataclass
class KernelResult:
    name: str
    max_abs_err: float
    device_ms: float            # time_ms: the kernel alone on the device
    call_ms: float              # call_ms: one call, host work included
    plain_ms: float             # the twin, call_ms
    ok: bool
    detail: str
    bytes: float = 0.0          # bytes the function must move
    flops: float = 0.0          # float32 operations it does on these inputs
    library_ms: float = None    # one PyTorch call computing the same (device
    library_call_ms: float = None   # time and call time), or None
    launch: dict = None         # gn.launch_info of the GN modes at this B

    @property
    def bound_ms(self) -> float:
        return 1e3 * max(self.bytes / HBM_BYTES_PER_S,
                         self.flops / FP32_FLOPS_PER_S)

    @property
    def bound_by(self) -> str:
        return ("bytes" if self.bytes / HBM_BYTES_PER_S
                >= self.flops / FP32_FLOPS_PER_S else "operations")

    def record(self, launches: int) -> dict:
        src, rep = KERNELS[self.name]
        return {"name": self.name, "route": "cuda", "source": src,
                "replaces": rep, "launches": int(launches),
                "max_abs_err": self.max_abs_err, "ms": self.device_ms,
                "device_ms": self.device_ms, "call_ms": self.call_ms,
                "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": self.bound_by, "library_ms": self.library_ms,
                "library_call_ms": self.library_call_ms,
                "ok": self.ok, "detail": self.detail}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# Float32 operations of the kernels' arithmetic, counted from csrc/*.cuh and
# csrc/gn.cu (a multiply-add counts 2; sin, cos, rsqrt and divisions 1).
SAMPLE_FLOPS = 2 * 4 + 2 * 8 + 3 * 9     # grid coords, 2 tap sets, 3 channels
NORMALIZE_FLOPS = 3 * 5 + 3             # per texel: mean, centre, var, scale
VIEW_GEOM_FLOPS = 150                   # per view: projections and gates
PATCH_GEOM_FLOPS = 120                  # per pass: frame, normal, axes


def flops_per_pass(K: int, grad: bool) -> float:
    """Float32 operations of one GN objective pass over one patch with K
    view slots (the reference view and K-1 scored views)."""
    P2 = score.P2
    view = (VIEW_GEOM_FLOPS + P2 * (SAMPLE_FLOPS + NORMALIZE_FLOPS)
            + P2 * 3 * 2)                                  # NCC dot
    if grad:
        view += (80 + P2 * 3 * 6                           # partials
                 + 3 * P2 * 3 * (4 + 4 + 6 + 4))           # tangents, ddot
    return PATCH_GEOM_FLOPS + (200 if grad else 0) + K * view


def both_ms(fn, reps: int):
    """(device ms, call ms) of fn: time_ms over 2 * reps back-to-back calls
    a run, call_ms over reps calls."""
    return time_ms(fn, reps=2 * reps), call_ms(fn, reps)


def _library(fn, reps: int) -> dict:
    dev, call = both_ms(fn, reps)
    return dict(library_ms=dev, library_call_ms=call)


def _err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def check_kernels(ctx, opt, center, normal, scale, views, reps: int = 10):
    """Run every kernel and its twin on the main path's inputs; returns a
    list of KernelResult (ok False on disagreement)."""
    b1, b2, b3, (st, args) = main_path_inputs(ctx, opt, center, normal,
                                              scale, views)
    out = []

    k = fetch.fetch_windows(**b1)
    p = fetch.fetch_windows_twin(**b1)
    e = _err(k, p)
    W = b1["W"]
    live = b1["mask"]
    ar = torch.arange(W, device=k.device)
    ri = (b1["rows"].long()[:, None] + ar)[:, :, None]       # (N, W, 1)
    cj = (b1["ox"].long()[:, None] + ar)[:, None, :]         # (N, 1, W)
    tex = b1["tex"]
    n_live = int(live.sum())
    n = b1["rows"].numel()
    out.append(KernelResult(
        "fetch", e, *both_ms(lambda: fetch.fetch_windows(**b1), reps),
        call_ms(lambda: fetch.fetch_windows_twin(**b1), reps),
        torch.equal(k, p), f"N={n} ({n_live} live) W={W}, exact",
        bytes=2 * n_live * W * W * 3 * F32 + nbytes(b1["rows"], b1["ox"],
                                                      live),
        **_library(lambda: tex[ri, cj], reps)))

    kt, kc = score.sample_windows(b2["geom"], b2["win"], True)
    pt, pc = score.sample_windows_twin(b2["geom"], b2["win"], True)
    B, K = b2["geom"].shape[:2]
    e = _err(kt, pt)
    # the colour is a raw 0..255 pixel value: relative tolerance
    ec = float(((kc - pc).abs() / pc.abs().clamp(min=1.0)).max())
    out.append(KernelResult(
        "score", e,
        *both_ms(lambda: score.sample_windows(b2["geom"], b2["win"], True),
                 reps),
        call_ms(lambda: score.sample_windows_twin(b2["geom"], b2["win"],
                                                  True), reps),
        e <= 2e-5 and ec <= 2e-5,
        f"B={B} K={K}: texture err {e:.3g} (tol 2e-5), colour relative "
        f"err {ec:.3g} (tol 2e-5)",
        bytes=nbytes(b2["geom"], b2["win"], kt, kc),
        flops=B * K * (score.P2 * (SAMPLE_FLOPS + NORMALIZE_FLOPS)
                       + SAMPLE_FLOPS)))

    k = score.permute_windows(**b3)
    p = score.permute_windows_twin(**b3)
    wv = b3["win"].reshape(B, K, -1)
    oi = b3["order"].long()[:, :, None].expand(wv.shape)
    out.append(KernelResult(
        "permute", _err(k, p), *both_ms(lambda: score.permute_windows(**b3),
                                        reps),
        call_ms(lambda: score.permute_windows_twin(**b3), reps),
        torch.equal(k, p), f"B={B} K={K}, exact",
        bytes=nbytes(b3["win"], b3["order"], k),
        **_library(lambda: torch.gather(wv, 1, oi), reps)))

    exact = dataclasses.replace(st, exact_j=True)
    fd = dataclasses.replace(st, exact_j=False)
    out.append(_check_gn("gn", exact, dataclasses.replace(exact, iters_exact=0),
                         args, reps))
    out.append(_check_gn("gn_fd", fd, dataclasses.replace(fd, iters=0), args,
                         reps))
    out.append(_check_debug_j(st, args))
    out.extend(check_select(ctx, opt, center, normal, scale, views, reps))
    return out


# Float32 operations of csrc/select.cu, counted from its source (sqrt, log2,
# exp2, acos and divisions 1): addImages per candidate (ray 12, angle 5,
# level 5, projection 20, bounds 2) and per patch (the normal's norm);
# sortImages per slot (ray, cosine, scale) and per pair of slots in the
# greedy rounds. The pairwise angle test stops at its first good pair and
# is left out, so the count is a floor.
ADD_FLOPS_PER_CAND = 44
SORT_FLOPS_PER_SLOT = 23
SORT_FLOPS_PER_ROUND_SLOT = 10
PATCH_FLOPS = 12 + 17                   # normalize3, reference level


def _differ(*pairs):
    """Lanes (dim 0) on which any pair of outputs differs."""
    bad = torch.zeros(pairs[0][0].shape[0], dtype=torch.bool,
                      device=pairs[0][0].device)
    for a, b in pairs:
        ne = a != b
        bad |= ne.reshape(ne.shape[0], -1).any(dim=1)
    return bad.nonzero()[:, 0].tolist()


def _show(bad, *pairs) -> str:
    """The first three differing lanes' outputs, kernel / twin."""
    return "; ".join(
        f"lane {i}: " + " | ".join(f"{a[i].tolist()} / {b[i].tolist()}"
                                   for a, b in pairs) for i in bad[:3])


EPS32 = float(torch.finfo(torch.float32).eps)
NEAR_ULPS = 4        # how near its threshold a deciding quantity may differ
MAX_DIFFER = 1e-3    # share of lanes that may differ at all


def _near(q, scale):
    """Whether |q| lies within NEAR_ULPS float32 ulps of a quantity whose
    operands have magnitude `scale` (q: the distance to the threshold)."""
    return q.abs() <= NEAR_ULPS * EPS32 * scale


def _near_add(ctx, opt, center, normal, scale, views, lanes):
    """Per lane of `lanes`: whether some candidate's angle, level or bounds
    test sits within NEAR_ULPS of its threshold (float64, the twin's
    formulas). The projection is the one reduction whose cuBLAS order
    changes with the batch's shape (csrc/select.cu, proj_row)."""
    d = torch.float64
    li = torch.as_tensor(lanes, dtype=torch.long, device=views.device)
    c, s = center[li].to(d), scale[li].to(d)
    nz = normal[li].to(d)
    nz = nz / nz.norm(dim=-1, keepdim=True)
    cand = ctx.covis[views[li, 0].clamp(min=0).long()].clamp(min=0).long()
    cams = ctx.cams
    dv = cams.center[cand].to(d) - c[:, None]
    fz = dv.norm(dim=-1)
    near = _near(((dv / fz[..., None]) * nz[:, None]).sum(-1)
                 - sampling.cos32(opt.MAX_ANGLE), torch.ones_like(fz))
    lv = torch.log2(s[:, None] * cams.fsum[cand].to(d) / (2 * fz))
    near |= _near(lv - torch.floor(lv) - 0.5, torch.ones_like(lv))
    lvl = torch.round(lv).clamp(0, opt.MAXLEVEL).nan_to_num().long()
    P = cams.P[cand, lvl].to(d)                       # (n, C, 3, 4)
    ch = torch.cat([c, torch.ones_like(c[:, :1])], -1)[:, None, None]
    terms = P * ch
    r, mag = terms.sum(-1), terms.abs().sum(-1)
    near |= _near(r[..., 2], mag[..., 2])
    for i, lim in ((0, ctx.imgs.width), (1, ctx.imgs.height)):
        u = r[..., i] / r[..., 2]
        m = (mag[..., i] + u.abs() * mag[..., 2]) / r[..., 2].abs()
        near |= _near(u, m) | _near(u - (lim[cand, lvl].to(d) - 1), m)
    return near.any(dim=1).tolist()


def _near_sort(ctx, opt, center, normal, views, lanes):
    """Per lane of `lanes`: whether a sorted pair's angle (the pair dots'
    cuBLAS order differs for a batch of one patch) or a view's cosine
    sits within NEAR_ULPS of its threshold (float64)."""
    d = torch.float64
    li = torch.as_tensor(lanes, dtype=torch.long, device=views.device)
    c = center[li].to(d)
    nz = normal[li].to(d)
    nz = nz / nz.norm(dim=-1, keepdim=True)
    v = views[li]
    rays = ctx.cams.center[v.clamp(min=0).long()].to(d) - c[:, None]
    rays = rays / rays.norm(dim=-1, keepdim=True)
    near = _near((rays * nz[:, None]).sum(-1), torch.ones_like(rays[..., 0]))
    near = near.any(dim=1)
    ang = torch.arccos(torch.einsum("nkd,njd->nkj", rays, rays).clamp(-1, 1))
    # d(acos)/d(dot) = 1/sin, and acos near a dot of +-1 goes as its sqrt
    sin = torch.sin(ang).clamp(min=EPS32 ** 0.5)
    eye = torch.eye(v.shape[1], dtype=torch.bool, device=v.device)
    pair = (v[:, :, None] >= 0) & (v[:, None, :] >= 0) & ~eye
    for a in (opt.MIN_ANGLE, opt.MAX_ANGLE):
        near |= (pair & _near(ang - a, 1.0 / sin)).flatten(1).any(dim=1)
    return near.tolist()


def _agree(bad, B, near) -> bool:
    """The view-selection rule: equal on every lane, or at most MAX_DIFFER
    of the lanes differ and each has a deciding quantity within NEAR_ULPS
    of its threshold (near: one flag per differing lane)."""
    return not bad or (len(bad) <= MAX_DIFFER * B and all(near))


def edge_lanes(ctx, batch, seed: int):
    """A batch (center, normal, scale, views) of at least 640 lanes with
    edge lanes written in (numpy, seeded), for check_select: every slot
    invalid (lanes 0-63), reference camera 0 (64-127: give camera 0 no
    covisible candidates to test that), normals facing away, so fewer than
    2 sort candidates (128-191), duplicated views, so exact wscale ties
    (192-255), random slots (256-511). Returns (batch, nccs, valid): NCCs on
    a grid of eighths (exact ties), at the filter threshold on lanes
    512-639, and random valid masks, for sort_in."""
    c, n, s, v = (a.cpu().numpy().copy() for a in batch)
    B, K = v.shape
    rng = np.random.default_rng(seed)
    ncam = ctx.covis.shape[0]
    v[:64] = -1
    v[64:128, 0] = 0
    n[128:192] = -n[128:192]
    v[192:256, 1:4] = v[192:256, :1]
    v[256:512] = rng.integers(-1, ncam, (256, K))
    nccs = (rng.integers(0, 9, (B, K)) / 8.0).astype(np.float32)
    nccs[512:640] = np.float32(0.4)
    valid = rng.random((B, K)) > 0.15
    valid[:, 0] |= rng.random(B) > 0.5
    dev = batch[0].device
    out = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
           for a in (c, n, s, v.astype(np.int32))]
    return (out, torch.as_tensor(nccs, device=dev),
            torch.as_tensor(valid, device=dev))


def check_select(ctx, opt, center, normal, scale, views, reps: int = 10,
                 sort_in=None):
    """The two view-selection kernels against their twins on one batch:
    add_views on (center, normal, scale, views), then sort_views on the
    kernel's views, the NCCs of their fetched windows and the score
    kernel's valid slots (sort_in = (views, nccs, valid) replaces these).
    Returns [add_views, sort_views] KernelResults; each detail names the
    differing lanes (at most 20), max_abs_err counts them. reps=0 times
    nothing (the times are then NaN)."""
    def times(fn, twin):
        if not reps:
            return float("nan"), float("nan"), float("nan")
        return (*both_ms(fn, reps), call_ms(twin, reps))

    normal = sampling.normalize3(normal)
    a_in = (ctx, opt, center, normal, scale, views)
    kv, kok = select.add_views(*a_in)
    pv, pok = popt._add_images_twin(*a_in)
    B, K = views.shape
    C = ctx.covis.shape[1]
    cams, imgs = ctx.cams, ctx.imgs
    bad = _differ((kv, pv), (kok, pok))
    near = _near_add(*a_in, bad) if bad else []
    out = [KernelResult(
        "add_views", float(len(bad)),
        *times(lambda: select.add_views(*a_in),
               lambda: popt._add_images_twin(*a_in)), _agree(bad, B, near),
        f"B={B} K={K} C={C}: views and ok equal on {B - len(bad)} of {B} "
        f"lanes; differing lanes {bad[:20]}, near a threshold {near[:20]}; "
        f"ok {int(kok.sum())}; {_show(bad, (kv, pv), (kok, pok))}",
        bytes=nbytes(views, center, normal, scale, kv, kok, ctx.covis,
                     cams.center, cams.fsum, cams.P, imgs.width, imgs.height),
        flops=B * (12 + C * ADD_FLOPS_PER_CAND))]
    if sort_in is None:
        ws = popt._fetch_ws_b(ctx, opt, kv, center, scale)
        sort_in = (kv, *popt._ref_nccs(ctx, opt, center, normal, scale, kv,
                                       ws))
    s_in = (ctx, opt, center, normal, scale, *sort_in)
    kv, kok, ko = select.sort_views(*s_in)
    pv, pok, po = popt._sort_views_twin(*s_in)
    bad = _differ((kv, pv), (kok, pok), (ko.long(), po))
    near = _near_sort(ctx, opt, center, normal, pv, bad) if bad else []
    out.append(KernelResult(
        "sort_views", float(len(bad)),
        *times(lambda: select.sort_views(*s_in),
               lambda: popt._sort_views_twin(*s_in)), _agree(bad, B, near),
        f"B={B} K={K}: views, ok and order equal on {B - len(bad)} of {B} "
        f"lanes; differing lanes {bad[:20]}, near a threshold {near[:20]}; "
        f"ok {int(kok.sum())}; {_show(bad, (kv, pv), (kok, pok), (ko, po))}",
        bytes=nbytes(*sort_in, center, normal, scale, kv, kok, ko,
                     cams.center, cams.fsum),
        flops=B * (PATCH_FLOPS + K * SORT_FLOPS_PER_SLOT
                   + K * K * SORT_FLOPS_PER_ROUND_SLOT)))
    return out


def _gn_bytes(st, args, *outs) -> int:
    """Inputs of the GN kernel read once (only the first K window slots are
    read) and its outputs written once."""
    win = args["win"]
    B = win.shape[0]
    rest = nbytes(*(v for k, v in args.items() if k != "win"))
    return rest + B * st.K * st.W * st.W * 3 * F32 + nbytes(*outs)


def _equal(*pairs) -> bool:
    return all(torch.equal(a, b) for a, b in pairs)


def _check_gn(name, st, st0, args, reps):
    """Kernel vs twin for one refinement mode, bit for bit: the value pass
    at x0 (st0, no iterations), then the full loop (st)."""
    kx0, kf0 = gn.gn_refine(st0, **args)
    px0, pf0 = gn.gn_refine_twin(st0, **args)
    eq0 = _equal((kx0, px0), (kf0, pf0))
    kx, kf = gn.gn_refine(st, **args)
    passes = {}
    px, pf = gn.gn_refine_twin(st, **args, passes=passes)
    eq = _equal((kx, px), (kf, pf))
    dc = (kx[:, 0] - px[:, 0]).abs()
    df = (kf - pf).abs()
    # the twin's own sensitivity: the same loop from x0 moved by 1e-6
    gen = torch.Generator(device=args["x0"].device).manual_seed(0)
    noise = 1e-6 * torch.randn(args["x0"].shape, generator=gen,
                               device=args["x0"].device)
    qx, qf = gn.gn_refine_twin(st, **{**args, "x0": args["x0"] + noise})
    self_frac = float((((qx[:, 0] - px[:, 0]).abs() <= 2e-3)
                       & ((qf - pf).abs() <= 5e-3)).float().mean())
    ok = eq0 and eq and bool(torch.isfinite(kx).all())
    K, B = st.K, kx.shape[0]
    launch = gn.launch_info(st, B)
    # the first blocks that fit the card at once (one cluster each): where
    # B needs more clusters, the rest wait for a second wave
    nw = min(B, gn.NB * launch["max_active_clusters"])
    wave = {k: v[:nw] for k, v in args.items()}
    wave_ms = time_ms(lambda: gn.gn_refine(st, **wave), reps=2 * reps)
    flops = gn.NB * (passes.get("value", 0) * flops_per_pass(K, False)
                          + passes.get("grad", 0) * flops_per_pass(K, True))
    return KernelResult(
        name, float(df.max()), *both_ms(lambda: gn.gn_refine(st, **args),
                                        reps),
        call_ms(lambda: gn.gn_refine_twin(st, **args), reps),
        ok, f"B={B} K={K}: x and f bit-equal at x0 {eq0}, after the loop "
            f"{eq}; max errors: f at x0 {_err(kf0, pf0):.3g}, f "
            f"{float(df.max()):.3g}, centre {float(dc.max()):.3g}; the twin "
            f"against itself from x0 + 1e-6 noise: {self_frac:.4f} of "
            f"patches within centre 2e-3 / f 5e-3; block passes {passes}; "
            f"launch {launch}; the first B={nw} alone (one wave): "
            f"{wave_ms:.4f} ms",
        bytes=_gn_bytes(st, args, kx, kf), flops=flops, launch=launch)


def _check_debug_j(st, args):
    """debug_j: rho and the analytic J at x0, kernel vs twin, bit for bit."""
    sd = dataclasses.replace(st, debug_j=True)
    kx, kf, kJ, krho = gn.gn_refine(sd, **args)
    px, pf, pJ, prho = gn.gn_refine_twin(sd, **args)
    ok = _equal((kJ, pJ), (krho, prho), (kf, pf), (kx, px),
                (kx, args["x0"]))
    B = kx.shape[0]
    launch = gn.launch_info(sd, B)
    return KernelResult(
        "gn_debug_j", max(_err(krho, prho), _err(kJ, pJ)),
        *both_ms(lambda: gn.gn_refine(sd, **args), 3),
        call_ms(lambda: gn.gn_refine_twin(sd, **args), 3), ok,
        f"B={B} K={st.K}: J, rho, f and x bit-equal {ok}; max errors: rho "
        f"{_err(krho, prho):.3g}, J {_err(kJ, pJ):.3g}, f {_err(kf, pf):.3g}; "
        f"max |J| {float(pJ.abs().max()):.3g}; launch {launch}",
        bytes=_gn_bytes(st, args, kx, kf, kJ, krho),
        flops=B * flops_per_pass(st.K, True), launch=launch)


def check_fetch_slab(cams, slab, full, ci, center, scale, maxlevel: int,
                     W: int, reps: int = 10) -> dict:
    """The fetch kernel on a per-shard image slab (parallel/subsets.py: a
    packed pyramid whose row table is block-local and whose absent cameras
    have width and height 0), at the windows the main path cuts there
    (windows.window_cut on the slab, its row clamp the slab's own row
    count). ci (N, K) camera ids, -1 for none; center (N, K, 3); scale
    (N, K). `full` is the replicated pack on the same device.

    Returns {"equal_twin": kernel == twin (torch.equal), "equal_full": the
    slab's windows equal the full pack's wherever the plane holds a whole
    window (a plane narrower than W reads past its rows into the next
    plane, which the two packs order differently), "n", "live", "compared",
    "max_abs_err"}, with reps > 0 also "device_ms", "call_ms" and
    "plain_ms" (timing.py; the card only)."""
    present = (ci >= 0) & (slab.width[ci.clamp(min=0).long(), 0] > 0)
    cc = torch.where(present, ci, torch.zeros_like(ci)).long()
    level, ox, oy, rows, cols = win_ops.window_cut(
        cams, slab, cc, center, scale, maxlevel, W)
    mask = present.reshape(-1)
    args = dict(tex=slab.tex, rows=rows, ox=cols, W=W, mask=mask)
    k = fetch.fetch_windows(**args)
    p = fetch.fetch_windows_twin(**args)
    lvl = level.long()
    whole = (present & (full.width[cc, lvl] >= W)
             & (full.height[cc, lvl] >= W)).reshape(-1)
    _, _, _, rows_f, cols_f = win_ops.window_cut(cams, full, cc, center,
                                                 scale, maxlevel, W)
    f = fetch.fetch_windows_twin(full.tex, rows_f, cols_f, W, mask=mask)
    out = {"equal_twin": torch.equal(k, p),
           "equal_full": torch.equal(k[whole], f[whole]),
           "n": int(mask.numel()), "live": int(mask.sum()),
           "compared": int(whole.sum()), "max_abs_err": _err(k, p)}
    if reps:
        dev, call = both_ms(lambda: fetch.fetch_windows(**args), reps)
        out.update(device_ms=dev, call_ms=call, plain_ms=call_ms(
            lambda: fetch.fetch_windows_twin(**args), reps))
    return out
