"""Batched patch optimizer: the replacement for PatchOptimizer + nlopt.

Behavioral equivalent of the reference per-patch pipeline
(src/hpmvs/PatchOptimizer.cpp:48-103 runOptimization/optimize):

    addImages -> filterImagesNCC(a1) -> sortImages -> assureImageAngles ->
    optimizePatch(BOBYQA) -> addImages -> filterImagesNCC(a2) ->
    filterImagesByAngle -> assureImageAngles -> setRefImage ->
    filterImagesNCC(a2) -> getColor

Instead of one nlopt BOBYQA solve per patch, thousands of patches are refined
together by a Levenberg loop over the same 3-parameter space -- depth along
the reference ray + two normal angles at angleScale = pi/48
(PatchOptimizer.cpp:384-446). View lists are fixed-size slot arrays
(MAX_VIEWS) with -1 padding; every filter stage is a masked compaction,
every selection loop a fixed-trip loop over slots.

Both stage pipelines of hpmvs_tpu/ops/optimizer.py are here, each written
over a leading batch axis:
  - the batched stages (USE_BATCHED_STAGES and USE_WINDOWS and FAST_SETREF):
    one texture-sampling pass per stage through kernel B2, one window
    permute (B3), the fused post stage;
  - the per-patch stages (otherwise), with the single-patch semantics of the
    JAX package's vmapped functions: every stage resamples, windows are
    permuted by indexing, and FAST_SETREF=False runs the reference's
    setRefImage (K sampling passes of K views, PatchOptimizer.cpp:154-181).
Either refines with the GN kernel (ops/gn.py: exact-J, or FD/Broyden with
LM_EXACT_J=False) when USE_PALLAS_GN and USE_WINDOWS are on, and with the
plain refiner `_optimize_patch` otherwise.
"""

from __future__ import annotations

import dataclasses

import torch

from hpmvs_tpu_torch import kernels, trace
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.geom import camera as cam_ops
from hpmvs_tpu_torch.image.pyramid import ImagePack
from hpmvs_tpu_torch.ops import gn, sampling, score, select
from hpmvs_tpu_torch.ops import windows as win_ops

INVALID = -1
BIG = 1e9
GN_EPS = 1e-5


@dataclasses.dataclass
class SceneCtx:
    """Device-side immutable scene context shared by all patch batches."""
    cams: cam_ops.Cameras
    imgs: ImagePack        # tex/row0/width/height as device tensors
    covis: torch.Tensor    # (ncam, C) int32, -1 padded covisible image ids
    ncovis: torch.Tensor   # (ncam,) int32


def _nviews(views):
    return torch.sum(views >= 0, dim=-1)


def _compact(values, valid):
    """Stable compaction: keep `valid` slots in order, pad with -1. Returns
    (the compacted values, the slot order that realizes it)."""
    order = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    count = torch.sum(valid, dim=-1)
    idx = torch.arange(values.shape[-1], device=values.device)
    return torch.where(idx < count[..., None], torch.gather(values, -1, order),
                       torch.full_like(values, INVALID)), order


def _permute_ws(ws, order):
    """Reorder the per-slot window cache alongside a view-slot permutation
    (B, K), by indexing (the per-patch stages; the batched ones use B3)."""
    if ws is None:
        return None
    o = order.long()
    rows = torch.arange(o.shape[0], device=o.device)[:, None]
    return win_ops.WinState(win=ws.win[rows, o], ox=torch.gather(ws.ox, 1, o),
                            oy=torch.gather(ws.oy, 1, o),
                            level=torch.gather(ws.level, 1, o))


# ---------------------------------------------------------------------------
# Per-patch stages: the JAX package's single-patch functions (vmapped there)
# written over a leading batch axis, with the same semantics. Stages that
# are the same computation in both pipelines (addImages, the sortImages
# ordering, assureImageAngles) are shared with the batched pipeline below.
# ---------------------------------------------------------------------------

def _sample_views(ctx, opt: Options, views, center, scale, xax, yax, zax,
                  ws=None):
    """The 7x7 texture in every view slot (B, K). Returns (tex (B,K,49,3),
    valid (B,K)). With a window cache, samples from the cached windows
    instead of the full images."""
    ci = torch.clamp(views, min=0).long()
    shp = ci.shape
    args = (ci, center[:, None].expand(shp + (3,)), scale[:, None].expand(shp),
            xax[:, None].expand(shp + (3,)), yax[:, None].expand(shp + (3,)),
            zax[:, None].expand(shp + (3,)), sampling.cos32(opt.MAX_ANGLE),
            opt.MAXLEVEL - 1)
    if ws is None:
        tex, valid = sampling.sample_texture(ctx.cams, ctx.imgs, *args)
    else:
        tex, valid = win_ops.sample_from_windows(ctx.cams, ctx.imgs, ws, *args)
    return tex, valid & (views >= 0)


def _set_inccs(ctx, opt: Options, views, center, normal, scale, ref_slot: int,
               robust: bool, ws=None):
    """PatchOptimizer::setINCCs (PatchOptimizer.cpp:448-474): per-slot
    1 - NCC against the texture of slot `ref_slot` (0 for that slot, 2 for
    failed samples)."""
    ref_ci = torch.clamp(views[:, ref_slot], min=0)
    xax, yax, _ = sampling.patch_axes(ctx.cams, ref_ci, normal, scale)
    # the reference passes pNormal_ as the sampling z-axis here
    nz = sampling.normalize3(normal)
    tex, valid = _sample_views(ctx, opt, views, center, scale, xax, yax, nz,
                               ws)
    ref_ok = valid[:, ref_slot]
    vals = 1.0 - sampling.ncc(tex[:, ref_slot:ref_slot + 1], tex)
    if robust:
        vals = sampling.robust_incc(vals)
    vals = torch.where(valid & ref_ok[:, None], vals,
                       torch.full_like(vals, 2.0))
    slot = torch.arange(views.shape[1], device=views.device)
    return torch.where(slot == ref_slot, torch.where(ref_ok, 0.0, 2.0)[:, None],
                       vals)


def _filter_ncc(ctx, opt: Options, center, normal, scale, views, alpha,
                ws=None):
    """PatchOptimizer::filterImagesNCC (PatchOptimizer.cpp:138-152)."""
    inccs = _set_inccs(ctx, opt, views, center, normal, scale, 0,
                       robust=False, ws=ws)
    keep = (views >= 0) & (inccs < 1.0 - alpha)
    keep[:, 0] = views[:, 0] >= 0  # always keep the reference
    views, order = _compact(views, keep)
    ok = _nviews(views) >= opt.MIN_IMAGES_PER_PATCH
    return views, ok, _permute_ws(ws, order)


def _sort_images(ctx, opt: Options, center, normal, scale, views, ws=None):
    """PatchOptimizer::sortImages (PatchOptimizer.cpp:183-223), carrying the
    window cache along."""
    views, ok, perm = _sort_images_b(ctx, opt, center, normal, scale, views)
    return views, ok, _permute_ws(ws, perm)


def _filter_by_angle(ctx, opt: Options, center, normal, views, ws=None):
    """PatchOptimizer::filterImagesByAngle (PatchOptimizer.cpp:125-136)."""
    ci = torch.clamp(views, min=0).long()
    rays = sampling.normalize3(ctx.cams.center[ci] - center[:, None])
    keep = (views >= 0) & (torch.sum(rays * normal[:, None], dim=-1)
                           > sampling.cos32(opt.MAX_ANGLE))
    views, order = _compact(views, keep)
    ok = _nviews(views) >= opt.MIN_IMAGES_PER_PATCH
    return views, ok, _permute_ws(ws, order)


def _set_ref_image(ctx, opt: Options, center, normal, scale, views, ws=None):
    """PatchOptimizer::setRefImage (PatchOptimizer.cpp:154-181): pick the
    view minimizing the summed robust incc against all others; swap it to
    slot 0. FAST_SETREF samples once in the slot-0 tangent frame; without
    it every candidate reference samples all views in its own frame, as the
    reference does."""
    B, k = views.shape
    valid = views >= 0
    slot = torch.arange(k, device=views.device)
    if opt.FAST_SETREF:
        ref_ci = torch.clamp(views[:, 0], min=0)
        xax, yax, _ = sampling.patch_axes(ctx.cams, ref_ci, normal, scale)
        nz = sampling.normalize3(normal)
        tex, vv = _sample_views(ctx, opt, views, center, scale, xax, yax, nz,
                                ws)
        nccs = torch.einsum("batc,bdtc->bad", tex, tex) / sampling.N_TEXELS
        incc = sampling.robust_incc(1.0 - nccs)
        incc = torch.where(vv[:, :, None] & vv[:, None, :], incc,
                           torch.full_like(incc, 2.0))
        eye = slot[:, None] == slot[None, :]
        diag = torch.where(vv, 0.0, 2.0)[:, :, None].expand(B, k, k)
        incc = torch.where(eye, diag, incc)
        sums = torch.sum(torch.where(valid[:, None, :], incc,
                                     torch.zeros_like(incc)), dim=-1)
    else:
        sums = torch.stack([
            torch.sum(torch.where(valid, _set_inccs(
                ctx, opt, views, center, normal, scale, r, robust=True,
                ws=ws), torch.zeros(views.shape, device=views.device)),
                dim=-1)
            for r in range(k)], dim=-1)
    sums = torch.where(valid, sums, torch.full_like(sums, BIG))
    best = torch.argmin(sums, dim=-1)
    best = torch.where(_nviews(views) <= 1, torch.zeros_like(best), best)
    bi = best[:, None]
    order = torch.where(slot == 0, bi, torch.where(slot == bi,
                                                   torch.zeros_like(bi), slot))
    return torch.gather(views, -1, order), _permute_ws(ws, order)


def _get_color(ctx, opt: Options, center, scale, views):
    """Scene::getColor (Scene.cpp:300-327): median-by-norm over views with
    the white-pixel (sky) special case. Level capped at MAXLEVEL-1 (the
    window-cache cap) rather than the reference's MAXLEVEL -- the JAX
    package's documented divergence."""
    cams, imgs = ctx.cams, ctx.imgs
    ci = torch.clamp(views, min=0).long()
    valid = views >= 0
    cb = center[:, None].expand(ci.shape + (3,))
    lvl = cam_ops.get_leveli(cams, ci, cb, scale[:, None].expand(ci.shape),
                             opt.MAXLEVEL - 1).long()
    uvw = cam_ops.project(cams, ci, cb, lvl)
    w = imgs.width[ci, lvl].to(uvw.dtype)
    h = imgs.height[ci, lvl].to(uvw.dtype)
    gx = torch.minimum(torch.clamp(uvw[..., 0], min=0.0),
                       torch.clamp(w - 2.0, min=0.0))
    gy = torch.minimum(torch.clamp(uvw[..., 1], min=0.0),
                       torch.clamp(h - 2.0, min=0.0))
    cols = sampling.bilinear(imgs.tex, imgs.row0, imgs.width, ci, lvl, gx,
                             gy)                               # (B, K, 3)
    norms = torch.where(valid, torch.linalg.vector_norm(cols, dim=-1),
                        torch.full_like(cols[..., 0], BIG))
    order = torch.argsort(norms, dim=-1, stable=True)
    n = torch.clamp(torch.sum(valid, dim=-1), min=1)
    pick = torch.gather(order, -1, torch.stack([n // 2, torch.zeros_like(n)],
                                               -1))
    med, first = torch.gather(cols, 1, pick[:, :, None].expand(-1, 2, 3)
                              ).unbind(1)
    return torch.where(
        torch.linalg.vector_norm(med, dim=-1, keepdim=True) > 250.0, first,
        med)


def _fetch_ws(ctx, opt: Options, views, center, scale):
    """Window fetch for the current view slots (once per pipeline half)."""
    ci = torch.clamp(views, min=0)
    return win_ops.fetch_windows_t(
        ctx.cams, ctx.imgs, ci, center[:, None].expand(ci.shape + (3,)),
        scale[:, None].expand(ci.shape), opt.MAXLEVEL - 1, opt.WINDOW_SIZE)


def _run_pre(ctx, opt: Options, center, normal, scale, views):
    """First half of runOptimization: view growth + filters + sort, up to
    (and excluding) optimizePatch. Returns (center, normal, views, ok, ws)."""
    normal = sampling.normalize3(normal)
    views, ok = _add_images_b(ctx, opt, center, normal, scale, views)
    ws = _fetch_ws(ctx, opt, views, center, scale) if opt.USE_WINDOWS else None
    views, ok1, ws = _filter_ncc(ctx, opt, center, normal, scale, views,
                                 opt.NCC_ALPHA_1, ws)
    views, ok2, ws = _sort_images(ctx, opt, center, normal, scale, views, ws)
    ok = ok & ok1 & ok2 & _assure_angles_b(ctx, opt, center, views)
    return center, normal, views, ok, ws


def _run_post(ctx, opt: Options, center, normal, scale, views, ok):
    """Second half of runOptimization: re-grow views, final filters, ref
    re-selection, color. Takes the post-refinement (merged) center/normal."""
    views, ok4 = _add_images_b(ctx, opt, center, normal, scale, views)
    ws = _fetch_ws(ctx, opt, views, center, scale) if opt.USE_WINDOWS else None
    views, ok5, ws = _filter_ncc(ctx, opt, center, normal, scale, views,
                                 opt.NCC_ALPHA_2, ws)
    views, ok6, ws = _filter_by_angle(ctx, opt, center, normal, views, ws)
    ok = ok & ok4 & ok5 & ok6 & _assure_angles_b(ctx, opt, center, views)
    views, ws = _set_ref_image(ctx, opt, center, normal, scale, views, ws)
    views, ok7, ws = _filter_ncc(ctx, opt, center, normal, scale, views,
                                 opt.NCC_ALPHA_2, ws)
    color = _get_color(ctx, opt, center, scale, views)
    return center, normal, scale, views, ok & ok7, color


# ---------------------------------------------------------------------------
# Batched stages (same semantics and reference citations as the JAX
# package's batched pipeline).
# ---------------------------------------------------------------------------

def _fetch_ws_b(ctx, opt: Options, views, center, scale, prev=None,
                nv_old=None):
    """Window fetch for views (B, K), center (B, 3), scale (B,).

    prev + nv_old: selective re-fetch -- the first nv_old slots keep their
    windows from `prev` (the pre-stage cache, in matching slot order: the
    post add-images compaction keeps surviving views first); only the newly
    added slots are read."""
    ci = torch.clamp(views, min=0)
    k = views.shape[1]
    if prev is not None:
        slot = torch.arange(k, device=views.device)[None]
        mask = (slot >= nv_old[:, None]) & (views >= 0)
    else:
        mask = views >= 0   # empty slots are not read
    return win_ops.fetch_windows_t(
        ctx.cams, ctx.imgs, ci, center[:, None].expand(ci.shape + (3,)),
        scale[:, None].expand(ci.shape), opt.MAXLEVEL - 1, opt.WINDOW_SIZE,
        fetch_mask=mask, prev=prev)


def _add_images_b(ctx, opt: Options, center, normal, scale, views):
    """Batched addImages (PatchOptimizer.cpp:225-258). normal must be unit.
    CUDA tensors launch the add_views kernel (ops/select.py); CPU tensors
    run its twin."""
    if views.is_cuda:
        return select.add_views(ctx, opt, center, normal, scale, views)
    return _add_images_twin(ctx, opt, center, normal, scale, views)


def _add_images_twin(ctx, opt: Options, center, normal, scale, views):
    """Plain PyTorch version of the add_views kernel (csrc/select.cu)."""
    kernels.STATS["add_views"].twin_calls += 1
    ref_valid = views[:, 0] >= 0
    ref = torch.clamp(views[:, 0], min=0).long()
    cand = ctx.covis[ref]                                   # (B, C)
    cand_ci = torch.clamp(cand, min=0).long()
    cand_valid = (cand >= 0) & ref_valid[:, None]

    present = torch.any(cand[:, :, None] == views[:, None, :], dim=-1)

    ray = sampling.normalize3(ctx.cams.center[cand_ci] - center[:, None])
    angle_ok = (torch.sum(ray * sampling.normalize3(normal)[:, None], dim=-1)
                >= sampling.cos32(opt.MAX_ANGLE))

    cb = center[:, None].expand(cand_ci.shape + (3,))
    lvl = cam_ops.f2i(torch.round(cam_ops.get_level(ctx.cams, cand_ci, cb,
                                                    scale[:, None])))
    lvl_ok = (lvl >= opt.MINLEVEL) & (lvl < opt.MAXLEVEL - 2)
    lvl_c = torch.clamp(lvl, 0, opt.MAXLEVEL).long()

    uvw = cam_ops.project(ctx.cams, cand_ci, cb, lvl_c)
    w = ctx.imgs.width[cand_ci, lvl_c].to(uvw.dtype)
    h = ctx.imgs.height[cand_ci, lvl_c].to(uvw.dtype)
    inb = ((uvw[..., 0] >= 0.0) & (uvw[..., 0] < w - 1)
           & (uvw[..., 1] >= 0.0) & (uvw[..., 1] < h - 1))

    accept = cand_valid & ~present & angle_ok & lvl_ok & inb
    ext_vals = torch.cat([views, torch.where(accept, cand,
                                             torch.full_like(cand, INVALID))],
                         -1)
    ext_valid = torch.cat([views >= 0, accept], -1)
    k = views.shape[1]
    new_views = _compact(ext_vals, ext_valid)[0][:, :k]
    ok = ref_valid & (_nviews(new_views) >= opt.MIN_IMAGES_PER_PATCH)
    return new_views, ok


def _sample_views_b(ctx, opt: Options, center, normal, scale, views, ws,
                    with_color=False):
    """Texture of every view slot (scoring kernel B2). z axis =
    normalize(normal), tangent frame from slot 0 -- the _set_inccs
    convention (PatchOptimizer.cpp:448-474). Returns (tex (B,K,49,3), valid
    (B,K) incl. views >= 0[, center RGB (B,K,3) with with_color])."""
    out = score.sample_views_batch(ctx, opt, center, normal, scale, views, ws,
                                   with_color=with_color)
    return (out[0], out[1] & (views >= 0)) + tuple(out[2:])


def _ref_nccs(ctx, opt: Options, center, normal, scale, views, ws):
    """NCC of every view slot against slot 0 (B, K), and the slots whose
    texture was sampled (B, K) bool."""
    tex, valid = _sample_views_b(ctx, opt, center, normal, scale, views, ws)
    nccs = torch.einsum("bkpc,bpc->bk", tex, tex[:, 0]) / sampling.N_TEXELS
    return nccs, valid


def _sort_images_b(ctx, opt: Options, center, normal, scale, views):
    """Batched sortImages greedy ordering (PatchOptimizer.cpp:183-223)."""
    B, k = views.shape
    valid = views >= 0
    ci = torch.clamp(views, min=0).long()

    ref_level = cam_ops.f2i(torch.clamp(
        torch.round(cam_ops.get_level(ctx.cams, ci[:, 0], center, scale)),
        0, opt.MAXLEVEL - 1))
    rays = sampling.normalize3(ctx.cams.center[ci] - center[:, None])
    cosa = torch.sum(rays * sampling.normalize3(normal)[:, None], dim=-1)
    cand = valid & (cosa > 0)
    cb = center[:, None].expand(ci.shape + (3,))
    wscale = cam_ops.get_scale(ctx.cams, ci, cb,
                               ref_level[:, None].expand(ci.shape)
                               ) / torch.where(cosa > 0, cosa,
                                               torch.ones_like(cosa))

    order = torch.argsort((~cand).to(torch.int8), dim=-1, stable=True)
    ncand = torch.sum(cand, dim=-1)
    slot = torch.arange(k, device=views.device)
    c_views = torch.where(slot < ncand[:, None], torch.gather(views, -1, order),
                          torch.full_like(views, INVALID))
    c_w = torch.gather(wscale, -1, order)
    c_rays = torch.gather(rays, 1, order[:, :, None].expand(B, k, 3))
    c_valid = c_views >= 0
    c_w[:, 0] = 0.0
    c_w = torch.where(c_valid, c_w, torch.full_like(c_w, BIG))

    # float32 threshold as a tensor: torch evaluates python_scalar / tensor
    # as scalar * reciprocal(tensor), whose rounding can drop a ratio just
    # below 1 and let a picked slot (reset to BIG) win again
    # (torch.full, not torch.tensor: no host-to-device copy, which would
    # make the host wait for the stream)
    thr = torch.full(
        (), 1.0 - sampling.cos32(opt.SORT_SUPPRESS_DEG * torch.pi / 180.0),
        dtype=torch.float32, device=views.device)
    thr_half = thr / 2.0

    w = c_w
    out = torch.full_like(views, INVALID)
    picks = torch.zeros((B, k), dtype=torch.long, device=views.device)
    for i in range(k):
        pick = torch.argmin(w, dim=-1)                       # (B,)
        pv = torch.gather(c_views, -1, pick[:, None])[:, 0]
        wp = torch.gather(w, -1, pick[:, None])[:, 0]
        out[:, i] = torch.where(wp < BIG, pv, torch.full_like(pv, INVALID))
        picks[:, i] = pick
        pr = torch.gather(c_rays, 1, pick[:, None, None].expand(B, 1, 3))
        ftmp = torch.minimum(torch.maximum(
            1.0 - torch.sum(pr * c_rays, dim=-1), thr_half), thr)
        w = w * (thr / ftmp)
        w = torch.where(slot[None, :] == pick[:, None],
                        torch.full_like(w, BIG), w)
    ok = (_nviews(out) >= opt.MIN_IMAGES_PER_PATCH) & (ncand >= 2)
    perm = torch.gather(order, -1, picks)
    return out, ok, perm


def _pair_angles(rays):
    dots = torch.clamp(torch.einsum("bkd,bjd->bkj", rays, rays), -1.0, 1.0)
    return torch.arccos(dots)


def _assure_angles_b(ctx, opt: Options, center, views):
    """Batched assureImageAngles (PatchOptimizer.cpp:105-123)."""
    k = views.shape[1]
    ci = torch.clamp(views, min=0).long()
    rays = sampling.normalize3(ctx.cams.center[ci] - center[:, None])
    ang = _pair_angles(rays)
    valid = views >= 0
    eye = torch.eye(k, dtype=torch.bool, device=views.device)
    pair = valid[:, :, None] & valid[:, None, :] & ~eye[None]
    good = pair & (ang > opt.MIN_ANGLE) & (ang < opt.MAX_ANGLE)
    return torch.any(good.reshape(good.shape[0], -1), dim=-1)


def _sort_views(ctx, opt: Options, center, normal, scale, views, nccs,
                valid):
    """filterImagesNCC(NCC_ALPHA_1) + sortImages + assureImageAngles of the
    pre stage. CUDA tensors launch the sort_views kernel (ops/select.py);
    CPU tensors run its twin. Returns (views, ok, order: the composition of
    the filter compaction and the sort permutation)."""
    if views.is_cuda:
        return select.sort_views(ctx, opt, center, normal, scale, views, nccs,
                                 valid)
    return _sort_views_twin(ctx, opt, center, normal, scale, views, nccs,
                            valid)


def _sort_views_twin(ctx, opt: Options, center, normal, scale, views, nccs,
                     valid):
    """Plain PyTorch version of the sort_views kernel (csrc/select.cu)."""
    kernels.STATS["sort_views"].twin_calls += 1
    # filterImagesNCC (PatchOptimizer.cpp:138-152), compaction order o1
    ref_ok = valid[:, 0]
    two = torch.full_like(nccs, 2.0)
    inccs = torch.where(valid & ref_ok[:, None], 1.0 - nccs, two)
    inccs[:, 0] = torch.where(ref_ok, 0.0, 2.0)
    keep = (views >= 0) & (inccs < 1.0 - opt.NCC_ALPHA_1)
    keep[:, 0] = views[:, 0] >= 0  # always keep the reference
    views, o1 = _compact(views, keep)
    ok1 = _nviews(views) >= opt.MIN_IMAGES_PER_PATCH
    views, ok2, o2 = _sort_images_b(ctx, opt, center, normal, scale, views)
    ok = ok1 & ok2 & _assure_angles_b(ctx, opt, center, views)
    return views, ok, torch.gather(o1, -1, o2)


def _run_pre_b(ctx, opt: Options, center, normal, scale, views):
    """First half of runOptimization (growth + filters + sort). The window
    cache is permuted ONCE (kernel B3) with the composition of the filter
    compaction and the sort permutation."""
    normal = sampling.normalize3(normal)
    views, ok = _add_images_b(ctx, opt, center, normal, scale, views)
    ws = _fetch_ws_b(ctx, opt, views, center, scale)
    nccs, valid = _ref_nccs(ctx, opt, center, normal, scale, views, ws)
    views, ok1, order = _sort_views(ctx, opt, center, normal, scale, views,
                                    nccs, valid)
    ws = score.permute_ws(ws, order)
    return center, normal, views, ok & ok1, ws


def _run_post_b(ctx, opt: Options, center, normal, scale, views, ok,
                ws_pre=None):
    """Second half of runOptimization, fused: one window fetch and ONE
    texture-sampling pass; filterImagesNCC(a2), filterImagesByAngle,
    assureImageAngles, setRefImage and the final filterImagesNCC(a2)
    (PatchOptimizer.cpp:62-73) all read the same pairwise NCC matrix.

    With ws_pre (and REUSE_POST_WINDOWS), surviving view slots keep their
    pre-stage windows and only newly added views are fetched; views whose
    refined grid drifted past the coverage margin drop out via the standard
    level/coverage gates.

    Documented divergence: every NCC here is evaluated in the incoming
    slot-0 tangent frame; the reference resamples after each reorder, so its
    post-setRefImage NCCs use the *new* reference frame."""
    B, k = views.shape
    dev = views.device
    nv_old = _nviews(views)
    views, ok4 = _add_images_b(ctx, opt, center, normal, scale, views)
    ok = ok & ok4
    if ws_pre is not None and opt.REUSE_POST_WINDOWS:
        ws = _fetch_ws_b(ctx, opt, views, center, scale, prev=ws_pre,
                         nv_old=nv_old)
    else:
        ws = _fetch_ws_b(ctx, opt, views, center, scale)
    tex, vv, cols = _sample_views_b(ctx, opt, center, normal, scale, views,
                                    ws, with_color=True)
    nccs = torch.einsum("bapc,bkpc->bak", tex, tex) / sampling.N_TEXELS
    pair_ok = vv[:, :, None] & vv[:, None, :]
    eye = torch.eye(k, dtype=torch.bool, device=dev)[None]
    # plain pairwise incc (2.0 where either sample failed; 0 on the diagonal
    # of valid slots) -- the _set_inccs convention per reference row
    incc = torch.where(pair_ok, 1.0 - nccs, torch.full_like(nccs, 2.0))
    diag = torch.where(vv, 0.0, 2.0)[:, :, None].expand(B, k, k)
    incc = torch.where(eye, diag, incc)

    # filterImagesNCC(NCC_ALPHA_2) against the current reference (slot 0)
    keep = (views >= 0) & (incc[:, 0] < 1.0 - opt.NCC_ALPHA_2)
    keep[:, 0] = views[:, 0] >= 0  # ref always kept
    ok = ok & (torch.sum(keep, dim=-1) >= opt.MIN_IMAGES_PER_PATCH)

    # filterImagesByAngle (PatchOptimizer.cpp:125-136)
    ci = torch.clamp(views, min=0).long()
    rays = sampling.normalize3(ctx.cams.center[ci] - center[:, None])
    keep = keep & (torch.sum(rays * normal[:, None], dim=-1)
                   > sampling.cos32(opt.MAX_ANGLE))
    ok = ok & (torch.sum(keep, dim=-1) >= opt.MIN_IMAGES_PER_PATCH)

    # assureImageAngles over the kept views
    ang = _pair_angles(rays)
    pair = keep[:, :, None] & keep[:, None, :] & ~eye
    good = pair & (ang > opt.MIN_ANGLE) & (ang < opt.MAX_ANGLE)
    ok = ok & torch.any(good.reshape(B, -1), dim=-1)

    # setRefImage: argmin over kept slots of the summed robust incc
    # (robustify only real pair scores; masked 2.0 sentinels stay 2.0)
    rincc = torch.where(pair_ok & ~eye, sampling.robust_incc(incc), incc)
    sums = torch.sum(torch.where(keep[:, None, :], rincc,
                                 torch.zeros_like(rincc)), dim=-1)
    sums = torch.where(keep, sums, torch.full_like(sums, BIG))
    best = torch.argmin(sums, dim=-1)                       # (B,)
    best = torch.where(torch.sum(keep, dim=-1) <= 1, torch.zeros_like(best),
                       best)
    bi = best[:, None]

    # final filterImagesNCC(NCC_ALPHA_2) against the new reference = row
    # `best` of the incc matrix (divergence note above)
    incc_b = torch.gather(incc, 1, best[:, None, None].expand(B, 1, k))[:, 0]
    keep_b = torch.gather(keep, -1, bi)
    slot = torch.arange(k, device=dev)[None]
    keep2 = keep & (incc_b < 1.0 - opt.NCC_ALPHA_2)
    keep2 = torch.where(slot == bi, keep_b, keep2)          # new ref kept
    ok = ok & (torch.sum(keep2, dim=-1) >= opt.MIN_IMAGES_PER_PATCH)

    # realize the swap(0, best) + stable compaction as one view-id shuffle
    order = torch.where(slot == 0, bi, torch.where(slot == bi,
                                                   torch.zeros_like(slot),
                                                   slot))
    views, _ = _compact(torch.gather(views, -1, order),
                        torch.gather(keep2, -1, order))
    # Scene::getColor (Scene.cpp:300-327): median-by-norm over the kept views
    # using the center RGB the sampling pass already produced.
    # White-pixel (sky) case: |median| > 250 -> darkest view instead.
    norms = torch.where(keep2, torch.linalg.vector_norm(cols, dim=-1),
                        torch.full_like(cols[..., 0], BIG))
    corder = torch.argsort(norms, dim=-1, stable=True)
    nkept = torch.clamp(torch.sum(keep2, dim=-1), min=1)
    midx = torch.gather(corder, -1, (nkept // 2)[:, None])
    med = torch.gather(cols, 1, midx[:, :, None].expand(B, 1, 3))[:, 0]
    first = torch.gather(cols, 1, corder[:, :1, None].expand(B, 1, 3))[:, 0]
    color = torch.where(
        torch.linalg.vector_norm(med, dim=-1, keepdim=True) > 250.0, first, med)
    return center, normal, scale, views, ok, color


def _params_from_center_norm(center, normal, ref_center, ref_ray,
                             ax_x, ax_y, ax_z, opt: Options):
    """PatchOptimizer::parametersFromCenterNorm (PatchOptimizer.cpp:416-446),
    over a leading batch axis. Returns (B, 3)."""
    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    x0 = dot(center - ref_center, ref_ray)
    fx = dot(ax_x, normal)
    fy = dot(ax_y, normal)
    fz = dot(ax_z, normal)
    x2 = torch.arcsin(torch.clamp(fy, -1.0, 1.0))
    cosb = torch.cos(x2)
    safe = cosb != 0.0
    one = torch.ones_like(cosb)
    sina = fx / torch.where(safe, cosb, one)
    cosa = -fz / torch.where(safe, cosb, one)
    x1 = torch.arccos(torch.clamp(cosa, -1.0, 1.0))
    x1 = torch.where(sina < 0.0, -x1, x1)
    x1 = torch.where(safe, x1, torch.zeros_like(x1))
    b = opt.ANGLE_BOUND
    return torch.stack([x0,
                        torch.clamp(x1 / opt.ANGLE_SCALE, -b, b),
                        torch.clamp(x2 / opt.ANGLE_SCALE, -b, b)], dim=-1)


# ---------------------------------------------------------------------------
# The NCC objective and the plain refiner (USE_PALLAS_GN=False or
# USE_WINDOWS=False): the JAX package's _optimize_patch, per patch over a
# leading batch axis.
# ---------------------------------------------------------------------------

def _precompute_res(ctx, opt: Options, center, scale, views, ws):
    """Hoist the per-view projection terms out of the refinement loop.

    With center(x) = ref_center + x0*ref_ray, the homogeneous projection is
    affine in x0: P.[center;1] = P.[ref_center;1] + x0 * P3.ref_ray."""
    cams = ctx.cams
    ref_ci = torch.clamp(views[:, 0], min=0).long()
    ci = torch.clamp(views, min=0).long()
    level = ws.level.long()
    ref_ray = sampling.normalize3(center - cams.center[ref_ci])
    ax = [sampling.normalize3(a[ref_ci])
          for a in (cams.xaxis, cams.yaxis, cams.zaxis)]
    P = cams.P[ci, level]                                 # (B, K, 3, 4)
    Pl3 = P[..., :3]
    ch = torch.cat([center, torch.ones_like(center[:, :1])], -1)
    Pc_h = torch.einsum("bkij,bj->bki", P, ch)
    Pr = torch.einsum("bkij,bj->bki", Pl3, ref_ray)
    wlim = ctx.imgs.width[ci, level].to(center.dtype)
    hlim = ctx.imgs.height[ci, level].to(center.dtype)
    return (center, ref_ray, *ax, cams.center[ci], Pl3, Pc_h, Pr, wlim, hlim)


def _normal_from_params(x, ax_x, ax_y, ax_z, opt: Options):
    a1 = x[:, 1:2] * opt.ANGLE_SCALE
    a2 = x[:, 2:3] * opt.ANGLE_SCALE
    return (ax_x * (torch.sin(a1) * torch.cos(a2)) + ax_y * torch.sin(a2)
            + ax_z * (-torch.cos(a1) * torch.cos(a2)))


def _rho_from_textures(tex, valid, views):
    """Robust incc of every slot against slot 0: (rho (B,K) zero on invalid
    slots and the reference, n_valid (B,), ref_ok (B,))."""
    others = valid & (torch.arange(valid.shape[1], device=valid.device) > 0)
    incc = sampling.robust_incc(1.0 - sampling.ncc(tex[:, :1], tex))
    rho = torch.where(others, incc, torch.zeros_like(incc))
    return rho, torch.sum(others, dim=-1), valid[:, 0]


def _residuals_fast(opt: Options, x, pre, scale, views, ws):
    """Refiner residual pass on the precomputed terms (objective_fn via
    setCenterNorm, PatchOptimizer.cpp:286-311, 401-414) with the sampling
    level pinned to the window's level. x (B, 3)."""
    (ref_center, ref_ray, ax_x, ax_y, ax_z, cam_c, Pl3, Pc_h, Pr,
     wlim, hlim) = pre
    W = ws.W
    center = ref_center + x[:, 0:1] * ref_ray
    normal = _normal_from_params(x, ax_x, ax_y, ax_z, opt)
    # patch axes (calculatePatchAxis, PatchOptimizer.cpp:532-548)
    z = sampling.normalize3(normal)
    y = sampling.normalize3(torch.linalg.cross(z, ax_x, dim=-1))
    xax = sampling.normalize3(torch.linalg.cross(y, z, dim=-1)) * scale[:, None]
    yax = y * scale[:, None] * torch.sum(y * ax_y, dim=-1, keepdim=True)
    # projections, affine in x0
    ph_c = Pc_h + x[:, 0, None, None] * Pr                  # (B, K, 3)
    ph_x = ph_c + torch.einsum("bkij,bj->bki", Pl3, xax)
    ph_y = ph_c + torch.einsum("bkij,bj->bki", Pl3, yax)
    one = torch.ones_like(ph_c[..., 2])
    front = ph_c[..., 2] > 0.0
    c2 = ph_c[..., :2] / torch.where(front, ph_c[..., 2], one)[..., None]
    dx = ph_x[..., :2] / torch.where(ph_x[..., 2] != 0, ph_x[..., 2],
                                     one)[..., None] - c2
    dy = ph_y[..., :2] / torch.where(ph_y[..., 2] != 0, ph_y[..., 2],
                                     one)[..., None] - c2
    ray = sampling.normalize3(cam_c - center[:, None])
    angle_ok = (torch.sum(ray * z[:, None], dim=-1)
                >= sampling.cos32(opt.MAX_ANGLE))
    tl, mn, mx = win_ops.grid_box(c2, dx, dy)
    m = 3.0
    bounds_ok = ((mn[..., 0] >= m) & (mn[..., 1] >= m)
                 & (mx[..., 0] < wlim - m) & (mx[..., 1] < hlim - m))
    org = torch.stack([ws.ox, ws.oy], dim=-1).to(c2.dtype)
    cover_ok = (torch.all(mn - org >= 0.0, dim=-1)
                & torch.all(mx - org <= W - 1.0, dim=-1))
    valid = front & angle_ok & bounds_ok & cover_ok & (views >= 0)
    gx, gy = win_ops.local_grid(tl, dx, dy, ws)
    tex = sampling.normalize_tex(win_ops.hat_sample(
        ws.win, win_ops.jax_clip(gx, 0.0, W - 1.0),
        win_ops.jax_clip(gy, 0.0, W - 1.0)))
    return _rho_from_textures(tex, valid, views)


def _residuals(ctx, opt: Options, x, ref_center, ref_ray, ax_x, ax_y, ax_z,
               scale, views, ws=None):
    """Per-view robust incc residuals of PatchOptimizer::objective_fn via
    setCenterNorm (PatchOptimizer.cpp:286-311, 401-414), sampled from the
    full images (or the window cache). x (B, 3) = (depth, angle1, angle2).

    Returns (rho (B,K) with invalid slots zeroed, n_valid (B,), ref_ok)."""
    center = ref_center + x[:, 0:1] * ref_ray
    normal = _normal_from_params(x, ax_x, ax_y, ax_z, opt)
    ref_ci = torch.clamp(views[:, 0], min=0)
    xax, yax, zax = sampling.patch_axes(ctx.cams, ref_ci, normal, scale)
    tex, valid = _sample_views(ctx, opt, views, center, scale, xax, yax, zax,
                               ws)
    return _rho_from_textures(tex, valid, views)


def _objective(ctx, opt: Options, x, ref_center, ref_ray, ax_x, ax_y, ax_z,
               scale, views, ws=None):
    """Scalar objective per patch: mean robust incc over valid views, 2.0
    when the reference sample fails or too few views remain
    (objective_fn:293-310)."""
    return _mean_or_2(opt, *_residuals(ctx, opt, x, ref_center, ref_ray, ax_x,
                                       ax_y, ax_z, scale, views, ws))


def _mean_or_2(opt: Options, rho, n, ref_ok):
    """The objective from the residuals (n and ref_ok bool/int or float)."""
    mean = torch.sum(rho, dim=-1) / torch.clamp(n, min=1)
    good = (ref_ok > 0) & (n >= opt.MIN_IMAGES_PER_PATCH - 1)
    return torch.where(good, mean, torch.full_like(mean, 2.0))


def _lm_step(J, rho, n, lam):
    """Damped Gauss-Newton step on rho = r^2: g = sum_v J_v / n, H = sum_v
    J_v J_v^T / (2 rho_v) / n, (H + lam diag(max(|diag H|, 1e-6))) step =
    -g. A singular system (info != 0) or a non-finite step gives 0, as
    jnp.linalg.solve's non-finite result is zeroed. J (B, 3, K)."""
    n_f = torch.clamp(n, min=1.0)
    g = torch.sum(J, dim=-1) / n_f[:, None]
    w = torch.full_like(rho, 0.5) / (rho + GN_EPS)
    H = (J * w[:, None, :]) @ J.transpose(1, 2) / n_f[:, None, None]
    d = torch.clamp(torch.abs(torch.diagonal(H, dim1=1, dim2=2)), min=1e-6)
    sol, info = torch.linalg.solve_ex(H + lam[:, None, None]
                                      * torch.diag_embed(d), g)
    step = -sol
    ok = torch.isfinite(step) & (info == 0)[:, None]
    return torch.where(ok, step, torch.zeros_like(step))


def _optimize_patch(ctx, opt: Options, center, normal, scale, views, ws=None):
    """The plain refiner of (depth, angle1, angle2), replacing the BOBYQA
    call in PatchOptimizer::optimizePatch (PatchOptimizer.cpp:322-382).

    LM_EXACT_J=False: derivative-free like the reference -- each of
    ceil(LM_ITERS / LM_INNER) rounds refreshes J by forward differences (3
    residual passes at x + h e_i) and runs LM_INNER trial steps with a
    Broyden update after each; no early stop, fixed h (unlike the GN
    kernel's FD mode). LM_EXACT_J=True: LM_ITERS_EXACT Levenberg steps with
    J from torch.func.jacfwd, steps clamped to LM_STEP_CLAMP * h. With a
    window cache the passes run against precomputed projection terms
    (_residuals_fast). The objective evaluates the first
    min(K, MAX_IMAGES_PER_PATCH) view slots (PatchOptimizer.cpp:298).

    Returns (new_center (B,3), new_normal (B,3), ok (B,), f (B,))."""
    all_views = views
    kopt = min(views.shape[1], opt.MAX_IMAGES_PER_PATCH)
    views = views[:, :kopt]
    cams = ctx.cams
    ref_ci = torch.clamp(views[:, 0], min=0).long()
    ref_ray = sampling.normalize3(center - cams.center[ref_ci])
    ax_x, ax_y, ax_z = (sampling.normalize3(a[ref_ci])
                        for a in (cams.xaxis, cams.yaxis, cams.zaxis))
    if ws is not None:
        ws = win_ops.WinState(*(a[:, :kopt] for a in ws))
        pre = _precompute_res(ctx, opt, center, scale, views, ws)

        def res_fn(xx):
            return _residuals_fast(opt, xx, pre, scale, views, ws)
    else:
        def res_fn(xx):
            return _residuals(ctx, opt, xx, center, ref_ray, ax_x, ax_y, ax_z,
                              scale, views)

    def res_vec(xx):
        rho, n, ref_ok = res_fn(xx)
        return rho, n.to(rho.dtype), ref_ok.to(rho.dtype)

    b = opt.ANGLE_BOUND
    lo = center.new_tensor([-BIG, -b, -b])
    hi = center.new_tensor([BIG, b, b])
    x = _params_from_center_norm(center, normal, center, ref_ray, ax_x, ax_y,
                                 ax_z, opt)
    # FD steps: depth in world units scaled by the patch footprint, angles
    # in units of pi/48
    h = torch.stack([0.05 * scale, torch.full_like(scale, 0.25),
                     torch.full_like(scale, 0.25)], dim=-1)
    lam = torch.full_like(scale, opt.LM_LAMBDA0)

    def accept(acc, new, old):
        a = acc.reshape(acc.shape + (1,) * (new.dim() - 1))
        return torch.where(a, new, old)

    if opt.LM_EXACT_J:
        def grad_pass(xx):
            """rho, n, ref_ok and J (B, 3, K) at xx. The patches are
            independent, so the derivative along a shift d shared by all of
            them is each patch's own Jacobian."""
            def shifted(d):
                out = res_vec(xx + d)
                return out[0], out
            Jk, out = torch.func.jacfwd(shifted, has_aux=True)(
                torch.zeros(3, dtype=xx.dtype, device=xx.device))
            return (*out, Jk.transpose(1, 2))

        cl = h * opt.LM_STEP_CLAMP
        rho, n, ref_ok, J = grad_pass(x)
        f = _mean_or_2(opt, rho, n, ref_ok)
        for _ in range(int(opt.LM_ITERS_EXACT)):
            step = torch.minimum(torch.maximum(_lm_step(J, rho, n, lam), -cl),
                                 cl)
            x_t = torch.minimum(torch.maximum(x + step, lo), hi)
            rho_t, n_t, ref_t, J_t = grad_pass(x_t)
            f_t = _mean_or_2(opt, rho_t, n_t, ref_t)
            acc = f_t < f
            x, rho, n, ref_ok, f, J = (accept(acc, a_, b_) for a_, b_ in (
                (x_t, x), (rho_t, rho), (n_t, n), (ref_t, ref_ok), (f_t, f),
                (J_t, J)))
            lam = torch.clamp(torch.where(acc, lam * 0.5, lam * 4.0), 1e-7,
                              1e7)
    else:
        inner = max(1, int(opt.LM_INNER))
        eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
        rho, n, ref_ok = res_vec(x)
        f = _mean_or_2(opt, rho, n, ref_ok)
        for _ in range(-(-opt.LM_ITERS // inner)):
            J = torch.stack([(res_vec(x + h[:, i:i + 1] * eye3[i])[0] - rho)
                             / h[:, i:i + 1] for i in range(3)], dim=1)
            for _ in range(inner):
                x_new = torch.minimum(torch.maximum(
                    x + _lm_step(J, rho, n, lam), lo), hi)
                rho_t, n_t, ref_t = res_vec(x_new)
                # Broyden rank-1 secant update, accepted or not
                dx = x_new - x
                dd = torch.sum(dx * dx, dim=-1)
                pred = torch.sum(J * dx[:, :, None], dim=1)
                upd = dx[:, :, None] * ((rho_t - rho - pred) / torch.clamp(
                    dd, min=1e-20)[:, None])[:, None, :]
                J = torch.where((dd > 1e-20)[:, None, None], J + upd, J)
                f_new = _mean_or_2(opt, rho_t, n_t, ref_t)
                acc = f_new < f
                x, rho, n, ref_ok, f = (accept(acc, a_, b_) for a_, b_ in (
                    (x_new, x), (rho_t, rho), (n_t, n), (ref_t, ref_ok),
                    (f_new, f)))
                lam = torch.clamp(torch.where(acc, lam * 0.5, lam * 4.0),
                                  1e-7, 1e7)

    # setCenterNorm(x) write-back (PatchOptimizer.cpp:401-414)
    new_center = center + x[:, 0:1] * ref_ray
    new_normal = _normal_from_params(x, ax_x, ax_y, ax_z, opt)
    ok = _nviews(all_views) >= opt.MIN_IMAGES_PER_PATCH
    return new_center, new_normal, ok, f


def _use_gn_kernel(opt: Options) -> bool:
    """Refine with the GN kernel (ops/gn.py), as the JAX package does on a
    TPU; otherwise with the plain refiner _optimize_patch."""
    return opt.USE_PALLAS_GN and opt.USE_WINDOWS


def _use_batched_stages(opt: Options) -> bool:
    # the batched post stage implements the FAST_SETREF formulation only
    return opt.USE_BATCHED_STAGES and opt.USE_WINDOWS and opt.FAST_SETREF


def _refine(ctx, opt: Options, center, normal, scale, views, ok, ws):
    """optimizePatch for the whole batch, merged into (center, normal) where
    every stage so far succeeded. Returns (center, normal, ok, resid)."""
    if _use_gn_kernel(opt):
        new_center, new_normal, ok3, resid = gn.gn_refine_batch(
            ctx, opt, center, normal, scale, views, ws)
    else:
        new_center, new_normal, ok3, resid = _optimize_patch(
            ctx, opt, center, normal, scale, views, ws)
    ok = ok & ok3
    center = torch.where(ok[:, None], new_center, center)
    normal = torch.where(ok[:, None], sampling.normalize3(new_normal), normal)
    return center, normal, ok, resid


def _optimize_all(ctx, opt: Options, center, normal, scale, views):
    """Batched runOptimization over B patches: one of the two stage
    pipelines around the refiner (the GN kernel pads to its 128-patch block
    itself, on every device). Returns (center, normal, scale, views, ok,
    color, resid)."""
    batched = _use_batched_stages(opt)
    with trace.span("opt.pre"):
        pre = _run_pre_b if batched else _run_pre
        center, normal, views, ok, ws = pre(ctx, opt, center, normal, scale,
                                            views)
    with trace.span("opt.refine"):
        center, normal, ok, resid = _refine(ctx, opt, center, normal, scale,
                                            views, ok, ws)
    with trace.span("opt.post"):
        if batched:
            out = _run_post_b(ctx, opt, center, normal, scale, views, ok,
                              ws_pre=ws)
        else:
            out = _run_post(ctx, opt, center, normal, scale, views, ok)
    return out + (resid,)


def optimize_batch(ctx: SceneCtx, opt: Options, center, normal, scale, views):
    """Optimize B patches in one shot.

    center (B,3), normal (B,3), scale (B,), views (B,K) int32 -1-padded, all
    on ctx's device. Returns (center, normal, scale, views, ok, color, resid)
    batched -- the equivalent of B sequential PatchOptimizer::optimize
    invocations in the reference."""
    return _optimize_all(ctx, opt, center, normal, scale, views)


def optimize_and_gate(ctx: SceneCtx, pack, opt: Options, n_images: int,
                      center, normal, scale, views, parent_c, widths,
                      pend=None, with_gates: bool = True, pack_layout=None,
                      gate_imgs=None):
    """Extend-candidate compute: optimize + every acceptance gate of
    CellProcessor::extend (:130-142) -- scale window, drift, depthTests,
    viewBlockTest, pixelFreeTests.

    pend: deferred setDepths updates (c, s, views, phase; phase 0=add,
    1=sub, 2=add-after-sub) accumulated since the last call. They apply to
    the z-buffer (in place) in deferred order BEFORE the gates run.

    widths <= 0 marks lanes that want the bare optimize (seed / branch
    candidates: the reference runs the same optimizer for every phase,
    PatchOptimizer.cpp:78, and only extend applies these acceptance gates,
    CellProcessor.cpp:130-142). with_gates=False: the caller promises every
    lane is bare, so the gates are skipped.

    gate_imgs: the image-dim tables of the geometric gates, ctx.imgs by
    default. Per-block image subsets (parallel/subsets.py) pass a shard's
    slab as ctx.imgs (its textures, block-local row tables, zero dims for
    absent cameras) and the GLOBAL dims here: visibility tests span all
    images (Scene.cpp:610-644) while textures only need the block's
    cameras.

    Returns (center', normal', scale', views', ok, color)."""
    from hpmvs_tpu_torch.core import depth as depth_mod

    if pend is not None:
        pc_, ps_, pv_, pph_ = pend
        depth_mod.apply_phased_updates(pack, ctx.cams, pc_, ps_, pv_, pph_,
                                       opt.DEPTH_SUBSAMPLE)

    oc, on, os_, ov, ok, col, _ = _optimize_all(ctx, opt, center, normal,
                                                scale, views)
    if not with_gates:
        return oc, on, os_, ov, ok, col
    gate_on = widths > 0.0
    g = (os_ * 2.0 < widths) & (os_ * 2.0 > widths / 2.0)
    g = g & (torch.linalg.vector_norm(oc - parent_c, dim=1)
             < widths * opt.EXTEND_DRIFT)

    with trace.span("depth.gates"):
        dt, vb, pf = _depth_gates(ctx, pack, opt, n_images, oc, on, os_, ov,
                                  pack_layout, gate_imgs)
    nv = torch.sum(ov >= 0, dim=1)
    g = g & (dt >= opt.MIN_IMAGES_PER_PATCH)
    g = g & (vb < opt.MIN_IMAGES_PER_PATCH)
    g = g & ((pf >= opt.MIN_IMAGES_PER_PATCH - 1)
             & (pf / torch.clamp(nv, min=1) > 0.75))
    ok = ok & (g | ~gate_on)
    return oc, on, os_, ov, ok, col


def _depth_gates(ctx, pack, opt: Options, n_images: int, oc, on, os_, ov,
                 pack_layout, gate_imgs):
    """The three z-buffer gates of extend: depthTests, viewBlockTest and
    pixelFreeTests per lane (depth counts, before their thresholds)."""
    from hpmvs_tpu_torch.core import depth as depth_mod

    m = opt.DEPTH_TEST_FACTOR
    # collapsed full-depth buffer: the pyramid min computed ONCE per call, so
    # the depth and viewBlock tests read 1 cell per (lane, view, neighbour)
    # instead of n_levels
    full0 = pool3 = None
    if pack_layout is not None:
        full0 = depth_mod.collapse_full_depth(pack.depth, pack_layout,
                                              n_images)
        if opt.DEPTH_SUBSAMPLE == 2:
            # its 2x2 pools: the 3x3-neighbourhood tests gather 2 pooled
            # values per (lane, image) instead of 9 (depth.pool_full_depth)
            pool3 = depth_mod.pool_full_depth(full0)
    imgs = ctx.imgs if gate_imgs is None else gate_imgs
    dt = depth_mod.depth_tests(pack, ctx.cams, imgs, opt, oc, on, os_, ov, m,
                               full0=full0, pool3=pool3)
    vb = depth_mod.view_block_test(pack, ctx.cams, imgs, opt, oc, on, os_, m,
                                   n_images, full0=full0, pool3=pool3)
    pf = depth_mod.pixel_free_tests(pack, ctx.cams, imgs, opt, oc, os_, ov)
    return dt, vb, pf
