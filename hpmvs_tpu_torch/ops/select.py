"""View selection of the batched stage pipelines in two kernels
(csrc/select.cu), one thread per patch.

`add_views` is addImages (PatchOptimizer.cpp:225-258), run once in each
stage; `sort_views` is the pre stage's filterImagesNCC(NCC_ALPHA_1),
sortImages and assureImageAngles on the NCCs the score kernel's textures
give, with the composed slot order for the window permute. Their plain
PyTorch twins are ops/optimizer.py::_add_images_twin and _sort_views_twin,
which the stage functions run for CPU tensors; these wrappers take CUDA
tensors only and launch or raise. K (view slots) and C (covisible
candidates) are read from the tensors, up to MAX_SLOTS each.
"""

from __future__ import annotations

import ctypes

import torch

from hpmvs_tpu_torch import kernels
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.ops import sampling

MAX_SLOTS = 32     # csrc/select.cu kMaxSlots: per-thread slot arrays


def _slots(name: str, t) -> int:
    """The width of a (rows, width) table, 1..MAX_SLOTS."""
    if t.dim() != 2 or not 1 <= t.shape[1] <= MAX_SLOTS:
        raise ValueError(f"{name}: expected (rows, n) with 1 <= n <= "
                         f"{MAX_SLOTS}, got {tuple(t.shape)}")
    return t.shape[1]


def _validate(spec) -> None:
    """spec: (name, tensor, dtype, shape) per kernel argument. Type, shape
    and layout first, the device last (so a CPU tensor of the wrong kind
    reports its kind); all on one CUDA device."""
    for name, t, dtype, shape in spec:
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    dev = spec[0][1].device
    for name, t, _, _ in spec:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")


def add_views(ctx, opt: Options, center, normal, scale, views):
    """addImages over B patches. center, normal (B, 3) float32 (normal
    unit), scale (B,), views (B, K) int32 -1-padded. Returns (views (B, K)
    int32, ok (B,) bool)."""
    K = _slots("views", views)
    C = _slots("covis", ctx.covis)
    B = views.shape[0]
    cams, imgs = ctx.cams, ctx.imgs
    ncam, nlev = cams.P.shape[:2]
    if not 0 <= opt.MAXLEVEL < nlev:
        raise ValueError(f"MAXLEVEL {opt.MAXLEVEL} outside the cameras' "
                         f"{nlev} levels")
    f32, i32 = torch.float32, torch.int32
    _validate([("views", views, i32, (B, K)),
               ("center", center, f32, (B, 3)),
               ("normal", normal, f32, (B, 3)),
               ("scale", scale, f32, (B,)),
               ("covis", ctx.covis, i32, (ncam, C)),
               ("cams.center", cams.center, f32, (ncam, 3)),
               ("cams.fsum", cams.fsum, f32, (ncam,)),
               ("cams.P", cams.P, f32, (ncam, nlev, 3, 4)),
               ("imgs.width", imgs.width, i32, (ncam, nlev)),
               ("imgs.height", imgs.height, i32, (ncam, nlev))])
    out = torch.empty_like(views)
    ok = torch.empty((B,), dtype=torch.bool, device=views.device)
    p = kernels.ptr
    kernels.launch(
        "hpmvs_add_views", p(views), p(center), p(normal), p(scale),
        p(ctx.covis), p(cams.center), p(cams.fsum), p(cams.P),
        p(imgs.width), p(imgs.height), ctypes.c_int(B), ctypes.c_int(K),
        ctypes.c_int(C), ctypes.c_int(nlev),
        ctypes.c_float(sampling.cos32(opt.MAX_ANGLE)),
        ctypes.c_int(opt.MINLEVEL), ctypes.c_int(opt.MAXLEVEL),
        ctypes.c_int(opt.MIN_IMAGES_PER_PATCH), p(out), p(ok))
    kernels.STATS["add_views"].launches += 1
    return out, ok


def sort_threshold(opt: Options) -> float:
    """sortImages' suppression threshold 1 - cos(SORT_SUPPRESS_DEG), as the
    twin's float32 tensor holds it."""
    return 1.0 - sampling.cos32(opt.SORT_SUPPRESS_DEG * torch.pi / 180.0)


def sort_views(ctx, opt: Options, center, normal, scale, views, nccs,
               valid):
    """filterImagesNCC(NCC_ALPHA_1) + sortImages + assureImageAngles over B
    patches. views (B, K) int32 after addImages, nccs (B, K) float32 (NCC of
    each slot against slot 0), valid (B, K) bool (the slot's texture
    sampled), normal unit. Returns (views (B, K) int32, ok (B,) bool,
    order (B, K) int32: new slot k holds old slot order[k])."""
    K = _slots("views", views)
    B = views.shape[0]
    ncam = ctx.cams.center.shape[0]
    f32 = torch.float32
    _validate([("views", views, torch.int32, (B, K)),
               ("nccs", nccs, f32, (B, K)),
               ("valid", valid, torch.bool, (B, K)),
               ("center", center, f32, (B, 3)),
               ("normal", normal, f32, (B, 3)),
               ("scale", scale, f32, (B,)),
               ("cams.center", ctx.cams.center, f32, (ncam, 3)),
               ("cams.fsum", ctx.cams.fsum, f32, (ncam,))])
    out = torch.empty_like(views)
    ok = torch.empty((B,), dtype=torch.bool, device=views.device)
    order = torch.empty_like(views)
    p = kernels.ptr
    kernels.launch(
        "hpmvs_sort_views", p(views), p(nccs), p(valid), p(center),
        p(normal), p(scale), p(ctx.cams.center), p(ctx.cams.fsum),
        ctypes.c_int(B), ctypes.c_int(K),
        ctypes.c_float(1.0 - opt.NCC_ALPHA_1),
        ctypes.c_float(sort_threshold(opt)), ctypes.c_int(opt.MAXLEVEL),
        ctypes.c_int(opt.MIN_IMAGES_PER_PATCH),
        ctypes.c_float(opt.MIN_ANGLE), ctypes.c_float(opt.MAX_ANGLE),
        p(out), p(ok), p(order))
    kernels.STATS["sort_views"].launches += 1
    return out, ok, order
