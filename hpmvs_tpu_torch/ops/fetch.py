"""Kernel B1: gather (patch, view) pixel windows from the packed pyramid.

Replaces hpmvs_tpu/ops/pallas_fetch.py::fetch_windows_dma. The CUDA kernel
is csrc/fetch.cu; `fetch_windows_twin` is its plain PyTorch version, run for
CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from hpmvs_tpu_torch import kernels


def fetch_windows(tex, rows, ox, W: int, mask=None, prev=None):
    """Cut W x W windows out of tex (R, wmax, 3) f32.

    rows/ox: (N,) int32 top row / left column (in bounds: the caller clamps
    them to R-W / wmax-W). mask: optional (N,) bool; pairs with mask False
    are not read and come back as prev's window, or zero without prev.
    Returns (N, W, W, 3) f32."""
    if not tex.is_cuda:
        return fetch_windows_twin(tex, rows, ox, W, mask, prev)
    n = rows.shape[0]
    kernels.check(tex, "tex", torch.float32, tex.shape)
    if tex.dim() != 3 or tex.shape[2] != 3:
        raise ValueError("tex: expected (rows, wmax, 3)")
    kernels.check(rows, "rows", torch.int32, (n,))
    kernels.check(ox, "ox", torch.int32, (n,))
    if mask is not None:
        # read in place as bytes (a bool is stored as one byte, 0 or 1): no
        # conversion kernel ahead of the copy
        mask = mask.contiguous()
        kernels.check(mask, "mask", torch.bool, (n,))
    if prev is not None:
        kernels.check(prev, "prev", torch.float32, (n, W, W, 3))
    out = torch.empty((n, W, W, 3), dtype=torch.float32, device=tex.device)
    kernels.launch("hpmvs_fetch_windows", kernels.ptr(tex),
                   ctypes.c_int(tex.shape[1]), kernels.ptr(rows),
                   kernels.ptr(ox), kernels.ptr(mask), kernels.ptr(prev),
                   kernels.ptr(out), ctypes.c_int(n), ctypes.c_int(W))
    kernels.STATS["fetch"].launches += 1
    return out


def fetch_windows_twin(tex, rows, ox, W: int, mask=None, prev=None):
    """Plain PyTorch version of the fetch kernel (same contract)."""
    kernels.STATS["fetch"].twin_calls += 1
    ar = torch.arange(W, device=tex.device)
    r = rows.long()[:, None] + ar                      # (N, W)
    c = ox.long()[:, None] + ar
    win = tex[r[:, :, None], c[:, None, :]]            # (N, W, W, 3)
    if mask is None:
        return win
    keep = mask[:, None, None, None]
    other = prev if prev is not None else torch.zeros_like(win)
    return torch.where(keep, win, other)
