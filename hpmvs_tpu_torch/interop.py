"""Build the port's device state from host arrays of the JAX package.

The system has no weights; the state that carries over between the two
packages is the scene context (cameras, packed image pyramids,
covisibility) and the depth pack. Callers pass the JAX package's arrays as
numpy (np.asarray of each field), so this module imports neither jax nor
hpmvs_tpu, and both packages then run on identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from hpmvs_tpu_torch import resolve_device
from hpmvs_tpu_torch.core.depth import DepthPack
from hpmvs_tpu_torch.geom.camera import Cameras
from hpmvs_tpu_torch.image.pyramid import ImagePack
from hpmvs_tpu_torch.ops.optimizer import SceneCtx


def scene_ctx_from_numpy(cams, tex, row0, width, height, covis, ncovis,
                         device="cuda") -> SceneCtx:
    """cams: mapping of Cameras field name -> array (P, center, fsum, xaxis,
    yaxis, zaxis, oaxis, ipscale); tex (rows, wmax, 3) f32; row0/width/
    height (ncam, nlevel) int32; covis (ncam, C) int32; ncovis (ncam,).
    On the GPU unless device="cpu"."""
    device = resolve_device(device)
    def t(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device)

    return SceneCtx(
        cams=Cameras.from_numpy(cams, device),
        imgs=ImagePack(tex=t(tex, np.float32), row0=t(row0, np.int32),
                       width=t(width, np.int32), height=t(height, np.int32)),
        covis=t(covis, np.int32), ncovis=t(ncovis, np.int32))


def depth_pack_from_numpy(depth, offset, width, height,
                          device="cuda") -> DepthPack:
    """depth (cells,) f32; offset/width/height (ncam, nlevel) int32. The
    depth tensor is a copy (the port updates it in place). On the GPU
    unless device="cpu"."""
    device = resolve_device(device)
    return DepthPack(
        depth=torch.tensor(np.asarray(depth, np.float32), device=device),
        offset=torch.tensor(np.asarray(offset, np.int32), device=device),
        width=torch.tensor(np.asarray(width, np.int32), device=device),
        height=torch.tensor(np.asarray(height, np.int32), device=device))
