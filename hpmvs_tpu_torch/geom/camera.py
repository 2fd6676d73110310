"""Batched pinhole camera model with per-pyramid-level projections.

Behavioral equivalent of the reference Camera (include/hpmvs/Camera.h:29-106,
src/hpmvs/Camera.cpp:34-99): K[R|t] built from the NVM quaternion + center,
principal point at the image center, per-level projection matrices with rows
0,1 halved per level, scale/level conversions based on fx+fy, and the camera
frame axes (xAxis/yAxis/zAxis/oAxis).

All cameras live in one structure-of-arrays of float32 tensors on the scene's
device; a "camera index" is data, not an object. Projection of B points into
B cameras is a single (B,3,4) x (B,4) contraction.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from hpmvs_tpu_torch import resolve_device


@dataclasses.dataclass
class Cameras:
    """Structure-of-arrays over all cameras of the scene."""
    P: torch.Tensor        # (ncam, nlevel, 3, 4) projection per level
    center: torch.Tensor   # (ncam, 3) optical center
    fsum: torch.Tensor     # (ncam,) fx + fy at level 0 (Camera.cpp:85)
    xaxis: torch.Tensor    # (ncam, 3) image x axis (unit)
    yaxis: torch.Tensor    # (ncam, 3) image y axis (unit)
    zaxis: torch.Tensor    # (ncam, 3) optical axis (unit)
    oaxis: torch.Tensor    # (ncam, 4) normalized P row 2 (plane through center)
    ipscale: torch.Tensor  # (ncam,) average pixel scale

    @property
    def n_cameras(self) -> int:
        return self.P.shape[0]

    @property
    def n_levels(self) -> int:
        return self.P.shape[1]

    @classmethod
    def from_numpy(cls, arrays, device) -> "Cameras":
        """Build from a mapping of field name -> host array."""
        return cls(**{f.name: torch.tensor(
            np.asarray(arrays[f.name], np.float32), device=device)
            for f in dataclasses.fields(cls)})


def _quat_to_R(rq: np.ndarray) -> np.ndarray:
    """Rotation matrix from w,x,y,z quaternion (Eigen convention)."""
    w, x, y, z = rq / np.linalg.norm(rq)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def build_cameras(nvm_cameras, widths, heights, max_level: int,
                  device="cuda") -> Cameras:
    """Host-side construction from parsed NVM cameras (Camera.cpp:34-81),
    on the GPU unless device="cpu" (resolve_device: raises without one).

    widths/heights: per-camera level-0 image sizes (after undistortion).
    """
    device = resolve_device(device)
    ncam = len(nvm_cameras)
    nlevel = max_level + 1
    P = np.zeros((ncam, nlevel, 3, 4), dtype=np.float32)
    center = np.zeros((ncam, 3), dtype=np.float32)
    fsum = np.zeros((ncam,), dtype=np.float32)
    xaxis = np.zeros((ncam, 3), dtype=np.float32)
    yaxis = np.zeros((ncam, 3), dtype=np.float32)
    zaxis = np.zeros((ncam, 3), dtype=np.float32)
    oaxis = np.zeros((ncam, 4), dtype=np.float32)
    ipscale = np.zeros((ncam,), dtype=np.float32)

    for ii, cam in enumerate(nvm_cameras):
        w, h = widths[ii], heights[ii]
        K = np.array([[cam.f, 0, w / 2.0],
                      [0, cam.f, h / 2.0],
                      [0, 0, 1]], dtype=np.float64)
        R = _quat_to_R(np.asarray(cam.rq, dtype=np.float64))
        Rt = np.zeros((3, 4), dtype=np.float64)
        Rt[:, :3] = R
        Rt[:, 3] = -R @ np.asarray(cam.c, dtype=np.float64)
        P0 = (K @ Rt).astype(np.float32)

        for lv in range(nlevel):
            scl = np.array([[0.5 ** lv], [0.5 ** lv], [1.0]], dtype=np.float32)
            P[ii, lv] = P0 * scl

        center[ii] = np.asarray(cam.c, dtype=np.float32)
        fsum[ii] = 2.0 * cam.f
        oaxis_row = P0[2].astype(np.float64)
        oaxis[ii] = (oaxis_row / np.linalg.norm(oaxis_row[:3])).astype(np.float32)
        z = oaxis[ii, :3].astype(np.float64)
        x = P0[0, :3].astype(np.float64)
        y = np.cross(z, x)
        y /= np.linalg.norm(y)
        x = np.cross(y, z)
        x /= np.linalg.norm(x)
        xaxis[ii], yaxis[ii], zaxis[ii] = x, y, z
        ipscale[ii] = (np.linalg.norm(P0[0, :3]) + np.linalg.norm(P0[1, :3])) / 2.0

    return Cameras.from_numpy(dict(P=P, center=center, fsum=fsum, xaxis=xaxis,
                                   yaxis=yaxis, zaxis=zaxis, oaxis=oaxis,
                                   ipscale=ipscale), device)


# ---------------------------------------------------------------------------
# Batched camera ops. All take tensors of camera indices `ci` and broadcast.
# ---------------------------------------------------------------------------

def mult(cams: Cameras, ci, x3, level):
    """Raw projective transform, no checks (Camera.h:76-78).

    ci: (...,) int; x3: (..., 3) world points; level: (...,) int.
    Returns (..., 3) homogeneous image coordinates (u*w, v*w, w).
    """
    ci, level = torch.broadcast_tensors(torch.as_tensor(ci),
                                        torch.as_tensor(level,
                                                        device=x3.device))
    Pm = cams.P[ci.long(), level.long()]                 # (..., 3, 4)
    xh = torch.cat([x3, torch.ones_like(x3[..., :1])], dim=-1)
    return torch.einsum("...ij,...j->...i", Pm, xh)


def project(cams: Cameras, ci, x3, level):
    """Project with behind-camera flagging (Camera.h:45-62).

    Returns (..., 3): (u, v, w) with perspective division applied; points with
    w <= 0 map to (-0xffff, -0xffff, -1) exactly like the reference.
    """
    r = mult(cams, ci, x3, level)
    w = r[..., 2:3]
    ok = w[..., 0] > 0.0
    uv = r[..., :2] / torch.where(ok[..., None], w, torch.ones_like(w))
    uv = torch.where(ok[..., None], uv, torch.full_like(uv, -float(0xffff)))
    wout = torch.where(ok, torch.ones_like(r[..., 2]), -torch.ones_like(r[..., 2]))
    return torch.cat([uv, wout[..., None]], dim=-1)


def get_scale(cams: Cameras, ci, x3, level):
    """3D footprint of one pixel at `level` seen from camera ci (Camera.cpp:83-90)."""
    ci = torch.as_tensor(ci).long()
    fz = torch.linalg.vector_norm(x3 - cams.center[ci], dim=-1)
    ftmp = cams.fsum[ci]
    lv = torch.as_tensor(level, device=x3.device).to(fz.dtype)
    return torch.where(ftmp == 0.0, torch.ones_like(fz),
                       2.0 * fz * torch.exp2(lv) / ftmp)


def get_level(cams: Cameras, ci, x3, scale):
    """Continuous pyramid level whose pixel footprint matches `scale`
    (Camera.cpp:92-95)."""
    ci = torch.as_tensor(ci).long()
    fz = torch.linalg.vector_norm(x3 - cams.center[ci], dim=-1)
    return torch.log2(scale * cams.fsum[ci] / (2.0 * fz))


def f2i(v):
    """float -> int32 truncation that saturates and maps NaN to 0: the XLA
    conversion the JAX package relies on (torch leaves out-of-range and NaN
    casts undefined)."""
    v = torch.nan_to_num(v, nan=0.0, posinf=2147483520.0,
                         neginf=-2147483648.0)
    return torch.clamp(v, -2147483648.0, 2147483520.0).to(torch.int32)


def get_leveli(cams: Cameras, ci, x3, scale, max_level):
    """Rounded + clamped level (Camera.cpp:97-99)."""
    lv = torch.round(get_level(cams, ci, x3, scale))
    return f2i(torch.clamp(lv, 0, max_level))


def get_level_fit(cams: Cameras, ci, x3, scale, max_level, win_w: int,
                  patch: float = 7.0):
    """Window-fitting sampling level: the reference's rounded level
    (get_leveli) bumped one coarser when the patch grid's pixel span at the
    rounded level cannot fit the cached window with a drift margin.

    The window cache (ops/windows.py) has a hard per-view footprint bound --
    the window width -- that the reference's direct full-image gathers
    (PatchOptimizer.cpp:476-529) do not have. At fractional levels just
    under the rounding threshold the 7x7 grid spans patch * 2^0.5 ~ 9.9 px,
    which cannot sit inside a 12 px window once the integer window origin
    and optimizer drift consume the rest; the coverage gate would then void
    the view. Documented divergence: views whose fractional level lies in
    (log2((W-3)/patch), 0.5) sample one level coarser than the reference
    would."""
    raw = get_level(cams, ci, x3, scale)
    lv = torch.round(raw)
    thresh = math.log2(max((win_w - 3.0) / patch, 1.001))
    lv = torch.where(raw - lv > thresh, lv + 1.0, lv)
    return f2i(torch.clamp(lv, 0, max_level))
