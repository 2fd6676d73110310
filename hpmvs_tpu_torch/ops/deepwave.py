"""Deep waves: WAVE_DEPTH consecutive extend waves in one enqueue.

Wave N+1's extend batch is a function of wave N's gate results, so the
progressive loop is a chain of dependent dispatches, and each link costs the
host a round trip to the device (enqueue, wait, copy back, route) however
well it overlaps its routing with the device (wave lookahead). This module
shortens the chain by simulating the router on the device: one enqueue
optimizes wave N's candidate batch, dedups its winners as the host router
does (first wins by target cell, Engine._insert_winners) minus the occupancy
checks that need the host octree, applies generation 0's winners' depth
adds, derives their tangent-disc extend candidates
(Engine._extend_candidates minus the same occupancy pre-check) and
optimizes those as wave N+1, for n_gens generations. The host enqueues every
generation without waiting for the device in between, and copies all of
them back at once.

Because the device cannot see the host octree, each generation runs a
superset of the lanes the host router would have dispatched: device winners
include lanes whose target cell is occupied or finer on the host (the host
re-applies those checks fresh when it consumes a generation, which only
removes lanes), and every generation's candidates take all EXTEND_DIRS
directions. Superset lanes are wasted work, not errors. The z-buffer gets
only generation 0's winner adds on the device; deeper generations gate
against a buffer that lags their parents' adds by one dispatch (the host
stages their adds at routing), and false winners' adds of generation 0 are
repaired by staged subtracts. Parity with the classic engine is
statistical (tests/test_torch_deepwave.py).

The same design as hpmvs_tpu/ops/deepwave.py, where it hides a TPU
transport's round trips inside one XLA executable. Here the generations are
plain torch ops and kernel launches on one stream; nothing in them waits
for the device (no .item(), no data-dependent shapes, no host-to-device
copies), so the enqueue of all generations runs ahead of the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.core import depth as depth_mod
from hpmvs_tpu_torch.ops import optimizer as popt

BIG = 2 ** 30


class GateIn(NamedTuple):
    """One extend dispatch's lanes: centre, normal, scale, views (int32),
    parent centre, parent cell width (<= 0: no extend gates)."""
    c: torch.Tensor
    n: torch.Tensor
    s: torch.Tensor
    v: torch.Tensor
    pc: torch.Tensor
    w: torch.Tensor


class DeepOut(NamedTuple):
    """Every generation's results, stacked (n_gens, B, ...): optimized
    centre, normal, scale, views, ok, colour, the lane's candidate centre
    before optimization, and its device-winner mask."""
    oc: torch.Tensor
    on: torch.Tensor
    os: torch.Tensor
    ov: torch.Tensor
    ok: torch.Tensor
    col: torch.Tensor
    cand: torch.Tensor
    win: torch.Tensor


def pad_lanes(lanes, b: int):
    """Host lanes (centre, normal, scale, views, parent centre, width) padded
    to b rows as numpy arrays: padding lanes have no views, so no gate or
    winner takes them."""
    out = []
    for a, fill, dt in zip(lanes, (0.0, 0.0, 0.0, -1, 0.0, 1.0),
                           (np.float32,) * 3 + (np.int32,)
                           + (np.float32,) * 2):
        buf = np.full((b,) + a.shape[1:], fill, dt)
        buf[:len(a)] = a
        out.append(buf)
    return out


def level_from_width(widths, root_w):
    """Target level from the parent-cell width column: widths are exactly
    root_w / 2^lv (cell_center_width computes them so), so the log2 ratio
    rounds to the integer level in float32. root_w: 0-dim float32 tensor
    (a true division; torch turns python_scalar / tensor into a reciprocal
    multiply)."""
    r = torch.clamp(root_w / torch.clamp(widths, min=1e-30), min=1.0)
    return torch.round(torch.log2(r)).to(torch.int32)


def _cell_ijk(oc, lv, root_c, root_w):
    """Integer cell coordinates of oc at level lv (>= 0) inside the root cube,
    clipped to the level's resolution (LinearOctree.cell_coords in f32)."""
    lo = root_c - root_w * 0.5
    res = torch.bitwise_left_shift(torch.ones_like(lv), lv)
    cw = root_w / res.to(torch.float32)
    ijk = torch.floor((oc - lo[None]) / cw[:, None]).to(torch.int32)
    return torch.clamp(ijk, torch.zeros_like(ijk), (res - 1)[:, None])


def winner_dedup(oc, ok, lv, root_c, root_w):
    """Device twin of Engine._insert_winners minus the occupancy checks:
    inside-root test, then first wins by (level, cell ijk) in lane order.
    Returns the winner mask, a superset of the host's.

    The lanes are grouped by two stable sorts (the cell's z coordinate, then
    level|x|y packed into 45 bits), so each group lists its lanes in lane
    order and its first lane wins, as np.unique's first index does on the
    host."""
    B = oc.shape[0]
    lo = root_c - root_w * 0.5
    hi = root_c + root_w * 0.5
    inside = torch.all((oc >= lo[None]) & (oc < hi[None]), dim=1)
    ok = ok & inside & (lv >= 0)
    ijk = _cell_ijk(oc, torch.clamp(lv, min=0), root_c, root_w).long()
    k0 = torch.where(ok, lv.long(), torch.full_like(ijk[:, 0], 31))
    k12 = torch.where(ok, (ijk[:, 0] << 20) | ijk[:, 1],
                      torch.zeros_like(ijk[:, 0]))
    k3 = torch.where(ok, ijk[:, 2], torch.zeros_like(ijk[:, 0]))
    o1 = torch.sort(k3, stable=True).indices
    primary = ((k0 << 40) | k12)[o1]
    o2 = torch.sort(primary, stable=True).indices
    perm = o1[o2]
    sp, s3 = primary[o2], k3[perm]
    first = torch.ones(B, dtype=torch.bool, device=oc.device)
    first[1:] = (sp[1:] != sp[:-1]) | (s3[1:] != s3[:-1])
    win_sorted = first & ok[perm]
    return torch.zeros_like(ok).scatter(0, perm, win_sorted)


def compact_winner_lanes(winner, n_par: int):
    """First n_par winner lanes in ascending lane order (-1 padded): the
    parent slots of the next generation. The host recovers the same mapping
    from the winner mask (np.nonzero is ascending too)."""
    lane = torch.arange(winner.shape[0], dtype=torch.int32,
                        device=winner.device)
    key = torch.where(winner, lane, torch.full_like(lane, BIG))
    par = torch.sort(key).values[:n_par]
    return torch.where(par < BIG, par, torch.full_like(par, -1))


def next_gen_inputs(ctx, opt: Options, oc, on, os_, ov, width, winner):
    """Tangent-disc extend candidates of the compacted winner lanes as the
    next generation's lanes (Engine._extend_candidates without the tree
    pre-check; CellProcessor.cpp:104-116 geometry). Row p * EXTEND_DIRS + d
    holds parent slot p (ascending winner-lane order), direction d; rows
    past the last live parent are dead (views -1, width -1). Returns
    (GateIn, parent lane per slot)."""
    B = oc.shape[0]
    dirs = int(opt.EXTEND_DIRS)
    n_par = B // dirs
    par = compact_winner_lanes(winner, n_par)
    safe = torch.clamp(par, min=0).long()
    alive = par >= 0
    pc, pn, pv, pw = oc[safe], on[safe], ov[safe], width[safe]
    # tangent frame (Engine._tangent_axes / CellProcessor.cpp:98-101)
    cam_x = ctx.cams.xaxis[torch.clamp(pv[:, 0], min=0).long()]
    yax = torch.linalg.cross(pn, cam_x, dim=-1)
    yax = yax / torch.clamp(torch.linalg.vector_norm(yax, dim=1, keepdim=True),
                            min=1e-12)
    xax = torch.linalg.cross(yax, pn, dim=-1)
    ang = (2.0 * math.pi / dirs) * torch.arange(dirs, dtype=torch.float32,
                                                device=oc.device)
    dx, dy = torch.cos(ang), torch.sin(ang)
    cand = (pc[:, None, :] + (dx[None, :, None] * xax[:, None, :]
                              + dy[None, :, None] * yax[:, None, :])
            * pw[:, None, None]).reshape(n_par * dirs, 3)

    def rep(a):
        # each row dirs times (expand: repeat_interleave can sync the host)
        return a[:, None].expand(a.shape[0], dirs, *a.shape[1:]).reshape(
            a.shape[0] * dirs, *a.shape[1:])

    alive_r = rep(alive)
    rows = GateIn(c=cand, n=rep(pn), s=rep(pw) * (opt.EXTEND_SCALE / 2.0),
                  v=torch.where(alive_r[:, None], rep(pv),
                                torch.full_like(rep(pv), -1)),
                  pc=rep(pc),
                  w=torch.where(alive_r, rep(pw), torch.full_like(rep(pw),
                                                                  -1.0)))
    pad = B - n_par * dirs
    if pad:
        fills = (0.0, 0.0, 0.0, -1, 0.0, -1.0)
        rows = GateIn(*(torch.cat([a, torch.full((pad,) + a.shape[1:], f,
                                                 dtype=a.dtype,
                                                 device=a.device)])
                        for a, f in zip(rows, fills)))
    return rows, par


def winner_depth_adds(pack, cams, opt: Options, oc, os_, ov, winner):
    """Scatter-min the winners' depth windows into the z-buffer in place
    (Scene::setDepths adds), so the next generation's gates read them."""
    v = torch.where(winner[:, None], ov, torch.full_like(ov, -1))
    ph = torch.zeros(oc.shape[0], dtype=torch.int32, device=oc.device)
    depth_mod.apply_phased_updates(pack, cams, oc, os_, v, ph,
                                   opt.DEPTH_SUBSAMPLE)


def optimize_and_gate_deep(ctx, pack, opt: Options, n_images: int,
                           lanes: GateIn, root_c, root_w, pend=None,
                           n_gens: int = 2, pack_layout=None) -> DeepOut:
    """n_gens consecutive extend waves in one enqueue (see the module doc).

    lanes: wave N's lanes (host-built and host-prechecked like any extend
    dispatch), on the device. root_c (3,) / root_w (): the octree root cube
    as float32 device tensors. pend: deferred depth updates (c, s, views,
    phase), applied in place first, as optimize_and_gate does.

    Returns DeepOut stacked over generations; generation g's `cand` is its
    lanes' candidate centres before optimization, `win` its device winners.
    The z-buffer (pack.depth, updated in place) then holds generation 0's
    winner adds."""
    if pend is not None:
        depth_mod.apply_phased_updates(pack, ctx.cams, *pend,
                                       subsample=opt.DEPTH_SUBSAMPLE)
    outs = []
    for g in range(n_gens):
        oc, on, os_, ov, ok, col = popt.optimize_and_gate(
            ctx, pack, opt, n_images, *lanes, pack_layout=pack_layout)
        lv = level_from_width(lanes.w, root_w)
        win = winner_dedup(oc, ok, torch.where(lanes.w > 0, lv,
                                               torch.full_like(lv, -1)),
                           root_c, root_w)
        outs.append((oc, on, os_, ov, ok, col, lanes.c, win))
        if g + 1 < n_gens:
            if g == 0:
                # generation 0's lanes are host-prechecked, so its device
                # winners match the host router's up to one dispatch of tree
                # staleness, and their adds keep generation 1's gates fresh.
                # Deeper generations' lanes have no occupancy pre-check:
                # their winners include interior-targeting false winners
                # whose adds would poison the following generations'
                # pixel-free gates, so those run with an add lag instead.
                winner_depth_adds(pack, ctx.cams, opt, oc, os_, ov, win)
            lanes, _ = next_gen_inputs(ctx, opt, oc, on, os_, ov, lanes.w,
                                       win)
    return DeepOut(*(torch.stack(a) for a in zip(*outs)))


def to_host(out: DeepOut):
    """DeepOut -> numpy arrays of the same layout, in ONE device-to-host
    copy: the float columns and the int32 views (reinterpreted as float32)
    go back as one (n_gens, B, 15+K) tensor."""
    K = out.ov.shape[-1]
    f = torch.float32
    rows = torch.cat([out.oc, out.on, out.os[..., None], out.col,
                      out.ok.to(f)[..., None], out.cand,
                      out.win.to(f)[..., None],
                      out.ov.to(torch.int32).contiguous().view(f)], dim=-1)
    a = rows.cpu().numpy()
    return DeepOut(oc=a[..., 0:3], on=a[..., 3:6], os=a[..., 6],
                   ov=np.ascontiguousarray(a[..., 15:15 + K]).view(np.int32),
                   ok=a[..., 10] > 0.5, col=a[..., 7:10], cand=a[..., 11:14],
                   win=a[..., 14] > 0.5)
