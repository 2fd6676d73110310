"""Sharding of the wavefront compute over a mesh of torch devices, driven by
one process.

The reference's only parallelism is shared-memory spatial data-parallelism
over octree subtrees with mutex-guarded shared depth buffers and border-patch
queues (SURVEY.md section 2.3, main.cpp:144-181, CellProcessor.cpp:487-540).
The counterparts here, those of hpmvs_tpu/parallel/mesh.py:

  - axis 'dp' (patch data-parallel): a wavefront's candidate batch is split
    across the shards; each shard runs the full batched optimize pipeline.
  - axis 'sp' (spatial blocks): octree blocks map to shards; border patches
    that leave a shard migrate through a halo exchange (runtime/spatial.py).
  - depth-buffer consistency: every shard keeps its own z-buffer replica;
    a shard scatter-mins into its replica, then a min across the replicas
    (`pmin`) restores one consistent z-buffer.
  - termination: a sum of per-shard queue sizes (`have_work_psum`).

A Mesh is an ordered list of torch devices with the ('dp', 'sp') shape of
the JAX mesh kept for the reader. The same device may appear several times:
that is how the CPU tests run 8 shards (the counterpart of the JAX tests'
8 virtual XLA devices) and how one GPU runs 4 to 8. On a host with several
GPUs the shards are cuda:0..n-1.

State: mutable state (the z-buffer) is per shard, one replica each, as a
JAX P() array is one buffer per device, so one code path serves meshes with
and without repeated devices. Read-only scene tables go once per distinct
device (`replicate_tables`). A sharded batch is a list of per-shard
tensors, each on its shard's device.

Collectives are explicit tensor operations: `pmin` (a min across the
replicas, written back to each), `psum` (a sum), `ppermute` (shard s's
buffer to shard (s+k) mod n by .to(device)) and `all_to_all` (the
(destination, slot) exchange of `make_halo_exchange`).

Several processes (the JAX package's multi-controller bring-up):
`init_distributed` opens one torch.distributed process group (gloo) and
`make_mesh` then builds a mesh whose shards span the processes: process 0's
shards first, then process 1's (the order of jax.devices()). A shard of
another process holds no tensor here: its entry in `Mesh.devices`, in every
per-shard list and in every collective's output is None. Every collective
reduces over the local shards first, then across the processes through a
host allgather in process order, so its result is bit-identical on every
process. The group runs on CPU tensors, staged from and to the devices
explicitly: gloo runs only broadcast and all_reduce on CUDA tensors, and
NCCL cannot put two ranks on one GPU (the two-process runs on one card).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from hpmvs_tpu_torch import resolve_device
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.core import depth as depth_mod
from hpmvs_tpu_torch.ops import optimizer as popt

AXES = ("dp", "sp")


# ----------------------------------------------------------------------
# processes (torch.distributed, one gloo group)
# ----------------------------------------------------------------------
# a collective that one process never joins fails after this long instead
# of hanging the run
DIST_TIMEOUT_S = 300.0
_LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
# host collectives of this process: calls and the bytes received from the
# other processes
WIRE = {"calls": 0, "bytes": 0}


def init_distributed(address: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = DIST_TIMEOUT_S) -> int:
    """Multi-process bring-up (hpmvs_tpu/parallel/mesh.py:39-80 on
    torch.distributed): one gloo process group. Returns the number of
    processes.

    address ("tcp://host:port" or "host:port"), world_size and rank given
    explicitly, or taken from a torchrun launch's MASTER_ADDR, MASTER_PORT,
    RANK and WORLD_SIZE. Without either it does nothing and returns 1; an
    initialised group is kept. When explicit arguments or a launcher's
    variables are present and the initialisation fails, it raises: carrying
    on single-process would run the whole reconstruction once per process,
    each writing its own conflicting output. timeout_s bounds every
    collective of the group."""
    dist = torch.distributed
    if dist.is_initialized():
        return dist.get_world_size()
    explicit = (address, world_size, rank) != (None, None, None)
    env = [k for k in _LAUNCH_VARS if os.environ.get(k)]
    if not explicit and not env:
        return 1
    if explicit:
        if None in (address, world_size, rank):
            raise ValueError("init_distributed: give address, world_size "
                             "and rank together")
        init = address if "://" in address else f"tcp://{address}"
        kw = dict(init_method=init, world_size=int(world_size),
                  rank=int(rank))
    else:
        missing = [k for k in _LAUNCH_VARS if k not in env]
        if missing:
            raise ValueError(f"init_distributed: a launch sets {env} but "
                             f"not {missing}")
        kw = dict(init_method="env://")
    dist.init_process_group(
        "gloo", timeout=datetime.timedelta(seconds=float(timeout_s)), **kw)
    return dist.get_world_size()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_initialized() else 1


def _gather_bytes(buf: np.ndarray) -> list:
    """Host allgather of a uint8 buffer of any length: every process's
    buffer, in process order. CPU tensors (gloo)."""
    dist = torch.distributed
    P = process_count()
    buf = np.ascontiguousarray(buf, np.uint8).reshape(-1)
    n = torch.tensor([buf.size], dtype=torch.int64)
    ns = [torch.zeros(1, dtype=torch.int64) for _ in range(P)]
    dist.all_gather(ns, n)
    ns = [int(x) for x in ns]
    t = torch.zeros(max(max(ns), 1), dtype=torch.uint8)
    t[:buf.size] = torch.from_numpy(buf.copy())
    outs = [torch.empty_like(t) for _ in range(P)]
    dist.all_gather(outs, t)
    WIRE["calls"] += 1
    WIRE["bytes"] += sum(ns) - buf.size
    return [o[:k].numpy() for o, k in zip(outs, ns)]


def allgather(x) -> np.ndarray:
    """Host allgather (hpmvs_tpu/runtime/owned.py::_allgather): a
    (P,) + x.shape array ordered by process id, identical on every
    process. Ragged leading dimensions are padded with zeros to the
    longest, as the JAX engine pads them (a caller that must tell padding
    from rows marks its rows: runtime/owned.py::_gather_pend)."""
    x = np.asarray(x)
    if process_count() == 1:
        return x[None].copy()
    scalar = x.ndim == 0
    x1 = np.ascontiguousarray(x.reshape(1) if scalar else x)
    rows = [b.view(x.dtype).reshape((-1,) + x1.shape[1:])
            for b in _gather_bytes(x1.view(np.uint8))]
    m = max(len(r) for r in rows)
    out = np.zeros((len(rows), m) + x1.shape[1:], x.dtype)
    for p, r in enumerate(rows):
        out[p, :len(r)] = r
    return out[:, 0] if scalar else out


def allgather_object(obj) -> list:
    """Every process's picklable host object, in process order (the
    cross-process rows of ppermute / all_to_all / unshard, the engines'
    per-shard dispatch outputs)."""
    if process_count() == 1:
        return [obj]
    got = _gather_bytes(np.frombuffer(pickle.dumps(obj, protocol=5),
                                      np.uint8))
    return [pickle.loads(b.tobytes()) for b in got]


class Mesh:
    """An ordered list of shard devices with a ('dp', 'sp') shape; shard i
    is devices[i], the row-major flattening of the shape (the order of
    JAX's P(('dp', 'sp')) sharding).

    shard_proc: the process of each shard (default: all this process's);
    devices[i] is None for a shard of another process."""

    def __init__(self, devices: Sequence[Optional[torch.device]],
                 shape: Tuple[int, int], shard_proc=None):
        shape = tuple(int(x) for x in shape)
        if len(shape) != 2 or shape[0] * shape[1] != len(devices):
            raise ValueError(f"mesh shape {shape} does not hold "
                             f"{len(devices)} devices")
        self.devices = tuple(devices)
        self.shape = shape
        self.axis_names = AXES
        self.pid = process_index()
        self.shard_proc = (np.full(len(devices), self.pid, np.int64)
                           if shard_proc is None
                           else np.asarray(shard_proc, np.int64))
        if [d is not None for d in self.devices] != \
                list(self.shard_proc == self.pid):
            raise ValueError("a mesh holds a device for exactly its local "
                             "shards")
        self.n_proc = len(np.unique(self.shard_proc))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> np.ndarray:
        """(size,) bool: the shards of this process."""
        return self.shard_proc == self.pid

    @property
    def local_ids(self) -> np.ndarray:
        return np.nonzero(self.local)[0]

    @property
    def first(self) -> torch.device:
        """The device of this process's first shard."""
        return self.devices[int(self.local_ids[0])]

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """This process's devices, each once, in shard order."""
        return tuple(dict.fromkeys(d for d in self.devices if d is not None))

    def __repr__(self):
        return f"Mesh({dict(zip(self.axis_names, self.shape))}, " \
               f"{[str(d) for d in self.devices]}, " \
               f"processes={self.shard_proc.tolist()})"


def _resolve(dev) -> torch.device:
    """resolve_device, with a bare "cuda" pinned to the current device so
    that "cuda" and "cuda:0" name one device."""
    d = resolve_device(dev)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices=None, shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """Build a ('dp', 'sp') mesh.

    devices: this process's shards as a sequence of device specs (repeats
    allowed: ["cuda"] * 4 puts four shards on one GPU, ["cpu"] * 8 eight
    on the CPU), an int n for cuda:0..n-1, or None for every visible GPU.
    A CUDA device without a GPU raises (no shard runs quietly on the CPU).
    Under a process group (init_distributed) every process calls it with
    its own shards and the mesh spans them all, process 0's first (a
    collective: every process must call it). shape: as JAX make_mesh
    (mesh.py:83-97) over the global shard count, default (n // sp, sp) with
    sp the first of 4, 2, 1 dividing n."""
    if devices is None:
        resolve_device("cuda")
        devices = torch.cuda.device_count()
    if isinstance(devices, int):
        n = devices
        if n > 0:
            resolve_device("cuda")
        if n > torch.cuda.device_count():
            raise ValueError(f"make_mesh: {n} GPUs asked for, "
                             f"{torch.cuda.device_count()} visible")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = [_resolve(d) for d in devices]
    counts = allgather(np.int64(len(devs)))
    if counts.min() == 0:
        # as hpmvs_tpu/runtime/owned.py:70-71: a process without a shard
        # of the mesh cannot own blocks nor join its dispatches
        raise ValueError(f"make_mesh: a process holds no shard "
                         f"(shards per process {counts.tolist()})")
    pid = process_index()
    shard_proc = np.repeat(np.arange(len(counts)), counts)
    glob = [None] * int(counts.sum())
    off = int(counts[:pid].sum())
    glob[off:off + len(devs)] = devs
    n = len(glob)
    if shape is None:
        sp = 1
        for cand in (4, 2, 1):
            if n % cand == 0:
                sp = cand
                break
        shape = (n // sp, sp)
    return Mesh(glob, shape, shard_proc=shard_proc)


# ----------------------------------------------------------------------
# placement
# ----------------------------------------------------------------------
def to_device(obj, device: torch.device):
    """obj with every tensor on `device` (a tensor already there is shared,
    not copied): tensors, dataclasses, named and plain tuples, lists."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(x, device) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(x, device) for x in obj)
    return obj


def replicate_tables(mesh: Mesh, obj) -> list:
    """Read-only `obj` per shard: one copy per distinct device, shared by
    the shards on it (the copy on obj's own device is obj's tensors); None
    for the shards of other processes."""
    per = {}
    for d in mesh.distinct:
        per[d] = to_device(obj, d)
    return [None if d is None else per[d] for d in mesh.devices]


def replicate(mesh: Mesh, t: torch.Tensor) -> list:
    """Mutable per-shard replicas of `t`: every local shard its own copy."""
    return [None if d is None else t.to(d, copy=True) for d in mesh.devices]


def shard_batch(mesh: Mesh, a) -> list:
    """A batch (leading dim a multiple of the mesh size: pad_to_multiple)
    as per-shard tensors, shard i holding the i-th contiguous segment
    (None for the shards of other processes)."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    if t.shape[0] % mesh.size:
        raise ValueError(f"batch of {t.shape[0]} does not split over "
                         f"{mesh.size} shards")
    return [None if d is None else p.to(d)
            for p, d in zip(torch.chunk(t, mesh.size), mesh.devices)]


def unshard(parts, mesh: Optional[Mesh] = None) -> np.ndarray:
    """Per-shard tensors -> one host array (shard order). Over a mesh that
    spans processes the other processes' shards are gathered (every
    process calls it)."""
    host = [None if p is None else p.cpu().numpy() for p in parts]
    if mesh is not None and mesh.n_proc > 1:
        host = _merge_shards(mesh, host)
    return np.concatenate(host)


def _merge_shards(mesh: Mesh, host: list) -> list:
    """A per-shard list of host values, this process's shards filled in,
    completed with the other processes' shards (one allgather)."""
    mine = {int(i): host[i] for i in mesh.local_ids}
    out = list(host)
    for p, got in enumerate(allgather_object(mine)):
        if p != mesh.pid:
            for i, v in got.items():
                out[i] = v
    return out


def pad_to_multiple(arrs, batch: int, mult: int, fills):
    """Pad leading batch dim to a multiple of `mult`."""
    pad = (-batch) % mult
    if pad == 0:
        return arrs, batch
    out = []
    for a, fill in zip(arrs, fills):
        padding = np.full((pad,) + a.shape[1:], fill, a.dtype)
        out.append(np.concatenate([np.asarray(a), padding], axis=0))
    return out, batch + pad


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------
def _across(mesh: Optional[Mesh], t: torch.Tensor, op) -> torch.Tensor:
    """This process's partial result t reduced with op across the
    processes of `mesh`, in process order (bit-identical on every process);
    t itself on a single-process mesh."""
    if mesh is None or mesh.n_proc == 1:
        return t
    g = torch.as_tensor(allgather(t.detach().cpu().numpy()))
    tot = g[0]
    for x in g[1:]:
        tot = op(tot, x)
    return tot.to(t.device)


def pmin(replicas: list, mesh: Optional[Mesh] = None) -> list:
    """All-reduce min over per-shard replicas, in place: every replica ends
    equal to the elementwise min of all of them (the local shards' first,
    then across the processes of `mesh`). None entries (other processes'
    shards) are skipped."""
    loc = [r for r in replicas if r is not None]
    m = loc[0]
    for r in loc[1:]:
        m = torch.minimum(m, r.to(m.device))
    m = _across(mesh, m, torch.minimum)
    for r in loc:
        r.copy_(m)
    return replicas


def psum(parts: list, mesh: Optional[Mesh] = None) -> list:
    """All-reduce sum over per-shard tensors: the total on every shard's
    device, summed in shard order over the local shards, then in process
    order across the processes of `mesh` (so every process holds the same
    bits). None entries (other processes' shards) stay None."""
    loc = [p for p in parts if p is not None]
    tot = loc[0]
    for p in loc[1:]:
        tot = tot + p.to(tot.device)
    tot = _across(mesh, tot, torch.add)
    return [None if p is None else tot.to(p.device) for p in parts]


def _cross(mesh: Mesh, sends: dict) -> dict:
    """Rows between processes: sends[(src, dst)] a tensor from a local
    shard src to a shard dst of another process. Returns {(src, dst):
    tensor on dst's device} for this process's shards dst (one allgather of
    host copies)."""
    out = {}
    mine = {k: v.cpu().numpy() for k, v in sends.items()}
    for p, got in enumerate(allgather_object(mine)):
        if p == mesh.pid:
            continue
        for (s, d), v in got.items():
            if mesh.devices[d] is not None:
                out[(s, d)] = torch.as_tensor(v).to(mesh.devices[d])
    return out


def _hop(mesh: Mesh, bufs: list, k: int):
    """Shard s's buffer to shard (s + k) mod n, for this process's shards
    s: device copies to this process's shards (out, None elsewhere), and
    the buffers bound for another process's shards ({(s, d): buffer})."""
    n = mesh.size
    out, sends = [None] * n, {}
    for s in mesh.local_ids:
        d = (int(s) + k) % n
        if bufs[s] is None:
            continue
        if mesh.devices[d] is not None:
            out[d] = bufs[s].to(mesh.devices[d])
        else:
            sends[(int(s), d)] = bufs[s]
    return out, sends


def ppermute(mesh: Mesh, bufs: list, k: int) -> list:
    """Shard s's buffer moves to shard (s + k) mod n: a device copy between
    this process's shards, through the host allgather between processes
    (every process calls it)."""
    out, sends = _hop(mesh, bufs, k)
    if mesh.n_proc > 1:
        for (s, d), v in _cross(mesh, sends).items():
            out[d] = v
    return out


def all_to_all(mesh: Mesh, sends: list) -> list:
    """sends[s] (n, ...) on local shard s: row d goes to shard d. Returns
    recv[d] (n, ...) on local shard d, row s from shard s (rows between
    processes through the host allgather; every process calls it)."""
    n = mesh.size
    loc = [int(i) for i in mesh.local_ids]
    remote = {}
    if mesh.n_proc > 1:
        remote = _cross(mesh, {(s, d): sends[s][d] for s in loc
                               for d in range(n)
                               if mesh.devices[d] is None})
    return [None if mesh.devices[d] is None else torch.stack(
        [sends[s][d].to(mesh.devices[d]) if mesh.devices[s] is not None
         else remote[(s, d)] for s in range(n)]) for d in range(n)]


# ----------------------------------------------------------------------
# sharded compute
# ----------------------------------------------------------------------
def _pack_tables(mesh: Mesh, pack: depth_mod.DepthPack) -> list:
    """The depth pack's read-only tables per shard (depth left out: each
    shard brings its own replica)."""
    return replicate_tables(mesh, dataclasses.replace(pack, depth=None))


def sharded_optimize_step(mesh: Mesh, ctx: popt.SceneCtx, opt: Options,
                          pack: depth_mod.DepthPack):
    """The multi-shard wavefront compute step.

    Returns (step, n_shards): step(centers, normals, scales, views, depth)
    takes sharded batches (per-shard tensor lists, pad_to_multiple +
    shard_batch) and the per-shard z-buffer replicas, and returns
    (centers', normals', scales', views', ok, colors) as sharded batches
    and the replicas: each shard scatter-mins its accepted patches into its
    own replica, then pmin makes them consistent (in place), across the
    processes too. Over a mesh that spans processes each process runs its
    own shards (None in and out for the others')."""
    n_shards = mesh.size
    ctxs = replicate_tables(mesh, ctx)
    tabs = _pack_tables(mesh, pack)
    subsample = opt.DEPTH_SUBSAMPLE

    def step(c, n, s, v, depth):
        outs = []
        for i in range(n_shards):
            if depth[i] is None:            # another process's shard
                outs.append((None,) * 6)
                continue
            oc, on, os_, ov, ok, col, _ = popt._optimize_all(
                ctxs[i], opt, c[i], n[i], s[i], v[i])
            v_ok = torch.where(ok[:, None], ov, torch.full_like(ov, -1))
            local = dataclasses.replace(tabs[i], depth=depth[i])
            idx, d, valid = depth_mod._patch_view_cells(
                local, ctxs[i].cams, oc, os_, v_ok, subsample)
            depth[i].scatter_reduce_(
                0, idx.reshape(-1).long(),
                torch.where(valid, d, torch.full_like(d, float("inf")))
                .reshape(-1), "amin")
            outs.append((oc, on, os_, ov, ok, col))
        pmin(depth, mesh)
        return tuple([o[j] for o in outs] for j in range(6)) + (depth,)

    return step, n_shards


def gate_shards(ctxs, tabs, opt: Options, n_images: int, lanes, depth, pend,
                with_gates: bool = True, pack_layout=None, slabs=None):
    """optimize_and_gate on every shard: lanes[i] (centers, normals, scales,
    views, parent_c, widths) on shard i's device, or None for a shard
    without lanes; depth[i] its z-buffer replica; pend[i] the deferred
    depth window on its device (or pend None). The window applies to every
    replica exactly once, a shard without lanes included, so the replicas
    stay equal. slabs[i]: shard i's image slab (per-block image subsets):
    textures come from it, while the geometric gates keep the global image
    dims (ctxs[i].imgs). Returns per-shard output tuples (None where a shard
    had no lanes). The shards of other processes (depth[i] None) are
    skipped: each process applies the same window to its own replicas, so
    every replica stays equal without a device collective."""
    outs = []
    for i, d in enumerate(depth):
        if d is None:
            outs.append(None)
            continue
        local = dataclasses.replace(tabs[i], depth=d)
        p = None if pend is None else pend[i]
        if lanes[i] is None:
            if p is not None:
                depth_mod.apply_phased_updates(local, ctxs[i].cams, *p,
                                               opt.DEPTH_SUBSAMPLE)
            outs.append(None)
            continue
        ctx = ctxs[i]
        gate_imgs = None
        if slabs is not None:
            gate_imgs = ctx.imgs
            ctx = dataclasses.replace(ctx, imgs=slabs[i])
        outs.append(popt.optimize_and_gate(
            ctx, local, opt, n_images, *lanes[i], pend=p,
            with_gates=with_gates, pack_layout=pack_layout,
            gate_imgs=gate_imgs))
    return outs


def sharded_optimize_and_gate(mesh: Mesh, ctx: popt.SceneCtx, opt: Options,
                              pack: depth_mod.DepthPack, n_images: int,
                              pack_layout=None, image_subsets: bool = False):
    """Extend-candidate compute over the mesh: optimize + every
    CellProcessor::extend acceptance gate, once per shard on its lanes
    (the twin of ops/optimizer.optimize_and_gate; the JAX package's
    sharded_optimize_and_gate and its packed twin in one, the port having
    no packed row layout). The deferred depth window applies to every
    shard's replica before its gates.

    Returns (fn, n_shards): fn(lanes, depth, pend=None, with_gates=True,
    slabs=None) with the arguments of gate_shards. image_subsets: the
    dispatches pass per-shard slabs (parallel/subsets.place_block_pack),
    so the replicated scene tables leave out the global texture (it may
    stay on the host: Engine(host_images=True)). The scene and pack tables
    are replicated here, once: rebuild fn when the scene grows
    (Engine.refresh_host_caches does)."""
    if image_subsets:
        ctx = dataclasses.replace(ctx, imgs=ctx.imgs._replace(tex=None))
    ctxs = replicate_tables(mesh, ctx)
    tabs = _pack_tables(mesh, pack)

    def fn(lanes, depth, pend=None, with_gates=True, slabs=None):
        return gate_shards(ctxs, tabs, opt, n_images, lanes, depth, pend,
                           with_gates=with_gates, pack_layout=pack_layout,
                           slabs=slabs)

    return fn, mesh.size


def sharded_apply_depth_updates(mesh: Mesh, cams, pack: depth_mod.DepthPack,
                                subsample: int):
    """Standalone deferred-depth flush over the mesh: fn(depth, c, s, v, ph)
    applies the window (host arrays or tensors) to every per-shard replica
    in place and returns the replicas."""
    camss = replicate_tables(mesh, cams)
    tabs = _pack_tables(mesh, pack)

    def fn(depth, c, s, v, ph):
        win = tuple(torch.as_tensor(np.asarray(a)) if not
                    isinstance(a, torch.Tensor) else a for a in (c, s, v, ph))
        wins = replicate_tables(mesh, win)
        for i, d in enumerate(depth):
            if d is None:
                continue
            depth_mod.apply_phased_updates(
                dataclasses.replace(tabs[i], depth=d), camss[i], *wins[i],
                subsample)
        return depth

    return fn


def make_halo_exchange(mesh: Mesh, slots: int):
    """The border-patch migration collective (replaces distributeBorderCell,
    CellProcessor.cpp:533-540).

    The returned fn(block_of, payload) takes per-shard lists of
      block_of: (B,) destination block id per patch (-1 = stays local);
      payload:  (B, D) patch record
    and returns (recv_payload, recv_valid, n_dropped): each shard receives
    up to `slots` incoming patches per source shard, as (n_shards * slots,
    D) rows, source-major; overflow beyond `slots` is counted in n_dropped
    (summed over the mesh) so callers can retry with more slots; over a
    mesh that spans processes, each process passes and gets its own
    shards' entries (None for the others'). Packing is
    a stable sort by destination and one scatter, O(B log B) per shard.
    Blocks map to shards by identity modulo the mesh size (JAX's
    n_blocks argument, which it does not use either, is left out)."""
    n = mesh.size

    def pack_one(blk, pay):
        B = blk.shape[0]
        dev = blk.device
        dest = torch.where(blk >= 0, blk % n, torch.full_like(blk, n)).long()
        order = torch.sort(dest, stable=True).indices
        sd = dest[order]
        starts = torch.searchsorted(sd, torch.arange(n + 1, device=dev))
        slot = torch.arange(B, device=dev) - starts[torch.clamp(sd, max=n)]
        valid = (sd < n) & (slot < slots)
        dropped = ((sd < n) & (slot >= slots)).sum()
        # one scatter into (dest, slot); invalid rows land in the dump
        # row/column that the final slice cuts away
        d_idx = torch.where(valid, sd, torch.full_like(sd, n))
        s_idx = torch.where(valid, slot, torch.full_like(slot, slots))
        send = pay.new_zeros((n + 1, slots + 1) + tuple(pay.shape[1:]))
        send[d_idx, s_idx] = pay[order]
        sv = torch.zeros((n + 1, slots + 1), dtype=torch.bool, device=dev)
        sv[d_idx, s_idx] = valid
        return send[:n, :slots], sv[:n, :slots], dropped

    def fn(block_of, payload):
        packed = [None if b is None else pack_one(b, p)
                  for b, p in zip(block_of, payload)]
        recv = all_to_all(mesh, [None if p is None else p[0]
                                 for p in packed])
        recv_valid = all_to_all(mesh, [None if p is None else p[1]
                                       for p in packed])
        dropped = psum([None if p is None else p[2] for p in packed], mesh)
        dropped = int(next(d for d in dropped if d is not None))
        return ([r if r is None else
                 r.reshape((n * slots,) + tuple(r.shape[2:])) for r in recv],
                [v if v is None else v.reshape(n * slots)
                 for v in recv_valid], dropped)

    return fn


def make_pairwise_halo(mesh: Mesh, k: int):
    """One ragged-halo hop: every shard ships its patch rows to the shard
    `k` positions ahead (mod mesh size). The spatial engine knows the
    exact per-(src, dst) migration counts on the host, so it issues ONE
    hop per shard offset that carries patches, each sized to that offset's
    own max count: the wire volume tracks the logical payload instead of
    the dense all_to_all's (n_shards x slots) buffer per shard. fn(pay,
    valid) takes and returns per-shard lists; the rows a shard ships are
    its buffer's (JAX's slots argument is its leading size). Only the hops
    between this process's shards run (device copies, no collective; a
    shard without rows passes None): over several processes the spatial
    engine ships the rows for other processes itself, in one allgather
    per round."""

    def fn(pay, valid):
        return _hop(mesh, pay, k)[0], _hop(mesh, valid, k)[0]

    return fn


def halo_exchange(mesh: Mesh, block_of, payload, slots: int):
    """One-shot make_halo_exchange on global batches (split over the mesh
    with shard_batch) or per-shard lists. Returns per-shard (recv, valid)."""
    if not isinstance(block_of, (list, tuple)):
        block_of = shard_batch(mesh, block_of)
        payload = shard_batch(mesh, payload)
    out = make_halo_exchange(mesh, slots)(block_of, payload)
    return out[0], out[1]


def have_work_psum(mesh: Mesh, local_counts) -> int:
    """Termination detection: the sum of per-shard queue sizes (replaces the
    haveWork() OR reduction, main.cpp:174-180). local_counts: per-shard
    counts (None for other processes' shards), or an (n_shards,) array
    split over the mesh; summed across the processes too."""
    if not isinstance(local_counts, (list, tuple)):
        local_counts = shard_batch(mesh, local_counts)
    parts = [c if c is None or isinstance(c, torch.Tensor)
             else torch.as_tensor(c) for c in local_counts]
    return int(next(t for t in psum(parts, mesh) if t is not None).sum())
