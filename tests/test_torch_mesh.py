"""The port's mesh (hpmvs_tpu_torch/parallel/mesh.py) and the Engine's mesh
branches against hpmvs_tpu/parallel/mesh.py on the CPU: the JAX functions
over conftest's 8 virtual devices, the port's over 8 CPU shards
(make_mesh(["cpu"] * 8)).

- make_mesh: the default and explicit (dp, sp) shapes equal the JAX
  mesh's for 1-8 devices (bitwise); a CUDA mesh raises without a GPU.
- The halo all_to_all (payload, valid, dropped count, with and without
  overflow), the pairwise hop and have_work_psum equal the JAX collectives'
  outputs bitwise.
- The deferred-depth window on the replicas: sharded_apply_depth_updates
  and gate_shards (a shard without lanes included) leave every replica
  bit-equal to one single-device apply_phased_updates of the window,
  add/subtract/add phases included (the window applies once per replica;
  phase 1 is not idempotent).
- sharded_optimize_step on the engine tests' small plane (B=32 seeds over
  8 shards), against the JAX sharded step: per lane, statistically like
  the GN parity (tests/test_torch_gn.py) -- ok agrees on >= 95% of lanes,
  the centres of lanes both accept within 1e-3 on >= 95% -- and the
  min-reduced depth equals (bitwise) one single-device scatter-min of the
  port's own accepted (patch, view) pairs; the replicas are equal.
- The Engine over a 4-shard mesh on tests/test_subsets.py's _tiny plane
  (4 cameras x 96 px, 24 points; the JAX mesh engine's time is mostly its
  compilation, which a larger scene would not cut), against the JAX Engine
  over a 4-device mesh (WAVE_LOOKAHEAD on, no deep waves under a mesh in
  either): alive within 10% (measured 140 against 132), >= 0.95 within
  0.02 of the plane.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hpmvs_tpu.config import Options as JOptions
from hpmvs_tpu.core import depth as jdepth
from hpmvs_tpu.core import scene as jscene
from hpmvs_tpu.parallel import mesh as jmesh
from hpmvs_tpu.runtime.wavefront import Engine as JEngine
from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.core import depth as pdepth
from hpmvs_tpu_torch.parallel import mesh as pmesh
from hpmvs_tpu_torch.runtime.wavefront import Engine as PEngine

from torch_parity import plane_options, port_ctx, port_pack, run_to

torch.set_num_threads(1)


def _cpu_mesh(n=8, shape=None):
    return pmesh.make_mesh(["cpu"] * n, shape=shape)


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shapes(n):
    m = _cpu_mesh(n)
    j = jmesh.make_mesh(n)
    assert m.shape == j.devices.shape
    assert m.axis_names == j.axis_names == ("dp", "sp")
    assert m.size == n and m.distinct == (torch.device("cpu"),)


def test_make_mesh_explicit_shape_and_cuda():
    m = _cpu_mesh(8, shape=(4, 2))
    assert m.shape == jmesh.make_mesh(8, shape=(4, 2)).devices.shape
    with pytest.raises(ValueError):
        _cpu_mesh(8, shape=(3, 2))
    if not torch.cuda.is_available():
        # no shard ever runs quietly on the CPU
        for devs in (["cuda"], None, 2):
            with pytest.raises(RuntimeError):
                pmesh.make_mesh(devs)


def _halo_inputs(B_per=6, seed=0):
    n = 8
    rng = np.random.default_rng(seed)
    payload = rng.normal(size=(n * B_per, 5)).astype(np.float32)
    payload[:, 0] = np.arange(n * B_per)
    block = rng.integers(0, 3 * n, n * B_per).astype(np.int32)
    block[::3] = -1
    return block, payload


@pytest.mark.parametrize("slots", [6, 1])
def test_halo_exchange_equals_jax(slots):
    """all_to_all migration: recv payload, recv valid and the dropped
    count bitwise (slots=1 overflows some (src, dst) pairs)."""
    block, payload = _halo_inputs()
    jm = jmesh.make_mesh(8, shape=(2, 4))
    jr, jv, jd = jmesh.make_halo_exchange(jm, 24, slots)(
        jnp.asarray(block), jnp.asarray(payload))
    pm = _cpu_mesh(8, shape=(2, 4))
    pr, pv, pd = pmesh.make_halo_exchange(pm, slots)(
        pmesh.shard_batch(pm, block), pmesh.shard_batch(pm, payload))
    jv = np.asarray(jv)
    np.testing.assert_array_equal(pmesh.unshard(pv), jv)
    # invalid slots hold zeros in both
    np.testing.assert_array_equal(pmesh.unshard(pr), np.asarray(jr))
    assert pd == int(np.asarray(jd).reshape(-1)[0])
    assert (pd > 0) == (slots == 1)
    got = sorted(pmesh.unshard(pr)[pmesh.unshard(pv)][:, 0].tolist())
    if pd == 0:
        assert got == sorted(payload[block >= 0, 0].tolist())
    r1, v1 = pmesh.halo_exchange(pm, block, payload, slots)
    np.testing.assert_array_equal(pmesh.unshard(v1), jv)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_pairwise_halo_equals_jax(k):
    rng = np.random.default_rng(k)
    slots = 3
    pay = rng.normal(size=(8 * slots, 14)).astype(np.float32)
    val = rng.random(8 * slots) < 0.6
    jm = jmesh.make_mesh(8)
    jp, jv = jmesh.make_pairwise_halo(jm, k, slots)(jnp.asarray(pay),
                                                    jnp.asarray(val))
    pm = _cpu_mesh(8)
    pp, pv = pmesh.make_pairwise_halo(pm, k)(
        pmesh.shard_batch(pm, pay), pmesh.shard_batch(pm, val))
    np.testing.assert_array_equal(pmesh.unshard(pp), np.asarray(jp))
    np.testing.assert_array_equal(pmesh.unshard(pv), np.asarray(jv))


@pytest.mark.parametrize("counts", [[0, 1, 0, 2, 0, 0, 3, 0], [0] * 8,
                                    [5, 4, 3, 2, 1, 0, 9, 11]])
def test_have_work_psum_equals_jax(counts):
    c = np.asarray(counts, np.int32)
    jm = jmesh.make_mesh(8, shape=(2, 4))
    assert pmesh.have_work_psum(_cpu_mesh(8), c) \
        == jmesh.have_work_psum(jm, jnp.asarray(c)) == int(c.sum())


def test_pmin_psum_ppermute():
    m = _cpu_mesh(4)
    reps = [torch.tensor([3.0, float(i), 5.0 - i]) for i in range(4)]
    pmesh.pmin(reps)
    for r in reps:
        assert r.tolist() == [3.0, 0.0, 2.0]
    s = pmesh.psum([torch.tensor([i, 1]) for i in range(4)])
    assert all(x.tolist() == [6, 4] for x in s)
    out = pmesh.ppermute(m, [torch.tensor([i]) for i in range(4)], 1)
    assert [int(x) for x in out] == [3, 0, 1, 2]


@pytest.fixture(scope="module")
def small():
    """The engine tests' small plane, built once by each package."""
    ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2)
    jo = plane_options(JOptions)
    scene = jscene.build_scene(ps.model, jo, images=ps.images)
    jpack = jdepth.build_depth_pack(np.asarray(scene.ctx.imgs.width),
                                    np.asarray(scene.ctx.imgs.height))
    seeds = jscene.make_seed_patches(ps.model, scene, jo)
    return ps, jo, scene, jpack, seeds


def _window(small, n=24, seed=3):
    """A starting z-buffer holding n seed patches S, and a phased window:
    adds of S pushed back along their normals (deeper, mostly the same
    cells), subtracts of S, adds of other seeds."""
    _, _, _, _, (c, nrm, s, v, _) = small
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(c))
    a, b = idx[:n], idx[n:2 * n]
    back = (c[a] - 2e-3 * nrm[a]).astype(np.float32)
    cc = np.concatenate([back, c[a], c[b]]).astype(np.float32)
    ss = np.concatenate([s[a], s[a], s[b]]).astype(np.float32)
    vv = np.concatenate([v[a], v[a], v[b]]).astype(np.int32)
    ph = np.repeat(np.asarray([0, 1, 2], np.int32), [n, n, len(b)])
    start = (c[a].astype(np.float32), s[a].astype(np.float32),
             v[a].astype(np.int32), np.zeros(n, np.int32))
    return start, (cc, ss, vv, ph)


def test_depth_window_once_per_replica(small):
    ps, jo, scene, jpack, _ = small
    ctx, pack = port_ctx(scene.ctx), port_pack(jpack)
    opt = plane_options(POptions)
    start, win = _window(small)
    pdepth.apply_phased_updates(pack, ctx.cams,
                                *(torch.as_tensor(a) for a in start),
                                opt.DEPTH_SUBSAMPLE)
    wt = tuple(torch.as_tensor(a) for a in win)
    ref = dataclasses.replace(pack, depth=pack.depth.clone())
    pdepth.apply_phased_updates(ref, ctx.cams, *wt, opt.DEPTH_SUBSAMPLE)
    # applied twice the window differs: it must apply once per replica
    twice = dataclasses.replace(ref, depth=ref.depth.clone())
    pdepth.apply_phased_updates(twice, ctx.cams, *wt, opt.DEPTH_SUBSAMPLE)
    assert not torch.equal(twice.depth, ref.depth)
    m = _cpu_mesh(4)
    reps = pmesh.replicate(m, pack.depth)
    pmesh.sharded_apply_depth_updates(m, ctx.cams, pack,
                                      opt.DEPTH_SUBSAMPLE)(reps, *win)
    for r in reps:
        assert torch.equal(r, ref.depth)
    # the fused gate path: shards 1 and 3 without lanes still apply it
    reps = pmesh.replicate(m, pack.depth)
    _, _, _, _, (c, nrm, s, v, _) = small
    lanes = tuple(torch.as_tensor(a) for a in (
        c[:4], nrm[:4], s[:4], v[:4], c[:4], np.full(4, 0.1, np.float32)))
    fn, _ = pmesh.sharded_optimize_and_gate(m, ctx, opt, pack,
                                            scene.n_cameras)
    outs = fn([lanes, None, lanes, None], reps,
              pmesh.replicate_tables(m, wt))
    assert outs[1] is None and outs[3] is None and outs[0] is not None
    for r in reps:
        assert torch.equal(r, ref.depth)


def test_sharded_step_against_jax(small):
    ps, jo, scene, jpack, (c, n, s, v, _) = small
    B = 32
    (cp, np_, sp, vp), Bp = jmesh.pad_to_multiple(
        (c[:B], n[:B], s[:B], v[:B]), min(B, len(c)), 8,
        (0.0, 0.0, 0.0, -1))
    jm = jmesh.make_mesh(8, shape=(2, 4))
    jstep, _ = jmesh.sharded_optimize_step(jm, scene.ctx, jo, jpack)
    jout = jstep(jnp.asarray(cp), jnp.asarray(np_), jnp.asarray(sp),
                 jnp.asarray(vp), jpack.depth)
    pm = _cpu_mesh(8, shape=(2, 4))
    opt = plane_options(POptions)
    ctx, pack = port_ctx(scene.ctx), port_pack(jpack)
    pstep, n_shards = pmesh.sharded_optimize_step(pm, ctx, opt, pack)
    assert n_shards == 8
    sh = [pmesh.shard_batch(pm, a) for a in (cp, np_, sp, vp)]
    reps = pmesh.replicate(pm, pack.depth)
    pout = pstep(*sh, reps)
    oc, ok = pmesh.unshard(pout[0]), pmesh.unshard(pout[4])
    jc, jok = np.asarray(jout[0]), np.asarray(jout[4])
    assert (ok == jok).mean() >= 0.95
    both = ok & jok
    assert both.sum() >= 0.5 * Bp
    close = np.abs(oc[both] - jc[both]).max(1) < 1e-3
    assert close.mean() >= 0.95
    # replicas: equal, and the min-reduce of the shards' scatter-mins is
    # one single-device scatter-min of the same accepted pairs
    for r in reps[1:]:
        assert torch.equal(r, reps[0])
    ov = pmesh.unshard(pout[3])
    v_ok = np.where(ok[:, None], ov, -1)
    idx, d, valid = pdepth._patch_view_cells(
        pack, ctx.cams, torch.as_tensor(oc),
        torch.as_tensor(pmesh.unshard(pout[2])), torch.as_tensor(v_ok),
        opt.DEPTH_SUBSAMPLE)
    ref = pack.depth.clone().scatter_reduce_(
        0, idx.reshape(-1).long(),
        torch.where(valid, d, torch.full_like(d, float("inf"))).reshape(-1),
        "amin")
    assert torch.equal(reps[0], ref)
    assert int((ref < pdepth.MAX_DEPTH).sum()) > 0


def test_engine_over_mesh_against_jax():
    ps = make_plane_scene(n_cams=4, imgsize=96, n_points=24, seed=0)
    jm = jmesh.make_mesh(4)
    je = run_to(JEngine(ps.model, plane_options(JOptions), images=ps.images,
                        mesh=jm), 100)
    pm = _cpu_mesh(4)
    pe = run_to(PEngine(ps.model, plane_options(POptions), images=ps.images,
                        mesh=pm), 100)
    assert pe.stats["disp_deep"] == je.stats["disp_deep"] == 0
    assert pe.stats["lookahead_hits"] > 0
    nj, np_ = je.n_alive(), pe.n_alive()
    assert abs(np_ - nj) <= 0.1 * nj, (nj, np_)
    d = np.abs(pe.alive_arrays()[0][:, 2] - ps.plane_z)
    assert (d < 0.02).mean() >= 0.95
    # the replicas stayed equal to the engine's z-buffer
    pe._flush_depths()
    for r in pe._replicas()[1:]:
        assert torch.equal(r, pe.pack.depth)
