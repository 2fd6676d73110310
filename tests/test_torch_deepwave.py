"""Deep waves in the port (hpmvs_tpu_torch/ops/deepwave.py and the engine's
_deep_* methods) against the JAX package's deep waves and the port's own
classic engine.

Unit level: the device router's winner dedup equals the JAX one and the
host router's on an empty tree; the next generation's lanes and the level
from a cell width equal the JAX ones; one WAVE_DEPTH=2 enqueue equals the
same chain called step by step, bit for bit on the CPU.

Engine level, on the small plane of tests/torch_parity.py: the port at its
defaults (deep waves and lookahead) against the port's classic engine, in
the bands of the JAX package's tests/test_deepwave.py and
tests/test_lookahead.py. tests/test_torch_pipeline.py holds the port at its
defaults against a live run of the JAX engine at its defaults."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpmvs_tpu.config import Options as JOptions
from hpmvs_tpu.core import scene as jscene
from hpmvs_tpu.ops import deepwave as jdeep
from hpmvs_tpu.ops import optimizer as jopt
from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.core import depth as pdepth
from hpmvs_tpu_torch.core.octree import LinearOctree
from hpmvs_tpu_torch.ops import deepwave as pdeep
from hpmvs_tpu_torch.ops import optimizer as popt
from hpmvs_tpu_torch.runtime.wavefront import Engine

from torch_parity import plane_options, port_ctx, t

torch.set_num_threads(1)


def _cluster_batch(seed, B=512):
    """Lanes around a root cube, half spread, half packed into a few cells
    (collisions), a fifth not ok, a tenth outside the root."""
    rng = np.random.default_rng(seed)
    center = np.array([0.25, -0.5, 1.0])
    oc = center + rng.uniform(-2.5, 2.5, (B, 3))
    hot = rng.random(B) < 0.5
    oc[hot] = center + rng.choice([-0.3, 0.1, 0.7], (hot.sum(), 3)) \
        + rng.normal(0, 0.05, (hot.sum(), 3))
    ok = rng.random(B) < 0.8
    lv = rng.integers(2, 6, B).astype(np.int64)
    return center, oc.astype(np.float32), ok, lv


@pytest.mark.parametrize("seed", [0, 1])
def test_winner_dedup_matches_jax_and_host_router(seed):
    """First wins per (level, cell) in lane order: port == JAX == the host
    router's _insert_winners on an empty tree (its occupancy checks are
    vacuous there)."""
    center, oc, ok, lv = _cluster_batch(seed)
    tree = LinearOctree(center, 4.0, max_level=12, native=False)

    class _Host:
        pass

    h = _Host()
    h.tree = tree
    host, _ = Engine._insert_winners(h, oc, ok.copy(), lv)
    jwin = np.asarray(jdeep.winner_dedup(
        jnp.asarray(oc), jnp.asarray(ok), jnp.asarray(lv, jnp.int32),
        jnp.asarray(center, jnp.float32), jnp.float32(4.0)))
    pwin = pdeep.winner_dedup(t(oc), t(ok), t(lv.astype(np.int32)),
                              t(center.astype(np.float32)),
                              torch.tensor(4.0)).numpy()
    np.testing.assert_array_equal(pwin, jwin)
    np.testing.assert_array_equal(pwin, host)
    # collisions really happened: fewer winners than ok lanes inside
    assert 20 <= pwin.sum() < (ok & tree.contains(oc)).sum() - 20


def test_level_from_width_matches_jax():
    root_w = np.float32(3.7)
    lv = np.arange(0, 21)
    w = (root_w / (2.0 ** lv)).astype(np.float32)
    w = np.concatenate([w, np.float32([-1.0, 1e-35, 10.0])])
    got = pdeep.level_from_width(t(w), torch.tensor(root_w)).numpy()
    want = np.asarray(jdeep.level_from_width(jnp.asarray(w), root_w))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:21], lv)


@pytest.fixture(scope="module")
def wave0():
    """The small plane's first extend wave, as the engine builds it: the
    seeds' candidate lanes padded to 128 as Engine._deep_dispatch pads them,
    the z-buffer with the seeds' depth adds pending, and the JAX scene the
    port's context was copied from."""
    ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2)
    jo = plane_options(JOptions)
    po = plane_options(POptions)
    jsc = jscene.build_scene(ps.model, jo, images=ps.images)
    eng = Engine(ps.model, po, images=ps.images, device="cpu",
                 native_octree=False)
    eng.seed()
    cids = eng._pop_live(min(eng.queue))
    pids = eng.cell_head[cids]
    _, widths = eng.tree.cell_center_width(cids)
    lanes = eng._extend_candidates(
        eng.patches.center[pids], eng.patches.normal[pids],
        eng.patches.views[pids], eng.patches.prio_red[pids], widths,
        eng.tree.node_level(cids))[:6]
    assert 10 <= len(lanes[0]) <= 128
    gin = pdeep.GateIn(*(t(a) for a in pdeep.pad_lanes(lanes, 128)))
    root = (t(np.asarray(eng.tree.center, np.float32)),
            torch.tensor(np.float32(eng.tree.width)))
    return dict(eng=eng, jsc=jsc, jo=jo, po=po, gin=gin, root=root,
                pend=eng._take_pending())


def _copy_pack(pack):
    return dataclasses.replace(pack, depth=pack.depth.clone())


def test_deep_enqueue_equals_step_by_step(wave0):
    """optimize_and_gate_deep(n_gens=2) == optimize_and_gate, the winner
    dedup, generation 0's depth adds, next_gen_inputs and optimize_and_gate
    again, called one by one: every output and the z-buffer bit for bit."""
    eng, po, gin = wave0["eng"], wave0["po"], wave0["gin"]
    ctx, n_img, lay = eng.scene.ctx, eng.scene.n_cameras, eng._pack_layout
    root_c, root_w = wave0["root"]
    pack_a, pack_b = _copy_pack(eng.pack), _copy_pack(eng.pack)
    deep = pdeep.optimize_and_gate_deep(ctx, pack_a, po, n_img, gin, root_c,
                                        root_w, pend=wave0["pend"], n_gens=2,
                                        pack_layout=lay)

    pdepth.apply_phased_updates(pack_b, ctx.cams, *wave0["pend"],
                                subsample=po.DEPTH_SUBSAMPLE)
    lanes, gens = gin, []
    for g in range(2):
        oc, on, os_, ov, ok, col = popt.optimize_and_gate(
            ctx, pack_b, po, n_img, *lanes, pack_layout=lay)
        lv = pdeep.level_from_width(lanes.w, root_w)
        win = pdeep.winner_dedup(oc, ok, torch.where(lanes.w > 0, lv, -1),
                                 root_c, root_w)
        gens.append((oc, on, os_, ov, ok, col, lanes.c, win))
        if g == 0:
            pdeep.winner_depth_adds(pack_b, ctx.cams, po, oc, os_, ov, win)
            lanes, _ = pdeep.next_gen_inputs(ctx, po, oc, on, os_, ov,
                                             lanes.w, win)
    for name, got, *want in zip(pdeep.DeepOut._fields, deep, *gens):
        assert torch.equal(got, torch.stack(want)), name
    assert torch.equal(pack_a.depth, pack_b.depth)
    # both generations did work: winners in generation 0, ok lanes in 1
    assert deep.win[0].sum() >= 5 and deep.ok[1].sum() >= 5
    # the z-buffer holds generation 0's adds beyond the pending window
    ref = _copy_pack(eng.pack)
    pdepth.apply_phased_updates(ref, ctx.cams, *wave0["pend"],
                                subsample=po.DEPTH_SUBSAMPLE)
    assert (pack_a.depth < ref.depth).sum() > 0


def test_next_gen_inputs_match_jax(wave0):
    """Generation 1's lanes from generation 0's results: port == JAX, ints
    exact, floats to 1e-6."""
    eng, po, gin = wave0["eng"], wave0["po"], wave0["gin"]
    jsc, jo = wave0["jsc"], wave0["jo"]
    root_c, root_w = wave0["root"]
    pack = _copy_pack(eng.pack)
    oc, on, os_, ov, ok, col = popt.optimize_and_gate(
        eng.scene.ctx, pack, po, eng.scene.n_cameras, *gin,
        pend=wave0["pend"], pack_layout=eng._pack_layout)
    lv = pdeep.level_from_width(gin.w, root_w)
    win = pdeep.winner_dedup(oc, ok, torch.where(gin.w > 0, lv, -1), root_c,
                             root_w)
    assert win.sum() >= 5
    got, par = pdeep.next_gen_inputs(port_ctx(jsc.ctx), po, oc, on, os_, ov,
                                     gin.w, win)
    j = lambda a: jnp.asarray(a.numpy())
    xin, jpar = jdeep.next_gen_inputs(jsc.ctx, jo, j(oc), j(on), j(os_),
                                      j(ov), j(gin.w), j(win))
    want = jopt.unpack_gate_in(xin)
    np.testing.assert_array_equal(par.numpy(), np.asarray(jpar))
    for name, a, b in zip(pdeep.GateIn._fields, got, want):
        b = np.asarray(b)
        if b.dtype.kind == "i":
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6,
                                       err_msg=name)
    assert (par.numpy() >= 0).sum() == min(int(win.sum()), 128 // 6)


def _run(ps, outdir, **kw):
    opt = plane_options(POptions, OUTFOLDER=str(outdir), **kw)
    e = Engine(ps.model, opt, images=ps.images, device="cpu")
    e.seed()
    for prio in range(opt.max_prio):
        e.process_priority_step(prio)
        if not e.have_work():
            break
    return e


@pytest.fixture(scope="module")
def deep_runs(tmp_path_factory):
    """The classic engine and the port at its defaults on the small plane."""
    ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2)
    d = tmp_path_factory.mktemp("deep")
    classic = _run(ps, d, WAVE_DEPTH=1, WAVE_LOOKAHEAD=False)
    deep = _run(ps, d)
    assert (deep.opt.WAVE_DEPTH, deep.opt.WAVE_LOOKAHEAD) == (4, True)
    return ps, classic, deep


def test_deep_engages(deep_runs):
    """Deep dispatches carry the wavefront and cut the dispatch chain."""
    _, e1, e4 = deep_runs
    assert e4.stats["disp_deep"] > 0
    assert e4.stats["deep_gens_consumed"] > 0
    assert e4.stats["dispatches"] < 0.7 * e1.stats["dispatches"], \
        (e1.stats["dispatches"], e4.stats["dispatches"])
    hits, misses = e4.stats["lookahead_hits"], e4.stats["lookahead_misses"]
    assert hits >= 5 * max(misses, 1), (hits, misses)
    assert e1.stats["disp_deep"] == 0 and e1.stats["lookahead_hits"] == 0
    fb = e4.stats
    assert fb["deep_fallbacks"] >= (fb["deep_fb_overflow"]
                                    + fb["deep_fb_mismatch"]
                                    + fb["deep_fb_dead"])


def test_deep_parity(deep_runs):
    """Statistical parity with the classic engine: alive within 5%, plane
    RMS within 10% + 1e-4, level histogram within max(5%, 5)."""
    ps, e1, e4 = deep_runs
    n1, n4 = e1.n_alive(), e4.n_alive()
    assert abs(n4 - n1) <= 0.05 * n1, (n1, n4)
    rms = [float(np.sqrt(((e.alive_arrays()[0][:, 2] - ps.plane_z) ** 2)
                         .mean())) for e in (e1, e4)]
    assert rms[1] <= rms[0] * 1.1 + 1e-4, rms
    h1, h4 = e1.tree.histogram(), e4.tree.histogram()
    L = max(len(h1), len(h4))
    h1, h4 = np.pad(h1, (0, L - len(h1))), np.pad(h4, (0, L - len(h4)))
    assert (np.abs(h4 - h1) <= np.maximum(0.05 * h1, 5)).all(), (h1, h4)


def test_deep_honest_counting(deep_runs):
    """patches_optimized counts the lanes a classic engine would have
    dispatched; the speculative superset is counted apart."""
    _, e1, e4 = deep_runs
    a, b = int(e1.stats["patches_optimized"]), \
        int(e4.stats["patches_optimized"])
    assert abs(b - a) <= 0.10 * a, (a, b)
    assert e4.stats["spec_waste_lanes"] > 0
