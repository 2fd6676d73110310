"""The port's optimize_batch (stage pipeline + kernels B1-B4 through their
CPU twins) vs the JAX package's batched optimize_batch at B=128, with the
JAX refiner switched to its GN kernel in pallas interpret mode (on the CPU
the JAX package would otherwise refine with its XLA _optimize_patch, a
different algorithm). Views and `ok` equal on >= 98% of the lanes; centres
within 2e-3 where both accept."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpmvs_tpu.config import Options as JOptions
from hpmvs_tpu.core import scene as jscene
from hpmvs_tpu.ops import optimizer as jopt
from hpmvs_tpu.ops import pallas_gn
from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch import kernels
from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.ops import optimizer as popt

from torch_parity import plane_options, port_ctx, t, tiled_batch

torch.set_num_threads(1)

# an OUTFOLDER no other test uses: a distinct static Options value, so the
# patched JAX trace below never meets a cached executable of another test
_OUT = "/tmp/hpmvs_torch_parity_optimizer"


@pytest.fixture(scope="module")
def outputs():
    jo = plane_options(JOptions, MAX_VIEWS=8, OUTFOLDER=_OUT)
    po = plane_options(POptions, MAX_VIEWS=8, OUTFOLDER=_OUT)
    ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2)
    sc = jscene.build_scene(ps.model, jo, images=ps.images)
    c, n, s, v = tiled_batch(jscene.make_seed_patches(ps.model, sc, jo),
                             jitter=0.003)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jopt, "_use_pallas_gn", lambda opt: True)
        mp.setattr(pallas_gn, "gn_refine_batch",
                   functools.partial(pallas_gn.gn_refine_batch,
                                     interpret=True))
        jout = jopt.optimize_batch(sc.ctx, jo, jnp.asarray(c), jnp.asarray(n),
                                   jnp.asarray(s), jnp.asarray(v))
        jout = tuple(np.asarray(a) for a in jout)
    finally:
        mp.undo()
    kernels.reset_counts()
    pout = popt.optimize_batch(port_ctx(sc.ctx), po, t(c), t(n), t(s), t(v))
    stats = {k: dataclasses.asdict(st) for k, st in kernels.STATS.items()}
    return jout, tuple(a.numpy() for a in pout), c, ps.plane_z, stats


def test_optimize_batch_matches_jax(outputs):
    jout, pout, c0, plane_z, _ = outputs
    jc, jn, js, jv, jok, jcol, _ = jout
    pc, pn, ps_, pv, pok, pcol, _ = pout
    assert (pok == jok).mean() >= 0.98
    assert (pv == jv).all(axis=1).mean() >= 0.98
    both = pok & jok
    assert both.sum() >= 64
    np.testing.assert_allclose(pc[both], jc[both], atol=2e-3)
    np.testing.assert_array_equal(ps_, js)
    same = both & (pv == jv).all(axis=1)
    np.testing.assert_allclose(pcol[same], jcol[same], atol=1.0)
    # the batch really was refined onto the plane
    assert np.median(np.abs(pc[pok, 2] - plane_z)) < 0.02


def test_optimize_batch_runs_every_twin(outputs):
    """On CPU tensors every kernel wrapper takes its twin, once per call
    site: fetch twice (pre and post stage), score twice, permute and GN
    once, add_views twice (pre and post stage) and sort_views once; no
    kernel launches."""
    *_, stats = outputs
    assert {k: v["twin_calls"] for k, v in stats.items()} == \
        {"fetch": 2, "score": 2, "permute": 1, "gn": 1, "gn_fd": 0,
         "add_views": 2, "sort_views": 1}
    assert all(v["launches"] == 0 for v in stats.values())


@pytest.fixture(scope="module")
def tiny_plane():
    return make_plane_scene(n_cams=4, imgsize=64, n_points=10, seed=2)


@pytest.mark.parametrize("kw", [dict(WAVE_DEPTH=4, WAVE_LOOKAHEAD=True),
                                dict(WAVE_DEPTH=1, WAVE_LOOKAHEAD=True)])
def test_unported_options_raise(tiny_plane, kw):
    """Deep waves (which ride the lookahead's speculative dispatches) and
    wave lookahead alone build an engine that raises nothing and runs the
    tiny plane to completion."""
    from hpmvs_tpu_torch.runtime.wavefront import Engine
    opt = plane_options(POptions, **kw)
    eng = Engine(tiny_plane.model, opt, images=tiny_plane.images,
                 device="cpu")
    eng.seed()
    for prio in range(opt.max_prio):
        eng.process_priority_step(prio)
        if not eng.have_work():
            break
    assert not eng.have_work() and eng.n_alive() > 0
    if opt.WAVE_DEPTH > 1:
        assert eng.stats["disp_deep"] > 0
    else:
        assert eng.stats["lookahead_hits"] > 0


@pytest.mark.parametrize("kw", [dict(LM_EXACT_J=False),
                                dict(FAST_SETREF=False),
                                dict(FAST_SETREF=False, LM_EXACT_J=False),
                                dict(USE_BATCHED_STAGES=False),
                                dict(USE_WINDOWS=False),
                                dict(USE_PALLAS_GN=False)])
def test_ported_options_build_an_engine(tiny_plane, kw):
    """Every optimizer option (stage pipeline, refiner, GN mode) builds an
    engine."""
    from hpmvs_tpu_torch.runtime.wavefront import Engine
    eng = Engine(tiny_plane.model, plane_options(POptions, **kw),
                 images=tiny_plane.images, device="cpu")
    assert eng.device.type == "cpu"
