"""Wave lookahead in the port's engine (runtime/wavefront.py:
_speculate_next, _speculate_after_branch, _extend_finish_from).

With WAVE_LOOKAHEAD the engine dispatches wave N+1's extend batch before it
routes wave N: the next wave's membership is the router's own decision
(_insert_winners) on wave N's gate output and the current tree. Parity with
the classic engine is statistical, as in the JAX package's
tests/test_lookahead.py (whose bands these are): subtracts made after a
speculation lag one dispatch, and large waves route as one batch.

Run on the small plane of tests/torch_parity.py with WAVE_DEPTH=1, so the
lookahead is measured alone (tests/test_torch_deepwave.py runs it with deep
waves)."""

import numpy as np
import pytest
import torch

from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.runtime.wavefront import Engine

from torch_parity import plane_options

torch.set_num_threads(1)


def _engine(ps, outdir, **kw):
    opt = plane_options(POptions, WAVE_DEPTH=1, OUTFOLDER=str(outdir), **kw)
    e = Engine(ps.model, opt, images=ps.images, device="cpu")
    e.seed()
    return e


def _finish(e):
    for prio in range(e.opt.max_prio):
        e.process_priority_step(prio)
        if not e.have_work():
            break
    return e


@pytest.fixture(scope="module")
def scene():
    return make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2)


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    d = tmp_path_factory.mktemp("lookahead")
    on = _finish(_engine(scene, d, WAVE_LOOKAHEAD=True))
    off = _finish(_engine(scene, d, WAVE_LOOKAHEAD=False))
    return on, off


def test_lookahead_engages(runs):
    """Speculation carries the steady-state wavefront: hits outnumber misses
    at least five to one, and the classic engine never speculates."""
    on, off = runs
    hits, misses = int(on.stats["lookahead_hits"]), \
        int(on.stats["lookahead_misses"])
    assert hits > 0 and hits >= 5 * max(misses, 1), (hits, misses)
    assert on.stats["t_host_overlapped"] > 0.0
    assert int(off.stats["lookahead_hits"]) == 0
    assert int(off.stats["spec_waste_lanes"]) == 0
    # the one-shot flags never outlive the route they were set for
    assert on._depths_pre_added is False and on._spec is None


def test_lookahead_parity(runs, scene):
    """Alive within 5%, plane RMS within 10% + 1e-4, level histogram within
    max(5%, 5)."""
    on, off = runs
    n_on, n_off = on.n_alive(), off.n_alive()
    assert abs(n_on - n_off) <= 0.05 * n_off, (n_on, n_off)
    z = scene.plane_z
    rms = [float(np.sqrt(((e.alive_arrays()[0][:, 2] - z) ** 2).mean()))
           for e in (on, off)]
    assert rms[0] <= rms[1] * 1.1 + 1e-4, rms
    h_on, h_off = on.tree.histogram(), off.tree.histogram()
    L = max(len(h_on), len(h_off))
    h_on, h_off = np.pad(h_on, (0, L - len(h_on))), \
        np.pad(h_off, (0, L - len(h_off)))
    assert (np.abs(h_on - h_off) <= np.maximum(0.05 * h_off, 5)).all(), \
        (h_on, h_off)


def test_lookahead_honest_counting(runs):
    """patches_optimized counts the consumed waves' fresh lanes (what the
    classic engine dispatches); the stale superset is speculative waste."""
    on, off = runs
    a, b = int(off.stats["patches_optimized"]), \
        int(on.stats["patches_optimized"])
    assert abs(b - a) <= 0.10 * a, (a, b)
    assert on.stats["spec_waste_lanes"] > 0


def test_lookahead_gate_decomposition(runs):
    """A count delta stays spread over the phases (one localized to a phase
    would be a semantic break, not near-threshold jitter); the multi-patch
    filter absorbs the one-dispatch freshness lag (JAX
    tests/test_lookahead.py)."""
    on, off = runs
    for k in ("extended", "branched", "regularized"):
        a, b = int(off.stats[k]), int(on.stats[k])
        assert abs(b - a) <= max(0.10 * a, 20), (k, a, b)
    a, b = int(off.stats["filtered"]), int(on.stats["filtered"])
    assert abs(b - a) <= max(0.30 * a, 20), ("filtered", a, b)


def test_speculation_voided_by_mutation(scene, tmp_path):
    """A speculation whose parents moved (an external mutation between
    waves) misses and falls back to a fresh dispatch; drop_speculation()
    voids one outright."""
    e = _engine(scene, tmp_path, WAVE_LOOKAHEAD=True)
    while e.have_work() and e._spec is None:
        e.process_priority_step(min(e.queue))
    assert e._spec is not None and e._spec["par_pids"] is not None
    spec = e._spec
    pids = spec["par_pids"]
    assert e._spec_matches(spec, pids)
    e.patches.center[pids[0]] += 1e-3
    assert not e._spec_matches(spec, pids)
    e.patches.center[pids[0]] -= 1e-3
    misses = int(e.stats["lookahead_misses"])
    e.patches.center[pids[0]] = e.patches.center[pids[0]] + 1e-3
    _finish(e)
    assert int(e.stats["lookahead_misses"]) == misses + 1
    e2 = _engine(scene, tmp_path, WAVE_LOOKAHEAD=True)
    while e2.have_work() and e2._spec is None:
        e2.process_priority_step(min(e2.queue))
    e2.drop_speculation()
    assert e2._spec is None
