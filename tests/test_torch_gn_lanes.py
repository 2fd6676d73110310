"""The GN kernel's texel-sum order (one warp per patch, csrc/gn.cu) in the
plain PyTorch twin (ops/gn.py::lane_sum), on the CPU.

- lane_sum(..., ordered=True) equals, bit for bit, a numpy float32 model of
  the kernel's order: lane l < 17 adds texel l + 32 to texel l, then every
  lane adds its xor partner's value at offsets 16, 8, 4, 2, 1 (and all 32
  lanes end with the same bits). Without ordered, on a CPU tensor, it is
  torch.sum. A numpy model of the kernel's lane_sums<N>, which runs N such
  sums as a reduce-scatter, gives the butterfly's bits.
- The twin with ordered=True (the order it takes on CUDA tensors, where it
  is held bit for bit against the kernel) against the JAX package's pallas
  kernel in interpret mode, in both refinement modes, with the tolerances
  of tests/test_torch_gn.py and tests/test_torch_gn_fd.py: f at x0 to 1e-5,
  the analytic J to 1e-4, and the depth parameter within 2e-3 and f within
  5e-3 on at least 95% of the trajectories (LM_ITERS_EXACT=4 exact, LM_ITERS
  6 FD: the 3x3 systems here are ill-conditioned, see those files).
- The ordered and unordered twins agree on f at x0 to 1e-6: the order moves
  a sum by a few ulps only.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpmvs_tpu.config import Options as JOptions
from hpmvs_tpu.core import scene as jscene
from hpmvs_tpu.ops import optimizer as jopt
from hpmvs_tpu.ops import pallas_gn
from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.ops import gn
from hpmvs_tpu_torch.ops.windows import WinState

from test_torch_gn_fd import _port_layout, _port_statics
from torch_parity import plane_options, port_ctx, t, tiled_batch

torch.set_num_threads(1)


def _kernel_order(x):
    """numpy float32 model of the GN kernel's texel sum over the last axis (49):
    per lane, the pair, then the xor butterfly; returns lane 0's value after
    checking that every lane holds the same bits."""
    x = x.astype(np.float32)
    lanes = x[..., :32].copy()
    lanes[..., :17] = lanes[..., :17] + x[..., 32:49]
    idx = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    bits = lanes.view(np.uint32)
    assert (bits == bits[..., :1]).all()
    return lanes[..., 0]


def _inputs(kind, seed):
    rng = np.random.default_rng(seed)
    shape = (64, 5, 49, 3)
    if kind == "normal":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "magnitudes":   # mixed signs over twelve decades
        return (rng.standard_normal(shape)
                * 10.0 ** rng.uniform(-6, 6, shape)).astype(np.float32)
    # centred values that cancel, as the normalised textures do
    x = rng.uniform(0, 255, shape).astype(np.float32)
    return x - x.mean(axis=-2, keepdims=True, dtype=np.float32)


@pytest.mark.parametrize("kind", ["normal", "magnitudes", "cancelling"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lane_sum_is_the_kernels_order(kind, seed):
    x = _inputs(kind, seed)
    got = gn.lane_sum(torch.from_numpy(x), -2, ordered=True).numpy()
    want = _kernel_order(np.moveaxis(x, -2, -1))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # off CUDA and unasked, the plain torch.sum
    tx = torch.from_numpy(x)
    assert torch.equal(gn.lane_sum(tx, -2), torch.sum(tx, dim=-2))
    # the order matters: a sequential sum rounds differently somewhere
    seq = np.zeros(want.shape, np.float32)
    for i in range(49):
        seq = seq + x[..., i, :]
    assert (seq != want).any()


def _reduce_scatter(v):
    """numpy float32 model of csrc/gn.cu::lane_sums<N> on v (N, ..., 32):
    while a lane holds several sums it keeps half and trades the other half
    with its xor partner, then the plain steps, then a shuffle from the
    lane holding sum i."""
    N = v.shape[0]
    kl = N.bit_length() - 1
    lane = np.arange(32)
    v = list(v)
    for step in range(kl):
        o, n = 16 >> step, N >> step
        up = (lane & o) != 0
        for i in range(n // 2):
            keep = np.where(up, v[i + n // 2], v[i])
            send = np.where(up, v[i], v[i + n // 2])
            v[i] = keep + send[..., lane ^ o]
    t, o = v[0], 16 >> kl
    while o:
        t, o = t + t[..., lane ^ o], o // 2
    return np.stack([t[..., i << (5 - kl)] for i in range(N)])


@pytest.mark.parametrize("N", [4, 8])
def test_reduce_scatter_keeps_the_butterflys_bits(N):
    x = _inputs("magnitudes", N).reshape(-1, 49)[: 64 * N]
    pairs = x[:, :32].copy()
    pairs[:, :17] = pairs[:, :17] + x[:, 32:49]
    got = _reduce_scatter(pairs.reshape(N, 64, 32))
    want = _kernel_order(x).reshape(N, 64)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.fixture(scope="module")
def setup():
    jo = plane_options(JOptions, MAX_VIEWS=8, LM_ITERS_EXACT=4)
    po = plane_options(POptions, MAX_VIEWS=8, LM_ITERS_EXACT=4)
    ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2)
    sc = jscene.build_scene(ps.model, jo, images=ps.images)
    c, n, s, v = tiled_batch(jscene.make_seed_patches(ps.model, sc, jo),
                             seed=5, jitter=0.004)
    c0, n0, v1, ok0, ws = jax.vmap(functools.partial(jopt._run_pre, sc.ctx,
                                                     jo))(
        jnp.asarray(c), jnp.asarray(n), jnp.asarray(s), jnp.asarray(v))
    pws = WinState(win=t(ws.win), ox=t(ws.ox), oy=t(ws.oy),
                   level=t(ws.level))
    st, args, _ = pallas_gn._prep(sc.ctx, jo, c0, n0, jnp.asarray(s), v1, ws)
    pst, pargs, _ = gn._prep(port_ctx(sc.ctx), po, t(c0), t(n0), t(s),
                             t(v1), pws)
    assert pst == _port_statics(st)
    # the JAX kernel's debug_j output: f, rho and J at x0
    _, fT, JT, _ = pallas_gn.gn_refine_pallas(
        st._replace(debug_j=True), interpret=True, **args)
    J = np.asarray(JT).reshape(3, st.K, -1).transpose(2, 0, 1)
    return st, args, _port_layout(args, st.K, st.W), np.asarray(fT)[0], J


MODES = {"exact": dict(exact_j=True), "fd": dict(exact_j=False)}


@pytest.mark.parametrize("mode", ["exact", "fd"])
def test_ordered_twin_matches_interpret_kernel(setup, mode):
    st, args, a, f0, J0 = setup
    pst = dataclasses.replace(_port_statics(st), **MODES[mode])
    # the value pass at x0 (no iterations), and the analytic J there
    x, f = gn.gn_refine_twin(dataclasses.replace(pst, iters=0, iters_exact=0),
                             **a, ordered=True)
    assert torch.equal(x, a["x0"])
    np.testing.assert_allclose(f.numpy(), f0, atol=1e-5)
    _, fj, J, _ = gn.gn_refine_twin(dataclasses.replace(pst, debug_j=True),
                                    **a, ordered=True)
    assert np.abs(J0).max() > 0.1
    np.testing.assert_allclose(J.numpy(), J0, atol=1e-4)
    np.testing.assert_allclose(fj.numpy(), f0, atol=1e-5)
    # the whole loop
    kx, kf = pallas_gn.gn_refine_pallas(st._replace(**MODES[mode]),
                                        interpret=True, **args)
    kx, kf = np.asarray(kx).T, np.asarray(kf)[0]
    px, pf = (r.numpy() for r in gn.gn_refine_twin(pst, **a, ordered=True))
    within = (np.abs(px[:, 0] - kx[:, 0]) <= 2e-3) & (np.abs(pf - kf) <= 5e-3)
    assert within.mean() >= 0.95, np.nonzero(~within)[0]
    moved = np.abs(px - a["x0"].numpy()).max(1) > 1e-4
    assert moved.mean() > 0.5


@pytest.mark.parametrize("mode", ["exact", "fd"])
def test_ordered_and_unordered_twins_agree_at_x0(setup, mode):
    st, args, a, f0, J0 = setup
    pst = dataclasses.replace(_port_statics(st), iters=0, iters_exact=0,
                              **MODES[mode])
    fo = gn.gn_refine_twin(pst, **a, ordered=True)[1]
    fu = gn.gn_refine_twin(pst, **a, ordered=False)[1]
    np.testing.assert_allclose(fo.numpy(), fu.numpy(), atol=1e-6)
    assert (fo < 2.0).sum() >= 64
