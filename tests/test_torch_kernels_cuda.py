"""Each hand-written CUDA kernel against its plain PyTorch twin on the GPU,
at the main path's shapes (the comparison chip_smoke.py's kernel phase
makes). Needs a CUDA device and nvcc; skipped without them. Run on the GPU
host with: python -m pytest tests/test_torch_kernels_cuda.py -m cuda"""

import dataclasses

import numpy as np
import pytest
import torch

from hpmvs_tpu_torch import kernel_check, kernels
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.core import scene as scene_mod
from hpmvs_tpu_torch.testing import make_plane_scene

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def results():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "their CPU twins are tested against the JAX package)")
    opt = dataclasses.replace(Options(), START_LEVEL=2, MAX_VIEWS=8,
                              COVIS_MIN_POINTS=30)
    ps = make_plane_scene(n_cams=7, imgsize=512, n_points=400, seed=0)
    sc = scene_mod.build_scene(ps.model, opt, images=ps.images, device="cuda")
    c, n, s, v, _ = scene_mod.make_seed_patches(ps.model, sc, opt)
    B = 2048
    idx = np.arange(B) % len(c)
    rng = np.random.default_rng(0)
    cc = c[idx] + rng.normal(0, 0.002, (B, 3)).astype(np.float32)
    batch = [torch.as_tensor(a, device="cuda")
             for a in (cc, n[idx], s[idx], v[idx])]
    kernels.reset_counts()
    res = kernel_check.check_kernels(sc.ctx, opt, *batch, reps=3)
    return {r.name: r for r in res}


@pytest.mark.parametrize("name", ["fetch", "score", "permute", "gn", "gn_fd",
                                  "gn_debug_j"])
def test_kernel_matches_twin(results, name):
    """gn_fd is the GN kernel's FD/Broyden mode, gn_debug_j its debug_j
    output (counted with the exact mode's launches). The three GN results
    are ok only when bit-equal to the twin (kernel_check._check_gn)."""
    r = results[name]
    assert r.ok, r.detail
    assert kernels.STATS[{"gn_debug_j": "gn"}.get(name, name)].launches > 0


@pytest.mark.parametrize("name", ["gn", "gn_fd", "gn_debug_j"])
def test_gn_is_bit_equal_and_fills_the_card(results, name):
    """One warp per patch, one cluster of 8 CTAs per 128-patch block: at
    B=2048 128 CTAs (a thread per patch launched 16). Local memory holds no
    spills: at most the 32 B stack frame of sinf/cosf's reduction of huge
    arguments."""
    r = results[name]
    assert r.max_abs_err == 0.0, r.detail
    assert "bit-equal" in r.detail and "False" not in r.detail, r.detail
    info = r.launch
    assert info["ctas"] > 16 and info["ctas"] == 2048 // 16, info
    assert info["ctas_per_cluster"] == 8 and info["threads_per_cta"] == 512
    assert info["local_bytes"] <= 32, info


def test_times_are_device_and_call(results):
    """Every kernel and yardstick carries both times: device_ms from a
    backed-up stream, call_ms from one call with its host work."""
    for r in results.values():
        assert 0.0 < r.device_ms < float("inf"), r
        assert 0.0 < r.call_ms < float("inf"), r
        if r.library_ms is not None:
            assert r.library_ms > 0.0 and r.library_call_ms > 0.0, r


def test_copies_exact_and_score_within_tolerance(results):
    assert results["fetch"].max_abs_err == 0.0, results["fetch"].detail
    assert results["permute"].max_abs_err == 0.0, results["permute"].detail
    assert results["score"].max_abs_err <= 2e-5, results["score"].detail


@pytest.mark.parametrize("W", [12, 10])
def test_fetch_paths_match_twin(results, W):
    """The fetch kernel against its twin off the main path's inputs, its
    bool mask read in place, with dead pairs taking zeros and then prev's
    window: W=12, and W=10 (rows of 3W floats not a multiple of 16 bytes)."""
    from hpmvs_tpu_torch.ops import fetch
    g = torch.Generator(device="cuda").manual_seed(W)
    R, wmax, n = 700, 512, 5000
    tex = torch.rand((R, wmax, 3), device="cuda", generator=g) * 255
    rows = torch.randint(0, R - W + 1, (n,), device="cuda", generator=g,
                         dtype=torch.int32)
    ox = torch.randint(0, wmax - W + 1, (n,), device="cuda", generator=g,
                       dtype=torch.int32)
    mask = torch.rand((n,), device="cuda", generator=g) > 0.2
    prev = torch.rand((n, W, W, 3), device="cuda", generator=g)
    for pv in (None, prev):
        k = fetch.fetch_windows(tex, rows, ox, W, mask=mask, prev=pv)
        p = fetch.fetch_windows_twin(tex, rows, ox, W, mask=mask, prev=pv)
        assert torch.equal(k, p)


@pytest.mark.parametrize("W,offset", [(12, 0), (11, 0), (12, 1), (40, 0),
                                      (40, 1)])
def test_score_paths_match_twin(results, W, offset):
    """The score kernel against its twin off the main path's shapes: odd W
    (windows of 12 W^2 bytes, not a multiple of 16), a geometry tensor 4
    bytes off a 16-byte boundary, and W=40. The windows are smooth (as
    images are at the scale of a patch), so a coordinate rounded once more
    in the twin moves a sample by far less than the tolerance."""
    from hpmvs_tpu_torch.ops import score
    g = torch.Generator(device="cuda").manual_seed(W + offset)
    B, K = 129, 7
    ph = torch.rand((B, K, 1, 1, 3), device="cuda", generator=g) * 6.28
    ar = torch.arange(W, device="cuda", dtype=torch.float32)
    yx = 0.2 * ar[:, None, None] + 0.3 * ar[None, :, None]     # (W, W, 1)
    win = (128 + 100 * torch.sin(yx + ph)).contiguous()
    geo = torch.rand((B, K, 6), device="cuda", generator=g)
    geo[..., :2] *= W - 8
    geo[..., 2:] = geo[..., 2:] * 0.6 + 0.5
    flat = torch.empty(geo.numel() + 1, device="cuda")
    geom = flat[offset:offset + geo.numel()].view(B, K, 6)
    geom.copy_(geo)
    kt, kc = score.sample_windows(geom, win, True)
    pt, pc = score.sample_windows_twin(geom, win, True)
    assert float((kt - pt).abs().max()) <= 2e-5
    assert float(((kc - pc).abs() / pc.abs().clamp(min=1.0)).max()) <= 2e-5
