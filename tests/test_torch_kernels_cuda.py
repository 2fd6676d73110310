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
