"""The view-selection kernels (hpmvs_tpu_torch/ops/select.py,
csrc/select.cu) on the CPU.

The wrappers refuse what the kernels do not take (ValueError before any
library is loaded or pointer passed), and accept the tables the scene and
the stage pipeline give them up to the device test. The kernels' source,
compiled for the host with g++ (one loop iteration per thread, no FMA
contraction, as nvcc builds it), against its plain PyTorch twins on CPU
tensors: views, ok and the slot order on a plane at K = 8 and a facade at
K = 16, each with kernel_check.edge_lanes. The card runs the kernels
themselves in tests/test_torch_kernels_cuda.py."""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hpmvs_tpu_torch import kernel_check, kernels
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.core import scene as scene_mod
from hpmvs_tpu_torch.ops import optimizer as popt
from hpmvs_tpu_torch.ops import sampling, select
from hpmvs_tpu_torch.testing import make_facade_scene, make_plane_scene

torch.set_num_threads(1)

B = 1024


def _scene(kind):
    if kind == "plane":
        opt = dataclasses.replace(Options(), START_LEVEL=2, MAX_VIEWS=8,
                                  COVIS_MIN_POINTS=30)
        sc = make_plane_scene(n_cams=7, imgsize=256, n_points=200, seed=0)
    else:
        opt = dataclasses.replace(Options(), START_LEVEL=2,
                                  COVIS_MIN_POINTS=10)
        sc = make_facade_scene(n_cams=11, imgsize=256, n_points=300, seed=0)
    scene = scene_mod.build_scene(sc.model, opt, images=sc.images,
                                  device="cpu")
    c, n, s, v, _ = scene_mod.make_seed_patches(sc.model, scene, opt)
    rng = np.random.default_rng(0)
    idx = np.arange(B) % len(c)
    cc = c[idx] + rng.normal(0, 0.01, (B, 3)).astype(np.float32)
    nn = n[idx] + rng.normal(0, 0.2, (B, 3)).astype(np.float32)
    batch = [torch.as_tensor(np.ascontiguousarray(a))
             for a in (cc, nn, s[idx], v[idx])]
    return opt, scene.ctx, batch


@pytest.fixture(scope="module", params=["plane", "facade"])
def scene(request):
    return _scene(request.param)


@pytest.fixture(scope="module")
def plane():
    return _scene("plane")


def _guard_cases(ctx, batch):
    c, n, s, v = batch
    big = torch.zeros((B, select.MAX_SLOTS + 1), dtype=torch.int32)
    wide = dataclasses.replace(ctx, covis=torch.full(
        (ctx.covis.shape[0], select.MAX_SLOTS + 1), -1, dtype=torch.int32))
    nccs = torch.zeros(v.shape)
    valid = torch.ones(v.shape, dtype=torch.bool)
    return {
        "K>32": ("add", ctx, (c, n, s, big), "1 <= n <= 32"),
        "C>32": ("add", wide, (c, n, s, v), "covis"),
        "views int64": ("add", ctx, (c, n, s, v.long()), "int32"),
        "center float64": ("add", ctx, (c.double(), n, s, v), "float32"),
        "normal not contiguous": ("add", ctx, (c, n.t().contiguous().t(), s,
                                               v), "contiguous"),
        "sort K>32": ("sort", ctx, (c, n, s, big, torch.zeros(big.shape),
                                    torch.ones(big.shape, dtype=torch.bool)),
                      "1 <= n <= 32"),
        "nccs float64": ("sort", ctx, (c, n, s, v, nccs.double(), valid),
                         "float32"),
        "valid uint8": ("sort", ctx, (c, n, s, v, nccs,
                                      valid.to(torch.uint8)), "bool"),
        "views not contiguous": ("sort", ctx, (c, n, s, v.t().contiguous().t(),
                                               nccs, valid), "contiguous"),
        "add on the CPU": ("add", ctx, (c, n, s, v), "CUDA"),
        "sort on the CPU": ("sort", ctx, (c, n, s, v, nccs, valid), "CUDA"),
    }


@pytest.mark.parametrize("case", ["K>32", "C>32", "views int64",
                                  "center float64", "normal not contiguous",
                                  "sort K>32", "nccs float64", "valid uint8",
                                  "views not contiguous", "add on the CPU",
                                  "sort on the CPU"])
def test_wrapper_refuses_before_launch(plane, case):
    """Each wrapper raises ValueError on what its kernel does not take, and
    no library is built or loaded, no launch counted. The two CPU cases
    carry the scene's own tables and the main path's batch: every check
    passes but the device's."""
    opt, ctx, batch = plane
    kind, cctx, args, match = _guard_cases(ctx, batch)[case]
    fn = select.add_views if kind == "add" else select.sort_views
    kernels.reset_counts()
    handle = kernels._Lib.handle
    with pytest.raises(ValueError, match=match):
        fn(cctx, opt, *args)
    assert kernels._Lib.handle is handle
    assert all(st.launches == 0 for st in kernels.STATS.values())


# The host build: csrc/select.cu up to the end of its anonymous namespace
# (the kernels; the launchers after it are CUDA-only), with the CUDA
# qualifiers defined away and one call per thread index.
SHIM = r"""
#include <algorithm>
#include <cmath>
struct Dim { int x; };
static Dim blockIdx, threadIdx, blockDim;
#define __global__ static
#define __device__
#define __forceinline__ inline
#define __restrict__
using std::isnan; using std::max; using std::min;
#include "kernels.inc"
#define EACH_THREAD(call) \
  blockDim.x = 1; threadIdx.x = 0; \
  for (int b = 0; b < B; ++b) { blockIdx.x = b; call; }
extern "C" void host_add_views(const int* v, const float* c, const float* n,
    const float* s, const int* cov, const float* cc, const float* fs,
    const float* P, const int* w, const int* h, int B, int K, int C,
    int nlev, float cmax, int minl, int maxl, int mini, int* ov, bool* ok) {
  EACH_THREAD(add_views_kernel(v, c, n, s, cov, cc, fs, P, w, h, B, K, C,
                               nlev, cmax, minl, maxl, mini, ov, ok))
}
extern "C" void host_sort_views(const int* v, const float* nc,
    const bool* va, const float* c, const float* n, const float* s,
    const float* cc, const float* fs, int B, int K, float kt, float t,
    int maxl, int mini, float mina, float maxa, int* ov, bool* ok, int* o) {
  EACH_THREAD(sort_views_kernel(v, nc, va, c, n, s, cc, fs, B, K, kt, t,
                                maxl, mini, mina, maxa, ov, ok, o))
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (the native library's compiler)")
    d = tmp_path_factory.mktemp("select_host")
    src = (kernels.CSRC / "select.cu").read_text()
    (d / "kernels.inc").write_text(src[:src.index("}  // namespace")]
                                   + "}  // namespace\n")
    (d / "cuda_runtime.h").write_text("")
    (d / "shim.cpp").write_text(SHIM)
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-fPIC", "-shared", f"-I{d}", "-o", str(d / "lib.so"),
                    str(d / "shim.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(d / "lib.so"))


def _host_add(lib, ctx, opt, center, normal, scale, views):
    Bn, K = views.shape
    p = kernels.ptr
    out, ok = torch.empty_like(views), torch.empty(Bn, dtype=torch.bool)
    lib.host_add_views(
        p(views), p(center), p(normal), p(scale), p(ctx.covis),
        p(ctx.cams.center), p(ctx.cams.fsum), p(ctx.cams.P),
        p(ctx.imgs.width), p(ctx.imgs.height), Bn, K, ctx.covis.shape[1],
        ctx.cams.P.shape[1], ctypes.c_float(sampling.cos32(opt.MAX_ANGLE)),
        opt.MINLEVEL, opt.MAXLEVEL, opt.MIN_IMAGES_PER_PATCH, p(out), p(ok))
    return out, ok


def _host_sort(lib, ctx, opt, center, normal, scale, views, nccs, valid):
    Bn, K = views.shape
    p = kernels.ptr
    out, ok = torch.empty_like(views), torch.empty(Bn, dtype=torch.bool)
    order = torch.empty_like(views)
    lib.host_sort_views(
        p(views), p(nccs), p(valid), p(center), p(normal), p(scale),
        p(ctx.cams.center), p(ctx.cams.fsum), Bn, K,
        ctypes.c_float(1.0 - opt.NCC_ALPHA_1),
        ctypes.c_float(select.sort_threshold(opt)), opt.MAXLEVEL,
        opt.MIN_IMAGES_PER_PATCH, ctypes.c_float(opt.MIN_ANGLE),
        ctypes.c_float(opt.MAX_ANGLE), p(out), p(ok), p(order))
    return out, ok, order


@pytest.mark.parametrize("lanes", ["main", "edge"])
def test_kernel_source_matches_twins(host_lib, scene, lanes):
    """The kernels' source on the host against the twins: add_views on the
    batch, sort_views on the NCCs of the grown views' fetched windows and
    (edge) on edge_lanes' own NCCs and valid masks. The twins' CPU sums
    over 3 run in another order than torch's CUDA ones, which the kernels
    follow, so a lane whose decision sits within an ulp of its threshold
    may differ: at most 1 lane in 1,000."""
    opt, ctx, batch = scene
    sort_in = None
    if lanes == "edge":
        batch, nccs, valid = kernel_check.edge_lanes(ctx, batch, seed=3)
    center, normal, scale, views = batch
    normal = sampling.normalize3(normal)
    a_in = (ctx, opt, center, normal, scale, views)
    hv, hok = _host_add(host_lib, *a_in)
    tv, tok = popt._add_images_twin(*a_in)
    bad = kernel_check._differ((hv, tv), (hok, tok))
    assert len(bad) <= B // 1000, bad
    assert int(hok.sum()) > 0
    if lanes == "edge":
        sort_in = (views, nccs, valid)
    else:
        ws = popt._fetch_ws_b(ctx, opt, hv, center, scale)
        sort_in = (hv, *popt._ref_nccs(ctx, opt, center, normal, scale, hv,
                                       ws))
    s_in = (ctx, opt, center, normal, scale, *sort_in)
    hv, hok, ho = _host_sort(host_lib, *s_in)
    tv, tok, to = popt._sort_views_twin(*s_in)
    bad = kernel_check._differ((hv, tv), (hok, tok), (ho.long(), to))
    assert len(bad) <= B // 1000, bad
    assert int(hok.sum()) > 0
