"""The port's native octree query library (hpmvs_tpu_torch/core/native.py,
built from native/octree_core.cpp) against the port's numpy path and the
JAX package's LinearOctree: every entry point on random trees and points,
bit for bit (the answers are integers), below and above the size where the
library switches to its sorted merge sweeps; and an engine run answered by
the library equal to one answered by numpy."""

import numpy as np
import pytest
import torch

from hpmvs_tpu.core import octree as joctree
from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.core import native
from hpmvs_tpu_torch.core import octree as poctree
from hpmvs_tpu_torch.runtime.wavefront import Engine

from torch_parity import plane_options

torch.set_num_threads(1)

CENTER = np.array([0.3, -1.2, 2.5])
WIDTH = 3.0
MAX_LEVEL = 12


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The library built here with g++ into a temporary directory, loaded in
    place of the default build for this module's tests."""
    path = native.build(tmp_path_factory.mktemp("octree_lib"))
    assert path.exists() and path.suffix == ".so"
    mp = pytest.MonkeyPatch()
    mp.setattr(native._Lib, "handle", native.lib(path))
    yield path
    mp.undo()


def _trees(seed):
    """The same random tree three times: the port answering natively, the
    port answering with numpy, and the JAX package's LinearOctree. Cells at
    levels 4..MAX_LEVEL around a few clusters, a fifth of them freed."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([CENTER + rng.normal(0, s, (n, 3)) for s, n in
                          ((0.05, 400), (0.3, 600), (1.0, 300))])
    pts = np.clip(pts, CENTER - WIDTH / 2, CENTER + WIDTH / 2 - 1e-9)
    lv = rng.integers(4, MAX_LEVEL + 1, len(pts))
    trees = (poctree.LinearOctree(CENTER, WIDTH, MAX_LEVEL, native=True),
             poctree.LinearOctree(CENTER, WIDTH, MAX_LEVEL, native=False),
             joctree.LinearOctree(CENTER, WIDTH, MAX_LEVEL))
    keys = trees[1].keys_at_levels(pts, lv)
    pair = np.unique(np.stack([lv.astype(np.uint64), keys]), axis=1)
    dead = rng.random(pair.shape[1]) < 0.2
    for t in trees:
        cids = t.alloc_cells(pair[0].astype(np.int8), pair[1])
        t.free_cells(cids[dead])
    return trees, rng


def _queries(rng, n):
    """n points around the tree's clusters, some outside the root."""
    return (CENTER + rng.normal(0, 0.6, (n, 3))
            * rng.choice([0.1, 1.0, 2.0], (n, 1))).astype(np.float32)


@pytest.mark.parametrize("n", [500, 6000])
@pytest.mark.parametrize("query", ["structure_level", "containing_cell"])
def test_point_queries_equal(lib, n, query):
    trees, rng = _trees(n)
    q = _queries(rng, n)
    nat, num, jx = (getattr(t, query)(q) for t in trees)
    assert np.array_equal(nat, num)
    assert np.array_equal(nat, jx)
    # both outcomes occur
    if query == "containing_cell":
        assert (nat >= 0).sum() >= 10 and (nat < 0).sum() >= 10
    else:
        assert len(np.unique(nat)) >= 4


@pytest.mark.parametrize("n", [500, 6000])
def test_lookup_equal(lib, n):
    trees, rng = _trees(n + 1)
    t = trees[1]
    alive = np.nonzero(t.alive[:t.n])[0]
    ids = rng.choice(t.n, n)
    lv = t.level[ids].astype(np.int64)
    keys = t.key[ids].copy()
    # a third of the pairs absent: another level for the same key
    other = rng.random(n) < 0.33
    lv[other] = (lv[other] % MAX_LEVEL) + 1
    nat, num, jx = (tr.lookup(lv, keys) for tr in trees)
    assert np.array_equal(nat, num) and np.array_equal(nat, jx)
    assert np.isin(nat[nat >= 0], alive).all()
    assert (nat < 0).sum() >= 10 and (nat >= 0).sum() >= 10


@pytest.mark.parametrize("n", [500, 6000])
def test_keys_equal(lib, n):
    trees, rng = _trees(n + 2)
    q = _queries(rng, n)
    for level in (0, 3, MAX_LEVEL):
        want = trees[1].key_at(q, level)
        assert np.array_equal(trees[0].key_at(q, level), want)
        assert np.array_equal(
            native.keys_at_level(q, CENTER, WIDTH, level), want)
        assert np.array_equal(trees[2].key_at(q, level), want)
    ij = rng.integers(0, 2 ** 20, (n, 3))
    assert np.array_equal(native.morton_encode(ij[:, 0], ij[:, 1], ij[:, 2]),
                          poctree.morton_encode(ij[:, 0], ij[:, 1], ij[:, 2]))


@pytest.mark.parametrize("seed", [0, 1])
def test_seed_pushdown_equal(lib, seed):
    """Native push-down == the numpy fixed point on clustered seeds whose
    coarse cells hold finer seeds (levels really move)."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([CENTER + rng.normal(0, s, (300, 3))
                          for s in (0.01, 0.1, 0.5)]).astype(np.float32)
    pts = np.clip(pts, CENTER - WIDTH / 2, CENTER + WIDTH / 2 - 1e-6)
    lv0 = rng.integers(2, 9, len(pts))
    nat = poctree.LinearOctree(CENTER, WIDTH, MAX_LEVEL, native=True)
    num = poctree.LinearOctree(CENTER, WIDTH, MAX_LEVEL, native=False)
    lv_n, k_n = nat.seed_pushdown(pts, lv0)
    lv_p, k_p = num.seed_pushdown(pts, lv0)
    assert np.array_equal(lv_n, lv_p) and np.array_equal(k_n, k_p)
    assert (lv_n > lv0).sum() >= 10


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler error raises with the compiler's output; nothing falls
    back to numpy."""
    bad = tmp_path / "octree_core.cpp"
    bad.write_text("extern \"C\" int broken( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="build failed") as e:
        native.build(tmp_path / "build")
    assert "error" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.fixture(scope="module")
def engine_runs(lib, tmp_path_factory):
    ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2)
    opt = plane_options(POptions, WAVE_DEPTH=1,
                        OUTFOLDER=str(tmp_path_factory.mktemp("native")))

    def run(nat):
        e = Engine(ps.model, opt, images=ps.images, device="cpu",
                   native_octree=nat)
        e.seed()
        for prio in range(opt.max_prio):
            e.process_priority_step(prio)
            if not e.have_work():
                break
        return e

    return run(True), run(False)


def test_engine_native_equals_numpy(engine_runs):
    """The small plane with wave lookahead: the same cloud, bit for bit,
    whichever path answered the octree queries."""
    nat, num = engine_runs
    assert nat.stats["octree_native"] is True
    assert num.stats["octree_native"] is False
    assert nat.n_alive() == num.n_alive() > 100
    for a, b in zip(nat.alive_arrays(), num.alive_arrays()):
        assert np.array_equal(a, b)
    assert np.array_equal(nat.tree.histogram(), num.tree.histogram())
