"""The port's streaming engine (hpmvs_tpu_torch/runtime/streaming.py)
against hpmvs_tpu/runtime/streaming.py on the CPU.

- merge_models equal to the JAX function's (array-equal fields).
- Two chunks of the engine tests' small plane (tests/test_deepwave.py's
  Options; 5 cameras x 128 px, 40 points, split 3 cameras + 20 points /
  2 + 20), both engines classic (WAVE_DEPTH=1, WAVE_LOOKAHEAD=False: the
  JAX engine compiles no deep dispatch, for time), one octree level
  between them: the grown image pack keeps the
  old planes' rows, the old z-buffer is an unchanged prefix of the grown
  one right after _extend, and the second chunk's seeds (stream_seeds)
  are within 10% of the JAX engine's on the same inputs (the two seed
  refiners agree statistically on the CPU, tests/test_torch_gn.py); the
  port then runs to completion on the plane.
- tests/test_streaming.py:134's reroot case on a smaller plane (5 cameras
  x 192 px, 80 points sorted by x, split 3 + 40 / 2 + 40; MAX_TREE_LEVEL
  5), at the port's defaults: the second
  chunk lies outside the first chunk's root cube, so the tree reroots and
  every queued priority shifts +10 per reroot; the reroot of the port's
  Engine.reroot_tree equals the JAX engine's on the same tree and queue.
- tests/test_streaming.py:166's composition on the port (streaming +
  spatial engine over 4 CPU shards + image subsets + checkpoint/resume):
  the resumed run within max(8%, 30) of the uninterrupted one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hpmvs_tpu.config import Options as JOptions
from hpmvs_tpu.runtime import checkpoint as jckpt
from hpmvs_tpu.runtime.streaming import StreamingEngine as JStream
from hpmvs_tpu.runtime.streaming import merge_models as jmerge
from hpmvs_tpu.runtime.wavefront import Engine as JEngine
from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.runtime import checkpoint as pckpt
from hpmvs_tpu_torch.runtime.streaming import StreamingEngine as PStream
from hpmvs_tpu_torch.runtime.streaming import merge_models as pmerge

from hpmvs_tpu_torch.testing import split_model

from torch_parity import flat_queue, plane_options, sort_points_by_x

torch.set_num_threads(1)

CLASSIC = dict(WAVE_DEPTH=1, WAVE_LOOKAHEAD=False)


def _fields_equal(a, b):
    assert len(a.cameras) == len(b.cameras)
    for ca, cb in zip(a.cameras, b.cameras):
        assert ca.filename == cb.filename
        np.testing.assert_array_equal(ca.c, cb.c)
    for f in ("points_xyz", "points_rgb", "meas_start", "meas_img",
              "meas_feat", "meas_xy"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def test_merge_models_equal():
    scene = make_plane_scene(n_cams=5, imgsize=64, n_points=30, seed=2)
    a, b = split_model(scene.model, 3, np.arange(15))
    merged = pmerge(a, b)
    _fields_equal(merged, jmerge(a, b))
    assert pmerge(None, a) is a
    m = scene.model
    np.testing.assert_array_equal(merged.meas_img[merged.meas_start[15]:],
                                  m.meas_img[m.meas_start[15]:])
    assert merged.meas_start[-1] == len(merged.meas_img)


@pytest.fixture(scope="module")
def two_chunks():
    scene = make_plane_scene(n_cams=5, imgsize=128, n_points=40, seed=2)
    first, second = split_model(scene.model, 3, np.arange(20))
    out = {"scene": scene}
    for name, stream in (("jax", JStream(plane_options(JOptions,
                                                       **CLASSIC))),
                         ("port", PStream(plane_options(POptions, **CLASSIC),
                                          device="cpu"))):
        n1 = stream.add_chunk(first, images=scene.images[:3])
        eng = stream.engine
        lv0 = min(eng.queue) // 10
        stream.run_to(lv0 * 10 + 9)          # one octree level
        eng._flush_depths()
        old_depth = np.array(eng.pack.depth)
        old_rows = int(eng.scene.ctx.imgs.tex.shape[0])
        old_row0 = np.array(eng.scene.ctx.imgs.row0)
        n2 = stream.add_chunk(second, images=scene.images[3:])
        out[name] = dict(stream=stream, n1=n1, n2=n2, old_depth=old_depth,
                         depth=np.array(stream.engine.pack.depth),
                         old_rows=old_rows, old_row0=old_row0)
    return out


def test_extend_keeps_old_state(two_chunks):
    got = two_chunks["port"]
    eng = got["stream"].engine
    assert eng.scene.n_cameras == 5
    imgs = eng.scene.ctx.imgs
    assert imgs.tex.shape[0] > got["old_rows"]
    np.testing.assert_array_equal(imgs.row0[:3].numpy(), got["old_row0"])
    old = got["old_depth"]
    assert (old < 999.0).sum() > 100
    assert len(got["depth"]) > len(old)
    np.testing.assert_array_equal(got["depth"][:len(old)], old)
    assert (got["depth"][len(old):] == 1000.0).all()


def test_stream_seeds_against_jax(two_chunks):
    p, j = two_chunks["port"], two_chunks["jax"]
    assert p["n1"] == j["n1"] > 10
    assert j["n2"] > 5
    assert abs(p["n2"] - j["n2"]) <= 0.10 * j["n2"], (p["n2"], j["n2"])
    assert p["stream"].engine.stats["stream_seeds"] == p["n2"]


def test_stream_runs_to_completion(two_chunks):
    scene = two_chunks["scene"]
    st = two_chunks["port"]["stream"]
    mid = st.engine.n_alive()
    eng = st.run_to(st.opt.max_prio - 1)
    assert not eng.have_work()
    assert eng.n_alive() > mid
    err = np.abs(eng.alive_arrays()[0][:, 2] - scene.plane_z)
    assert np.median(err) < 0.02


REROOT = dict(START_LEVEL=2, MAX_VIEWS=8, COVIS_MIN_POINTS=10,
              MAX_TREE_LEVEL=5, PATCH_FINAL_MINLEVEL=4, LM_ITERS=8)


@pytest.fixture(scope="module")
def reroot_stream(tmp_path_factory):
    scene = make_plane_scene(n_cams=5, imgsize=192, n_points=80, seed=5)
    scene = dataclasses.replace(scene, model=sort_points_by_x(scene.model))
    first, second = split_model(scene.model, 3, np.arange(40))
    st = PStream(dataclasses.replace(POptions(), **REROOT), device="cpu")
    assert st.add_chunk(first, images=scene.images[:3]) > 10
    st.run_to(45)
    before = dict(width=st.engine.tree.width,
                  x_max=st.engine.alive_arrays()[0][:, 0].max(),
                  queue={pr: np.concatenate(c).tolist()
                         for pr, c in st.engine.queue.items() if c})
    n2 = st.add_chunk(second, images=scene.images[3:])
    before["ckpt"] = str(tmp_path_factory.mktemp("reroot") / "s.npz")
    pckpt.save_checkpoint(st.engine, before["ckpt"])
    return scene, st, before, n2


def test_reroot_shifts_queued_priorities(reroot_stream):
    _, st, before, n2 = reroot_stream
    eng = st.engine
    k = int(eng.stats["reroots"])
    assert n2 > 5 and k >= 1
    assert eng.tree.width == pytest.approx(before["width"] * 2 ** k)
    # every cell queued before the extension is queued 10 per reroot later
    after = flat_queue(eng)
    assert before["queue"]
    for pr, cids in before["queue"].items():
        assert set(cids) <= set(after.get(pr + 10 * k, [])), pr


def test_reroot_reconstructs_beyond_old_cube(reroot_stream):
    scene, st, before, _ = reroot_stream
    eng = st.run_to(st.opt.max_prio - 1)
    c = eng.alive_arrays()[0]
    assert c[:, 0].max() > before["x_max"] + 0.1
    assert np.median(np.abs(c[:, 2] - scene.plane_z)) < 0.02


@pytest.mark.parametrize("direction", [(1, 1, 1), (-1, 1, -1)])
def test_reroot_tree_equals_jax(reroot_stream, direction):
    """Engine.reroot_tree in both packages on the state right after the
    streamed extension (checkpointed then)."""
    _, st, before, _ = reroot_stream
    path = before["ckpt"]
    model = st.model
    jopt = dataclasses.replace(JOptions(), **REROOT)
    je = JEngine(model, jopt, images=st.images)
    jckpt.load_checkpoint(je, path)
    pe = type(st.engine)(model, st.opt, images=st.images, device="cpu")
    pckpt.load_checkpoint(pe, path, device="cpu")
    d = np.asarray(direction, np.float64)
    je.reroot_tree(d)
    pe.reroot_tree(d)
    n = pe.tree.n
    assert n == je.tree.n > 0
    np.testing.assert_array_equal(pe.tree.key[:n], je.tree.key[:n])
    np.testing.assert_array_equal(pe.tree.level[:n], je.tree.level[:n])
    np.testing.assert_array_equal(pe.tree.center, je.tree.center)
    assert pe.tree.width == je.tree.width
    assert flat_queue(pe) == flat_queue(je)
    assert pe.stats["reroots"] == je.stats["reroots"] >= 2
    assert len(flat_queue(pe)) > 0
    x = np.asarray(pe.alive_arrays()[0], np.float32)
    np.testing.assert_array_equal(pe.tree.containing_cell(x),
                                  je.tree.containing_cell(x))


def test_streaming_spatial_subsets_checkpoint_compose(tmp_path):
    """tests/test_streaming.py:166-215 composed on the port: streaming
    chunks with a reroot into a spatial engine over 4 CPU shards with
    per-shard image slabs, checkpointed mid-run with live migration state,
    resumed into a FRESH spatial engine over the merged model, finishing
    within max(8%, 30) of the uninterrupted run's alive count, both with
    the median distance to the plane < 0.02 and slab_miss == 0. On the
    reroot plane above (5 cameras x 192 px, 80 points sorted by x, split
    3 + 40 / 2 + 40) with MAX_TREE_LEVEL 6, so that work remains after the
    checkpoint at prio 55. The stream is run once: the uninterrupted run
    goes on from the state the checkpoint was taken of (the JAX test
    streams twice to the same midpoint; the run is deterministic)."""
    from hpmvs_tpu_torch.parallel import mesh as pmesh
    from hpmvs_tpu_torch.runtime.spatial import SpatialEngine

    scene = make_plane_scene(n_cams=5, imgsize=192, n_points=80, seed=5)
    scene = dataclasses.replace(scene, model=sort_points_by_x(scene.model))
    first, second = split_model(scene.model, 3, np.arange(40))
    opt = dataclasses.replace(POptions(), **dict(REROOT, MAX_TREE_LEVEL=6))
    mesh = pmesh.make_mesh(["cpu"] * 4)

    def stream_to_mid():
        se = PStream(opt, mesh=mesh, spatial=True, image_subsets=True)
        assert se.add_chunk(first, images=scene.images[:3]) > 10
        se.run_to(45)
        assert se.add_chunk(second, images=scene.images[3:]) > 5
        assert se.engine.stats["reroots"] >= 1       # the cube grew
        se.run_to(55)
        return se

    se_a = stream_to_mid()
    assert se_a.engine.stats["migrated"] > 0         # halo state exercised
    assert se_a.engine.stats["subset_rebuilds"] >= 1  # slabs really built
    path = str(tmp_path / "compose.npz")
    pckpt.save_checkpoint(se_a.engine, path)
    eng_c = SpatialEngine(se_a.model, opt, images=se_a.images, mesh=mesh,
                          image_subsets=True)
    eng_a = se_a.run_to(opt.max_prio - 1)
    pckpt.load_checkpoint(eng_c, path, device="cpu")
    pckpt.requeue_from_tree(eng_c)
    for p in range(opt.max_prio):
        eng_c.process_priority_step(p)
        if not eng_c.have_work():
            break
    n_a, n_c = eng_a.n_alive(), eng_c.n_alive()
    assert abs(n_c - n_a) <= max(0.08 * n_a, 30), (n_a, n_c)
    for e in (eng_a, eng_c):
        c = e.alive_arrays()[0]
        assert np.median(np.abs(c[:, 2] - scene.plane_z)) < 0.02
        assert e.stats["slab_miss"] == 0
    # both reached past the original cube (the reroot survived the file)
    assert eng_c.alive_arrays()[0][:, 0].max() > 0.1
